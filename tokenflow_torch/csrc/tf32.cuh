// The 3xTF32 split shared by the fp32 kernels (flash_attention_f32.cu and
// token_match_f32.cu): fp32 products on the tensor cores at fp32-class
// error.
//   - rounding: every fp32 operand x becomes hi = cvt.rna.tf32.f32(x)
//     (round to nearest, ties away from zero: a TF32 value, its low 13
//     mantissa bits zero) and lo = cvt.rna.tf32.f32(x - hi); x - hi is exact
//     in fp32, so hi + lo equals x to within 2^-22 |x| (FFMA's own operand
//     error is 0). A product a b becomes a_lo b_hi + a_hi b_lo + a_hi b_hi
//     (the a_lo b_lo term is below 2^-22 |a b|), the two cross terms
//     accumulated before the hi hi term so that they meet a partial sum of
//     their own size first. Both parts are rounded explicitly: the kernels
//     never hand the tensor cores a raw fp32 operand and do not depend on
//     how the hardware reads one. (Checked once on an H100 80GB HBM3 with a
//     one-warp mma.sync m16n8k8 tf32 probe against a one-hot B: a raw fp32
//     operand is read as its truncated TF32 value, low 13 mantissa bits
//     dropped; as hi that would leave lo up to 2^-10 |x| and the sum's
//     error twice that of rna.)
//   - the split pre-pass (tf32_split_rows): an fp32 (B, S, H, D) tensor with
//     arbitrary batch, sequence and head strides becomes a contiguous table
//     of rows [hi (dp) | lo (dp)], dims d .. dp - 1 zero, so that one TMA
//     tensor map loads both parts as 32-column boxes;
//   - the tf32 wgmma products (m64nNk8: the reduction step is 8 tf32 = 32
//     bytes, so a 128-byte swizzle row holds 32 fp32 and four k-steps;
//     tf32 operands must be K-major, A from shared memory or registers);
//   - the fp32 TMA tensor map (32-column boxes, 128-byte swizzle).
#pragma once

#include "common.cuh"

namespace tf {

constexpr int kTf32BoxCols = 32;  // fp32 columns per 128-byte swizzle row

// round to nearest TF32, ties away from zero (the split's one rounding)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// (hi, lo) of x: hi = rna(x), lo = rna(x - hi), both TF32 values as floats
__device__ __forceinline__ float2 tf32_split(float x) {
  const float hi = __uint_as_float(tf32_rna(x));
  return make_float2(hi, __uint_as_float(tf32_rna(__fsub_rn(x, hi))));
}

// 4-D map over an fp32 table (c0 contiguous columns, then c1, c2, c3 with
// element strides s1, s2, s3), boxes of 32 columns x `rows` rows (128-byte
// swizzle); TMA fills the box's elements past the table's extent with zeros
inline int make_map_f32(CUtensorMap* map, EncodeTiledFn encode, const void* ptr,
                        long long c0, long long c1, long long c2, long long c3,
                        long long s1, long long s2, long long s3, uint32_t rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c0), static_cast<cuuint64_t>(c1),
                              static_cast<cuuint64_t>(c2), static_cast<cuuint64_t>(c3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1) * 4,
                                 static_cast<cuuint64_t>(s2) * 4,
                                 static_cast<cuuint64_t>(s3) * 4};
  const cuuint32_t box[4] = {kTf32BoxCols, rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - static_cast<int>(r);
}

// shared-memory descriptor of column `col` (a multiple of 8) of a K-major
// tile stored as 32-column boxes of `box_bytes` each (rows 128 bytes apart)
__device__ __forceinline__ uint64_t tf32_desc(uint32_t tile, int col, uint32_t box_bytes) {
  return kmajor_desc(tile + (col / kTf32BoxCols) * box_bytes + (col % kTf32BoxCols) * 4);
}

// d (64 x 32, fp32) = A (64 x 8 tf32, K-major smem) . B (8 x 32, K-major
// smem) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32_m64n32k8_ss(float (&d)[16], uint64_t da,
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = A (64 x 8 tf32, K-major smem) . B (8 x 64, K-major
// smem) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32_m64n64k8_ss(float (&d)[32], uint64_t da,
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) = A (64 x 8 tf32, K-major smem) . B (8 x 128, K-major
// smem) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32_m64n128k8_ss(float (&d)[64], uint64_t da,
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 40, fp32) = A (64 x 8 tf32, registers) . B (8 x 40, K-major
// smem) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32_m64n40k8_rs(float (&d)[20],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = A (64 x 8 tf32, registers) . B (8 x 64, K-major
// smem) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32_m64n64k8_rs(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 80, fp32) = A (64 x 8 tf32, registers) . B (8 x 80, K-major
// smem) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32_m64n80k8_rs(float (&d)[40],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 160, fp32) = A (64 x 8 tf32, registers) . B (8 x 160, K-major
// smem) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32_m64n160k8_rs(float (&d)[80],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// the products by N (one instantiation per width the kernels use)
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "tf32 wgmma width (ss)");
  if constexpr (N == 32) wgmma_tf32_m64n32k8_ss(d, da, db, accumulate);
  if constexpr (N == 64) wgmma_tf32_m64n64k8_ss(d, da, db, accumulate);
  if constexpr (N == 128) wgmma_tf32_m64n128k8_ss(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  static_assert(N == 40 || N == 64 || N == 80 || N == 160, "tf32 wgmma width (rs)");
  if constexpr (N == 40) wgmma_tf32_m64n40k8_rs(d, a, db, accumulate);
  if constexpr (N == 64) wgmma_tf32_m64n64k8_rs(d, a, db, accumulate);
  if constexpr (N == 80) wgmma_tf32_m64n80k8_rs(d, a, db, accumulate);
  if constexpr (N == 160) wgmma_tf32_m64n160k8_rs(d, a, db, accumulate);
}

}  // namespace tf

namespace {

// The split pre-pass: row (b, s, h) of src (element strides sb, ss, sh,
// unit stride along its d dims, 16-byte aligned rows) becomes row (b * n_s
// + s) * n_h + h of dst, [hi (dp) | lo (dp)] with dims >= d zero. d and dp
// are multiples of 4.
__global__ void __launch_bounds__(256)
tf32_split_rows(const float* __restrict__ src, float* __restrict__ dst, int n_s, int n_h,
                long long sb, long long ss, long long sh, int d, int dp, long long n_rows) {
  const int quads = dp / 4;
  const long long n = n_rows * quads;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += gridDim.x * 256ll) {
    const long long row = i / quads;
    const int c = static_cast<int>(i - row * quads) * 4;
    const int h = static_cast<int>(row % n_h);
    const long long bs = row / n_h;
    const int s = static_cast<int>(bs % n_s);
    const long long b = bs / n_s;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) v = *reinterpret_cast<const float4*>(src + b * sb + s * ss + h * sh + c);
    const float2 x = tf::tf32_split(v.x), y = tf::tf32_split(v.y);
    const float2 z = tf::tf32_split(v.z), w = tf::tf32_split(v.w);
    float* out = dst + row * 2 * dp + c;
    *reinterpret_cast<float4*>(out) = make_float4(x.x, y.x, z.x, w.x);
    *reinterpret_cast<float4*>(out + dp) = make_float4(x.y, y.y, z.y, w.y);
  }
}

// grid of the pre-passes: enough 256-thread blocks for n items, at most
// 16 per SM of the H100's 132 (the loop strides past the grid)
inline unsigned split_blocks(long long n) {
  const long long blocks = (n + 255) / 256;
  return static_cast<unsigned>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace
