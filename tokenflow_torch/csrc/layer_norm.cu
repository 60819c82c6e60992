// K5: LayerNorm over the last axis for Hopper (sm_90a): bf16 rows and affine
// parameters, fp32 statistics and affine arithmetic, bf16 output.
//
// The port's transformer blocks (UNet, ControlNet: C = 320, 640, 1280;
// HunyuanDiT: 1408, its per-head QK norm at 88 and its long-skip norm at
// 2816) and CLIP text towers (C = 768, 1024) normalise (B, S, C)
// activations row by row:
//   mean = sum(x) / C, var = sum((x - mean)^2) / C (two passes over the
//   row held in registers: no E[x^2] - E[x]^2 cancellation),
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta, rounded to bf16 once.
// That is the maths of the fp32 path it replaces (F.layer_norm on an fp32
// copy, cast back), without the copy: one read and one write of the
// activation, 4 bytes per element.
//
// Bound: memory bandwidth. Design:
//   - a row is held by a segment of kLanes lanes of one warp (4, 8, 16 or
//     32; 32 / kLanes rows a warp), each lane holding kVecs 16-byte vectors
//     of it (vector v of the row at lane v % kLanes), loaded with 16-byte
//     loads, so a warp's load instruction reads whole 128-byte lines of its
//     rows; the wrapper's plan (kernels/layer_norm.py::plan) picks the
//     fewest lanes whose vectors per lane stay at five or under (C = 320:
//     8 lanes x 5, 640: 16 x 5, 1280: 32 x 5, 768: 32 x 3, 1024: 32 x 4,
//     88: 4 x 3, 1408: 32 x 6, 2816: 32 x 11);
//   - the row's sums reduce over the segment by xor shuffles, in one fixed
//     order (deterministic);
//   - gamma and beta are loaded once per CTA, widened to fp32 in shared
//     memory;
//   - one row group per warp, a CTA per 8 row groups, at four CTAs (1024
//     threads, 64 registers a thread) an SM: the card keeps the next CTAs'
//     loads in flight while others reduce and store; 16-byte stores.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md), this grid beat a persistent one
// (as many CTAs as the card holds, each warp striding over row groups,
// with or without the next rows' loads issued before this row's sums) at
// every row count of the path above 10,000 rows: 87.5% of the bound
// against 78-81% at 491,520 x 320 by CUDA events; streaming cache hints
// (ld.global.nc.L1::no_allocate, st.global.cs) and gamma and beta kept in
// registers read no faster.
//
// The rotary variant (tf_layer_norm_rope, layer_norm_rope_kernel): the same
// rows, statistics and affine at a head dim C (HunyuanDiT's q and k, 16
// heads of 88), the normed row rounded to bf16 as K5 stores it, then the
// 2-D RoPE rotation of its interleaved pairs by fp32 cos / sin tables of
// the row's token position, rounded to bf16 again: the two-launch path (K5,
// then the rotation in fp32) in one read and one write of the activation.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
// 16-byte vectors a lane holds: 8 at any lanes, 11 at 32 (C <= 32 * 11 * 8)
constexpr int kMaxVecs = 11;
// CTAs an SM should hold: four (at most 64 registers a thread) while a
// lane's row takes at most 20 registers (five vectors), else two
template <int kVecs>
constexpr int kMinCtas = kVecs <= 5 ? 4 : 2;
// the rotary variant's lanes a row and most vectors a lane: head dims up to
// 4 x 5 x 8 = 160 (HunyuanDiT's 88: 4 x 3)
constexpr int kRopeLanes = 4;
constexpr int kRopeMaxVecs = 5;

// the 8 bf16 of a 16-byte vector widened to fp32 (a bf16 is the top half
// of its fp32)
__device__ __forceinline__ void widen(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// sum over the kLanes lanes of a segment; every lane gets it
template <int kLanes>
__device__ __forceinline__ float segment_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the kVecs 16-byte vectors of a row that lane sl of its segment holds
// (vector v of the row at lane v % kLanes); zeros past the row or past the
// last row
template <int kLanes, int kVecs>
__device__ __forceinline__ void load_row(const bf16* __restrict__ x, long long row,
                                         long long rows, int c, int n_vec, int sl,
                                         uint4 (&raw)[kVecs]) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * c);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int v = sl + j * kLanes;
    raw[j] = (row < rows && v < n_vec) ? xr[v] : make_uint4(0, 0, 0, 0);
  }
}

// the row's mean and rstd, two passes over the registers, each summed over
// the segment by xor shuffles in one fixed order; every lane gets both
template <int kLanes, int kVecs>
__device__ __forceinline__ void row_stats(const uint4 (&raw)[kVecs], int n_vec, int sl,
                                          float fc, float eps, float& mean, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    float e[8];
    widen(raw[j], e);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += e[k];
  }
  mean = segment_sum<kLanes>(s) / fc;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if (sl + j * kLanes >= n_vec) continue;
    float e[8];
    widen(raw[j], e);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = e[k] - mean;
      q += d * d;
    }
  }
  rstd = rsqrtf(segment_sum<kLanes>(q) / fc + eps);
}

// vector v of the row normalised in place: (e - mean) * rstd * gamma + beta,
// gamma and beta from the CTA's fp32 copy
__device__ __forceinline__ void normalize_vec(float (&e)[8], const float* s_affine, int c, int v,
                                          float mean, float rstd) {
  const float4* g = reinterpret_cast<const float4*>(s_affine + 8 * v);
  const float4* b = reinterpret_cast<const float4*>(s_affine + c + 8 * v);
  const float4 g0 = g[0], g1 = g[1], b0 = b[0], b1 = b[1];
  const float ge[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float be[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = fmaf((e[k] - mean) * rstd, ge[k], be[k]);
}

__device__ __forceinline__ uint4 pack_vec(const float (&e)[8]) {
  return make_uint4(tf::pack_bf16(e[0], e[1]), tf::pack_bf16(e[2], e[3]),
                    tf::pack_bf16(e[4], e[5]), tf::pack_bf16(e[6], e[7]));
}

// gamma and beta widened to fp32 in shared memory, once per CTA
__device__ __forceinline__ void load_affine(float* s_affine, const bf16* __restrict__ gamma,
                                            const bf16* __restrict__ beta, int c) {
  for (int i = threadIdx.x; i < c; i += kThreads) {
    s_affine[i] = __bfloat162float(gamma[i]);
    s_affine[c + i] = __bfloat162float(beta[i]);
  }
  __syncthreads();
}

template <int kLanes, int kVecs>
__global__ void __launch_bounds__(kThreads, kMinCtas<kVecs>)
layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, bf16* __restrict__ y, long long rows, int c,
                  float eps) {
  constexpr int kRowsPerWarp = 32 / kLanes;
  extern __shared__ __align__(16) float s_affine[];  // gamma[c], then beta[c], fp32
  const int n_vec = c / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane / kLanes, sl = lane % kLanes;
  const float fc = static_cast<float>(c);
  load_affine(s_affine, gamma, beta, c);

  // warp-uniform loop (one pass unless the grid is capped): every lane
  // takes part in the shuffles; rows past the end are read as zeros and
  // not stored
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kRowsPerWarp;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kRowsPerWarp;
       r0 < rows; r0 += stride) {
    const long long row = r0 + seg;
    uint4 raw[kVecs];
    load_row<kLanes, kVecs>(x, row, rows, c, n_vec, sl, raw);
    float mean, rstd;
    row_stats<kLanes, kVecs>(raw, n_vec, sl, fc, eps, mean, rstd);
    if (row >= rows) continue;
    uint4* yr = reinterpret_cast<uint4*>(y + row * c);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int v = sl + j * kLanes;
      if (v >= n_vec) continue;
      float e[8];
      widen(raw[j], e);
      normalize_vec(e, s_affine, c, v, mean, rstd);
      yr[v] = pack_vec(e);
    }
  }
}

// The rotary variant (HunyuanDiT's per-head q/k norm followed by its 2-D
// RoPE): rows are one head of one token of a (B, S, H, c) tensor, c the
// head dim, normalised as layer_norm_kernel normalises them, rounded to
// bf16 as that kernel stores them, then rotated on interleaved pairs in
// fp32 and rounded once more:
//   out_{2k} = y_{2k} cos_{2k} - y_{2k+1} sin_{2k},
//   out_{2k+1} = y_{2k+1} cos_{2k+1} + y_{2k} sin_{2k+1},
// cos and sin the fp32 (S, c) tables' row of the token's position, (row /
// H) % S. A pair never straddles a 16-byte vector, so no lane needs
// another's values. The tables (2.9 MB at 4096 x 88) stay in L2, and the
// 16 heads of a token, which share a table row, sit in the same CTA: one
// read and one write of the activation, as layer_norm_kernel. kRopeLanes
// lanes a row (the plan of c up to 160).
template <int kVecs>
__global__ void __launch_bounds__(kThreads, kMinCtas<kVecs>)
layer_norm_rope_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                       const bf16* __restrict__ beta, const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, bf16* __restrict__ y, long long rows,
                       int c, int heads, int seq, float eps) {
  constexpr int kLanes = kRopeLanes;
  constexpr int kRowsPerWarp = 32 / kLanes;
  extern __shared__ __align__(16) float s_affine[];  // gamma[c], then beta[c], fp32
  const int n_vec = c / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane / kLanes, sl = lane % kLanes;
  const float fc = static_cast<float>(c);
  load_affine(s_affine, gamma, beta, c);

  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kRowsPerWarp;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kRowsPerWarp;
       r0 < rows; r0 += stride) {
    const long long row = r0 + seg;
    uint4 raw[kVecs];
    load_row<kLanes, kVecs>(x, row, rows, c, n_vec, sl, raw);
    float mean, rstd;
    row_stats<kLanes, kVecs>(raw, n_vec, sl, fc, eps, mean, rstd);
    if (row >= rows) continue;
    const long long pos = (row / heads) % seq;
    const float4* cr = reinterpret_cast<const float4*>(cos_t + pos * c);
    const float4* sr = reinterpret_cast<const float4*>(sin_t + pos * c);
    uint4* yr = reinterpret_cast<uint4*>(y + row * c);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int v = sl + j * kLanes;
      if (v >= n_vec) continue;
      const float4 c0 = __ldg(cr + 2 * v), c1 = __ldg(cr + 2 * v + 1);
      const float4 s0 = __ldg(sr + 2 * v), s1 = __ldg(sr + 2 * v + 1);
      const float ce[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float se[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float e[8];
      widen(raw[j], e);
      normalize_vec(e, s_affine, c, v, mean, rstd);
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const float a = __bfloat162float(__float2bfloat16_rn(e[k]));
        const float b = __bfloat162float(__float2bfloat16_rn(e[k + 1]));
        e[k] = fmaf(-b, se[k], a * ce[k]);
        e[k + 1] = fmaf(a, se[k + 1], b * ce[k + 1]);
      }
      yr[v] = pack_vec(e);
    }
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*, long long, int, float);

template <int kLanes>
Kernel kernel_for_vecs(int vecs) {
  switch (vecs) {
    case 1: return layer_norm_kernel<kLanes, 1>;
    case 2: return layer_norm_kernel<kLanes, 2>;
    case 3: return layer_norm_kernel<kLanes, 3>;
    case 4: return layer_norm_kernel<kLanes, 4>;
    case 5: return layer_norm_kernel<kLanes, 5>;
    case 6: return layer_norm_kernel<kLanes, 6>;
    case 7: return layer_norm_kernel<kLanes, 7>;
    case 8: return layer_norm_kernel<kLanes, 8>;
    default: return nullptr;
  }
}

// 32 lanes also hold 9-11 vectors (the plan takes fewer lanes only at five
// or under)
Kernel kernel_for_wide(int vecs) {
  switch (vecs) {
    case 9: return layer_norm_kernel<32, 9>;
    case 10: return layer_norm_kernel<32, 10>;
    case 11: return layer_norm_kernel<32, 11>;
    default: return kernel_for_vecs<32>(vecs);
  }
}

// the instantiation for (lanes, vecs); nullptr for a plan it lacks
Kernel kernel_for(int lanes, int vecs) {
  switch (lanes) {
    case 4: return kernel_for_vecs<4>(vecs);
    case 8: return kernel_for_vecs<8>(vecs);
    case 16: return kernel_for_vecs<16>(vecs);
    case 32: return kernel_for_wide(vecs);
    default: return nullptr;
  }
}

// the plan checks: a positive C of whole 16-byte vectors whose vectors the
// segment's lanes cover, with no lane's last vector wholly past the row
bool plan_ok(int c, int lanes, int vecs) {
  if (c <= 0 || c % 8 || !kernel_for(lanes, vecs)) return false;
  const int n_vec = c / 8;
  return lanes * vecs >= n_vec && lanes * (vecs - 1) < n_vec;
}

using RopeKernel = void (*)(const bf16*, const bf16*, const bf16*, const float*, const float*,
                           bf16*, long long, int, int, int, float);

// the rotary instantiation for vecs vectors a lane (kRopeLanes lanes a row);
// nullptr past kRopeMaxVecs
RopeKernel rope_kernel_for(int vecs) {
  switch (vecs) {
    case 1: return layer_norm_rope_kernel<1>;
    case 2: return layer_norm_rope_kernel<2>;
    case 3: return layer_norm_rope_kernel<3>;
    case 4: return layer_norm_rope_kernel<4>;
    case 5: return layer_norm_rope_kernel<5>;
    default: return nullptr;
  }
}

// one row group per warp, capped at the grid's limit (the kernel's loop
// takes the rest)
long long grid_for(long long rows, int lanes) {
  const long long rows_per_cta = static_cast<long long>(kWarps) * (32 / lanes);
  const long long needed = (rows + rows_per_cta - 1) / rows_per_cta;
  return needed < 0x7fffffffLL ? needed : 0x7fffffffLL;
}

}  // namespace

// LayerNorm over the last axis of x (rows x c, contiguous, 16-byte aligned
// like y, gamma and beta), all bf16: `lanes` lanes a row, `vecs` 16-byte
// vectors a lane (the wrapper's plan). Returns the cudaError_t of the
// launch (0 = success; cudaErrorInvalidValue for a plan or pointer this
// file does not accept).
extern "C" int tf_layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                             long long rows, int c, int lanes, int vecs, float eps,
                             void* stream) {
  if (!plan_ok(c, lanes, vecs) || rows < 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(gamma) % 16 ||
      reinterpret_cast<uintptr_t>(beta) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  kernel_for(lanes, vecs)<<<static_cast<unsigned>(grid_for(rows, lanes)), kThreads,
                            8 * c, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(y), rows, c, eps);
  return static_cast<int>(cudaGetLastError());
}

// LayerNorm of each head of a (B, S, H, c) bf16 tensor x (rows = B S H rows
// of c, contiguous, 16-byte aligned like y, gamma and beta), then the 2-D
// RoPE rotation of the normed row by the fp32 (seq, c) tables cos_t and
// sin_t (16-byte aligned) at the row's position (row / heads) % seq:
// `lanes` must be kRopeLanes and `vecs` at most kRopeMaxVecs (the
// wrapper's plan). Returns the cudaError_t of the launch (0 = success;
// cudaErrorInvalidValue for a plan, shape or pointer this file does not
// accept).
extern "C" int tf_layer_norm_rope(const void* x, const void* gamma, const void* beta,
                                  const void* cos_t, const void* sin_t, void* y, long long rows,
                                  int c, int lanes, int vecs, int heads, int seq, float eps,
                                  void* stream) {
  if (lanes != kRopeLanes || vecs > kRopeMaxVecs || !plan_ok(c, lanes, vecs) || rows < 0 ||
      heads <= 0 || seq <= 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(gamma) % 16 ||
      reinterpret_cast<uintptr_t>(beta) % 16 || reinterpret_cast<uintptr_t>(cos_t) % 16 ||
      reinterpret_cast<uintptr_t>(sin_t) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  rope_kernel_for(vecs)<<<static_cast<unsigned>(grid_for(rows, lanes)), kThreads, 8 * c,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(y), rows, c, heads, seq, eps);
  return static_cast<int>(cudaGetLastError());
}
