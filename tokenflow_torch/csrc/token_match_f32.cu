// The token-match core in fp32 for Hopper (sm_90a): K2's and K3's fp32
// instantiation (the bf16 one is token_match_core.cuh). Both wrappers
// launch it, K2 (kernels/token_match.py) with the two rows of its (2, F, S)
// index buffer, K3 (kernels/token_match_split.py) with its (F, 1, S) ia
// and ib, so the two agree bit for bit.
//
// Replaces the Pallas TPU kernels tokenflow_tpu/kernels/token_match.py:105
// (token_match_gather_pallas) and token_match_split.py:123
// (token_match_gather_split) on fp32 tables. For frame f and query row s,
//   ia[f,s] = first argmax_z  x[f,s] . p_hat[pa[f], z]
//   ib[f,s] = first argmax_z  x[f,s] . p_hat[pb[f], z]
//   out[c,f,s] = w1[f] * kf[c,pa[f],ia[f,s]] + (1 - w1[f]) * kf[c,pb[f],ib[f,s]]
// without building the (F, S, S) similarities.
//
// Design (a simple kernel on the CUDA cores, plain fp32 FFMA):
//   - one block of 256 threads per (64 query rows, frame). The threads form
//     a 16 x 16 grid: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and, in
//     every 64-token z tile, the pivot tokens z0 + tx + 16 j (j < 4);
//   - pivot a's tokens stream through shared memory in z tiles of 64, then
//     pivot b's. A similarity tile is summed over D in chunks of 64 dims:
//     the chunk of the query rows and of the z tile are loaded (16-byte
//     loads, rows padded to 68 floats so the 16 token rows a half-warp
//     reads fall on distinct banks) and multiplied as 4 x 4 register
//     micro-tiles, every sum in ascending dim order;
//   - the first argmax: each thread keeps a running (max, index) per row
//     over its own tokens, which it visits in ascending index order (j
//     within a tile, then the next tile), with a strict '>' (tokens >= S,
//     zero-filled, are skipped). After the last tile the row's 16 owners
//     merge through shuffles: the larger value wins, on equal values the
//     smaller index. So the result is jnp.argmax's first maximum, and K3's
//     `better = blk_max > m` rule across tiles;
//   - the gather + blend is the epilogue: the block's indices go through
//     shared memory, then every thread reads matched kf rows of every
//     stream as 16-byte loads, blends in fp32 with the roundings of the
//     plain version (no contraction into an fma) and stores the rows. With
//     out null the kernel writes the indices only (the match timed alone).
// Shared memory: two 64 x 68 float tiles and the indices, 35.3 KB (static).
// Bound: 4 S^2 D flops per frame at the H100's 67 TFLOP/s of fp32 on the
// CUDA cores (the tables are read once from HBM at 4 S D bytes per frame
// and pivot; the gather moves 3 ns S D * 4 bytes per frame). The query
// chunk is reloaded from L2 for every z tile and every 16 FFMAs cost two
// 16-byte shared loads; making it fast is later work.
#include "common.cuh"

namespace {

constexpr int kMRows = 64;      // query rows per block
constexpr int kMTokens = 64;    // pivot tokens per z tile
constexpr int kMChunk = 64;     // dims per chunk
constexpr int kMLd = kMChunk + 4;  // padded row stride (floats)
constexpr int kMThreads = 256;  // 16 x 16

// dims d0 .. d0 + 63 of rows row0 .. row0 + 63 of an (S, D) slice into
// dst; rows >= s_len and dims >= d are zeros (d % 4 == 0)
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ src,
                                           int row0, int s_len, int d, int d0) {
  constexpr int kChunks = kMChunk / 4;
  for (int i = threadIdx.x; i < kMRows * kChunks; i += kMThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s_len && d0 + c < d)
      v = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * d + d0 + c);
    *reinterpret_cast<float4*>(dst + r * kMLd + c) = v;
  }
}

// x (F, S, D), phat (K, S, D), kf (ns, K, S, D), out (ns, F, S, D): fp32,
// contiguous, 16-byte aligned. Writes out_a[f * s_len + s], out_b[...] and,
// unless out is null, out.
__global__ void __launch_bounds__(kMThreads)
match_f32(const float* __restrict__ x, const float* __restrict__ phat,
          const float* __restrict__ kf, const int* __restrict__ pa,
          const int* __restrict__ pb, const float* __restrict__ w1,
          int* __restrict__ out_a, int* __restrict__ out_b, float* __restrict__ out,
          int ns, int n_piv, int s_len, int d) {
  __shared__ __align__(16) float xs[kMRows * kMLd];
  __shared__ __align__(16) float zs[kMTokens * kMLd];
  __shared__ int slot[2][kMRows];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kMRows, f = blockIdx.y, f_total = gridDim.y;
  const long long plane = (long long)s_len * d;
  const float* xf = x + f * plane;
  const int piv_a = pa[f], piv_b = pb[f];

  for (int p = 0; p < 2; ++p) {
    const float* zp = phat + (p == 0 ? piv_a : piv_b) * plane;
    float best[4];
    int idx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = tf::neg_inf();
      idx[i] = 0;
    }
    for (int z0 = 0; z0 < s_len; z0 += kMTokens) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d0 = 0; d0 < d; d0 += kMChunk) {
        __syncthreads();  // the previous chunk is read
        load_chunk(xs, xf, q0, s_len, d, d0);
        load_chunk(zs, zp, z0, s_len, d, d0);
        __syncthreads();
#pragma unroll 4
        for (int e = 0; e < kMChunk; e += 4) {
          float4 a[4], bz[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(xs + (4 * ty + i) * kMLd + e);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bz[j] = *reinterpret_cast<const float4*>(zs + (tx + 16 * j) * kMLd + e);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(a[i].x, bz[j].x, s[i][j]);
              s[i][j] = fmaf(a[i].y, bz[j].y, s[i][j]);
              s[i][j] = fmaf(a[i].z, bz[j].z, s[i][j]);
              s[i][j] = fmaf(a[i].w, bz[j].w, s[i][j]);
            }
        }
      }
      // this thread's tokens in ascending order, strict '>': the first max
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int z = z0 + tx + 16 * j;
        if (z >= s_len) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (s[i][j] > best[i]) {
            best[i] = s[i][j];
            idx[i] = z;
          }
      }
    }
    // the row's 16 owners: larger value, on equal values the smaller index
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx[i], off);
        if (ov > best[i] || (ov == best[i] && oi < idx[i])) {
          best[i] = ov;
          idx[i] = oi;
        }
      }
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) slot[p][4 * ty + i] = idx[i];
  }
  __syncthreads();

  const int n_rows = min(kMRows, s_len - q0);
  for (int r = threadIdx.x; r < n_rows; r += kMThreads) {
    out_a[(long long)f * s_len + q0 + r] = slot[0][r];
    out_b[(long long)f * s_len + q0 + r] = slot[1][r];
  }
  if (out == nullptr) return;
  const int chunks = d / 4, per_row = ns * chunks;
  const float* kfa = kf + piv_a * plane;
  const float* kfb = kf + piv_b * plane;
  float* of = out + ((long long)f * s_len + q0) * d;
  const float w = w1[f];
  const float wb = __fsub_rn(1.f, w);
  for (int it = threadIdx.x; it < n_rows * per_row; it += kMThreads) {
    const int r = it / per_row, rem = it - r * per_row;
    const int c = rem / chunks, e4 = (rem - c * chunks) * 4;
    const long long cs = c * n_piv * plane;
    const float4 va =
        *reinterpret_cast<const float4*>(kfa + cs + (long long)slot[0][r] * d + e4);
    const float4 vb =
        *reinterpret_cast<const float4*>(kfb + cs + (long long)slot[1][r] * d + e4);
    // no contraction into an fma: the same roundings as the plain version
    float4 res;
    res.x = __fadd_rn(__fmul_rn(w, va.x), __fmul_rn(wb, vb.x));
    res.y = __fadd_rn(__fmul_rn(w, va.y), __fmul_rn(wb, vb.y));
    res.z = __fadd_rn(__fmul_rn(w, va.z), __fmul_rn(wb, vb.z));
    res.w = __fadd_rn(__fmul_rn(w, va.w), __fmul_rn(wb, vb.w));
    *reinterpret_cast<float4*>(of + c * f_total * plane + (long long)r * d + e4) = res;
  }
}

}  // namespace

// K2 and K3 in fp32: indices into out_a and out_b, (F, S) int32 each, and,
// unless out is null, the blended rows into out (ns, F, S, D). n_piv is the
// pivot count K of p_hat (K, S, D) and kf (ns, K, S, D). Returns 0 or the
// cudaError_t of the launch.
extern "C" int tf_token_match_f32(const void* x, const void* phat, const void* kf,
                                  const int* pa, const int* pb, const float* w1,
                                  int* out_a, int* out_b, void* out, int ns, int f_total,
                                  int n_piv, int s_len, int d, void* stream) {
  const dim3 grid((s_len + kMRows - 1) / kMRows, f_total);
  match_f32<<<grid, kMThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(phat),
      static_cast<const float*>(kf), pa, pb, w1, out_a, out_b, static_cast<float*>(out),
      ns, n_piv, s_len, d);
  return static_cast<int>(cudaGetLastError());
}
