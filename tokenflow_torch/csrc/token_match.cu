// Token match + gather for Hopper (sm_90a), bf16 tables, fp32 math.
//
// Replaces the Pallas TPU kernel tokenflow_tpu/kernels/token_match.py
// (token_match_gather_pallas / _kernel); the large-S sites go to K3
// (token_match_split.cu), chosen as in the JAX package. For each frame f:
//   i1[s] = first argmax_z  x[f,s] . p_hat[pa[f], z]
//   i2[s] = first argmax_z  x[f,s] . p_hat[pb[f], z]
//   out[c,f,s] = w1[f] * kf[c,pa[f],i1[s]] + (1 - w1[f]) * kf[c,pb[f],i2[s]]
// without building the (F, S, S) similarity tensor.
//
// Stage 1 (match): one block of 4 warps per (64-query tile, frame, pivot).
// The block's 64 x D query rows sit in shared memory for the whole run; the
// pivot's tokens stream through shared memory in 64-token x 64-dim tiles and
// the similarities come from mma.sync m16n8k16 bf16 with fp32 accumulation.
// Each query row keeps a running (max, index) in registers; a tile replaces
// it only on a strict '>', and inside a tile an equal value resolves to the
// lower index, so the result is jnp.argmax's first maximum. Indices go to a
// (2, F, S) int32 scratch.
// Stage 2 (gather + blend): one thread per 8-element chunk of an output
// row: two indexed 16-byte loads from the keyframe table, the blend in fp32
// as the Pallas kernel does (token_match.py:82), a 16-byte bf16 store. The
// TPU kernel's one-hot matmul gather is not carried over.
// Bound: stage 1 does 2 * 2 * S * S * D flops per frame against ~2 S D
// bytes of table reads per query tile (compute bound, mma.sync issue rate
// limits this first version); stage 2 moves 2 * ns * S * D * 2 bytes per
// frame and is bound by memory bandwidth.
#include "common.cuh"

namespace {

using tf::kMatchBD;
using tf::kMatchBQ;
using tf::kMatchBZ;
using tf::kMatchLdp;
using tf::kMatchThreads;

__global__ void __launch_bounds__(kMatchThreads)
match_kernel(const __nv_bfloat16* __restrict__ x,     // (F, S, D)
             const __nv_bfloat16* __restrict__ phat,  // (K, S, D)
             const int* __restrict__ pa, const int* __restrict__ pb,
             int* __restrict__ idx,  // (2, F, S)
             int f_total, int s_len, int d, int d_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = d_pad + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][ldx]
  __nv_bfloat16* ps = xs + kMatchBQ * ldx;                        // [BZ][Ldp]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMatchBQ;
  const int f = blockIdx.y;
  const int which = blockIdx.z;  // 0: pivot pa[f], 1: pivot pb[f]
  const int piv = which == 0 ? pa[f] : pb[f];
  const __nv_bfloat16* pp = phat + (long long)piv * s_len * d;

  tf::load_query_tile(xs, ldx, x + (long long)f * s_len * d, q0, s_len, d,
                      d_pad);

  const int row0 = warp * 16 + g;  // this thread's two rows in the tile
  float best0 = tf::neg_inf(), best1 = tf::neg_inf();
  int bidx0 = 0, bidx1 = 0;

  for (int z0 = 0; z0 < s_len; z0 += kMatchBZ) {
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int d0 = 0; d0 < d_pad; d0 += kMatchBD) {
      __syncthreads();  // previous pivot tile consumed (and xs written)
      tf::load_pivot_tile(ps, pp, z0, d0, s_len, d);
      __syncthreads();
      tf::match_tile_mma(s, xs, ldx, ps, row0, d0, g, t);
    }
    tf::first_max_update(s, z0, s_len, t, best0, bidx0, best1, bidx1);
  }

  if (t == 0) {
    int* out = idx + ((long long)which * f_total + f) * s_len;
    const int r0 = q0 + row0, r1 = r0 + 8;
    if (r0 < s_len) out[r0] = bidx0;
    if (r1 < s_len) out[r1] = bidx1;
  }
}

__global__ void gather_blend_kernel(
    const __nv_bfloat16* __restrict__ kf,  // (ns, K, S, D)
    const int* __restrict__ idx,           // (2, F, S)
    const int* __restrict__ pa, const int* __restrict__ pb,
    const float* __restrict__ w1,
    __nv_bfloat16* __restrict__ out,  // (ns, F, S, D)
    int ns, int n_piv, int f_total, int s_len, int d) {
  const int chunks = d / 8;
  const long long total = (long long)ns * f_total * s_len * chunks;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c8 = static_cast<int>(i % chunks);
    long long rest = i / chunks;
    const int s = static_cast<int>(rest % s_len);
    rest /= s_len;
    const int f = static_cast<int>(rest % f_total);
    const int c = static_cast<int>(rest / f_total);
    const int i1 = idx[(long long)f * s_len + s];
    const int i2 = idx[((long long)f_total + f) * s_len + s];
    const uint4 va = *reinterpret_cast<const uint4*>(
        kf + (((long long)c * n_piv + pa[f]) * s_len + i1) * d + c8 * 8);
    const uint4 vb = *reinterpret_cast<const uint4*>(
        kf + (((long long)c * n_piv + pb[f]) * s_len + i2) * d + c8 * 8);
    const float w = w1[f];
    const float wb = __fsub_rn(1.f, w);
    const __nv_bfloat16* ea = reinterpret_cast<const __nv_bfloat16*>(&va);
    const __nv_bfloat16* eb = reinterpret_cast<const __nv_bfloat16*>(&vb);
    uint4 res;
    uint32_t* rw = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // no contraction into an fma: the same roundings as the plain version
      const float lo = __fadd_rn(__fmul_rn(w, __bfloat162float(ea[2 * j])),
                                 __fmul_rn(wb, __bfloat162float(eb[2 * j])));
      const float hi =
          __fadd_rn(__fmul_rn(w, __bfloat162float(ea[2 * j + 1])),
                    __fmul_rn(wb, __bfloat162float(eb[2 * j + 1])));
      rw[j] = tf::pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(out + i * 8) = res;
  }
}

}  // namespace

// Match stage. Needs (64 * (d_pad + 8) + 64 * 72) * 2 bytes of dynamic
// shared memory; returns the cudaError_t of the launch (0 = success).
extern "C" int tf_token_match(const void* x, const void* phat, const int* pa,
                              const int* pb, int* idx, int f_total, int s_len,
                              int d, void* stream) {
  const int d_pad = (d + kMatchBD - 1) / kMatchBD * kMatchBD;
  const size_t smem = (size_t)(kMatchBQ * (d_pad + 8) + kMatchBZ * kMatchLdp) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + kMatchBQ - 1) / kMatchBQ, f_total, 2);
  match_kernel<<<grid, kMatchThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(phat), pa, pb, idx, f_total, s_len, d,
      d_pad);
  return static_cast<int>(cudaGetLastError());
}

// Gather + blend stage; returns the cudaError_t of the launch.
extern "C" int tf_token_gather(const void* kf, const int* idx, const int* pa,
                               const int* pb, const float* w1, void* out,
                               int ns, int n_piv, int f_total, int s_len,
                               int d, void* stream) {
  const long long total = (long long)ns * f_total * s_len * (d / 8);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  gather_blend_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(kf), idx, pa, pb, w1,
      static_cast<__nv_bfloat16*>(out), ns, n_piv, f_total, s_len, d);
  return static_cast<int>(cudaGetLastError());
}
