// Split token match + gather (K3) for Hopper (sm_90a), bf16 tables, fp32
// math: the large-S sites of the propagation (768p top level, S = 9216,
// D = 320).
//
// Replaces the Pallas TPU kernel tokenflow_tpu/kernels/token_match_split.py
// (token_match_gather_split: _match_kernel, then _gather_kernel). Same
// contract as K2 (token_match.cu), in two stages whose interface is the
// TPU kernel's: int32 indices ia, ib shaped (F, 1, S), one per pivot. This
// file holds the match stage; the gather stage is K2's (tf_token_gather),
// which reads ia and ib as the two rows of one (2, F, S) index buffer.
//   ia[f,s] = first argmax_z  x[f,s] . p_hat[pa[f], z]   (ib: pivot pb[f])
//   out[c,f,s] = w1[f] * kf[c,pa[f],ia[f,s]] + (1 - w1[f]) * kf[c,pb[f],ib[f,s]]
//
// Match stage: one block of 4 warps per (64-query tile, frame). The query
// tile is loaded into shared memory once and BOTH pivots' tokens stream
// through the same z loop, each z step updating both running first maxima,
// as the TPU kernel updates both per z block (token_match_split.py:79-80);
// K2 instead launches one block per pivot and loads the query tile twice.
// Within a z step the two pivots take turns through one pivot tile and one
// accumulator (a lambda called once per pivot, so no running maximum is
// indexed by a loop variable and spilled), which keeps K2's shared memory
// and about its registers; holding both pivots' tiles and accumulators
// live instead cost occupancy and ran slower per frame than K2.
// Similarities come from mma.sync m16n8k16 bf16 with fp32 accumulation;
// ties keep the first maximum (strict '>' across tiles, the lower index
// inside a tile and across a quad), the helpers K2 uses (common.cuh).
// Bound: the match stage does 2 * 2 * S * S * D flops per frame (compute
// bound, limited by mma.sync issue rate and the unpipelined tile loads;
// cp.async/TMA staging of the pivot stream is later work).
#include "common.cuh"

namespace {

using tf::kMatchBD;
using tf::kMatchBQ;
using tf::kMatchBZ;
using tf::kMatchLdp;
using tf::kMatchThreads;

__global__ void __launch_bounds__(kMatchThreads)
split_match_kernel(const __nv_bfloat16* __restrict__ x,     // (F, S, D)
                   const __nv_bfloat16* __restrict__ phat,  // (K, S, D)
                   const int* __restrict__ pa, const int* __restrict__ pb,
                   int* __restrict__ ia,  // (F, 1, S)
                   int* __restrict__ ib,  // (F, 1, S)
                   int s_len, int d, int d_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = d_pad + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][ldx]
  __nv_bfloat16* ps = xs + kMatchBQ * ldx;                       // [BZ][Ldp]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMatchBQ;
  const int f = blockIdx.y;
  const __nv_bfloat16* ppa = phat + (long long)pa[f] * s_len * d;
  const __nv_bfloat16* ppb = phat + (long long)pb[f] * s_len * d;

  tf::load_query_tile(xs, ldx, x + (long long)f * s_len * d, q0, s_len, d,
                      d_pad);

  const int row0 = warp * 16 + g;  // this thread's two rows in the tile
  // running first maxima of rows row0 and row0 + 8 against pivots a and b
  float besta0 = tf::neg_inf(), besta1 = tf::neg_inf();
  float bestb0 = tf::neg_inf(), bestb1 = tf::neg_inf();
  int ia0 = 0, ia1 = 0, ib0 = 0, ib1 = 0;

  // one pivot's tiles z0 .. z0 + 63 folded into its running first maxima
  auto z_step = [&](const __nv_bfloat16* pp, int z0, float& best0, int& bidx0,
                    float& best1, int& bidx1) {
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
  };
  for (int z0 = 0; z0 < s_len; z0 += kMatchBZ) {
    z_step(ppa, z0, besta0, ia0, besta1, ia1);
    z_step(ppb, z0, bestb0, ib0, bestb1, ib1);
  }

  if (t == 0) {
    const long long base = (long long)f * s_len;
    const int r0 = q0 + row0, r1 = r0 + 8;
    if (r0 < s_len) { ia[base + r0] = ia0; ib[base + r0] = ib0; }
    if (r1 < s_len) { ia[base + r1] = ia1; ib[base + r1] = ib1; }
  }
}

}  // namespace

// Match stage. Needs (64 * (d_pad + 8) + 64 * 72) * 2 bytes of dynamic
// shared memory; returns the cudaError_t of the launch (0 = success).
extern "C" int tf_token_match_split(const void* x, const void* phat,
                                    const int* pa, const int* pb, int* ia,
                                    int* ib, int f_total, int s_len, int d,
                                    void* stream) {
  const int d_pad = (d + kMatchBD - 1) / kMatchBD * kMatchBD;
  const size_t smem = (size_t)(kMatchBQ * (d_pad + 8) + kMatchBZ * kMatchLdp) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      split_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + kMatchBQ - 1) / kMatchBQ, f_total);
  split_match_kernel<<<grid, kMatchThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(phat), pa, pb, ia, ib, s_len, d, d_pad);
  return static_cast<int>(cudaGetLastError());
}
