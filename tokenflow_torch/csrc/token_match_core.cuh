// The token-match core for Hopper (sm_90a): K2 (token_match.cu) and K3
// (token_match_split.cu) launch it. For frame f and query row s it
// computes, in fp32 from bf16 tables,
//   ia[f,s] = first argmax_z  x[f,s] . p_hat[pa[f], z]
//   ib[f,s] = first argmax_z  x[f,s] . p_hat[pb[f], z]
//   out[c,f,s] = w1[f] * kf[c,pa[f],ia[f,s]] + (1 - w1[f]) * kf[c,pb[f],ib[f,s]]
// without building the (F, S, S) similarities, and writes ia, ib and out.
//
// Design (a GEMM whose epilogue is a running first argmax):
//   - one block per (query tile, frame): a producer warpgroup and C consumer
//     warpgroups, each consumer owning 64 query rows. The producer gives
//     its registers to the consumers (setmaxnreg).
//   - the query tile (64 C rows x D) stays resident in shared memory, loaded
//     once by TMA as D / 64 boxes of (64 C rows x 64 dims);
//   - both pivots stream through the same block: the pivot tokens come as
//     (128 tokens x 64 dims) boxes, 16 KB each, through a ring of TMA
//     stages, in the order z tile j: pivot a's D / 64 boxes, then pivot b's.
//     One producer thread keeps the ring full; a "full" mbarrier per stage
//     (TMA transaction count) and an "empty" one that every consumer warp
//     arrives on pace it, as in K1. Every box uses the 128-byte swizzle (a
//     64-dim bf16 row is 128 bytes);
//   - a consumer runs wgmma m64n128k16, both operands from shared memory
//     and K-major (the query chunk as A, the pivot box as B), fp32
//     accumulate: four products per box, one commit group per box. Pivot a
//     accumulates in acc_a and pivot b in acc_b, so the fold of one z tile's
//     similarities runs while the next tile's products are on the tensor
//     cores: the consumer issues a box, waits until only that box is
//     pending, frees the stage of the box before it, and after the first box
//     of a tile folds the other accumulator;
//   - the first-max fold reads the wgmma accumulator layout (the thread
//     holds rows g and g + 8 of its warp's 16; acc[4n + e] and acc[4n + 2 +
//     e] at column 8n + 2t + e): an ascending scan with '>' inside the
//     thread, the lower index on ties across the quad, a strict '>' against
//     the earlier z tiles, so the result is jnp.argmax's first maximum.
//     Columns at or past s_len (TMA's zero-filled tail rows) are masked out,
//     never compared as zero similarities;
//   - the gather + blend is the epilogue: each warp stores its 16 rows'
//     indices, then reads the matched kf rows of every stream as 16-byte
//     loads (lanes along D), blends in fp32 as the Pallas kernel does
//     (token_match.py:82) and stores the bf16 rows. Fused, it costs the
//     tensor cores only the block's last stretch, where a separate gather
//     launch cost a pass over the indices and a launch of its own. With out
//     null the core writes the indices only (the match timed alone).
// Query rows per block: the resident tile costs 128 C D bytes, so C falls
// with D to fit the 227 KB of shared memory beside the ring: C = 3 (192
// rows, 6 stages) for D <= 320, C = 2 (128 rows, 4 stages) for D <= 640,
// C = 1 (64 rows, 4 stages) for D <= 1280, and C = 1 with 3 stages for
// 1280 < D <= 1408 (HunyuanDiT's 1408: a 180,224-byte query tile, 229,376
// bytes with three 16 KB stages, where four do not fit). More rows per
// block means fewer pivot bytes read from L2 per product: each pivot box
// serves 64 C rows.
// Bound: 4 S^2 D flops per frame at the bf16 tensor-core rate (the tables
// are read once from HBM at 2 S D bytes per frame and pivot, thousands of
// flops per byte; the gather moves 3 ns S D bytes per frame, a few percent
// of that time); the design keeps the tensor cores fed by TMA and takes
// the fold off their critical path.
#pragma once

#include "common.cuh"

namespace {

constexpr int kCoreBZ = 128;  // pivot tokens per box (the wgmma N)
constexpr int kCoreChunk = 64;  // dims per box: one 128-byte swizzle row
constexpr uint32_t kCoreBoxBytes = kCoreBZ * tf::kSwizzleRowBytes;  // 16 KB
constexpr int kCoreMaxD = 1408;
constexpr int kCoreFourStageMaxD = 1280;  // the widest D beside a 4-stage ring
constexpr int kCoreWideStages = 3;  // the ring of 1280 < D <= kCoreMaxD
constexpr int kCoreProducerRegs = 24;

template <int C>
struct CoreShape;
template <>
struct CoreShape<3> {
  static constexpr int kStages = 6, kRegs = 160;
};
template <>
struct CoreShape<2> {
  static constexpr int kStages = 4, kRegs = 240;
};
template <>
struct CoreShape<1> {
  static constexpr int kStages = 4, kRegs = 240;
};

// consumer warpgroups for a head width of d (d <= kCoreMaxD)
inline int core_consumers(int d) { return d <= 320 ? 3 : d <= 640 ? 2 : 1; }

// query-tile bytes, the ring, the barriers (bar_q, full[], empty[]) and the
// slack that aligns the base to 1024 bytes
template <int C, int kStages>
constexpr uint32_t core_smem_bytes(int nd) {
  return nd * 64 * C * tf::kSwizzleRowBytes + kStages * kCoreBoxBytes + 8 * (1 + 2 * kStages) +
         1024;
}
static_assert(core_smem_bytes<1, 4>(kCoreFourStageMaxD / 64) <= 232448, "C = 1, 4 stages");
static_assert(core_smem_bytes<1, kCoreWideStages>(kCoreMaxD / 64) <= 232448,
              "C = 1, 3 stages");

// One z tile of similarities (columns z0 .. z0 + 127 of this thread's rows
// g and g + 8) folded into their running first maxima. kMasked: columns
// 8n + e >= lim (that is z >= s_len, lim = s_len - z0 - 2t) are skipped.
template <bool kMasked>
__device__ __forceinline__ void fold_tile(const float (&acc)[64], int z0, int lim,
                                          int t, float& best0, int& idx0,
                                          float& best1, int& idx1) {
  float v0 = tf::neg_inf(), v1 = tf::neg_inf();
  int j0 = -1, j1 = -1;
#pragma unroll
  for (int n = 0; n < kCoreBZ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kMasked && 8 * n + e >= lim) continue;
      if (acc[4 * n + e] > v0) { v0 = acc[4 * n + e]; j0 = 8 * n + e; }
      if (acc[4 * n + 2 + e] > v1) { v1 = acc[4 * n + 2 + e]; j1 = 8 * n + e; }
    }
  int i0 = j0 < 0 ? 0x7fffffff : z0 + 2 * t + j0;
  int i1 = j1 < 0 ? 0x7fffffff : z0 + 2 * t + j1;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ov0 = __shfl_xor_sync(0xffffffffu, v0, off);
    const int oi0 = __shfl_xor_sync(0xffffffffu, i0, off);
    const float ov1 = __shfl_xor_sync(0xffffffffu, v1, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
    if (ov0 > v0 || (ov0 == v0 && oi0 < i0)) { v0 = ov0; i0 = oi0; }
    if (ov1 > v1 || (ov1 == v1 && oi1 < i1)) { v1 = ov1; i1 = oi1; }
  }
  if (v0 > best0) { best0 = v0; idx0 = i0; }
  if (v1 > best1) { best1 = v1; idx1 = i1; }
}

__device__ __forceinline__ void fold(const float (&acc)[64], int z0, int s_len, int t,
                                     float& best0, int& idx0, float& best1,
                                     int& idx1) {
  if (z0 + kCoreBZ <= s_len)
    fold_tile<false>(acc, z0, 0, t, best0, idx0, best1, idx1);
  else
    fold_tile<true>(acc, z0, s_len - z0 - 2 * t, t, best0, idx0, best1, idx1);
}

// The epilogue of one warp: rows row0 .. row0 + n_rows - 1 of frame f,
// whose matched tokens sit in slot[2 r] (pivot a) and slot[2 r + 1] (pivot
// b); every stream's D elements, 8 per lane and step.
__device__ __forceinline__ void gather_rows(
    const int* slot, int row0, int n_rows, int lane, int f, int f_total,
    int s_len, int d, int ns, int n_piv, int piv_a, int piv_b,
    const __nv_bfloat16* __restrict__ kf, const float* __restrict__ w1,
    __nv_bfloat16* __restrict__ out) {
  const int chunks = d / 8, per_row = ns * chunks;
  const long long plane = (long long)s_len * d;
  const __nv_bfloat16* kfa = kf + piv_a * plane;
  const __nv_bfloat16* kfb = kf + piv_b * plane;
  __nv_bfloat16* of = out + ((long long)f * s_len + row0) * d;
  const float w = w1[f];
  const float wb = __fsub_rn(1.f, w);
#pragma unroll 8
  for (int it = lane; it < n_rows * per_row; it += 32) {
    const int r = it / per_row, rem = it - r * per_row;
    const int c = rem / chunks, e8 = (rem - c * chunks) * 8;
    const long long cs = c * n_piv * plane;
    const uint4 va = *reinterpret_cast<const uint4*>(kfa + cs + slot[2 * r] * d + e8);
    const uint4 vb = *reinterpret_cast<const uint4*>(kfb + cs + slot[2 * r + 1] * d + e8);
    const __nv_bfloat16* ea = reinterpret_cast<const __nv_bfloat16*>(&va);
    const __nv_bfloat16* eb = reinterpret_cast<const __nv_bfloat16*>(&vb);
    uint4 res;
    uint32_t* rw = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // no contraction into an fma: the same roundings as the plain version
      const float lo = __fadd_rn(__fmul_rn(w, __bfloat162float(ea[2 * j])),
                                 __fmul_rn(wb, __bfloat162float(eb[2 * j])));
      const float hi = __fadd_rn(__fmul_rn(w, __bfloat162float(ea[2 * j + 1])),
                                 __fmul_rn(wb, __bfloat162float(eb[2 * j + 1])));
      rw[j] = tf::pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(of + c * f_total * plane + r * d + e8) = res;
  }
}

// tx: 4-D map of x (F, S, D) as (D, S, 1, F), boxes of 64 C rows;
// tp: of p_hat (K, S, D) as (D, S, 1, K), boxes of kCoreBZ tokens.
// Writes out_a[f * s_len + s], out_b[f * s_len + s] and, unless out is
// null, out (ns, F, S, D) from kf (ns, K, S, D).
template <int C, int kStages>
__global__ void __launch_bounds__(128 * (1 + C), 1)
match_core(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tp, const int* __restrict__ pa,
           const int* __restrict__ pb, int* __restrict__ out_a,
           int* __restrict__ out_b, const __nv_bfloat16* __restrict__ kf,
           const float* __restrict__ w1, __nv_bfloat16* __restrict__ out, int ns,
           int n_piv, int s_len, int d, int nd) {
  constexpr uint32_t kQChunkBytes = 64 * C * tf::kSwizzleRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tf::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + nd * kQChunkBytes;
  const uint32_t bar_q = ring + kStages * kCoreBoxBytes;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  const int q0 = blockIdx.x * 64 * C, f = blockIdx.y;
  const int nz = (s_len + kCoreBZ - 1) / kCoreBZ;

  if (threadIdx.x == 0) {
    tf::mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      tf::mbar_init(full(s), 1);
      tf::mbar_init(empty(s), 4 * C);
    }
    tf::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    tf::setmaxnreg_dec<kCoreProducerRegs>();
    if (threadIdx.x == 0) {
      tf::mbar_expect_tx(bar_q, nd * kQChunkBytes);
      for (int c = 0; c < nd; ++c)
        tf::tma_load_4d(base + c * kQChunkBytes, &tx, bar_q, c * kCoreChunk, q0, 0, f);
      const int piv_a = pa[f], piv_b = pb[f];
      int i = 0;
      for (int j = 0; j < nz; ++j)
        for (int p = 0; p < 2; ++p)
          for (int c = 0; c < nd; ++c, ++i) {
            const int s = i % kStages;
            tf::mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
            tf::mbar_expect_tx(full(s), kCoreBoxBytes);
            tf::tma_load_4d(ring + s * kCoreBoxBytes, &tp, full(s), c * kCoreChunk,
                            j * kCoreBZ, 0, p == 0 ? piv_a : piv_b);
          }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    tf::setmaxnreg_inc<CoreShape<C>::kRegs>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_s = base + wg * 64 * tf::kSwizzleRowBytes;

    float acc_a[64], acc_b[64];
    // running first maxima of rows g, g + 8 against pivots a and b
    float best_a0 = tf::neg_inf(), best_a1 = tf::neg_inf();
    float best_b0 = tf::neg_inf(), best_b1 = tf::neg_inf();
    int ia0 = 0, ia1 = 0, ib0 = 0, ib1 = 0;

    int stage = 0, prev = -1;  // ring stage of the next box and of the last
    uint32_t phase = 0;
    // box c of the current z tile into acc (one commit group), then wait
    // until it is the only group pending and free the previous box's stage
    auto issue = [&](float (&acc)[64], int c) {
      tf::mbar_wait(full(stage), phase);
      const uint32_t ps = ring + stage * kCoreBoxBytes;
      const uint32_t qs = q_s + c * kQChunkBytes;
      tf::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCoreChunk / 16; ++kk)
        tf::wgmma_m64n128k16_ss(acc, tf::kmajor_desc(qs + kk * 32),
                                tf::kmajor_desc(ps + kk * 32), c | kk);
      tf::wgmma_commit();
      tf::wgmma_wait<1>();
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) tf::mbar_arrive(empty(prev));
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };

    tf::mbar_wait(bar_q, 0);
    for (int j = 0; j < nz; ++j) {
      issue(acc_a, 0);
      if (j > 0) {  // pivot b's tile j - 1 is complete
        tf::fence_regs(acc_b);
        fold(acc_b, (j - 1) * kCoreBZ, s_len, t, best_b0, ib0, best_b1, ib1);
      }
      for (int c = 1; c < nd; ++c) issue(acc_a, c);
      issue(acc_b, 0);
      tf::fence_regs(acc_a);  // pivot a's tile j is complete
      fold(acc_a, j * kCoreBZ, s_len, t, best_a0, ia0, best_a1, ia1);
      for (int c = 1; c < nd; ++c) issue(acc_b, c);
    }
    tf::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) tf::mbar_arrive(empty(prev));
    tf::fence_regs(acc_b);
    fold(acc_b, (nz - 1) * kCoreBZ, s_len, t, best_b0, ib0, best_b1, ib1);

    const int row0 = q0 + wg * 64 + warp * 16;  // this warp's 16 rows
    if (t == 0) {
      const long long o = (long long)f * s_len;
      const int r0 = row0 + g, r1 = r0 + 8;
      if (r0 < s_len) { out_a[o + r0] = ia0; out_b[o + r0] = ib0; }
      if (r1 < s_len) { out_a[o + r1] = ia1; out_b[o + r1] = ib1; }
    }
    if (out != nullptr) {
      // the warp's indices go to the start of this consumer's query rows,
      // which no product reads any more (wgmma_wait<0> above)
      int* slot = reinterpret_cast<int*>(smem_raw + (q_s - tf::smem_u32(smem_raw))) +
                  warp * 32;
      if (t == 0) {
        slot[2 * g] = ia0;
        slot[2 * g + 1] = ib0;
        slot[2 * g + 16] = ia1;
        slot[2 * g + 17] = ib1;
      }
      __syncwarp();
      gather_rows(slot, row0, min(16, s_len - row0), lane, f, gridDim.y, s_len, d, ns,
                  n_piv, pa[f], pb[f], kf, w1, out);
    }
  }
}

template <int C, int kStages = CoreShape<C>::kStages>
int launch_core(tf::EncodeTiledFn encode, const void* x, const void* phat,
                const int* pa, const int* pb, int* out_a, int* out_b, const void* kf,
                const float* w1, void* out, int ns, int f_total, int n_piv, int s_len,
                int d, cudaStream_t stream) {
  const long long plane = (long long)s_len * d;
  CUtensorMap tx, tp;
  int rc = tf::make_map(&tx, encode, x, d, s_len, 1, f_total, plane, d, plane, 64 * C);
  if (rc == 0)
    rc = tf::make_map(&tp, encode, phat, d, s_len, 1, n_piv, plane, d, plane, kCoreBZ);
  if (rc != 0) return rc;
  const int nd = (d + kCoreChunk - 1) / kCoreChunk;
  const uint32_t smem = core_smem_bytes<C, kStages>(nd);
  const cudaError_t attr = cudaFuncSetAttribute(
      match_core<C, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_len + 64 * C - 1) / (64 * C), f_total);
  match_core<C, kStages><<<grid, 128 * (1 + C), smem, stream>>>(
      tx, tp, pa, pb, out_a, out_b, static_cast<const __nv_bfloat16*>(kf), w1,
      static_cast<__nv_bfloat16*>(out), ns, n_piv, s_len, d, nd);
  return static_cast<int>(cudaGetLastError());
}

// K2 and K3: indices into out_a and out_b, (F, S) int32 each, and the
// blended rows into out (ns, F, S, D) bf16 unless out is null. Returns 0, a
// cudaError_t, or a negative tensor-map code (tf_error_string); a head
// width past kCoreMaxD is cudaErrorInvalidValue.
inline int launch_match_core(const void* x, const void* phat, const void* kf,
                             const int* pa, const int* pb, const float* w1,
                             int* out_a, int* out_b, void* out, int ns, int f_total,
                             int n_piv, int s_len, int d, void* stream) {
  if (d > kCoreMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const tf::EncodeTiledFn encode = tf::encode_tiled();
  if (encode == nullptr) return tf::kErrNoEncoder;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (core_consumers(d)) {
    case 3:
      return launch_core<3>(encode, x, phat, pa, pb, out_a, out_b, kf, w1, out, ns,
                            f_total, n_piv, s_len, d, st);
    case 2:
      return launch_core<2>(encode, x, phat, pa, pb, out_a, out_b, kf, w1, out, ns,
                            f_total, n_piv, s_len, d, st);
    default:
      if (d > kCoreFourStageMaxD)
        return launch_core<1, kCoreWideStages>(encode, x, phat, pa, pb, out_a, out_b, kf, w1,
                                               out, ns, f_total, n_piv, s_len, d, st);
      return launch_core<1>(encode, x, phat, pa, pb, out_a, out_b, kf, w1, out, ns,
                            f_total, n_piv, s_len, d, st);
  }
}

}  // namespace
