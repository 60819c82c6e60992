// K6: short-key attention forward for Hopper (sm_90a), bf16 in/out, head
// dims 40, 64, 80, 88 and 160, for the attention calls whose keys fit the
// UNet's kv_block (1024): every cross-attention call (77 text tokens), the
// source stream's own self attention at the 32^2, 16^2 and 8^2 levels, the
// 8^2 mid block's extended attention and, on passes without an edit, the
// plain self attention at those levels.
//
// It replaces no TPU kernel: the JAX package computes these calls with
// XLA's dense einsums (tokenflow_tpu/ops/attention.py, the Skv <= kv_block
// shortcut), and so did the port (ops/attention.py::sdp_attention, fp32
// copies of q, k and v, fp32 logits and probabilities in device memory).
// K6 computes the same function with the same precision: fp32 logits and
// softmax statistics, probabilities cast to bf16 before P V, P V summed in
// fp32, bf16 output, and nothing but Q, K, V and O in device memory.
//
// What bounds it: bytes where the keys are few (cross attention, about 77
// flops a byte: read Q, write O), operations at 1024 keys. Measured on an
// H100 80GB HBM3 at 700 W, by device time: 60-62% of the bytes bound on
// the cross-attention rows at D = 64 ((B, Sq, Skv, H, D) = (120, 1024, 77,
// 20, 64) 0.334 ms, (120, 9216, 77, 5, 64) 0.691), 42-57% at D = 40, 80
// and 160, 32-54% of the bound on the streamed rows (within 11% of SDPA's
// time), an order of magnitude faster than the einsums it replaced
// (PERF.md).
//
// Design:
//   - persistent blocks: the grid is at most one block per SM, and each
//     block walks many steps (a step: 128 query rows of one (batch, head)),
//     so its set-up (barriers, tensor-map fetches) is paid once per SM. In
//     the one-tile plan block i takes the i-th contiguous share of the
//     steps, in the order all steps of a head, then the next head: a block
//     loads a head's K and V once for many steps. At D = 40, 80 and 88 a
//     head's row (80, 160 or 176 bytes) is not a whole number of 64-byte
//     bursts, and its neighbours' rows share its bursts, so there the steps
//     run the heads of one row block one after another instead (K and V loaded
//     each step, from L2): at (120, 4096, 77, 8, 40) 0.889 -> 0.446 ms, at
//     (120, 1024, 77, 8, 80) 0.247 -> 0.207, where D = 64 and 160 lost
//     1-9% to that order (H100, 700 W). In the streamed plan block i takes
//     steps i, i + grid, ...: the blocks that run at one time work on a few
//     heads, whose K and V then stay in L2 for every step that re-reads
//     them (a contiguous share had 132 heads' K and V live at once:
//     (120, 1024, 1024, 8, 80) took 2.46 ms against 0.80);
//   - a producer warpgroup and two consumer warpgroups. Warpgroup 0 is the
//     producer: one thread starts every TMA load, and the warpgroup gives
//     its registers to the consumers (setmaxnreg). Each consumer owns 64
//     rows of the step; both read the same K and V;
//   - Q steps arrive through a ring of up to four TMA stages ("full"
//     mbarrier with the transaction count, "empty" one that the consumer
//     warps arrive on once Q K^T has read the stage), so the next steps'
//     loads run under this step's products;
//   - two plans, chosen by the key length (the launcher's dispatch):
//       * one tile (Skv <= 128): the whole row is one tile of kN = 64, 80
//         or 128 keys (77 keys take 80), loaded once per head into one of
//         two K/V slots, so the next head's K and V load under this head's
//         last steps. Columns at or past Skv (zero-filled by TMA) are masked
//         to -inf; the row's max and sum are taken in registers and P is
//         normalised before the bf16 cast, sdp_attention's order;
//       * streamed (Skv > 128): 128-key tiles (64 at D = 160) stream through
//         a ring of up to four K/V stages, re-read from L2 by every step of
//         the head; the online softmax is K1's (unnormalised bf16 P, one
//         division at the end), and each consumer's softmax of tile j runs
//         while its P V of tile j - 1 is on the tensor cores;
//   - S = Q K^T and O = P V on wgmma: Q and K from shared memory (K-major),
//     S in registers, P packed to bf16 in registers as the A operand of
//     P V, V MN-major from shared memory, O exactly D columns wide (as K1;
//     the 64-column boxes along D and the zero-filled columns past D are
//     K1's, csrc/flash_attention.cu's header explains them);
//   - O leaves through a staged store: each consumer writes its 64 x D
//     tile in bf16 into its own shared-memory buffer in the 128-byte
//     swizzle (conflict-free), and one thread stores it with a TMA tile
//     store that runs while the consumer goes on to its next step. TMA
//     clips rows past Sq and columns past D.
// Plans per head dim (ShortCfg): the stages follow from the shared memory a
// plan's tiles take, within the SM's 227 KB; both plans keep 240 registers
// a consumer thread, one block per SM.
//
// Layout: tensors are (B, S, H, D) with arbitrary batch/sequence/head
// strides (in elements; positive multiples of 8) and unit stride along the
// head dim, as K1 takes them. The kernels are named short_attn_fwd, so a
// trace tells them apart from K1's flash_fwd and the match core's kernels.
#include <cuda.h>
#include <stdio.h>

#include <atomic>

#include "common.cuh"

namespace {

using namespace tf;

// dynamic shared memory of q Q stages of q_bytes, kv K/V stages of two
// kv_bytes tiles and the consumers' O buffers (o_bytes), with the barriers
// and the 1024-byte alignment slack counted generously
constexpr uint32_t smem_of(uint32_t q_bytes, uint32_t kv_bytes, uint32_t o_bytes, int q,
                           int kv) {
  return q * q_bytes + 2 * kv * kv_bytes + o_bytes + 16 * (q + 2 * kv) + 1024;
}

// the plan of head dim D over tiles of kN keys: the whole row in one tile
// (kOneTile) or the row streamed through a ring of tiles
template <int D, int kN, bool kOneTile>
struct ShortCfg {
  static constexpr int kConsumers = 2;                  // 64 query rows each
  static constexpr int kBM = 64 * kConsumers;           // query rows a step
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kBoxes = (D + 63) / 64;          // 64-column boxes along D
  static constexpr int kKSteps = (D + 15) / 16;         // k16 steps of Q K^T
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr uint32_t kRowBytes = kSwizzleRowBytes;
  static constexpr uint32_t kQBoxBytes = kBM * kRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kQBoxBytes;      // one Q stage
  static constexpr uint32_t kKVBoxBytes = kN * kRowBytes;
  static constexpr uint32_t kKVBytes = kBoxes * kKVBoxBytes;    // one K or V tile
  static constexpr uint32_t kOBoxBytes = 64 * kRowBytes;
  static constexpr uint32_t kOBytes = kBoxes * kOBoxBytes;      // a consumer's O buffer
  static constexpr uint32_t kMaxSmem = 232448;
  // the order of the steps and a block's share of them (the header
  // comment says why): one tile at head dims whose rows are not whole
  // 64-byte bursts (D = 40, 80) takes the heads of a row block one after
  // another, other one-tile plans all steps of a head; a block takes a
  // contiguous share in the one-tile plan and every gridDim-th step in the
  // streamed one
  static constexpr bool kHeadsInner = kOneTile && (2 * D) % 64 != 0;
  static constexpr bool kStrided = !kOneTile;
  // K/V slots (one tile: two if they fit) or stages (streamed: four if they
  // fit), then as many Q stages, up to four, as the rest leaves room for
  static constexpr int kKVStages =
      kOneTile ? (smem_of(kQBytes, kKVBytes, kConsumers * kOBytes, 2, 2) <= kMaxSmem ? 2 : 1)
               : (smem_of(kQBytes, kKVBytes, kConsumers * kOBytes, 2, 4) <= kMaxSmem ? 4 : 2);
  static constexpr int kQStages =
      smem_of(kQBytes, kKVBytes, kConsumers * kOBytes, 4, kKVStages) <= kMaxSmem   ? 4
      : smem_of(kQBytes, kKVBytes, kConsumers * kOBytes, 3, kKVStages) <= kMaxSmem ? 3
      : smem_of(kQBytes, kKVBytes, kConsumers * kOBytes, 2, kKVStages) <= kMaxSmem ? 2
                                                                                   : 1;
  // from a 1024-aligned base: Q stages, K stages, V stages, the consumers'
  // O buffers, then the barriers: full_q[kQStages], empty_q[kQStages],
  // full_k[kKVStages], full_v[kKVStages], empty_kv[kKVStages]
  static constexpr uint32_t kOffK = kQStages * kQBytes;
  static constexpr uint32_t kOffV = kOffK + kKVStages * kKVBytes;
  static constexpr uint32_t kOffO = kOffV + kKVStages * kKVBytes;
  static constexpr uint32_t kOffBar = kOffO + kConsumers * kOBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (2 * kQStages + 3 * kKVStages) + 1024;
  static_assert(D % 8 == 0 && D <= 256, "head dim");
  static_assert(kN == 64 || kN == 80 || kN == 128, "keys a tile");
  static_assert(kKVBytes % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "register budget");
  static_assert(kSmemBytes <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x kN, fp32) = Q K^T, one k16 step
template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (kN == 64) wgmma_m64n64k16_ss(d, da, db, accumulate);
  if constexpr (kN == 80) wgmma_m64n80k16_ss(d, da, db, accumulate);
  if constexpr (kN == 128) wgmma_m64n128k16_ss(d, da, db, accumulate);
}

// Masks the columns >= skv of the tile that starts at key kv0 to -inf. The
// thread holds rows g and g + 8 of its warp's 16: sc[4n], sc[4n + 1] at
// columns 8n + 2t, 8n + 2t + 1 of row g; sc[4n + 2], sc[4n + 3] of row g + 8.
template <int kN>
__device__ __forceinline__ void mask_tail(float (&sc)[kN / 2], int kv0, int skv, int t) {
  if (kv0 + kN <= skv) return;
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (kv0 + n * 8 + 2 * t + e >= skv) {
        sc[4 * n + e] = tf::neg_inf();
        sc[4 * n + 2 + e] = tf::neg_inf();
      }
}

// the maximum of row r's raw logits over the quad that holds the row
template <int kN>
__device__ __forceinline__ float row_max(const float (&sc)[kN / 2], int r) {
  float mx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[i] = fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]);
#pragma unroll
  for (int n = 4; n < kN / 8; ++n)
    mx[n & 3] = fmaxf(mx[n & 3], fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
  float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

// row r of sc turned into exp2(S scale log2 e - mn) in place; returns this
// thread's part of the row sum
template <int kN>
__device__ __forceinline__ float exp_row(float (&sc)[kN / 2], int r, float mn,
                                         float scale_log2) {
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& x = sc[4 * n + 2 * r + e];
      x = ex2(fmaf(x, scale_log2, -mn));
      sum[n & 3] += x;
    }
  return (sum[0] + sum[1]) + (sum[2] + sum[3]);
}

// The one-tile plan's softmax: the whole row is in sc, so P = softmax(S
// scale) is normalised in fp32 here, before P is cast to bf16 (the order of
// ops/attention.py::sdp_attention)
template <int kN>
__device__ __forceinline__ void softmax_whole(float (&sc)[kN / 2], int skv, int t,
                                              float scale_log2) {
  mask_tail<kN>(sc, 0, skv, t);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = row_max<kN>(sc, r) * scale_log2;  // scale > 0
    float sum = exp_row<kN>(sc, r, mn, scale_log2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      sc[4 * n + 2 * r] *= inv;
      sc[4 * n + 2 * r + 1] *= inv;
    }
  }
}

// The streamed plan's online softmax of one tile (K1's): moves the running
// maxima m (log2 domain) to the tile's, returns in c the factors that
// rescale the earlier sums, turns sc into unnormalised P and adds its row
// sums to the partial sums l
template <int kN>
__device__ __forceinline__ void softmax_online(float (&sc)[kN / 2], float (&m)[2],
                                               float (&l)[2], float (&c)[2], int kv0,
                                               int skv, int t, float scale_log2) {
  mask_tail<kN>(sc, kv0, skv, t);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], row_max<kN>(sc, r) * scale_log2);
    c[r] = ex2(m[r] - mn);  // 0 on the first tile
    m[r] = mn;
    l[r] = l[r] * c[r] + exp_row<kN>(sc, r, mn, scale_log2);
  }
}

// P packed to bf16 straight into the A fragments of the P V product: k-slice
// kk covers S columns 16kk .. 16kk + 15, the accumulator's 8-column groups
// 2kk and 2kk + 1
template <int kN>
__device__ __forceinline__ void pack_p(const float (&sc)[kN / 2], uint32_t (&pf)[kN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    pf[kk][0] = tf::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pf[kk][1] = tf::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = tf::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = tf::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// step s's (batch, head, first query row) and its head's number b * heads + h
struct Step {
  int b, h, q0;
  long long head;
};
template <bool kHeadsInner, int kBM>
__device__ __forceinline__ Step step_at(long long s, int heads, int qsteps) {
  Step st;
  if (kHeadsInner) {
    const long long r = s / heads;
    st.h = static_cast<int>(s - r * heads);
    const long long b = r / qsteps;
    st.q0 = static_cast<int>(r - b * qsteps) * kBM;
    st.b = static_cast<int>(b);
  } else {
    const long long bh = s / qsteps;
    st.q0 = static_cast<int>(s - bh * qsteps) * kBM;
    st.h = static_cast<int>(bh % heads);
    st.b = static_cast<int>(bh / heads);
  }
  st.head = static_cast<long long>(st.b) * heads + st.h;
  return st;
}

template <int D, int kN, bool kOneTile>
__global__ void __launch_bounds__(ShortCfg<D, kN, kOneTile>::kThreads, 1)
short_attn_fwd(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, int heads, int sq, int qsteps,
               long long total, int skv, float scale_log2) {
  using C = ShortCfg<D, kN, kOneTile>;
  constexpr int kQS = C::kQStages, kKVS = C::kKVStages, kBoxes = C::kBoxes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kOffBar;
  auto full_q = [&](int s) { return bars + 8u * s; };
  auto empty_q = [&](int s) { return bars + 8u * (kQS + s); };
  auto full_k = [&](int s) { return bars + 8u * (2 * kQS + s); };
  auto full_v = [&](int s) { return bars + 8u * (2 * kQS + kKVS + s); };
  auto empty_kv = [&](int s) { return bars + 8u * (2 * kQS + 2 * kKVS + s); };
  auto parity = [](int i, int stages) { return static_cast<uint32_t>((i / stages) & 1); };
  // this block's contiguous share of the steps; step s is query rows
  // kBM (s % qsteps) .. of (batch, head) number s / qsteps
  const long long s0 = total * blockIdx.x / gridDim.x;
  const long long mine = C::kStrided ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x
                                     : total * (blockIdx.x + 1) / gridDim.x - s0;
  auto step = [&](long long i) {
    return step_at<C::kHeadsInner, C::kBM>(C::kStrided ? blockIdx.x + i * gridDim.x : s0 + i,
                                           heads, qsteps);
  };
  const int nkv = kOneTile ? 1 : (skv + kN - 1) / kN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kQS; ++s) {
      mbar_init(full_q(s), 1);
      mbar_init(empty_q(s), C::kConsumerWarps);
    }
#pragma unroll
    for (int s = 0; s < kKVS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_kv(s), C::kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the rings full ----
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      int qi = 0, kvi = 0;  // Q stages and K/V tiles loaded so far
      long long head = -1;
      for (long long i = 0; i < mine; ++i) {
        const Step at = step(i);
        const int q0 = at.q0, h = at.h, b = at.b;
        auto load_kv = [&](int j) {  // K/V tile j of this head into the next slot
          const int st = kvi % kKVS;
          mbar_wait(empty_kv(st), parity(kvi, kKVS) ^ 1);
          mbar_expect_tx(full_k(st), C::kKVBytes);
#pragma unroll
          for (int bx = 0; bx < kBoxes; ++bx)
            tma_load_4d(base + C::kOffK + st * C::kKVBytes + bx * C::kKVBoxBytes, &tk,
                        full_k(st), 64 * bx, j * kN, h, b);
          mbar_expect_tx(full_v(st), C::kKVBytes);
#pragma unroll
          for (int bx = 0; bx < kBoxes; ++bx)
            tma_load_4d(base + C::kOffV + st * C::kKVBytes + bx * C::kKVBoxBytes, &tv,
                        full_v(st), 64 * bx, j * kN, h, b);
          ++kvi;
        };
        if (kOneTile && at.head != head) {
          load_kv(0);
          head = at.head;
        }
        const int qs = qi % kQS;
        mbar_wait(empty_q(qs), parity(qi, kQS) ^ 1);
        mbar_expect_tx(full_q(qs), C::kQBytes);
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_4d(base + qs * C::kQBytes + bx * C::kQBoxBytes, &tq, full_q(qs), 64 * bx,
                      q0, h, b);
        ++qi;
        if (!kOneTile)
          for (int j = 0; j < nkv; ++j) load_kv(j);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows of each step ----
    setmaxnreg_inc<C::kConsumerRegs>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t o_s = base + C::kOffO + wg * C::kOBytes;

    float acc[D / 2];  // O: 64 rows x D columns, fp32
    float sc[kN / 2];
    uint32_t pf[kN / 16][4];
    int qi = 0, kvi = 0;  // Q stages and K/V tiles consumed so far
    long long head = -1;

    auto release = [&](uint32_t bar) {  // this warp is done with a stage
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q K^T over this consumer's 64 rows of Q stage qs and K slot st;
    // k-step kk reads box kk / 4 at byte 32 (kk % 4) of its swizzle rows
    auto mma_qk = [&](int qs, int st) {
      const uint32_t q_s = base + qs * C::kQBytes + wg * 64 * C::kRowBytes;
      const uint32_t k_s = base + C::kOffK + st * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk)
        wgmma_ss<kN>(sc, kmajor_desc(q_s + (kk / 4) * C::kQBoxBytes + (kk % 4) * 32),
                     kmajor_desc(k_s + (kk / 4) * C::kKVBoxBytes + (kk % 4) * 32), kk);
    };
    // O += P V over the kN keys of V slot st, 16 per wgmma, all D columns
    constexpr uint32_t kAtomBytes = kBoxes > 1 ? C::kKVBoxBytes : 8 * C::kRowBytes;
    auto mma_pv = [&](int st) {
      const uint32_t v_s = base + C::kOffV + st * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<D>(acc, pf[kk], mnmajor_desc(v_s + kk * 16 * C::kRowBytes, kAtomBytes));
    };

    for (long long i = 0; i < mine; ++i) {
      const Step at = step(i);
      const int q0 = at.q0, h = at.h, b = at.b;
      const int qs = qi % kQS;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float inv[2] = {1.f, 1.f};
      if constexpr (kOneTile) {
        if (at.head != head) {  // this head's K and V: the next slot
          if (head >= 0) release(empty_kv((kvi - 1) % kKVS));
          head = at.head;
          mbar_wait(full_k(kvi % kKVS), parity(kvi, kKVS));
          mbar_wait(full_v(kvi % kKVS), parity(kvi, kKVS));
          ++kvi;
        }
        const int st = (kvi - 1) % kKVS;
        mbar_wait(full_q(qs), parity(qi, kQS));
        wgmma_fence();
        mma_qk(qs, st);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        release(empty_q(qs));
        softmax_whole<kN>(sc, skv, t, scale_log2);
        pack_p<kN>(sc, pf);
        fence_regs(acc);
        fence_regs(pf);
        wgmma_fence();
        mma_pv(st);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      } else {
        float m[2] = {tf::neg_inf(), tf::neg_inf()};  // running max, log2 domain
        float l[2] = {0.f, 0.f};                      // per-thread partial row sums
        float c[2];
        mbar_wait(full_q(qs), parity(qi, kQS));
        mbar_wait(full_k(kvi % kKVS), parity(kvi, kKVS));
        wgmma_fence();
        mma_qk(qs, kvi % kKVS);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (nkv == 1) release(empty_q(qs));
        softmax_online<kN>(sc, m, l, c, 0, skv, t, scale_log2);
        pack_p<kN>(sc, pf);
        for (int j = 1; j < nkv; ++j) {
          // Q K^T of this tile, then P V of the previous one; the softmax
          // of this tile runs while P V is still on the tensor cores
          const int sj = (kvi + j) % kKVS, sp = (kvi + j - 1) % kKVS;
          mbar_wait(full_k(sj), parity(kvi + j, kKVS));
          mbar_wait(full_v(sp), parity(kvi + j - 1, kKVS));
          fence_regs(acc);
          fence_regs(pf);
          wgmma_fence();
          mma_qk(qs, sj);
          wgmma_commit();
          mma_pv(sp);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sc);
          if (j == nkv - 1) release(empty_q(qs));
          softmax_online<kN>(sc, m, l, c, j * kN, skv, t, scale_log2);
          wgmma_wait<0>();
          fence_regs(acc);
          release(empty_kv(sp));
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            acc[4 * n] *= c[0];
            acc[4 * n + 1] *= c[0];
            acc[4 * n + 2] *= c[1];
            acc[4 * n + 3] *= c[1];
          }
          pack_p<kN>(sc, pf);
        }
        const int sl = (kvi + nkv - 1) % kKVS;
        mbar_wait(full_v(sl), parity(kvi + nkv - 1, kKVS));
        fence_regs(acc);
        fence_regs(pf);
        wgmma_fence();
        mma_pv(sl);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_kv(sl));
        kvi += nkv;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          inv[r] = 1.f / l[r];
        }
      }
      ++qi;

      // O -> this consumer's buffer, in the 128-byte swizzle of the output
      // map (16-byte chunk c of row r at chunk c ^ (r % 8)), then one TMA
      // store; the buffer's previous store must have read it first
      const int row0 = q0 + wg * 64;
      if (tid == 0) bulk_wait_read<0>();
      named_bar_sync(1 + wg, 128);
      const int r0 = warp * 16 + g;  // and r0 + 8, in the same swizzle phase
      const uint32_t swz = static_cast<uint32_t>(r0 & 7) << 4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + 2 * t;
        const uint32_t at = o_s + (col / 64) * C::kOBoxBytes + ((2u * (col % 64)) ^ swz);
        st_shared_u32(at + r0 * C::kRowBytes,
                      tf::pack_bf16(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]));
        st_shared_u32(at + (r0 + 8) * C::kRowBytes,
                      tf::pack_bf16(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]));
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (tid == 0 && row0 < sq) {
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_store_4d(&to, o_s + bx * C::kOBoxBytes, 64 * bx, row0, h, b);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

// raises short_attn_fwd<D, kN, kOneTile>'s dynamic shared memory limit on
// device dev on its first launch there (a bit per device)
template <int D, int kN, bool kOneTile>
cudaError_t allow_smem(int dev) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(short_attn_fwd<D, kN, kOneTile>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               ShortCfg<D, kN, kOneTile>::kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// the SMs of device dev, read once per device
inline int sm_count(int dev) {
  static std::atomic<int> counts[64];
  int n = counts[dev & 63].load(std::memory_order_relaxed);
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    counts[dev & 63].store(n, std::memory_order_relaxed);
  return n > 0 ? n : 1;
}

template <int D, int kN, bool kOneTile>
int launch(int dev, const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh, long long vsb, long long vss,
           long long vsh, long long osb, long long oss, long long osh, float scale,
           void* stream) {
  using C = ShortCfg<D, kN, kOneTile>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap tq, tk, tv, to;
  int rc = make_map(&tq, encode, q, D, sq, heads, batch, qsb, qss, qsh, C::kBM);
  if (rc == 0) rc = make_map(&tk, encode, k, D, skv, heads, batch, ksb, kss, ksh, kN);
  if (rc == 0) rc = make_map(&tv, encode, v, D, skv, heads, batch, vsb, vss, vsh, kN);
  if (rc == 0) rc = make_map(&to, encode, o, D, sq, heads, batch, osb, oss, osh, 64);
  if (rc != 0) return rc;
  const cudaError_t attr = allow_smem<D, kN, kOneTile>(dev);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int qsteps = (sq + C::kBM - 1) / C::kBM;
  const long long total = static_cast<long long>(batch) * heads * qsteps;
  const long long sms = sm_count(dev);
  const int grid = static_cast<int>(total < sms ? total : sms);
  const float scale_log2 = scale * 1.4426950408889634f;
  short_attn_fwd<D, kN, kOneTile>
      <<<grid, C::kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, to, heads, sq, qsteps, total, skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

#define TF_SHORT_ARGS                                                                       \
  dev, q, k, v, o, batch, heads, sq, skv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, \
      oss, osh, scale, stream

// the plan of head dim D at skv keys: one tile of 64, 80 or 128 keys, else
// 128-key tiles streamed (64 at D = 160, as K1's)
template <int D>
int dispatch(int dev, const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh, long long vsb, long long vss,
             long long vsh, long long osb, long long oss, long long osh, float scale,
             void* stream) {
  if (skv <= 64) return launch<D, 64, true>(TF_SHORT_ARGS);
  if (skv <= 80) return launch<D, 80, true>(TF_SHORT_ARGS);
  if (skv <= 128) return launch<D, 128, true>(TF_SHORT_ARGS);
  return launch<D, (D <= 128 ? 128 : 64), false>(TF_SHORT_ARGS);
}

}  // namespace

// Launches on `stream` for head dim 40, 64, 80, 88 or 160 and any key length
// (the wrapper sends it those at or under the UNet's kv_block); returns 0
// on success, a cudaError_t of the launch, or a negative code for a refused
// tensor map or another head dim (tf_error_string).
extern "C" int tf_short_attention(
    int head_dim, const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale,
    void* stream) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (head_dim) {
    case 40: return dispatch<40>(TF_SHORT_ARGS);
    case 64: return dispatch<64>(TF_SHORT_ARGS);
    case 80: return dispatch<80>(TF_SHORT_ARGS);
    case 88: return dispatch<88>(TF_SHORT_ARGS);
    case 160: return dispatch<160>(TF_SHORT_ARGS);
    default: return tf::kErrHeadDim;
  }
}
#undef TF_SHORT_ARGS
