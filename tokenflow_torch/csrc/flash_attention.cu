// Flash attention forward for Hopper (sm_90a), bf16 in/out, head dims 40,
// 64, 80, 88 and 160.
//
// Replaces the Pallas TPU kernel tokenflow_tpu/kernels/flash_attention.py
// (flash_attention_bhsd / _flash_kernel): softmax(Q K^T * scale) V with an
// online softmax whose state (acc, m, l) stays in fp32 registers across the
// KV tiles, so neither the (Sq, Skv) logits nor an fp32 accumulator ever
// reach device memory.
//
// Design (FlashAttention-3's structure, cut to what these head dims need):
//   - one block per (query tile, head, batch) of a producer warpgroup and
//     two or three consumer warpgroups. Warpgroup 0 is the producer: one
//     thread starts the TMA loads, and the warpgroup gives its registers to
//     the consumers (setmaxnreg). Each consumer owns 64 query rows, so every
//     K/V tile fetched serves 128 or 192 query rows;
//   - Q is loaded once by TMA; K and V tiles of kBN tokens stream through a
//     ring of stages in dynamic shared memory. Each stage has a "full"
//     mbarrier for K, one for V (TMA transaction counts) and an "empty"
//     mbarrier that the consumer warps arrive on once the stage is read;
//   - a 128-byte swizzle row holds 64 bf16, so every tile is cut along D
//     into boxes of 64 columns (one TMA load each, box b at column 64 b).
//     The tensor map's extent along D is the true head dim: TMA zero-fills
//     a box's columns past it in shared memory (D = 40: columns 40-63;
//     D = 80: 80-127; D = 88: 88-127; D = 160: 160-191) and reads only the
//     head's own D columns from device memory;
//   - S = Q K^T runs as ceil(D / 16) wgmma.mma_async k-steps per tile, both
//     operands from shared memory (K is K-major as it lies in memory); the
//     descriptor steps 32 bytes inside a box and moves to the next box every
//     four k-steps. D = 40 takes three k-steps: columns 40-47 are zeros;
//     D = 88 six, the last reading the zero columns 88-95;
//   - the softmax runs on the accumulator registers: row max and sum with
//     quad shuffles, scale * log2 e applied in the exp2 domain. The
//     m64nNk16 accumulator layout is the register A-operand layout of the
//     next wgmma, so P is packed to bf16 in registers and never touches
//     shared memory;
//   - O += P V runs as kBN / 16 wgmma m64nDk16, N = the head dim, with A =
//     P from registers and B = the V tile in its natural (token, dim)
//     layout, MN-major for this product (wgmma's transpose bit). The V
//     boxes are its swizzle atoms along N, a leading offset of one box
//     apart, and the product reads only the first D columns: the last atom
//     in part (D = 40: 40 of one atom's 64; 80: one and 16 of the next;
//     88: one and 24, m64n88k16; 160: two and 32 of the third). O is D columns wide, D / 2 fp32
//     registers a thread, and no zero column is ever multiplied into it;
//   - schedule: the consumers take turns (named barriers) to start Q K^T of
//     tile j and P V of tile j - 1, so the tensor cores work through one
//     warpgroup's products while the others run their softmax; and each
//     warpgroup's softmax of tile j runs while its own P V of tile j - 1 is
//     still on the tensor cores;
//   - ragged tiles: TMA zero-fills rows past the tensor's end; the last KV
//     tile masks its columns >= Skv to -inf, and Q rows >= Sq are not
//     stored.
// Plans (Cfg<D, kCons>): D = 40 and 64 have three consumers (192 query
// rows), 128-token KV tiles in four stages and 160 registers a consumer
// thread (O takes 20 or 32 of them, S 64 and P 32). D = 80 has two (128
// rows) with 240 registers and three stages of 128-token two-box tiles
// (225 KB of shared memory): three consumers fit only with 64- or 96-token
// tiles or two stages, and were 2-77% slower at 2 x 5120 rows. D = 88
// (HunyuanDiT's 16 heads over 1408) takes D = 80's plan: its K and V tiles
// are the same two boxes, and O's 44 registers fit the 240. D = 160
// takes 64-token tiles in three stages of three-box K and V and has two
// plans, three consumers (217 KB) and two (193 KB); the launcher takes the
// one whose grid ends first counting waves of one block per SM times a
// block's rows (d160_two_consumers, the one place the choice is made).
// SD-1.5's 16 x 16 level at 512^2 over 5 keyframes (2 x 1280 rows, 8
// heads) takes three: 112 blocks, one wave, where two make 160 in two (39%
// slower). Over 4 keyframes (2 x 1024 rows), and on the per-rank queries
// of a 2-rank frames group (2 x 768 and 2 x 512 rows against 1280 keys),
// the grid is one wave either way and two consumers' 128-row blocks end
// it sooner (PERF.md times both plans at these rows: two 15-18% faster).
// Bound: per (batch, head) the two products do 4 Sq Skv D flops against
// (Sq + 2 Skv) 2 D bytes read and Sq 2 D written, thousands of flops per
// byte at the path's lengths, so the kernel is compute bound (989 TFLOP/s
// bf16). The tensor cores multiply Q K^T 16 ceil(D / 16) deep and P V D
// wide: 88 / 80 of the bound's products at D = 40, exactly them at 80 and
// 160. Measured on an H100 80GB HBM3 at 700 W, by device time: about half
// the bound at D = 64 on the path's long rows, 38% at D = 40 (2 x 20480
// rows, 8 heads; 35% at 40 x 4096), 45% at D = 80 (2 x 5120), 39% at
// D = 160 (2 x 1280).
// What holds D = 40 back is not MUFU: per KV tile and SM the time is
// close to the tensor cores' work plus the consumers' instruction issue
// (about 7.5 instructions a score: max, FFMA, ex2, sum, half a pack, and
// the tile's share of barriers and descriptors), as if the two overlapped
// little. Computing a share of the exponentials on the FMA pipe with a
// degree-3 polynomial (FlashAttention-4's split) made the kernel slower in
// proportion to the instructions it added (an eighth of them 3-10%, a
// quarter 10-16%, half 24-30%); computing each operand's descriptor once
// per tile instead of per k-step, fewer instructions, moved D = 40 by -4%
// to +5% over two runs (D = 160 4% faster); two consumers with 128-, 192-
// or 256-token tiles were 24-38% slower than three with 128
// (scripts/k1_variants.py builds and times each of these).
//
// Layout: tensors are (B, S, H, D) with arbitrary batch/sequence/head
// strides (in elements; positive multiples of 8, which TMA needs as byte
// strides that are multiples of 16) and unit stride along the head dim.
// The launcher builds the TMA tensor maps on every call, reaching
// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
// needs no -lcuda; it raises a kernel's shared-memory limit and reads the
// SM count once per device. The TMA, mbarrier and wgmma helpers live in
// hopper.cuh, shared with the token-match core.
#include <cuda.h>
#include <stdio.h>

#include <atomic>

#include "common.cuh"

namespace {

using namespace tf;

// the tile plan of head dim D with kCons consumer warpgroups (see the
// header comment)
template <int D, int kCons>
struct Cfg {
  static constexpr int kBoxes = (D + 63) / 64;   // 64-column boxes along D
  static constexpr int kKSteps = (D + 15) / 16;  // k16 steps of Q K^T
  static constexpr int kConsumers = kCons;       // 64 query rows each
  static constexpr int kBM = 64 * kConsumers;    // query rows per block
  static constexpr int kBN = D <= 128 ? 128 : 64;  // KV tokens per tile
  static constexpr int kStages = D <= 64 ? 4 : 3;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  // registers per thread after setmaxnreg: the producer warpgroup gives its
  // share to the consumers, within the SM's 65536
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr uint32_t kRowBytes = kSwizzleRowBytes;  // one box row
  static constexpr uint32_t kBoxBytes = kBN * kRowBytes;   // one box of a K or V tile
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;
  static constexpr uint32_t kQBoxBytes = kBM * kRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kQBoxBytes;
  // dynamic shared memory from a 1024-aligned base: Q, K stages, V stages,
  // then the barriers: full_q, full_k[kStages], full_v[kStages], empty[kStages]
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
  static constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 3 * kStages) + 1024;
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static_assert(D % 8 == 0 && D <= 256, "head dim");
  static_assert(kConsumers == 2 || kConsumers == 3, "consumer warpgroups");
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "register budget");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one KV tile of kBN tokens on S's registers. The
// thread holds rows g and g + 8 of its warp's 16: sc[4n], sc[4n + 1] at
// columns 8n + 2t, 8n + 2t + 1 of row g; sc[4n + 2], sc[4n + 3] of row g + 8.
// Masks columns >= skv (the ragged tail), moves the running maxima m to the
// tile's, returns in c the factors that rescale the earlier sums, and turns
// sc into P = exp2(S scale log2 e - m) in place, adding its row sums to the
// partial sums l.
template <int kBN>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2], float (&m)[2],
                                             float (&l)[2], float (&c)[2], int kv0,
                                             int skv, int t, float scale_log2) {
  constexpr int kGroups = kBN / 8;  // 8-column groups
  if (kv0 + kBN > skv) {
#pragma unroll
    for (int n = 0; n < kGroups; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (kv0 + n * 8 + 2 * t + e >= skv) {
          sc[4 * n + e] = tf::neg_inf();
          sc[4 * n + 2 + e] = tf::neg_inf();
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // row maximum of the raw logits (scale > 0, so the maximum commutes
    // with it), four independent chains, then across the quad, whose four
    // threads hold the same two rows
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i] = fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]);
#pragma unroll
    for (int n = 4; n < kGroups; ++n)
      mx[n & 3] = fmaxf(mx[n & 3], fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    float row_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float mn = fmaxf(m[r], row_max * scale_log2);
    c[r] = ex2(m[r] - mn);  // 0 on the first tile
    m[r] = mn;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kGroups; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * r + e];
        x = ex2(fmaf(x, scale_log2, -mn));
        sum[n & 3] += x;
      }
    l[r] = l[r] * c[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// acc *= c (row g: c[0], row g + 8: c[1]) over O's D / 8 column groups,
// and P packed to bf16 straight into the A fragments of the P V product:
// k-slice kk covers S columns 16kk .. 16kk + 15, the accumulator's 8-column
// groups 2kk and 2kk + 1
template <int D, int kBN>
__device__ __forceinline__ void rescale_and_pack(const float (&sc)[kBN / 2],
                                                 float (&acc)[D / 2],
                                                 uint32_t (&pf)[kBN / 16][4],
                                                 const float (&c)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[4 * n] *= c[0];
    acc[4 * n + 1] *= c[0];
    acc[4 * n + 2] *= c[1];
    acc[4 * n + 3] *= c[1];
  }
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pf[kk][0] = tf::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pf[kk][1] = tf::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = tf::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = tf::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D, int kCons>
__global__ void __launch_bounds__(Cfg<D, kCons>::kThreads, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          __nv_bfloat16* __restrict__ o, int sq, int skv, long long osb,
          long long oss, long long osh, float scale_log2) {
  using C = Cfg<D, kCons>;
  constexpr int kBoxes = C::kBoxes, kBN = C::kBN, kStages = C::kStages;
  constexpr int kConsumers = C::kConsumers;
  constexpr uint32_t kRowBytes = C::kRowBytes, kBoxBytes = C::kBoxBytes;
  constexpr uint32_t kTileBytes = C::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::kOffBar;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  const int nkv = (skv + kBN - 1) / kBN;
  const int q0 = blockIdx.x * C::kBM, h = blockIdx.y, b = blockIdx.z;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), C::kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int bx = 0; bx < kBoxes; ++bx)
        tma_load_4d(base + bx * C::kQBoxBytes, &tq, bar_q, 64 * bx, q0, h, b);
      for (int j = 0; j < nkv; ++j) {
        const int s = j % kStages;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k(s), kTileBytes);
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_4d(base + C::kOffK + s * kTileBytes + bx * kBoxBytes, &tk, full_k(s),
                      64 * bx, j * kBN, h, b);
        mbar_expect_tx(full_v(s), kTileBytes);
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_4d(base + C::kOffV + s * kTileBytes + bx * kBoxBytes, &tv, full_v(s),
                      64 * bx, j * kBN, h, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<C::kConsumerRegs>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t q_s = base + wg * 64 * kRowBytes;  // in box 0

    float acc[D / 2];  // O: 64 rows x D columns, fp32
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBN / 2];
    uint32_t pf[kBN / 16][4];
    float m[2] = {tf::neg_inf(), tf::neg_inf()};  // running max, log2 domain
    float l[2] = {0.f, 0.f};  // per-thread partial row sums
    float c[2];

    // The consumer warpgroups take turns, in order, issuing their products
    // (named barrier 1 + wg is this warpgroup's turn), so that one
    // warpgroup's softmax runs while the tensor cores work through the
    // others'. Warpgroup 0 takes the first turn; the last warpgroup skips
    // its hand-over after its last turn, so every barrier is left balanced.
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
    const int n_turns = nkv + 1;
    int turn = 0;
    auto take_turn = [&] { named_bar_sync(my_turn); };
    auto pass_turn = [&] {
      if (wg < kConsumers - 1 || ++turn < n_turns) named_bar_arrive(next_turn);
    };
    if (wg == kConsumers - 1) named_bar_arrive(next_turn);

    // tile j's S = Q K^T: this warpgroup's 64 rows x kBN kv columns; k-step
    // kk reads box kk / 4 at byte 32 (kk % 4) of its swizzle rows
    auto mma_qk = [&](int j) {
      const uint32_t k_s = base + C::kOffK + (j % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        const uint64_t da = kmajor_desc(q_s + (kk / 4) * C::kQBoxBytes + (kk % 4) * 32);
        const uint64_t db = kmajor_desc(k_s + (kk / 4) * kBoxBytes + (kk % 4) * 32);
        if constexpr (kBN == 128)
          wgmma_m64n128k16_ss(sc, da, db, kk);
        else
          wgmma_m64n64k16_ss(sc, da, db, kk);
      }
    };
    // O += P V over tile j's kBN tokens, 16 per wgmma, all D columns of O
    // in one product: the V boxes are the swizzle atoms along N (at D <= 64
    // the product stays within one atom and never reads the leading offset,
    // which then keeps its one-atom value and D = 64 its instructions)
    constexpr uint32_t kAtomBytes = kBoxes > 1 ? kBoxBytes : 8 * kRowBytes;
    auto mma_pv = [&](int j) {
      const uint32_t v_s = base + C::kOffV + (j % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(acc, pf[kk], mnmajor_desc(v_s + kk * 16 * kRowBytes, kAtomBytes));
    };
    auto release = [&](int j) {  // this warp is done with tile j's stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j % kStages));
    };
    auto parity = [](int j) { return static_cast<uint32_t>((j / kStages) & 1); };

    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    take_turn();
    wgmma_fence();
    mma_qk(0);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<kBN>(sc, m, l, c, 0, skv, t, scale_log2);
    rescale_and_pack<D, kBN>(sc, acc, pf, c);
    for (int j = 1; j < nkv; ++j) {
      // Q K^T of this tile, then P V of the previous one, in one turn; the
      // softmax of this tile runs while P V is still on the tensor cores
      mbar_wait(full_k(j % kStages), parity(j));
      mbar_wait(full_v((j - 1) % kStages), parity(j - 1));
      take_turn();
      fence_regs(acc);
      fence_regs(pf);
      wgmma_fence();
      mma_qk(j);
      wgmma_commit();
      mma_pv(j - 1);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile<kBN>(sc, m, l, c, j * kBN, skv, t, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      release(j - 1);
      rescale_and_pack<D, kBN>(sc, acc, pf, c);
    }
    mbar_wait(full_v((nkv - 1) % kStages), parity(nkv - 1));
    take_turn();
    fence_regs(acc);
    fence_regs(pf);
    wgmma_fence();
    mma_pv(nkv - 1);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(acc);
    release(nkv - 1);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];

    // O holds exactly D columns: the zero-filled ones past D were never
    // multiplied into it
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
            tf::pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * oss + col) =
            tf::pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
  }
}

// raises flash_fwd<D, kCons>'s dynamic shared memory limit on device dev
// on its first launch there, not on every call (a bit per device)
template <int D, int kCons>
cudaError_t allow_smem(int dev) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd<D, kCons>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<D, kCons>::kSmemBytes);
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

// Whether D = 160 takes its two-consumer plan (128 query rows a block)
// over its three-consumer one (192): it does when that grid ends first if
// a block's time grows with its rows, counting waves of one block per SM
// times the rows of a block. At 2 x 1280 rows and 8 heads (5 keyframes)
// three consumers make 112 blocks in one wave against 160 in two; at 2 x
// 1024 rows (4 keyframes) two make 128 blocks in one wave against 96.
inline bool d160_two_consumers(int batch, int heads, int sq, int sms) {
  auto span = [&](long long rows) {
    const long long blocks = (sq + rows - 1) / rows * heads * batch;
    return (blocks + sms - 1) / sms * rows;
  };
  return span(128) < span(192);
}

template <int D, int kCons>
int launch(int dev, const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh, long long vsb, long long vss,
           long long vsh, long long osb, long long oss, long long osh, float scale,
           void* stream) {
  using C = Cfg<D, kCons>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, encode, q, D, sq, heads, batch, qsb, qss, qsh, C::kBM);
  if (rc == 0) rc = make_map(&tk, encode, k, D, skv, heads, batch, ksb, kss, ksh, C::kBN);
  if (rc == 0) rc = make_map(&tv, encode, v, D, skv, heads, batch, vsb, vss, vsh, C::kBN);
  if (rc != 0) return rc;
  const cudaError_t attr = allow_smem<D, kCons>(dev);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + C::kBM - 1) / C::kBM, heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd<D, kCons>
      <<<grid, C::kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, skv, osb, oss, osh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kCons>
int write_plan(int* plan) {
  using C = Cfg<D, kCons>;
  const int p[5] = {C::kBM, C::kBN, C::kStages, C::kConsumers,
                    static_cast<int>(C::kSmemBytes)};
  for (int i = 0; i < 5; ++i) plan[i] = p[i];
  return 0;
}

}  // namespace

// Launches on `stream` for head dim 40, 64, 80, 88 or 160; returns 0 on
// success, a cudaError_t of the launch, or a negative code for a refused
// tensor map or another head dim (tf_error_string).
extern "C" int tf_flash_attention(
    int head_dim, const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale,
    void* stream) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
#define TF_FLASH_ARGS                                                                       \
  dev, q, k, v, o, batch, heads, sq, skv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, \
      oss, osh, scale, stream
  switch (head_dim) {
    case 40: return launch<40, 3>(TF_FLASH_ARGS);
    case 64: return launch<64, 3>(TF_FLASH_ARGS);
    case 80: return launch<80, 2>(TF_FLASH_ARGS);
    case 88: return launch<88, 2>(TF_FLASH_ARGS);
    case 160:
      return d160_two_consumers(batch, heads, sq, sm_count(dev))
                 ? launch<160, 2>(TF_FLASH_ARGS)
                 : launch<160, 3>(TF_FLASH_ARGS);
    default: return tf::kErrHeadDim;
  }
#undef TF_FLASH_ARGS
}

// The tile plan a launch at head dim 40, 64, 80, 88 or 160 over (batch, heads,
// sq) query rows takes on a card of `sms` SMs, into plan[5]: query rows per
// block, KV tokens per tile, ring stages, consumer warpgroups and the
// dynamic shared memory bytes (chip_smoke.py prints it beside each row);
// returns 0, or kErrHeadDim
extern "C" int tf_flash_attention_plan(int head_dim, int batch, int heads, int sq, int sms,
                                       int* plan) {
  switch (head_dim) {
    case 40: return write_plan<40, 3>(plan);
    case 64: return write_plan<64, 3>(plan);
    case 80: return write_plan<80, 2>(plan);
    case 88: return write_plan<88, 2>(plan);
    case 160:
      return d160_two_consumers(batch, heads, sq, sms) ? write_plan<160, 2>(plan)
                                                       : write_plan<160, 3>(plan);
    default: return tf::kErrHeadDim;
  }
}

extern "C" const char* tf_error_string(int code) {
  static thread_local char buf[96];
  if (code == tf::kErrNoEncoder)
    return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
  if (code == tf::kErrHeadDim) return "flash attention has no kernel for this head dim";
  if (code <= tf::kErrEncodeBase) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             tf::kErrEncodeBase - code);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
