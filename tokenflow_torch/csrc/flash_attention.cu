// Flash attention forward for Hopper (sm_90a), bf16 in/out, head dim 64.
//
// Replaces the Pallas TPU kernel tokenflow_tpu/kernels/flash_attention.py
// (flash_attention_bhsd / _flash_kernel): softmax(Q K^T * scale) V with an
// online softmax whose state (acc, m, l) stays in fp32 registers across the
// KV tiles, so neither the (Sq, Skv) logits nor an fp32 accumulator ever
// reach device memory.
//
// Design (FlashAttention-3's structure, cut to what head dim 64 needs):
//   - one block of four warpgroups per (192-row query tile, head, batch).
//     Warpgroup 0 is the producer: one thread starts the TMA loads, and the
//     warpgroup gives its registers to the consumers (setmaxnreg 24/160).
//     Warpgroups 1-3 are consumers, each owning 64 query rows, so every K/V
//     tile fetched serves 192 query rows;
//   - Q (192 x 64) is loaded once by TMA; K and V tiles of 128 tokens x 64
//     dims (16 KB each) stream through a ring of four stages in dynamic
//     shared memory. Each stage has a "full" mbarrier for K, one for V (TMA
//     transaction counts) and an "empty" mbarrier that the 12 consumer warps
//     arrive on once the stage is read. A 64-dim bf16 row is 128 bytes, so
//     the TMA boxes and the wgmma descriptors both use the 128-byte swizzle;
//   - S = Q K^T runs as four wgmma.mma_async m64n128k16 per tile, both
//     operands from shared memory (K is K-major as it lies in memory);
//   - the softmax runs on the accumulator registers: row max and sum with
//     quad shuffles, scale * log2 e applied in the exp2 domain. The
//     m64nNk16 accumulator layout is the register A-operand layout of the
//     next wgmma, so P is packed to bf16 in registers and never touches
//     shared memory;
//   - O += P V runs as eight wgmma m64n64k16 per tile with A = P from
//     registers and B = V from shared memory in its natural (token, dim)
//     layout, which is MN-major for this product (wgmma's transpose bit);
//   - schedule: the consumers take turns (named barriers) to start Q K^T of
//     tile j and P V of tile j - 1, so the tensor cores work through one
//     warpgroup's products while the others run their softmax; and each
//     warpgroup's softmax of tile j runs while its own P V of tile j - 1 is
//     still on the tensor cores;
//   - ragged tiles: TMA zero-fills rows past the tensor's end; the last KV
//     tile masks its columns >= Skv to -inf, and Q rows >= Sq are not
//     stored.
// Bound: per (batch, head) the two products do 4 Sq Skv 64 flops against
// (Sq + 2 Skv) 128 bytes read and Sq 128 written, thousands of flops per
// byte at the path's lengths, so the kernel is compute bound (989 TFLOP/s
// bf16). At head dim 64 the exponentials weigh as much as the products: a
// score costs the SM 1/16 cycle in the tensor cores (256 flops) and 1/16
// cycle in MUFU ex2, so the two have to overlap. Measured (PERF.md): about
// half the bf16 peak at the path's long rows. Which part of the work sets
// the time is not measured yet; known limits are the grid's partial last
// wave (no persistent scheduler yet) and, at 4096 tokens, a block that
// lives for only 32 KV tiles.
//
// Layout: tensors are (B, S, H, 64) with arbitrary batch/sequence/head
// strides (in elements; positive multiples of 8, which TMA needs as byte
// strides that are multiples of 16) and unit stride along the head dim.
// The launcher builds the TMA tensor maps on every call, reaching
// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
// needs no -lcuda. The TMA, mbarrier and wgmma helpers live in hopper.cuh,
// shared with the token-match core.
#include <cuda.h>
#include <stdio.h>

#include "common.cuh"

namespace {

using namespace tf;

constexpr int kD = 64;
constexpr int kConsumers = 3;         // consumer warpgroups, 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows per block
constexpr int kBN = 128;              // KV tokens per tile
constexpr int kStages = 4;
constexpr int kThreads = 128 * (1 + kConsumers);
// registers per thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers, within the SM's 65536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
              "register budget");
constexpr uint32_t kRowBytes = kD * 2;               // 128: one swizzle row
constexpr uint32_t kTileBytes = kBN * kRowBytes;     // one K or V tile
constexpr uint32_t kQBytes = kBM * kRowBytes;
// dynamic shared memory from a 1024-aligned base: Q, K stages, V stages,
// then the barriers: full_q, full_k[kStages], full_v[kStages], empty[kStages]
constexpr uint32_t kOffK = kQBytes;
constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;
constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 3 * kStages) + 1024;
constexpr uint32_t kConsumerWarps = 4 * kConsumers;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one KV tile on S's registers. The thread holds
// rows g and g + 8 of its warp's 16: sc[4n], sc[4n + 1] at columns
// 8n + 2t, 8n + 2t + 1 of row g; sc[4n + 2], sc[4n + 3] of row g + 8.
// Masks columns >= skv (the ragged tail), moves the running maxima m to
// the tile's, returns in c the factors that rescale the earlier sums, and
// turns sc into P = exp2(S scale log2 e - m) in place, adding its row sums
// to the partial sums l.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&c)[2], int kv0,
                                             int skv, int t, float scale_log2) {
  if (kv0 + kBN > skv) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
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
    for (int n = 4; n < 16; ++n)
      mx[n & 3] = fmaxf(mx[n & 3], fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    float row_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float mn = fmaxf(m[r], row_max * scale_log2);
    c[r] = ex2(m[r] - mn);  // 0 on the first tile
    m[r] = mn;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * r + e];
        x = ex2(fmaf(x, scale_log2, -mn));
        sum[n & 3] += x;
      }
    l[r] = l[r] * c[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// acc *= c (row g: c[0], row g + 8: c[1]), and P packed to bf16 straight
// into the A fragments of the P V product: k-slice kk covers S columns
// 16kk .. 16kk + 15, the accumulator's 8-column groups 2kk and 2kk + 1
__device__ __forceinline__ void rescale_and_pack(const float (&sc)[64],
                                                 float (&acc)[32],
                                                 uint32_t (&pf)[8][4],
                                                 const float (&c)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[4 * n] *= c[0];
    acc[4 * n + 1] *= c[0];
    acc[4 * n + 2] *= c[1];
    acc[4 * n + 3] *= c[1];
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pf[kk][0] = tf::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pf[kk][1] = tf::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = tf::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = tf::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d64(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              __nv_bfloat16* __restrict__ o, int sq, int skv, long long osb,
              long long oss, long long osh, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + kOffBar;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  const int nkv = (skv + kBN - 1) / kBN;
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kQBytes);
      tma_load_4d(base, &tq, bar_q, 0, q0, h, b);
      for (int j = 0; j < nkv; ++j) {
        const int s = j % kStages;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k(s), kTileBytes);
        tma_load_4d(base + kOffK + s * kTileBytes, &tk, full_k(s), 0, j * kBN, h, b);
        mbar_expect_tx(full_v(s), kTileBytes);
        tma_load_4d(base + kOffV + s * kTileBytes, &tv, full_v(s), 0, j * kBN, h, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t q_s = base + wg * 64 * kRowBytes;

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float sc[64];
    uint32_t pf[8][4];
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

    // tile j's S = Q K^T: this warpgroup's 64 rows x 128 kv columns
    auto mma_qk = [&](int j) {
      const uint32_t k_s = base + kOffK + (j % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n128k16_ss(sc, kmajor_desc(q_s + kk * 32),
                            kmajor_desc(k_s + kk * 32), kk);
    };
    // O += P V over tile j's 128 tokens, 16 per wgmma
    auto mma_pv = [&](int j) {
      const uint32_t v_s = base + kOffV + (j % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_m64n64k16_rs(acc, pf[kk], mnmajor_desc(v_s + kk * 16 * kRowBytes));
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
    softmax_tile(sc, m, l, c, 0, skv, t, scale_log2);
    rescale_and_pack(sc, acc, pf, c);
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
      softmax_tile(sc, m, l, c, j * kBN, skv, t, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      release(j - 1);
      rescale_and_pack(sc, acc, pf, c);
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

    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
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

}  // namespace

// Launches on `stream`; returns 0 on success, a cudaError_t of the launch,
// or a negative code for a refused tensor map (tf_error_string).
extern "C" int tf_flash_attention_d64(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale,
    void* stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, encode, q, kD, sq, heads, batch, qsb, qss, qsh, kBM);
  if (rc == 0) rc = make_map(&tk, encode, k, kD, skv, heads, batch, ksb, kss, ksh, kBN);
  if (rc == 0) rc = make_map(&tv, encode, v, kD, skv, heads, batch, vsb, vss, vsh, kBN);
  if (rc != 0) return rc;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_d64, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + kBM - 1) / kBM, heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_d64<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, skv, osb, oss, osh,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tf_error_string(int code) {
  static thread_local char buf[96];
  if (code == tf::kErrNoEncoder)
    return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
  if (code <= tf::kErrEncodeBase) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             tf::kErrEncodeBase - code);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
