// Flash attention forward in fp32 for Hopper (sm_90a), head dims 40, 64,
// 80 and 160: K1's fp32 instantiation (the bf16 one is flash_attention.cu).
//
// Replaces the Pallas TPU kernel tokenflow_tpu/kernels/flash_attention.py
// (flash_attention_bhsd / _flash_kernel) on fp32 inputs: softmax(Q K^T *
// scale) V with an online softmax whose state (acc, m, l) stays in fp32
// registers across the KV tiles, the scale folded into the exp2 domain
// (scale * log2 e applied to the logits, exp2 of the differences), KV
// tokens >= Skv masked to -inf, Q rows >= Sq not stored, fp32 output.
//
// Design: both products on the tensor cores as 3xTF32 splits (tf32.cuh:
// hi = rna(x), lo = rna(x - hi), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi,
// cross terms first), fp32-class error; FFMA's 67 TFLOP/s ceiling becomes
// three TF32 products at 495 TFLOP/s.
//   - pre-pass (three launches on the same stream): Q and K become
//     contiguous tables of rows [hi (D) | lo (D)] (tf32_split_rows), V a
//     transposed table V^T (B, H, 2D, Skv8) of hi rows then lo rows
//     (tf32_split_vt), tokens padded with zeros to a multiple of 8. tf32
//     wgmma takes both operands K-major only: Q and K are (rows along D),
//     V's (token, dim) tile is not, so the pre-pass writes V^T once per
//     call (2 x the bytes of V; at the pivotal rows a few tens of MB, some
//     0.05 ms of HBM time against a kernel of milliseconds) rather than
//     transposing every tile in shared memory or loading mma.sync
//     fragments by hand, which would read V from shared memory once per
//     warp instead of once per warpgroup;
//   - one block per (64 kRowGroups query rows, head, batch): a producer
//     warpgroup (one thread issues every TMA load; setmaxnreg hands its
//     registers to the consumers) and kRowGroups x kKvSplit consumer
//     warpgroups. Consumer c owns the 64 query rows of group c % kRowGroups
//     and the KV tiles j with j % kKvSplit == c / kRowGroups;
//   - Q's table rows are loaded once by TMA and stay resident; K tiles and
//     V^T tiles stream through one ring of kUnits units (unit 2j: K tile j,
//     unit 2j + 1: V^T tile j), each unit with a "full" mbarrier (TMA
//     transaction count) and an "empty" one that the warps of the tile's
//     consumers arrive on once they are done with it. A unit is released
//     right after its products complete, so no unit waits on a later one;
//   - S = Q K^T: 3 D / 8 wgmma m64n{kBN}k8 tf32, both operands from shared
//     memory (Q_lo K_hi, then Q_hi K_lo, then Q_hi K_hi over every k-step
//     of 8 dims). A 128-byte swizzle row holds 32 fp32, so tiles are cut
//     along their columns into 32-column boxes; a k-step's descriptor
//     points 32 bytes into a box (tf32_desc);
//   - the softmax runs on the accumulator registers in fp32 with exact
//     exp2f (the library's 2-ulp exp2, not ex2.approx.ftz), the ragged KV
//     tail masked to -inf;
//   - O += P V: P goes from the S accumulator to the A operand in registers
//     and is split there into hi and lo. Each tile's P V starts from zero
//     in an accumulator of its own and is added to O in fp32 registers:
//     the tensor cores' fp32 accumulation is not round-to-nearest, and one
//     chain of products over every KV tile gave an error that grew with
//     Skv, past the 2e-5 relative L2 limit at the path's lengths on the
//     H100 (scripts/k1f32_chain.py: 2.8e-5 at Skv = 4096, 1.4e-4 at 20480,
//     against 1e-6 with an accumulator per tile). The accumulator holds
//     columns 2t and 2t + 1 of each 8-column group where the tf32 A
//     fragment holds k = t and t + 4, so P's
//     k-slice takes column 2t as k = t and 2t + 1 as k = t + 4, and the
//     pre-pass permutes V^T's tokens alike (position j of every 8-token
//     group holds token 2j for j < 4, token 2 (j - 4) + 1 else): no
//     shuffle. 3 kBN / 8 wgmma m64n{D}k8 (P_lo V_hi, P_hi V_lo,
//     P_hi V_hi), B = the V^T tile's hi or lo rows;
//   - kKvSplit = 2 (D = 160): the two consumers of a row group merge (m, l,
//     O) through shared memory at the end; the other rows divide O by l
//     and store it, rows >= Sq not stored.
// Per head dim (F32Cfg): D = 40: 3 row groups (192 rows), 64-token tiles,
// 6 units of 24 KB, 222,312 B of shared memory; D = 64: 3 row groups,
// 64-token tiles, 4 units of 32 KB, 230,472 B; D = 80: 3 row groups,
// 32-token tiles, 5 units of 20 KB, 226,392 B; D = 160: one row group of
// 64 rows whose KV tiles two consumers divide (the 80 KB hi/lo Q tile of
// a second row group leaves no room for a ring), 32-token tiles, 3 units
// of 40 KB, 205,880 B.
// Bound: 4 Sq Skv D flops per (batch, head) against (Sq + 2 Skv) 4 D bytes
// read and Sq 4 D written: compute bound at the path's lengths, as the 3 x
// 4 Sq Skv D TF32 flops the split runs at 495 TFLOP/s (chip_smoke.py's
// bound_ms), and read at the plain fp32 rate, 4 Sq Skv D flops at 67
// TFLOP/s of FFMA.
//
// Layout: tensors are (B, S, H, D) with arbitrary batch/sequence/head
// strides in elements (multiples of 4, with a 16-byte aligned base: the
// wrapper clones anything else) and unit stride along the head dim. The
// split tables live in the caller's workspace
// (tf_flash_attention_f32_workspace bytes).
#include <cuda.h>

#include "tf32.cuh"

namespace {

using namespace tf;

template <int D>
struct F32Cfg {
  static constexpr int kBN = D <= 64 ? 64 : 32;  // KV tokens per tile
  static constexpr int kRowGroups = D == 160 ? 1 : 3;  // 64 query rows each
  static constexpr int kKvSplit = D == 160 ? 2 : 1;  // consumers per row group
  static constexpr int kConsumers = kRowGroups * kKvSplit;
  static constexpr int kUnits = D == 40 ? 6 : D == 64 ? 4 : D == 80 ? 5 : 3;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kKSteps = D / 8;  // tf32 k-steps over D
  static constexpr int kSlices = kBN / 8;  // k-steps of P V
  static constexpr int kBoxes = (2 * D + kTf32BoxCols - 1) / kTf32BoxCols;  // [hi | lo]
  static constexpr uint32_t kQBoxBytes = 64 * kRowGroups * kSwizzleRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kQBoxBytes;
  static constexpr uint32_t kKBoxBytes = kBN * kSwizzleRowBytes;
  static constexpr uint32_t kKBytes = kBoxes * kKBoxBytes;
  static constexpr int kVTokenBoxes = kBN / kTf32BoxCols;  // per part
  static constexpr uint32_t kVBoxBytes = D * kSwizzleRowBytes;  // D rows x 32 tokens
  static constexpr uint32_t kVBytes = 2 * kVTokenBoxes * kVBoxBytes;
  static constexpr uint32_t kUnitBytes = kKBytes > kVBytes ? kKBytes : kVBytes;
  // dynamic shared memory from a 1024-aligned base: Q, the ring, then the
  // barriers: full_q, full[kUnits], empty[kUnits]
  static constexpr uint32_t kOffRing = kQBytes;
  static constexpr uint32_t kOffBar = kOffRing + kUnits * kUnitBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * kUnits) + 1024;
  static_assert(D % 8 == 0 && kBN % kTf32BoxCols == 0, "tiles");
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "register budget");
  static_assert(kKvSplit == 1 || 128 * (D / 2 + 4) * 4 <= kUnits * kUnitBytes,
                "the merge's (O, m, l) fit in the ring");
  static_assert(kKvSplit == 1 || kConsumers == 2, "the merge's named barriers count 256");
};

// P's k-slice s (S columns 8s .. 8s + 7) as the tf32 A fragment: a0 (row
// g, k = t), a1 (row g + 8, k = t), a2 (row g, k = t + 4), a3 (row g + 8,
// k = t + 4), with column 8s + 2t as k = t and 8s + 2t + 1 as k = t + 4;
// hi and lo parts
__device__ __forceinline__ void split_p(float c0, float c1, float c2, float c3,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float p[4] = {c0, c2, c1, c3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(p[i]);
    lo[i] = tf32_rna(__fsub_rn(p[i], __uint_as_float(hi[i])));
  }
}

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int sq,
              int skv, long long osb, long long oss, long long osh, float scale_log2) {
  using C = F32Cfg<D>;
  constexpr int kBN = C::kBN, kUnits = C::kUnits, kRowGroups = C::kRowGroups;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + C::kOffRing;
  const uint32_t bar_q = base + C::kOffBar;
  auto full = [&](int u) { return bar_q + 8u * (1 + u % kUnits); };
  auto empty = [&](int u) { return bar_q + 8u * (1 + kUnits + u % kUnits); };
  auto parity = [](int u) { return static_cast<uint32_t>((u / kUnits) & 1); };
  auto unit = [&](int u) { return ring + (u % kUnits) * C::kUnitBytes; };
  const int nkv = (skv + kBN - 1) / kBN;
  const int q0 = blockIdx.x * 64 * kRowGroups, h = blockIdx.y, b = blockIdx.z;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kUnits; ++s) {
      mbar_init(bar_q + 8u * (1 + s), 1);
      mbar_init(bar_q + 8u * (1 + kUnits + s), 4 * kRowGroups);
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
      for (int bx = 0; bx < C::kBoxes; ++bx)
        tma_load_4d(base + bx * C::kQBoxBytes, &tq, bar_q, kTf32BoxCols * bx, q0, h, b);
      for (int u = 0; u < 2 * nkv; ++u) {
        const int j = u >> 1;
        mbar_wait(empty(u), parity(u) ^ 1);
        if ((u & 1) == 0) {  // K tile j: its [hi | lo] columns
          mbar_expect_tx(full(u), C::kKBytes);
#pragma unroll
          for (int bx = 0; bx < C::kBoxes; ++bx)
            tma_load_4d(unit(u) + bx * C::kKBoxBytes, &tk, full(u), kTf32BoxCols * bx,
                        j * kBN, h, b);
        } else {  // V^T tile j: D hi rows, then D lo rows, 32 tokens a box
          mbar_expect_tx(full(u), C::kVBytes);
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int tb = 0; tb < C::kVTokenBoxes; ++tb)
              tma_load_4d(unit(u) + (part * C::kVTokenBoxes + tb) * C::kVBoxBytes, &tv,
                          full(u), j * kBN + kTf32BoxCols * tb, part * D, h, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    setmaxnreg_inc<C::kConsumerRegs>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int rg = wg % kRowGroups, ks = wg / kRowGroups;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t q_s = base + rg * 64 * kSwizzleRowBytes;  // in box 0

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBN / 2];
    float o_t[D / 2];  // one tile's P V
    uint32_t p_hi[C::kSlices][4], p_lo[C::kSlices][4];
    float m[2] = {neg_inf(), neg_inf()};  // running max, log2 domain
    float l[2] = {0.f, 0.f};  // per-thread partial row sums
    auto release = [&](int u) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(u));
    };
    // V^T tile's part (0 hi, 1 lo) at k-slice s: token box s / 4, 32 bytes
    // a slice inside it
    auto v_desc = [&](uint32_t v_s, int part, int s) {
      return kmajor_desc(v_s + (part * C::kVTokenBoxes + s / 4) * C::kVBoxBytes +
                         (s % 4) * 32);
    };

    mbar_wait(bar_q, 0);
    for (int j = ks; j < nkv; j += C::kKvSplit) {
      // S = Q K^T, cross terms first
      const int uk = 2 * j;
      mbar_wait(full(uk), parity(uk));
      const uint32_t k_s = unit(uk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk)
        wgmma_tf32_ss<kBN>(sc, tf32_desc(q_s, D + 8 * kk, C::kQBoxBytes),
                           tf32_desc(k_s, 8 * kk, C::kKBoxBytes), kk);
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk)
        wgmma_tf32_ss<kBN>(sc, tf32_desc(q_s, 8 * kk, C::kQBoxBytes),
                           tf32_desc(k_s, D + 8 * kk, C::kKBoxBytes), 1);
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk)
        wgmma_tf32_ss<kBN>(sc, tf32_desc(q_s, 8 * kk, C::kQBoxBytes),
                           tf32_desc(k_s, 8 * kk, C::kKBoxBytes), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(uk);

      // online softmax in the exp2 domain; the ragged tail is -inf. The
      // thread holds rows g (r = 0) and g + 8 (r = 1): sc[4n + 2r + e] at
      // column 8n + 2t + e
      const int kv0 = j * kBN;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = neg_inf();
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * n + 2 * r + e];
            x = kv0 + 8 * n + 2 * t + e < skv ? x * scale_log2 : neg_inf();
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);  // finite: a tile holds a token < skv
        const float corr = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n + 2 * r] *= corr;
          acc[4 * n + 2 * r + 1] *= corr;
        }
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * n + 2 * r + e];
            x = exp2f(x - m_new);
            l[r] += x;
          }
      }
#pragma unroll
      for (int s = 0; s < C::kSlices; ++s)
        split_p(sc[4 * s], sc[4 * s + 1], sc[4 * s + 2], sc[4 * s + 3], p_hi[s], p_lo[s]);

      // O += P V: the tile's product on the tensor cores from zero, cross
      // terms first, then added to O in fp32
      const int uv = 2 * j + 1;
      mbar_wait(full(uv), parity(uv));
      const uint32_t v_s = unit(uv);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C::kSlices; ++s)
        wgmma_tf32_rs<D>(o_t, p_lo[s], v_desc(v_s, 0, s), s);
#pragma unroll
      for (int s = 0; s < C::kSlices; ++s)
        wgmma_tf32_rs<D>(o_t, p_hi[s], v_desc(v_s, 1, s), 1);
#pragma unroll
      for (int s = 0; s < C::kSlices; ++s)
        wgmma_tf32_rs<D>(o_t, p_hi[s], v_desc(v_s, 0, s), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_t);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(uv);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += o_t[i];
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if constexpr (C::kKvSplit == 2) {
      // the row group's two consumers hold the same rows in the same
      // registers: the second hands (O, m, l) to the first through the
      // ring, which every load and product is done with after barrier 1
      float* buf = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
      named_bar_sync(1);
      if (ks == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) buf[i * 128 + tid] = acc[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          buf[(D / 2 + r) * 128 + tid] = m[r];
          buf[(D / 2 + 2 + r) * 128 + tid] = l[r];
        }
      }
      named_bar_sync(2);
      if (ks == 1) return;
      float c_own[2], c_peer[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_peer = buf[(D / 2 + r) * 128 + tid];  // -inf: no tile
        const float m_tot = fmaxf(m[r], m_peer);
        c_own[r] = exp2f(m[r] - m_tot);
        c_peer[r] = exp2f(m_peer - m_tot);
        l[r] = l[r] * c_own[r] + buf[(D / 2 + 2 + r) * 128 + tid] * c_peer[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int r = (i >> 1) & 1;
        acc[i] = acc[i] * c_own[r] + buf[i * 128 + tid] * c_peer[r];
      }
    }

    const int r0 = q0 + rg * 64 + warp * 16 + g, r1 = r0 + 8;
    float* ob = o + b * osb + h * osh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (r0 < sq)
        *reinterpret_cast<float2*>(ob + r0 * oss + col) =
            make_float2(acc[4 * n] / l[0], acc[4 * n + 1] / l[0]);
      if (r1 < sq)
        *reinterpret_cast<float2*>(ob + r1 * oss + col) =
            make_float2(acc[4 * n + 2] / l[1], acc[4 * n + 3] / l[1]);
    }
  }
}

// The V^T pre-pass: v (B, Skv, H, D), element strides (sb, ss, sh), into
// dst (B, H, 2D, skv8): row e < D holds dim e's hi parts, row D + e its lo
// parts; position 8n + j holds token 8n + 2j (j < 4) or 8n + 2 (j - 4) + 1
// (the P fragment's k order), tokens >= Skv zero. One block of 32 x 8
// threads per (32 tokens, head, batch) walks D in 32-dim tiles, read along
// D and written along the tokens.
__global__ void __launch_bounds__(256)
tf32_split_vt(const float* __restrict__ v, float* __restrict__ dst, int skv, int skv8,
              long long sb, long long ss, long long sh, int d) {
  __shared__ float tile[32][33];
  const int t0 = blockIdx.x * 32, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* src = v + b * sb + h * sh;
  const int p = tx & 7;
  const int src_tok = (tx & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
  const int pos = t0 + tx;
  float* out = dst + (static_cast<long long>(b) * gridDim.y + h) * 2 * d * skv8;
  for (int d0 = 0; d0 < d; d0 += 32) {
    if (d0 > 0) __syncthreads();  // the previous tile is read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = t0 + ty + 8 * i, dim = d0 + tx;
      tile[ty + 8 * i][tx] = tok < skv && dim < d ? src[tok * ss + dim] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dim = d0 + ty + 8 * i;
      if (dim < d && pos < skv8) {
        const float2 x = tf32_split(tile[src_tok][ty + 8 * i]);
        out[static_cast<long long>(dim) * skv8 + pos] = x.x;
        out[static_cast<long long>(d + dim) * skv8 + pos] = x.y;
      }
    }
  }
}

// the workspace of one call in floats: Q's and K's [hi | lo] tables and V^T
long long workspace_floats(int d, int batch, int heads, int sq, int skv) {
  const long long skv8 = (skv + 7) / 8 * 8;
  return 2ll * d * batch * heads * (static_cast<long long>(sq) + skv + skv8);
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o, int batch,
               int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb, long long vss,
               long long vsh, long long osb, long long oss, long long osh, float scale,
               float* ws, cudaStream_t stream) {
  using C = F32Cfg<D>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const int skv8 = (skv + 7) / 8 * 8;
  float* qt = ws;
  float* kt = qt + 2ll * D * batch * sq * heads;
  float* vt = kt + 2ll * D * batch * skv * heads;
  const long long q_rows = static_cast<long long>(batch) * sq * heads;
  const long long k_rows = static_cast<long long>(batch) * skv * heads;
  tf32_split_rows<<<split_blocks(q_rows * D / 4), 256, 0, stream>>>(
      q, qt, sq, heads, qsb, qss, qsh, D, D, q_rows);
  tf32_split_rows<<<split_blocks(k_rows * D / 4), 256, 0, stream>>>(
      k, kt, skv, heads, ksb, kss, ksh, D, D, k_rows);
  tf32_split_vt<<<dim3((skv8 + 31) / 32, heads, batch), dim3(32, 8), 0, stream>>>(
      v, vt, skv, skv8, vsb, vss, vsh, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap tq, tk, tv;
  const long long row = 2 * D;
  int rc = make_map_f32(&tq, encode, qt, row, sq, heads, batch, heads * row, row,
                        static_cast<long long>(sq) * heads * row, 64 * C::kRowGroups);
  if (rc == 0)
    rc = make_map_f32(&tk, encode, kt, row, skv, heads, batch, heads * row, row,
                      static_cast<long long>(skv) * heads * row, C::kBN);
  if (rc == 0)
    rc = make_map_f32(&tv, encode, vt, skv8, row, heads, batch, skv8, row * skv8,
                      heads * row * skv8, D);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + 64 * C::kRowGroups - 1) / (64 * C::kRowGroups), heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_f32<D><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, o, sq, skv, osb, oss, osh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of workspace tf_flash_attention_f32 needs for these sizes: the
// split tables of Q, K and V^T.
extern "C" long long tf_flash_attention_f32_workspace(int head_dim, int batch, int heads,
                                                      int sq, int skv) {
  return 4 * workspace_floats(head_dim, batch, heads, sq, skv);
}

// K1 in fp32: launches the split pre-pass and the kernel on `stream` for
// head dim 40, 64, 80 or 160, with the bf16 entry point's arguments
// (tf_flash_attention) and a workspace of
// tf_flash_attention_f32_workspace bytes (16-byte aligned); returns 0, a
// cudaError_t of a launch, or a negative code (tf_error_string).
extern "C" int tf_flash_attention_f32(
    int head_dim, const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale,
    void* workspace, void* stream) {
#define TF_FLASH_F32_ARGS                                                          \
  static_cast<const float*>(q), static_cast<const float*>(k),                     \
      static_cast<const float*>(v), static_cast<float*>(o), batch, heads, sq, skv, \
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, scale,           \
      static_cast<float*>(workspace), static_cast<cudaStream_t>(stream)
  switch (head_dim) {
    case 40: return launch_f32<40>(TF_FLASH_F32_ARGS);
    case 64: return launch_f32<64>(TF_FLASH_F32_ARGS);
    case 80: return launch_f32<80>(TF_FLASH_F32_ARGS);
    case 160: return launch_f32<160>(TF_FLASH_F32_ARGS);
    default: return tf::kErrHeadDim;
  }
#undef TF_FLASH_F32_ARGS
}

