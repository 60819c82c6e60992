// K7: the GEGLU feed-forward's first projection with its activation, for
// Hopper (sm_90a), bf16 in/out. For x (M, K), the ff.net.0.proj weight W
// (2N, K) as nn.Linear holds it ([hidden | gate] rows) and its bias b (2N):
//
//   out[m, j] = (x . W[j] + b[j]) * gelu_erf(x . W[N + j] + b[N + j]),  j < N,
//
// written as (M, N) bf16. Products summed in fp32, both biases added in
// fp32, the exact (erf) GELU and the product in fp32, one rounding to bf16.
//
// It replaces no TPU kernel: the JAX package leaves the GEGLU to XLA
// (tokenflow_tpu/models/layers.py, GEGLUFeedForward), and the port ran it
// as F.linear into an (M, 2N) bf16 tensor, a GELU pass over the gate half
// and a product pass (models/layers.py's plain version, kernels/geglu.py
// geglu_plain): five (M, N) bf16 tensors through device memory a block,
// each rounded to bf16. Here the (M, 2N) projection never leaves the chip.
//
// What bounds it: operations. The projection does 4 M N K flops against
// 2 (M K + 2 N K + M N) bytes: at K = 320, N = 1280 (SD's 64^2 level) about
// 490 flops a byte, above the card's 295; deeper K more.
//
// Design:
//   - persistent blocks, one per SM, each walking output tiles c, c + grid,
//     ... of 128 rows of x by kN output columns, which take kN rows of the
//     hidden half of W and the same kN rows of the gate half (the weight as
//     it lies, no re-layout). The tile order walks N within a group of
//     kGroupRows rows, so the group's x rows stay in L2 while every W tile
//     passes over them;
//   - a producer warpgroup (one thread issues the TMA loads; the warpgroup
//     gives its registers to the consumers, setmaxnreg) keeps a ring of
//     stages full: per stage one box of x (128 rows x 64 of K) and two of W
//     (rows n0 .. n0 + kN - 1 and N + n0 .. N + n0 + kN - 1), laid one after
//     the other, so the two W boxes are one 2kN-row K-major operand;
//   - two consumer warpgroups share every tile, 64 rows each, cooperative:
//     one m64n(2kN)k16 wgmma per k-step from shared memory into one fp32
//     accumulator whose columns 0 .. kN - 1 are the hidden half and kN ..
//     2kN - 1 the gate half, so every thread holds the hidden and gate
//     values of the same outputs. At kN = 128 a block's stage is 128 x 256
//     of output per 48 KB, the least shared-memory traffic a flop that 128
//     accumulator registers a thread allow. Two consumers each owning a
//     whole 128 x (64 + 64) tile and taking turns on the tensor cores
//     (ping-pong, so one's epilogue runs under the other's products) were
//     slower on an H100 at 700 W: 2.17 against 1.88 ms at 491,520 x 320 ->
//     2560, 1.34 against 1.20 at 30,720 x 1280 -> 10240; their stages feed a
//     quarter fewer flops a byte;
//   - epilogue: both biases, the exact GELU (erff) and the product in fp32
//     registers, one bf16 rounding, the consumer's 64 x kN tile written into
//     its shared-memory buffer in the 128-byte swizzle (conflict-free) and
//     stored by TMA, while the producer already loads the next tile's
//     stages; TMA zero-fills x's rows past M on the loads and clips them on
//     the stores. At K = 320 the epilogue (about 26 instructions an output)
//     is about 30% of a tile's time;
//   - two plans by shape, the wrapper's choice (kernels/geglu.py plan):
//     kN = 128 (4 stages of 48 KB) unless its tiles make fewer than a few
//     waves over the SMs, then kN = 64 (6 stages of 32 KB): the pivotal
//     pass's 960-row 8^2 level.
// K is a multiple of 64 and N of kN; the wrapper admits the UNets' widths.
// The kernel is named geglu_gemm, so a trace files it with the matmuls.
#include <cuda.h>
#include <stdio.h>

#include <atomic>

#include "common.cuh"

namespace {

using namespace tf;

template <int kN>
struct GegluCfg {
  static constexpr int kBM = 128;  // x rows of a tile, 64 a consumer
  static constexpr int kBK = 64;   // K of a stage: one 128-byte swizzle row
  static constexpr int kThreads = 384;  // a producer and two consumer warpgroups
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kGroupRows = 2048;  // x rows of a tile group
  static constexpr int kGroup = kGroupRows / kBM;
  static constexpr uint32_t kRowBytes = kSwizzleRowBytes;
  static constexpr uint32_t kABytes = kBM * kRowBytes;    // the x box of a stage
  static constexpr uint32_t kWBoxBytes = kN * kRowBytes;  // one W box (hidden or gate)
  static constexpr uint32_t kStageBytes = kABytes + 2 * kWBoxBytes;
  static constexpr int kOutBoxes = kN / 64;  // 64-column boxes of a consumer's output
  static constexpr uint32_t kOutBoxBytes = 64 * kRowBytes;
  static constexpr uint32_t kOutBytes = kOutBoxes * kOutBoxBytes;  // a consumer's buffer
  static constexpr uint32_t kMaxSmem = 232448;
  static constexpr int kStages =
      static_cast<int>((kMaxSmem - 2 * kOutBytes - 1024 - 256) / kStageBytes);
  // from a 1024-aligned base: the stages, the consumers' output buffers,
  // then the barriers full[kStages], empty[kStages]
  static constexpr uint32_t kOffOut = kStages * kStageBytes;
  static constexpr uint32_t kOffBar = kOffOut + 2 * kOutBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 16 * kStages + 1024;
  static_assert(kN == 64 || kN == 128, "64 or 128 output columns a tile");
  static_assert(kStageBytes % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(kStages >= 4, "pipeline depth");
  static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536, "register budget");
  static_assert(kSmemBytes <= kMaxSmem, "shared memory");
};

// exact GELU, F.gelu's order: x * 0.5 * (1 + erf(x / sqrt 2))
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// d (64 x 2kN, fp32) = A (64 x 16) . B (16 x 2kN) + (accumulate ? d : 0)
template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (kN == 128) wgmma_m64n256k16_ss(d, da, db, accumulate);
  if constexpr (kN == 64) wgmma_m64n128k16_ss(d, da, db, accumulate);
}

template <int kN>
__global__ void __launch_bounds__(GegluCfg<kN>::kThreads, 1)
geglu_gemm(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
           const __grid_constant__ CUtensorMap tout, const uint32_t* __restrict__ bias2,
           int m, int k, int n) {
  using C = GegluCfg<kN>;
  constexpr int kS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kOffBar;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kS + s); };
  auto parity = [](int i) { return static_cast<uint32_t>((i / kS) & 1); };
  const int mblocks = (m + C::kBM - 1) / C::kBM;
  const int nblocks = n / kN;
  const int nk = k / C::kBK;
  const long long tiles = static_cast<long long>(mblocks) * nblocks;
  const int mine = static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // this block's tile j -> its first row m0 and first output column n0:
  // groups of kGroup row blocks, each walked column block by column block
  auto tile = [&](int j, int& m0, int& n0) {
    const long long t = blockIdx.x + static_cast<long long>(j) * gridDim.x;
    const long long per_group = static_cast<long long>(C::kGroup) * nblocks;
    const int grp = static_cast<int>(t / per_group);
    const int within = static_cast<int>(t - grp * per_group);
    const int rows = min(C::kGroup, mblocks - grp * C::kGroup);
    m0 = (grp * C::kGroup + within % rows) * C::kBM;
    n0 = (within / rows) * kN;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // both consumers' four warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages loaded so far
      for (int j = 0; j < mine; ++j) {
        int m0, n0;
        tile(j, m0, n0);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % kS;
          const uint32_t st = base + s * C::kStageBytes;
          mbar_wait(empty(s), parity(it) ^ 1);
          mbar_expect_tx(full(s), C::kStageBytes);
          tma_load_4d(st, &tx, full(s), kb * C::kBK, m0, 0, 0);
          tma_load_4d(st + C::kABytes, &tw, full(s), kb * C::kBK, n0, 0, 0);
          tma_load_4d(st + C::kABytes + C::kWBoxBytes, &tw, full(s), kb * C::kBK, n + n0, 0,
                      0);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows of every tile each ----
    setmaxnreg_inc<C::kConsumerRegs>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t out_s = base + C::kOffOut + wg * C::kOutBytes;
    float acc[kN];  // 64 rows: hidden columns 0 .. kN - 1, gate kN .. 2kN - 1
    auto release = [&](int s) {  // this warp is done with stage s
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };

    int it = 0;  // stages consumed so far
    for (int j = 0; j < mine; ++j) {
      int m0, n0;
      tile(j, m0, n0);
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % kS;
        const uint32_t st = base + s * C::kStageBytes;
        mbar_wait(full(s), parity(it));
        wgmma_fence();
        // k-step kk reads byte 32 kk of every swizzle row; this consumer's
        // rows of x start 64 wg rows in
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kN>(acc, kmajor_desc(st + wg * 64 * C::kRowBytes + kk * 32),
                       kmajor_desc(st + C::kABytes + kk * 32), kb | kk);
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          release((it - 1) % kS);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % kS);

      // out = (h + b_h) gelu(g + b_g) -> bf16 -> this consumer's buffer in
      // the output map's 128-byte swizzle (16-byte chunk c of row r at
      // chunk c ^ (r % 8)), then TMA stores; the buffer's previous stores
      // must have read it first
      const int row0 = m0 + wg * 64;
      if (tid == 0) bulk_wait_read<0>();
      named_bar_sync(1 + wg, 128);
      const int r0 = warp * 16 + g;  // and r0 + 8, in the same swizzle phase
      const uint32_t swz = static_cast<uint32_t>(g) << 4;
#pragma unroll
      for (int c = 0; c < kN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * t;
        const float2 fh = bf16x2_to_f2(__ldg(bias2 + col / 2));
        const float2 fg = bf16x2_to_f2(__ldg(bias2 + (n + col) / 2));
        const uint32_t at = out_s + (c / 8) * C::kOutBoxBytes +
                            ((static_cast<uint32_t>(c % 8) << 4) ^ swz) + 4 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float h0 = acc[4 * c + 2 * r] + fh.x;
          const float h1 = acc[4 * c + 2 * r + 1] + fh.y;
          const float g0 = acc[kN / 2 + 4 * c + 2 * r] + fg.x;
          const float g1 = acc[kN / 2 + 4 * c + 2 * r + 1] + fg.y;
          st_shared_u32(at + (r0 + 8 * r) * C::kRowBytes,
                        tf::pack_bf16(h0 * gelu_erf(g0), h1 * gelu_erf(g1)));
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (tid == 0 && row0 < m) {
#pragma unroll
        for (int bx = 0; bx < C::kOutBoxes; ++bx)
          tma_store_4d(&tout, out_s + bx * C::kOutBoxBytes, n0 + 64 * bx, row0, 0, 0);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

// raises geglu_gemm<kN>'s dynamic shared memory limit on device dev on its
// first launch there (a bit per device)
template <int kN>
cudaError_t allow_smem(int dev) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(geglu_gemm<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           GegluCfg<kN>::kSmemBytes);
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

template <int kN>
int launch(int dev, const void* x, const void* w, const void* bias, void* out, int m, int k,
           int n, void* stream) {
  using C = GegluCfg<kN>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const long long mk = static_cast<long long>(m) * k, nk2 = 2ll * n * k;
  const long long mn = static_cast<long long>(m) * n;
  CUtensorMap tx, tw, to;
  int rc = make_map(&tx, encode, x, k, m, 1, 1, mk, k, mk, C::kBM);
  if (rc == 0) rc = make_map(&tw, encode, w, k, 2 * n, 1, 1, nk2, k, nk2, kN);
  if (rc == 0) rc = make_map(&to, encode, out, n, m, 1, 1, mn, n, mn, 64);
  if (rc != 0) return rc;
  const cudaError_t attr = allow_smem<kN>(dev);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = static_cast<long long>((m + C::kBM - 1) / C::kBM) * (n / kN);
  const long long sms = sm_count(dev);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  geglu_gemm<kN><<<grid, C::kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, to, static_cast<const uint32_t*>(bias), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` with tiles of `cols` (128 or 64) output columns: x
// (m, k), w (2n, k) and bias (2n) bf16, contiguous, 16-byte aligned; out
// (m, n) bf16. k is a multiple of 64, n of cols, and m > 0. Returns 0 on success, a
// cudaError_t of the launch, or a negative code for a refused tensor map
// (tf_error_string).
extern "C" int tf_geglu_gemm(const void* x, const void* w, const void* bias, void* out, int m,
                             int k, int n, int cols, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 64 || cols <= 0 || n % cols)
    return cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cols) {
    case 128: return launch<128>(dev, x, w, bias, out, m, k, n, stream);
    case 64: return launch<64>(dev, x, w, bias, out, m, k, n, stream);
    default: return cudaErrorInvalidValue;
  }
}
