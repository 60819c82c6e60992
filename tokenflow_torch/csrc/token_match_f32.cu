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
// Design: a GEMM on the tensor cores as 3xTF32 splits (tf32.cuh: hi =
// rna(x), lo = rna(x - hi), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the
// cross terms of each 32-dim chunk before its hi hi term), fp32-class
// error, whose epilogue is a running first argmax:
//   - pre-pass: x (F, S, D) and p_hat (K, S, D) become tables of rows [hi
//     (Dp) | lo (Dp)], Dp = D rounded up to 32 and zero-filled
//     (tf32_split_rows); p_hat's is made once per call and shared by all F
//     frames;
//   - one block per (64 C query rows, frame, cluster rank): a producer
//     warpgroup (one thread issues the TMA loads; setmaxnreg hands its
//     registers to the consumers) and C consumer warpgroups of 64 rows;
//   - the query tile does not stay resident: its hi and lo parts cost 64 D
//     8 bytes a consumer, 160 KB at D = 320 (one consumer's rows beside a
//     ring) and more than 227 KB at D >= 640. At every width the path has
//     (320, 640, 1280) the query streams along D with the pivot tokens: a
//     stage holds one 32-dim chunk (one 128-byte swizzle row of fp32) of
//     the query rows' hi and lo parts and of both pivots' 128-token z tile,
//     hi and lo: 16 C + 64 KB, two stages (224 KB at C = 3). A "full"
//     mbarrier per stage (TMA transaction count) and an "empty" one that
//     every consumer warp arrives on pace the ring, as in K1;
//   - a consumer runs wgmma m64n128k8 tf32, both operands from shared
//     memory and K-major (the query chunk as A, the pivot box as B), 3 x 4
//     products per pivot and chunk into acc_a and acc_b (one commit group
//     per chunk; the stage of the chunk before is freed once only this
//     chunk's group is pending). After the tile's last chunk both
//     accumulators fold into the running first maxima;
//   - the first-max fold is the bf16 core's (the wgmma accumulator layout:
//     the thread holds rows g and g + 8 of its warp's 16, acc[4n + e] and
//     acc[4n + 2 + e] at column 8n + 2t + e): an ascending scan with '>'
//     inside the thread, the lower index on ties across the quad, a strict
//     '>' against the earlier z tiles; columns >= s_len (TMA's zero-filled
//     tail) are masked out, never compared as zero similarities;
//   - filling the card at small S: a thread-block cluster of CL CTAs
//     (chosen by the launcher from the CTA count and the z tiles) divides
//     the z tiles (rank r takes tiles r, r + CL, ...); each CTA posts its
//     rows' (value, index) pairs in shared memory and, after a cluster
//     barrier, every CTA merges all CL pairs in rank order through
//     distributed shared memory: the larger value wins, on equal values
//     the smaller index, so the result is jnp.argmax's first maximum
//     whatever the split;
//   - the gather + blend is the epilogue: the merged indices go to shared
//     memory, then CTA r reads the matched kf rows of every stream for rows
//     r, r + CL, ... as 16-byte loads, blends in fp32 with the roundings of
//     the plain version (no contraction into an fma) and stores them. With
//     out null the kernel writes the indices only (the match timed alone).
// Query rows per block: C = 3 (192 rows) for S >= 1024, else C = 1 (more
// CTAs at the small sites); the cluster grows (up to 4) while the CTAs
// fall short of the 132 SMs and each CTA keeps a z tile.
// Bound: 4 S^2 D flops per frame, as the 3 x 4 S^2 D TF32 flops the split
// runs at 495 TFLOP/s (chip_smoke.py's bound_ms), and read at the plain
// fp32 rate, at 67 TFLOP/s of FFMA (the tables are read once from HBM at
// 4 S D bytes per frame and pivot; the gather moves 3 ns S D * 4 bytes
// per frame).
#include <cuda.h>

#include "tf32.cuh"

namespace {

constexpr int kZ = 128;  // pivot tokens per z tile (the wgmma N)
constexpr uint32_t kPBoxBytes = kZ * tf::kSwizzleRowBytes;  // 16 KB
constexpr int kM32Stages = 2;
constexpr int kM32MaxCluster = 4;
constexpr int kM32ProducerRegs = 24;

template <int C>
struct M32Shape {
  static constexpr int kRegs = C == 3 ? 160 : 240;
  static constexpr uint32_t kXBoxBytes = 64 * C * tf::kSwizzleRowBytes;
  // x hi, x lo, pivot a hi, lo, pivot b hi, lo
  static constexpr uint32_t kStageBytes = 2 * kXBoxBytes + 4 * kPBoxBytes;
  static constexpr uint32_t kSmemBytes = kM32Stages * kStageBytes + 8 * 2 * kM32Stages + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(128 * (kM32ProducerRegs + C * kRegs) <= 65536, "register budget");
  // the merge's (value, index) pairs and the merged indices reuse stage 0
  static_assert(64 * C * (16 + 8) <= kStageBytes, "merge slots");
};

// this CTA's shared address `addr` in the cluster's CTA `rank`, 16 bytes
__device__ __forceinline__ float4 ld_peer_f4(uint32_t addr, uint32_t rank) {
  uint32_t peer;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(peer) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(peer)
               : "memory");
  return v;
}

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
  for (int n = 0; n < kZ / 8; ++n)
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
                                     float& best0, int& idx0, float& best1, int& idx1) {
  if (z0 + kZ <= s_len)
    fold_tile<false>(acc, z0, 0, t, best0, idx0, best1, idx1);
  else
    fold_tile<true>(acc, z0, s_len - z0 - 2 * t, t, best0, idx0, best1, idx1);
}

// acc (+)= x . p over one 32-dim chunk: x_lo p_hi, x_hi p_lo, then x_hi
// p_hi, four k-steps of 8 dims each; the chunk's first product starts the
// sum afresh when `first`
__device__ __forceinline__ void chunk_products(float (&acc)[64], uint32_t x_hi,
                                               uint32_t x_lo, uint32_t p_hi, uint32_t p_lo,
                                               bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tf::wgmma_tf32_ss<kZ>(acc, tf::kmajor_desc(x_lo + 32 * kk),
                          tf::kmajor_desc(p_hi + 32 * kk), !(first && kk == 0));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tf::wgmma_tf32_ss<kZ>(acc, tf::kmajor_desc(x_hi + 32 * kk),
                          tf::kmajor_desc(p_lo + 32 * kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tf::wgmma_tf32_ss<kZ>(acc, tf::kmajor_desc(x_hi + 32 * kk),
                          tf::kmajor_desc(p_hi + 32 * kk), 1);
}

// named barrier 1 across the C consumer warpgroups (the producer has exited)
__device__ __forceinline__ void consumers_sync(int c) {
  asm volatile("bar.sync 1, %0;" ::"r"(128 * c) : "memory");
}

// tx: 4-D map of x's table (F, S, 2 dp) as (2 dp, S, 1, F), boxes of 64 C
// rows; tp: of p_hat's (K, S, 2 dp), boxes of kZ tokens. Writes
// out_a[f * s_len + s], out_b[f * s_len + s] and, unless out is null, out
// (ns, F, S, D) from kf (ns, K, S, D).
template <int C>
__global__ void __launch_bounds__(128 * (1 + C), 1)
match_core_f32(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tp, const int* __restrict__ pa,
               const int* __restrict__ pb, int* __restrict__ out_a,
               int* __restrict__ out_b, const float* __restrict__ kf,
               const float* __restrict__ w1, float* __restrict__ out, int ns, int n_piv,
               int s_len, int d, int dp) {
  using Sh = M32Shape<C>;
  constexpr uint32_t kXBox = Sh::kXBoxBytes, kStage = Sh::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tf::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kM32Stages * kStage;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kM32Stages + s); };
  const uint32_t rank = tf::cluster_ctarank(), n_cta = tf::cluster_nctarank();
  const int q0 = (blockIdx.x / n_cta) * 64 * C, f = blockIdx.y;
  const int nz = (s_len + kZ - 1) / kZ, nd = dp / tf::kTf32BoxCols;
  const int piv_a = pa[f], piv_b = pb[f];

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kM32Stages; ++s) {
      tf::mbar_init(full(s), 1);
      tf::mbar_init(empty(s), 4 * C);
    }
    tf::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    tf::setmaxnreg_dec<kM32ProducerRegs>();
    if (threadIdx.x == 0) {
      int i = 0;
      for (int j = rank; j < nz; j += n_cta)
        for (int c = 0; c < nd; ++c, ++i) {
          const int s = i % kM32Stages;
          const uint32_t st = base + s * kStage;
          const int col = c * tf::kTf32BoxCols;
          tf::mbar_wait(empty(s), ((i / kM32Stages) & 1) ^ 1);
          tf::mbar_expect_tx(full(s), kStage);
          tf::tma_load_4d(st, &tx, full(s), col, q0, 0, f);
          tf::tma_load_4d(st + kXBox, &tx, full(s), dp + col, q0, 0, f);
          tf::tma_load_4d(st + 2 * kXBox, &tp, full(s), col, j * kZ, 0, piv_a);
          tf::tma_load_4d(st + 2 * kXBox + kPBoxBytes, &tp, full(s), dp + col, j * kZ, 0,
                          piv_a);
          tf::tma_load_4d(st + 2 * kXBox + 2 * kPBoxBytes, &tp, full(s), col, j * kZ, 0,
                          piv_b);
          tf::tma_load_4d(st + 2 * kXBox + 3 * kPBoxBytes, &tp, full(s), dp + col, j * kZ, 0,
                          piv_b);
        }
    }
    return;  // the cluster barriers below count the threads that have not exited
  }

  // ---- consumer warpgroups: 64 query rows each ----
  tf::setmaxnreg_inc<M32Shape<C>::kRegs>();
  const int wg = (threadIdx.x >> 7) - 1, ct = threadIdx.x - 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // running first maxima of rows g and g + 8 against pivots a and b
  float best_a0 = tf::neg_inf(), best_a1 = tf::neg_inf();
  float best_b0 = tf::neg_inf(), best_b1 = tf::neg_inf();
  int ia0 = 0, ia1 = 0, ib0 = 0, ib1 = 0;
  {
    float acc_a[64], acc_b[64];
    int i = 0, prev = -1;  // chunks issued; stage of the chunk before
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) tf::mbar_arrive(empty(s));
    };
    for (int j = rank; j < nz; j += n_cta) {
      for (int c = 0; c < nd; ++c, ++i) {
        const int s = i % kM32Stages;
        const uint32_t st = base + s * kStage;
        const uint32_t xs = st + wg * 64 * tf::kSwizzleRowBytes;
        const uint32_t ps = st + 2 * kXBox;
        tf::mbar_wait(full(s), (i / kM32Stages) & 1);
        tf::wgmma_fence();
        chunk_products(acc_a, xs, xs + kXBox, ps, ps + kPBoxBytes, c == 0);
        chunk_products(acc_b, xs, xs + kXBox, ps + 2 * kPBoxBytes, ps + 3 * kPBoxBytes,
                       c == 0);
        tf::wgmma_commit();
        tf::wgmma_wait<1>();  // the chunk before is done
        if (prev >= 0) release(prev);
        prev = s;
      }
      tf::wgmma_wait<0>();
      release(prev);
      prev = -1;
      tf::fence_regs(acc_a);
      tf::fence_regs(acc_b);
      fold(acc_a, j * kZ, s_len, t, best_a0, ia0, best_a1, ia1);
      fold(acc_b, j * kZ, s_len, t, best_b0, ib0, best_b1, ib1);
    }
  }
  consumers_sync(C);  // every load and product is done: stage 0 is free

  // the cluster's merge: each CTA posts (value, index) of both pivots per
  // row, then reads every CTA's in rank order
  float4* res = reinterpret_cast<float4*>(smem_raw + (base - tf::smem_u32(smem_raw)));
  int* slot = reinterpret_cast<int*>(res + 64 * C);
  if (t == 0) {
    const int row = wg * 64 + warp * 16 + g;
    res[row] = make_float4(best_a0, __int_as_float(ia0), best_b0, __int_as_float(ib0));
    res[row + 8] = make_float4(best_a1, __int_as_float(ia1), best_b1, __int_as_float(ib1));
  }
  tf::cluster_arrive();
  tf::cluster_wait();
  if (ct < 64 * C) {
    const uint32_t addr = base + ct * 16;
    float va = tf::neg_inf(), vb = tf::neg_inf();
    int xa = 0, xb = 0;
    for (uint32_t q = 0; q < n_cta; ++q) {
      const float4 r = ld_peer_f4(addr, q);
      const int ra = __float_as_int(r.y), rb = __float_as_int(r.w);
      if (q == 0 || r.x > va || (r.x == va && ra < xa)) { va = r.x; xa = ra; }
      if (q == 0 || r.z > vb || (r.z == vb && rb < xb)) { vb = r.z; xb = rb; }
    }
    slot[2 * ct] = xa;
    slot[2 * ct + 1] = xb;
  }
  tf::cluster_arrive();  // done with the peers' shared memory (waited at exit)
  consumers_sync(C);

  // CTA `rank` stores rows rank, rank + n_cta, ... of this row tile
  const int n_rows = min(64 * C, s_len - q0);
  const int my_rows = n_rows > static_cast<int>(rank)
                          ? (n_rows - static_cast<int>(rank) + n_cta - 1) / n_cta
                          : 0;
  for (int m = ct; m < my_rows; m += 128 * C) {
    const int r = rank + m * n_cta;
    out_a[(long long)f * s_len + q0 + r] = slot[2 * r];
    out_b[(long long)f * s_len + q0 + r] = slot[2 * r + 1];
  }
  if (out != nullptr) {
    const long long plane = (long long)s_len * d;
    const int chunks = d / 4, per_row = ns * chunks;
    const float* kfa = kf + piv_a * plane;
    const float* kfb = kf + piv_b * plane;
    float* of = out + ((long long)f * s_len + q0) * d;
    const float w = w1[f];
    const float wb = __fsub_rn(1.f, w);
    for (int it = ct; it < my_rows * per_row; it += 128 * C) {
      const int m = it / per_row, rem = it - m * per_row;
      const int r = rank + m * n_cta;
      const int c = rem / chunks, e4 = (rem - c * chunks) * 4;
      const long long cs = c * n_piv * plane;
      const float4 va =
          *reinterpret_cast<const float4*>(kfa + cs + (long long)slot[2 * r] * d + e4);
      const float4 vb =
          *reinterpret_cast<const float4*>(kfb + cs + (long long)slot[2 * r + 1] * d + e4);
      // no contraction into an fma: the same roundings as the plain version
      float4 o;
      o.x = __fadd_rn(__fmul_rn(w, va.x), __fmul_rn(wb, vb.x));
      o.y = __fadd_rn(__fmul_rn(w, va.y), __fmul_rn(wb, vb.y));
      o.z = __fadd_rn(__fmul_rn(w, va.z), __fmul_rn(wb, vb.z));
      o.w = __fadd_rn(__fmul_rn(w, va.w), __fmul_rn(wb, vb.w));
      *reinterpret_cast<float4*>(of + c * gridDim.y * plane + (long long)r * d + e4) = o;
    }
  }
  tf::cluster_wait();
}

// the workspace of one call in floats: x's and p_hat's [hi | lo] tables
long long workspace_floats(int f_total, int n_piv, int s_len, int d) {
  const long long dp = (d + tf::kTf32BoxCols - 1) / tf::kTf32BoxCols * tf::kTf32BoxCols;
  return 2 * dp * s_len * (static_cast<long long>(f_total) + n_piv);
}

template <int C>
int launch_core_f32(tf::EncodeTiledFn encode, const float* x, const float* phat,
                    const float* kf, const int* pa, const int* pb, const float* w1,
                    int* out_a, int* out_b, float* out, int ns, int f_total, int n_piv,
                    int s_len, int d, float* ws, cudaStream_t stream) {
  using Sh = M32Shape<C>;
  const int dp = (d + tf::kTf32BoxCols - 1) / tf::kTf32BoxCols * tf::kTf32BoxCols;
  float* xt = ws;
  float* pt = xt + 2ll * dp * s_len * f_total;
  const long long plane = static_cast<long long>(s_len) * d;
  const long long x_rows = static_cast<long long>(f_total) * s_len;
  const long long p_rows = static_cast<long long>(n_piv) * s_len;
  tf32_split_rows<<<split_blocks(x_rows * dp / 4), 256, 0, stream>>>(
      x, xt, s_len, 1, plane, d, 0, d, dp, x_rows);
  tf32_split_rows<<<split_blocks(p_rows * dp / 4), 256, 0, stream>>>(
      phat, pt, s_len, 1, plane, d, 0, d, dp, p_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long row = 2 * dp, table = row * s_len;
  CUtensorMap tx, tp;
  int rc = tf::make_map_f32(&tx, encode, xt, row, s_len, 1, f_total, row, table, table,
                            64 * C);
  if (rc == 0)
    rc = tf::make_map_f32(&tp, encode, pt, row, s_len, 1, n_piv, row, table, table, kZ);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(match_core_f32<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Sh::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the cluster: grow while the CTAs fall short of the SMs and every CTA
  // keeps a z tile of its own
  const int row_tiles = (s_len + 64 * C - 1) / (64 * C);
  const int nz = (s_len + kZ - 1) / kZ;
  int cluster = 1;
  while (cluster * 2 <= kM32MaxCluster && cluster * 2 <= nz &&
         static_cast<long long>(row_tiles) * f_total * cluster < 132)
    cluster *= 2;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(row_tiles * cluster, f_total);
  cfg.blockDim = dim3(128 * (1 + C));
  cfg.dynamicSmemBytes = Sh::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one CTA: its implicit one-CTA cluster
  err = cudaLaunchKernelEx(&cfg, match_core_f32<C>, tx, tp, pa, pb, out_a, out_b, kf, w1, out,
                           ns, n_piv, s_len, d, dp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of workspace tf_token_match_f32 needs for these sizes: the split
// tables of x and p_hat.
extern "C" long long tf_token_match_f32_workspace(int f_total, int n_piv, int s_len, int d) {
  return 4 * workspace_floats(f_total, n_piv, s_len, d);
}

// K2 and K3 in fp32: indices into out_a and out_b, (F, S) int32 each, and,
// unless out is null, the blended rows into out (ns, F, S, D). n_piv is the
// pivot count K of p_hat (K, S, D) and kf (ns, K, S, D); the tables are
// contiguous and 16-byte aligned, D % 8 == 0. workspace holds
// tf_token_match_f32_workspace bytes (16-byte aligned). Returns 0, a
// cudaError_t of a launch, or a negative tensor-map code (tf_error_string).
extern "C" int tf_token_match_f32(const void* x, const void* phat, const void* kf,
                                  const int* pa, const int* pb, const float* w1,
                                  int* out_a, int* out_b, void* out, int ns, int f_total,
                                  int n_piv, int s_len, int d, void* workspace,
                                  void* stream) {
  const tf::EncodeTiledFn encode = tf::encode_tiled();
  if (encode == nullptr) return tf::kErrNoEncoder;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TF_MATCH_F32_ARGS                                                               \
  encode, static_cast<const float*>(x), static_cast<const float*>(phat),               \
      static_cast<const float*>(kf), pa, pb, w1, out_a, out_b, static_cast<float*>(out), \
      ns, f_total, n_piv, s_len, d, static_cast<float*>(workspace), st
  return s_len >= 1024 ? launch_core_f32<3>(TF_MATCH_F32_ARGS)
                       : launch_core_f32<1>(TF_MATCH_F32_ARGS);
#undef TF_MATCH_F32_ARGS
}
