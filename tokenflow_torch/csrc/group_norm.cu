// GroupNorm (+ optional SiLU) for Hopper (sm_90a): bf16 or fp32 activations
// and affine parameters of one dtype, fp32 statistics and affine
// arithmetic, the output in the input dtype.
//
// Replaces the Pallas TPU kernels of tokenflow_tpu/kernels/group_norm.py
// (_group_norm_3d: the stats pallas_call, then the apply pallas_call):
//   mean = E[x], var = E[x^2] - E[x]^2 over one (batch, group) in fp32,
//   a[c] = gamma[c] / sqrt(var + eps), b[c] = beta[c] - mean * a[c],
//   y = x * a[c] + b[c], then y * sigmoid(y) when SiLU is fused.
// The port's activations are NCHW, so one (batch, group) is one contiguous
// span of (C / G) * H * W elements and the TPU's "bl"/"cl" transposes have
// no counterpart.
//
// Bound: memory bandwidth (a few flops per element); the least traffic is
// one read and one write of the activation. Two variants, chosen by the
// wrapper's plan (kernels/group_norm.py::plan) from the shape and dtype
// alone and validated here:
//   - cluster (one pass, every span that fits on chip: every UNet site at
//     512^2 and 768^2, the VAE up to 192^2): a span is cut into `cluster`
//     slices of `slice` elements, one CTA each; the CTAs of a span form one
//     thread-block cluster (2, 4, 8, or 16 with the non-portable size
//     allowed), or run alone when one CTA holds the span. A CTA's thread 0
//     issues 1-D bulk copies (TMA) of its whole slice into shared memory at
//     once, in pieces of `piece` elements each completing on its own
//     mbarrier, so all the slice's bytes are in flight together; the warps
//     sum (x, x^2) piece by piece as each lands and reduce to one partial
//     per CTA. After a cluster barrier every CTA reads the cluster's
//     partials through distributed shared memory in rank order, so all
//     derive bit-identical statistics (no atomics, deterministic); a second
//     cluster barrier before exit keeps a CTA's shared memory alive until
//     its peers have read it. The threads then normalise the slice from
//     shared memory and store it with 16-byte stores (posted, so a CTA ends
//     without waiting on them; bulk-copy stores from shared memory measured
//     no faster). The plan cuts slices small enough for three or more CTAs
//     per SM where the span allows, so some CTAs load while others sum or
//     store: a CTA's own phases run one after the other. A slice's
//     16-byte-aligned middle goes through the bulk copies; its ragged ends
//     (a span whose byte length is not a multiple of 16, e.g. 3 channels x
//     63) are single elements loaded and stored by a few threads;
//   - split (two passes, spans larger than a cluster holds: the VAE at 384^2
//     and 768^2): chunks of `chunk` elements, one 512-thread block each; a
//     stats kernel writes one (sum, sumsq) per chunk, the apply kernel's
//     blocks each sum their span's partials in one fixed order, then re-read
//     their chunk. It reads x twice, so three passes over device memory: its
//     third pass is its gap to the one-read, one-write bound.
#include <mutex>
#include <vector>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // cluster variant: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSplitThreads = 512;
constexpr int kMaxPieces = 16;  // mbarriers per CTA
constexpr int kMaxCluster = 16;  // CTAs per span; above 8 a non-portable size
constexpr int kMaxGroupChannels = 1024;
constexpr int kSmemMax = 232448;  // shared memory a block can use on the H100
// cluster variant's shared memory: the piece barriers, the warps' partial
// sums, the CTA's partial, then (a, b) per channel the slice touches, then
// the slice
constexpr int kRedOffset = 8 * kMaxPieces;
constexpr int kPartialOffset = kRedOffset + 8 * kWarps;
constexpr int kHeaderBytes = 256;
static_assert(kPartialOffset + 8 <= kHeaderBytes, "header overflow");

// channels a slice of `slice` elements can touch (it may start mid-channel)
__host__ __device__ __forceinline__ int affine_slots(int cg, long long hw, long long slice) {
  const long long n = slice / hw + 2;
  return n < cg ? static_cast<int>(n) : cg;
}
__host__ __device__ __forceinline__ int data_offset(int slots) {
  return (kHeaderBytes + 8 * slots + 127) / 128 * 128;
}

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[kVec<T>]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) v[j] = to_f(e[j]);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {  // 8 bf16
  return make_uint4(tf::pack_bf16(v[0], v[1]), tf::pack_bf16(v[2], v[3]),
                    tf::pack_bf16(v[4], v[5]), tf::pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {  // 4 fp32
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

// accurate SiLU of the split variant
__device__ __forceinline__ float silu(float y) {
  return y * (1.f / (1.f + expf(-y)));
}
// the cluster variant's: __expf and an approximate division (rcp.approx),
// within a few fp32 ulps for |y| < 80 and -0 below
__device__ __forceinline__ float silu_fast(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

// a position's channel inside its span: c, counted from the first channel
// whose affine the caller holds, and the elements left until channel c + 1
struct Cursor {
  int c, left;
};
__device__ __forceinline__ Cursor cursor_at(int r, int hw, int c_first) {
  const int c = r / hw;
  return {c - c_first, (c + 1) * hw - r};
}
// moves the cursor `step` elements on
__device__ __forceinline__ void advance(Cursor& k, int step, int hw) {
  k.left -= step;
  while (k.left <= 0) {
    ++k.c;
    k.left += hw;
  }
}

// y = act(x * a[c] + b[c]) for the kVec elements of v, the first at cursor
// k: one (a, b) when the vector lies in one channel (always, when hw is a
// multiple of kVec), else a channel walk per element
template <typename T, bool kSilu, bool kFast>
__device__ __forceinline__ void affine_vec(float (&v)[kVec<T>], Cursor k, int hw,
                                           const float* s_a, const float* s_b) {
  if (k.left >= kVec<T>) {
    const float a = s_a[k.c], b = s_b[k.c];
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) v[j] = v[j] * a + b;
  } else {
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) {
      while (j >= k.left) {
        ++k.c;
        k.left += hw;
      }
      v[j] = v[j] * s_a[k.c] + s_b[k.c];
    }
  }
  if (kSilu) {
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) v[j] = kFast ? silu_fast(v[j]) : silu(v[j]);
  }
}

// ---------------------------------------------------------------------------
// cluster variant

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads, 4)
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, int groups, int cg,
                  int hw, int len, int slice, int piece, float eps) {
  constexpr int kV = kVec<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int slots = affine_slots(cg, hw, slice);
  float2* red = reinterpret_cast<float2*>(smem + kRedOffset);
  float2* partial = reinterpret_cast<float2*>(smem + kPartialOffset);
  float* s_a = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* s_b = s_a + slots;
  T* xs = reinterpret_cast<T*>(smem + data_offset(slots));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const uint32_t rank = tf::cluster_ctarank(), n_cta = tf::cluster_nctarank();
  const long long span = blockIdx.x / n_cta;
  const long long span_lo = span * len, span_hi = span_lo + len;
  const long long lo = min(span_lo + static_cast<long long>(rank) * slice, span_hi);
  const long long hi = min(lo + slice, span_hi);
  // the 16-byte-aligned middle [mid_lo, mid_hi) goes through bulk copies
  long long mid_lo = (lo + kV - 1) / kV * kV, mid_hi = hi / kV * kV;
  if (mid_lo >= mid_hi) mid_lo = mid_hi = hi;  // no whole vector
  const int n_mid = static_cast<int>(mid_hi - mid_lo);
  const int n_pieces = (n_mid + piece - 1) / piece;

  const uint32_t bar0 = tf::smem_u32(smem);
  if (threadIdx.x == 0) {
    for (int p = 0; p < n_pieces; ++p) tf::mbar_init(bar0 + 8 * p, 1);
    tf::mbar_init_fence();
    for (int p = 0; p < n_pieces; ++p) {
      const int e0 = p * piece;
      const uint32_t bytes = static_cast<uint32_t>(min(piece, n_mid - e0)) * sizeof(T);
      tf::mbar_expect_tx(bar0 + 8 * p, bytes);
      tf::bulk_load(tf::smem_u32(xs + e0), x + mid_lo + e0, bytes, bar0 + 8 * p);
    }
  }
  // the ragged ends: fewer than 2 * kV elements before mid_lo, fewer than
  // kV after mid_hi, one per thread
  long long end_i = -1;
  if (threadIdx.x < mid_lo - lo) end_i = lo + threadIdx.x;
  else if (threadIdx.x >= 32 && threadIdx.x - 32 < hi - mid_hi) end_i = mid_hi + threadIdx.x - 32;
  float s = 0.f, q = 0.f, end_v = 0.f;
  if (end_i >= 0) {
    end_v = to_f(x[end_i]);
    s = end_v;
    q = end_v * end_v;
  }
  // gamma and beta of the slice's channels, loaded beside the slice
  const int c_first = static_cast<int>((lo - span_lo) / hw);
  const int c0 = static_cast<int>(span % groups) * cg;
  for (int i = threadIdx.x; i < slots && c_first + i < cg; i += kThreads) {
    s_a[i] = to_f(gamma[c0 + c_first + i]);
    s_b[i] = to_f(beta[c0 + c_first + i]);
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  // (sum x, sum x^2) piece by piece as each lands
  const int vec_per_piece = piece / kV;
  const uint4* xv = reinterpret_cast<const uint4*>(xs);
  for (int p = 0; p < n_pieces; ++p) {
    tf::mbar_wait(bar0 + 8 * p, 0);
    const int v1 = min((p + 1) * vec_per_piece, n_mid / kV);
    for (int v = p * vec_per_piece + threadIdx.x; v < v1; v += kThreads) {
      float e[kV];
      unpack<T>(xv[v], e);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        s += e[j];
        q += e[j] * e[j];
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  if (lane == 0) red[warp] = make_float2(s, q);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = red[0];
    for (int w = 1; w < kWarps; ++w) {
      t.x += red[w].x;
      t.y += red[w].y;
    }
    *partial = t;
  }
  // every CTA's partial is written, then read by all in rank order (all
  // loads in flight first)
  tf::cluster_arrive();
  tf::cluster_wait();
  const uint32_t part_addr = tf::smem_u32(partial);
  float sum = 0.f, sumsq = 0.f;
  for (uint32_t r0 = 0; r0 < n_cta; r0 += 8) {
    float2 pr[8];
#pragma unroll
    for (uint32_t r = 0; r < 8; ++r)
      if (r0 + r < n_cta) pr[r] = tf::ld_peer_f2(part_addr, r0 + r);
#pragma unroll
    for (uint32_t r = 0; r < 8; ++r) {
      if (r0 + r < n_cta) {
        sum += pr[r].x;
        sumsq += pr[r].y;
      }
    }
  }
  tf::cluster_arrive();  // done with the peers' shared memory (waited at exit)

  const float fn = static_cast<float>(len);
  const float mean = __fdiv_rn(sum, fn);
  const float var = __fsub_rn(__fdiv_rn(sumsq, fn), __fmul_rn(mean, mean));
  const float inv = 1.f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < slots && c_first + i < cg; i += kThreads) {
    const float a = inv * s_a[i];  // the slots this thread loaded
    s_b[i] -= mean * a;
    s_a[i] = a;
  }
  __syncthreads();

  if (end_i >= 0) {
    const int c = static_cast<int>((end_i - span_lo) / hw) - c_first;
    float v = end_v * s_a[c] + s_b[c];
    if (kSilu) v = silu_fast(v);
    y[end_i] = from_f<T>(v);
  }
  // normalised from shared memory straight to global memory, 16 bytes a
  // thread, block-strided: the stores are posted, so the CTA exits as soon
  // as its peers have read its partial
  const int n_vec = n_mid / kV;
  uint4* yv = reinterpret_cast<uint4*>(y + mid_lo);
  Cursor c = cursor_at(static_cast<int>(mid_lo - span_lo) + threadIdx.x * kV, hw, c_first);
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    float e[kV];
    unpack<T>(xv[v], e);
    affine_vec<T, kSilu, true>(e, c, hw, s_a, s_b);
    yv[v] = pack(e);
    advance(c, kThreads * kV, hw);
  }
  tf::cluster_wait();
}

// ---------------------------------------------------------------------------
// split variant

// (sum a, sum b) over the block; every thread gets the result
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float2 r = red[0];
  __syncthreads();  // red may be reused
  return r;
}

// Per-thread (sum x, sum x^2) of x[lo, hi): 16-byte loads on the aligned
// middle, single elements on the ragged ends.
template <typename T>
__device__ __forceinline__ float2 sum_range(const T* __restrict__ x, long long lo,
                                            long long hi) {
  constexpr int kV = kVec<T>;
  long long mid_lo = (lo + kV - 1) / kV * kV, mid_hi = hi / kV * kV;
  if (mid_lo >= mid_hi) mid_lo = mid_hi = hi;  // no whole vector: all scalar
  float s = 0.f, q = 0.f;
  const long long head = mid_lo - lo, tail = hi - mid_hi;
  long long i = -1;
  if (threadIdx.x < head) i = lo + threadIdx.x;
  else if (threadIdx.x >= 32 && threadIdx.x - 32 < tail) i = mid_hi + threadIdx.x - 32;
  if (i >= 0) {
    const float v = to_f(x[i]);
    s += v;
    q += v * v;
  }
  const long long n_vec = (mid_hi - mid_lo) / kV;
  for (long long k = threadIdx.x; k < n_vec; k += blockDim.x) {
    float e[kV];
    unpack<T>(*reinterpret_cast<const uint4*>(x + mid_lo + kV * k), e);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      s += e[j];
      q += e[j] * e[j];
    }
  }
  return make_float2(s, q);
}

// Statistics of one span -> the per-channel affine of its group
__device__ __forceinline__ void set_affine(float sum, float sumsq, float n, float eps,
                                           float g, float b, float* a_out, float* b_out) {
  const float mean = __fdiv_rn(sum, n);
  const float var = __fsub_rn(__fdiv_rn(sumsq, n), __fmul_rn(mean, mean));
  const float inv = 1.f / sqrtf(var + eps);
  const float a = inv * g;
  *a_out = a;
  *b_out = b - mean * a;
}

// pass 1: (sum, sumsq) of each chunk of each span
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partials, long long len,
                long long chunk, int n_chunks) {
  __shared__ float2 red[32];
  const int span = blockIdx.x / n_chunks, k = blockIdx.x % n_chunks;
  const long long lo = span * len + k * chunk;
  const long long hi = min(lo + chunk, (span + 1) * len);
  const float2 part = sum_range(x, lo, hi);
  const float2 tot = block_sum2(part.x, part.y, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// pass 2: the span's statistics from its partials (one warp, one fixed
// order in every block), then the normalisation of this block's chunk
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kSplitThreads)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ beta, const float2* __restrict__ partials,
                T* __restrict__ y, int groups, int cg, int hw, long long chunk,
                int n_chunks, float eps) {
  constexpr int kV = kVec<T>;
  __shared__ float s_a[kMaxGroupChannels], s_b[kMaxGroupChannels];
  __shared__ float2 tot;
  const int span = blockIdx.x / n_chunks, k = blockIdx.x % n_chunks;
  const long long len = (long long)cg * hw;
  if (threadIdx.x < 32) {
    float s = 0.f, q = 0.f;
    for (int j = threadIdx.x; j < n_chunks; j += 32) {
      const float2 p = partials[(long long)span * n_chunks + j];
      s += p.x;
      q += p.y;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (threadIdx.x == 0) tot = make_float2(s, q);
  }
  __syncthreads();
  const int c0 = (span % groups) * cg;
  for (int c = threadIdx.x; c < cg; c += blockDim.x)
    set_affine(tot.x, tot.y, static_cast<float>(len), eps, to_f(gamma[c0 + c]),
               to_f(beta[c0 + c]), &s_a[c], &s_b[c]);
  __syncthreads();
  const long long span_lo = span * len;
  const long long lo = span_lo + k * chunk;
  const long long hi = min(lo + chunk, span_lo + len);
  long long mid_lo = (lo + kV - 1) / kV * kV, mid_hi = hi / kV * kV;
  if (mid_lo >= mid_hi) mid_lo = mid_hi = hi;
  long long i = -1;
  if (threadIdx.x < mid_lo - lo) i = lo + threadIdx.x;
  else if (threadIdx.x >= 32 && threadIdx.x - 32 < hi - mid_hi) i = mid_hi + threadIdx.x - 32;
  if (i >= 0) {
    const int c = static_cast<int>(i - span_lo) / hw;
    float v = to_f(x[i]) * s_a[c] + s_b[c];
    if (kSilu) v = silu(v);
    y[i] = from_f<T>(v);
  }
  const long long n_vec = (mid_hi - mid_lo) / kV;
  for (long long v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const long long i0 = mid_lo + kV * v;
    float e[kV];
    unpack<T>(*reinterpret_cast<const uint4*>(x + i0), e);
    affine_vec<T, kSilu, false>(e, cursor_at(static_cast<int>(i0 - span_lo), hw, 0), hw,
                                s_a, s_b);
    *reinterpret_cast<uint4*>(y + i0) = pack(e);
  }
}

// ---------------------------------------------------------------------------
// host side

// the four instantiations of the cluster kernel, by (dtype, silu)
template <typename T>
using ClusterKernel = void (*)(const T*, const T*, const T*, T*, int, int, int, int, int,
                               int, float);

template <typename T>
ClusterKernel<T> cluster_kernel(int fuse_silu) {
  return fuse_silu ? gn_cluster_kernel<T, true> : gn_cluster_kernel<T, false>;
}

struct Checked {
  int device;
  const void* kernel;
  int cluster, smem;
  int ctas_per_sm, clusters;
};
std::mutex g_mu;
std::vector<Checked> g_checked;  // configurations already queried

// The cluster kernel's occupancy at (cluster, smem) on the current device:
// CTAs per SM and co-resident clusters (0: the plan cannot be scheduled).
// The first query of a kernel on a device also lifts its dynamic shared
// memory limit; each configuration is queried once.
template <typename T>
cudaError_t occupancy(ClusterKernel<T> kernel, int cluster, int smem, Checked* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  bool attr_set = false;
  for (const Checked& c : g_checked) {
    if (c.device != device || c.kernel != (const void*)kernel) continue;
    attr_set = true;
    if (c.cluster == cluster && c.smem == smem) {
      *out = c;
      return cudaSuccess;
    }
  }
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  Checked c{device, (const void*)kernel, cluster, smem, 0, 0};
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.ctas_per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&c.clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  g_checked.push_back(c);
  *out = c;
  return cudaSuccess;
}

// the cluster variant's plan checks; returns the dynamic shared memory or -1
int cluster_smem(int esize, int cg, long long hw, int cluster, long long slice,
                 long long piece) {
  const long long len = (long long)cg * hw;
  const long long kv = 16 / esize;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))) return -1;
  if (slice <= 0 || slice % kv || slice * cluster < len || slice > 0x7fffffffLL) return -1;
  if (piece <= 0 || piece % kv || piece * esize >= (1 << 20)) return -1;
  if ((slice + piece - 1) / piece > kMaxPieces) return -1;
  const long long smem = data_offset(affine_slots(cg, hw, slice)) + slice * esize;
  return smem > kSmemMax ? -1 : static_cast<int>(smem);
}

template <typename T>
int launch_cluster(const void* x, const void* gamma, const void* beta, void* y, int n_spans,
                   int groups, int cg, long long hw, int cluster, long long slice,
                   long long piece, float eps, int fuse_silu, cudaStream_t st) {
  const int smem = cluster_smem(sizeof(T), cg, hw, cluster, slice, piece);
  if (smem < 0 || (long long)n_spans * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const ClusterKernel<T> kernel = cluster_kernel<T>(fuse_silu);
  Checked occ;
  cudaError_t err = occupancy<T>(kernel, cluster, smem, &occ);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ.clusters < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(n_spans * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  // one CTA per span needs no cluster: a plain launch schedules faster
  // (measured on the H100), and the kernel's cluster instructions act on
  // the CTA's implicit one-CTA cluster
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(gamma), static_cast<const T*>(beta),
                           static_cast<T*>(y), groups, cg, static_cast<int>(hw),
                           static_cast<int>((long long)cg * hw), static_cast<int>(slice),
                           static_cast<int>(piece), eps);
  return static_cast<int>(err);
}

template <typename T>
int launch_split(const void* x, const void* gamma, const void* beta, void* partials, void* y,
                 int n_spans, int groups, int cg, long long hw, long long chunk, float eps,
                 int fuse_silu, cudaStream_t st) {
  const long long len = (long long)cg * hw;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = static_cast<int>((len + chunk - 1) / chunk);
  const long long blocks = (long long)n_spans * n_chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  float2* part = static_cast<float2*>(partials);
  gn_stats_kernel<T><<<static_cast<unsigned>(blocks), kSplitThreads, 0, st>>>(
      static_cast<const T*>(x), part, len, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto apply = fuse_silu ? gn_apply_kernel<T, true> : gn_apply_kernel<T, false>;
  apply<<<static_cast<unsigned>(blocks), kSplitThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      part, static_cast<T*>(y), groups, cg, static_cast<int>(hw), chunk, n_chunks, eps);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int n_spans, int cg, long long hw) {
  return cg > 0 && cg <= kMaxGroupChannels && n_spans > 0 && hw > 0 &&
         (long long)(cg + 1) * hw <= 0x7fffffffLL;
}

}  // namespace

// GroupNorm over x (B, C, *spatial), contiguous and 16-byte aligned like y,
// with n_spans = B * groups spans of cg * hw elements; dtype 0 = bf16, 1 =
// fp32 (x, gamma, beta and y alike). cluster > 0 runs the cluster variant
// with that many CTAs per span, slices of `slice` and bulk-copy pieces of
// `piece` elements; cluster = 0 the split variant with chunks of `chunk`
// elements, whose partial sums go to `partials` (n_spans * ceil(cg * hw /
// chunk) float2). Returns the cudaError_t of the launches (0 = success;
// cudaErrorInvalidValue for a plan this file does not accept,
// cudaErrorInvalidClusterSize for one the card cannot schedule).
extern "C" int tf_group_norm(const void* x, const void* gamma, const void* beta,
                             void* partials, void* y, int dtype, int n_spans, int groups,
                             int cg, long long hw, int cluster, long long slice,
                             long long piece, long long chunk, float eps, int fuse_silu,
                             void* stream) {
  if (!shape_ok(n_spans, cg, hw) || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0)
    return dtype == 0
               ? launch_cluster<__nv_bfloat16>(x, gamma, beta, y, n_spans, groups, cg, hw,
                                               cluster, slice, piece, eps, fuse_silu, st)
               : launch_cluster<float>(x, gamma, beta, y, n_spans, groups, cg, hw, cluster,
                                       slice, piece, eps, fuse_silu, st);
  return dtype == 0 ? launch_split<__nv_bfloat16>(x, gamma, beta, partials, y, n_spans,
                                                  groups, cg, hw, chunk, eps, fuse_silu, st)
                    : launch_split<float>(x, gamma, beta, partials, y, n_spans, groups, cg,
                                          hw, chunk, eps, fuse_silu, st);
}

// The cluster variant's occupancy for a plan: CTAs per SM and co-resident
// clusters on the current device (0 clusters: the plan cannot be
// scheduled). Returns a cudaError_t as tf_group_norm does.
extern "C" int tf_group_norm_occupancy(int dtype, int fuse_silu, int cg, long long hw,
                                       int cluster, long long slice, long long piece,
                                       int* ctas_per_sm, int* clusters) {
  if (!shape_ok(1, cg, hw) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = cluster_smem(dtype == 0 ? 2 : 4, cg, hw, cluster, slice, piece);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  Checked occ;
  const cudaError_t err =
      dtype == 0 ? occupancy<__nv_bfloat16>(cluster_kernel<__nv_bfloat16>(fuse_silu), cluster,
                                            smem, &occ)
                 : occupancy<float>(cluster_kernel<float>(fuse_silu), cluster, smem, &occ);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas_per_sm = occ.ctas_per_sm;
  *clusters = occ.clusters;
  return 0;
}
