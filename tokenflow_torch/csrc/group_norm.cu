// GroupNorm (+ optional SiLU) for Hopper (sm_90a): bf16 activations and
// affine parameters, fp32 statistics and affine arithmetic, bf16 output.
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
// Bound: memory bandwidth (a few flops per element). The plain PyTorch
// chain (x.float(), mean, x * x, mean, normalise, affine, SiLU, cast back)
// makes about five fp32-sized passes over the activation; this kernel reads
// the bf16 activation once or twice and writes it once.
//
// Two variants, chosen by span size (the wrapper passes chunk = 0 for the
// first):
//   - resident: one block per span whose bf16 copy fits shared memory
//     (up to ~200 KB: 10 channels x 96^2, 40 channels x 48^2). The span is
//     read from device memory once into shared memory while the block sums
//     x and x^2, then normalised from shared memory;
//   - split: larger spans (the 96^2 up-block sites at 640 and 960 channels,
//     the 1920-channel 48^2 sites, the VAE at pixel resolution) are cut into
//     chunks of `chunk` elements, one block each, so that a small B * G
//     still fills the 132 SMs. A stats kernel writes one (sum, sumsq) per
//     chunk; the apply kernel's blocks each sum their span's partials in one
//     fixed order (deterministic, no atomics), then re-read their chunk.
// Loads and stores are 16 bytes (8 bf16) on the 8-aligned middle of a range
// and single elements on its ragged ends, so any C / G and H * W work.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxGroupChannels = 1024;  // per-channel (a, b) in shared memory

__device__ __forceinline__ float silu(float y) {
  return y * (1.f / (1.f + expf(-y)));
}

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

// Statistics of one span -> the per-channel affine of its group in shared
// memory.
__device__ __forceinline__ void set_affine(float sum, float sumsq, float n,
                                           float eps,
                                           const __nv_bfloat16* __restrict__ gamma,
                                           const __nv_bfloat16* __restrict__ beta,
                                           int c0, int cg, float* s_a,
                                           float* s_b) {
  const float mean = __fdiv_rn(sum, n);
  const float var = __fsub_rn(__fdiv_rn(sumsq, n), __fmul_rn(mean, mean));
  const float inv = 1.f / sqrtf(var + eps);
  for (int c = threadIdx.x; c < cg; c += blockDim.x) {
    const float a = inv * __bfloat162float(gamma[c0 + c]);
    s_a[c] = a;
    s_b[c] = __bfloat162float(beta[c0 + c]) - mean * a;
  }
  __syncthreads();
}

// Per-thread (sum x, sum x^2) of x[lo, hi); with `keep`, also copies each
// element i to keep[i - keep_off] (keep_off a multiple of 8).
__device__ __forceinline__ float2 sum_range(const __nv_bfloat16* __restrict__ x,
                                            long long lo, long long hi,
                                            __nv_bfloat16* keep,
                                            long long keep_off) {
  long long mid_lo = (lo + 7) & ~7LL, mid_hi = hi & ~7LL;
  if (mid_lo >= mid_hi) mid_lo = mid_hi = hi;  // no whole vector: all scalar
  float s = 0.f, q = 0.f;
  const long long head = mid_lo - lo, tail = hi - mid_hi;
  if (threadIdx.x < head) {
    const long long i = lo + threadIdx.x;
    const float v = __bfloat162float(x[i]);
    s += v;
    q += v * v;
    if (keep) keep[i - keep_off] = x[i];
  } else if (threadIdx.x >= 8 && threadIdx.x - 8 < tail) {
    const long long i = mid_hi + threadIdx.x - 8;
    const float v = __bfloat162float(x[i]);
    s += v;
    q += v * v;
    if (keep) keep[i - keep_off] = x[i];
  }
  const long long n_vec = (mid_hi - mid_lo) / 8;
  for (long long k = threadIdx.x; k < n_vec; k += blockDim.x) {
    const long long i = mid_lo + 8 * k;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + i);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = __bfloat162float(e[j]);
      s += v;
      q += v * v;
    }
    if (keep) *reinterpret_cast<uint4*>(keep + (i - keep_off)) = raw;
  }
  return make_float2(s, q);
}

// y[i] = act(src[i - src_off] * a[c] + b[c]) for i in [lo, hi), where c is
// element i's channel inside the span starting at `span` (hw elements per
// channel, span length < 2^31); src_off is a multiple of 8.
template <bool kSilu>
__device__ __forceinline__ void apply_range(const __nv_bfloat16* src,
                                            long long src_off,
                                            __nv_bfloat16* __restrict__ y,
                                            long long span, long long lo,
                                            long long hi, int hw,
                                            const float* s_a,
                                            const float* s_b) {
  long long mid_lo = (lo + 7) & ~7LL, mid_hi = hi & ~7LL;
  if (mid_lo >= mid_hi) mid_lo = mid_hi = hi;
  const long long head = mid_lo - lo, tail = hi - mid_hi;
  long long i = -1;
  if (threadIdx.x < head) i = lo + threadIdx.x;
  else if (threadIdx.x >= 8 && threadIdx.x - 8 < tail) i = mid_hi + threadIdx.x - 8;
  if (i >= 0) {
    const int c = static_cast<int>(i - span) / hw;
    float v = __bfloat162float(src[i - src_off]) * s_a[c] + s_b[c];
    if (kSilu) v = silu(v);
    y[i] = __float2bfloat16_rn(v);
  }
  const long long n_vec = (mid_hi - mid_lo) / 8;
  for (long long k = threadIdx.x; k < n_vec; k += blockDim.x) {
    const long long i0 = mid_lo + 8 * k;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (i0 - src_off));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    const int r = static_cast<int>(i0 - span);
    int c = r / hw;
    int left = (c + 1) * hw - r;  // elements until channel c + 1
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      while (j >= left) {
        ++c;
        left += hw;
      }
      v[j] = __bfloat162float(e[j]) * s_a[c] + s_b[c];
      if (kSilu) v[j] = silu(v[j]);
    }
    uint4 res;
    uint32_t* rw = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
    for (int j = 0; j < 4; ++j) rw[j] = tf::pack_bf16(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(y + i0) = res;
  }
}

// Resident variant: one block per span, the span held in shared memory.
template <bool kSilu>
__global__ void __launch_bounds__(kThreads)
gn_resident_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ gamma,
                   const __nv_bfloat16* __restrict__ beta,
                   __nv_bfloat16* __restrict__ y, int groups, int cg,
                   int hw, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float s_a[kMaxGroupChannels], s_b[kMaxGroupChannels];
  __shared__ float2 red[32];
  const long long len = (long long)cg * hw;
  const long long lo = blockIdx.x * len, hi = lo + len;
  const long long base = lo & ~7LL;  // xs[0] holds element `base`
  const float2 part = sum_range(x, lo, hi, xs, base);
  const float2 tot = block_sum2(part.x, part.y, red);  // also publishes xs
  set_affine(tot.x, tot.y, static_cast<float>(len), eps, gamma, beta,
             (blockIdx.x % groups) * cg, cg, s_a, s_b);
  apply_range<kSilu>(xs, base, y, lo, lo, hi, hw, s_a, s_b);
}

// Split variant, pass 1: (sum, sumsq) of each chunk of each span.
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                float2* __restrict__ partials, long long len, long long chunk,
                int n_chunks) {
  __shared__ float2 red[32];
  const int span = blockIdx.x / n_chunks, k = blockIdx.x % n_chunks;
  const long long lo = span * len + k * chunk;
  const long long hi = min(lo + chunk, (span + 1) * len);
  const float2 part = sum_range(x, lo, hi, nullptr, 0);
  const float2 tot = block_sum2(part.x, part.y, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// Split variant, pass 2: the span's statistics from its partials, then the
// normalisation of this block's chunk.
template <bool kSilu>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ gamma,
                const __nv_bfloat16* __restrict__ beta,
                const float2* __restrict__ partials,
                __nv_bfloat16* __restrict__ y, int groups, int cg,
                int hw, long long chunk, int n_chunks, float eps) {
  __shared__ float s_a[kMaxGroupChannels], s_b[kMaxGroupChannels];
  __shared__ float2 tot;
  const int span = blockIdx.x / n_chunks, k = blockIdx.x % n_chunks;
  const long long len = (long long)cg * hw;
  if (threadIdx.x < 32) {  // one warp, the same order in every block
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
  set_affine(tot.x, tot.y, static_cast<float>(len), eps, gamma, beta,
             (span % groups) * cg, cg, s_a, s_b);
  const long long span_lo = span * len;
  const long long lo = span_lo + k * chunk;
  const long long hi = min(lo + chunk, span_lo + len);
  apply_range<kSilu>(x, 0, y, span_lo, lo, hi, hw, s_a, s_b);
}

}  // namespace

// GroupNorm over x (B, C, *spatial), contiguous, with n_spans = B * groups
// spans of cg * hw elements. chunk = 0 runs the resident variant (needs
// (cg * hw + 8) * 2 bytes of dynamic shared memory); otherwise the split
// variant with chunks of `chunk` elements, whose partial sums go to
// `partials` (n_spans * ceil(cg * hw / chunk) float2). A span must hold
// fewer than 2^31 elements. Returns the cudaError_t of the launches
// (0 = success).
extern "C" int tf_group_norm(const void* x, const void* gamma,
                             const void* beta, void* partials, void* y,
                             int n_spans, int groups, int cg, long long hw,
                             long long chunk, float eps, int fuse_silu,
                             void* stream) {
  if (cg > kMaxGroupChannels || n_spans <= 0 || hw <= 0 ||
      (long long)cg * hw > 0x7fffffffLL - 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(gamma);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(beta);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const long long len = (long long)cg * hw;
  if (chunk == 0) {
    const size_t smem = (size_t)(len + 8) * sizeof(__nv_bfloat16);
    auto kernel =
        fuse_silu ? gn_resident_kernel<true> : gn_resident_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_spans, kThreads, smem, st>>>(xb, gb, bb, yb, groups, cg,
                                             static_cast<int>(hw), eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_chunks = static_cast<int>((len + chunk - 1) / chunk);
  const long long blocks = (long long)n_spans * n_chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  float2* part = static_cast<float2*>(partials);
  gn_stats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      xb, part, len, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto apply = fuse_silu ? gn_apply_kernel<true> : gn_apply_kernel<false>;
  apply<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      xb, gb, bb, part, yb, groups, cg, static_cast<int>(hw), chunk,
      n_chunks, eps);
  return static_cast<int>(cudaGetLastError());
}
