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
// Design (a simple kernel on the CUDA cores; products in plain fp32 FFMA,
// no TF32, whose 10-bit products would flip nearest-neighbour matches
// downstream):
//   - one block of 256 threads per (64 query rows, head, batch). The
//     threads form a 16 x 16 grid: thread (ty, tx) owns rows 4 ty .. 4 ty
//     + 3 of the tile, KV columns tx + 16 j (j < 4) of S and output columns
//     tx + 16 j (j < ceil(D / 16)) of O, so a row's 16 owners sit in one
//     half-warp and its max and sum need four shuffles;
//   - Q is loaded once into shared memory; each KV tile of 64 tokens is
//     loaded (16-byte loads along D) into shared memory, then S = Q K^T
//     runs as 4 x 4 register micro-tiles, 16-byte shared loads of four Q
//     rows (broadcast across the half-warp) and four K rows per four dims.
//     The Q and K tiles' rows are padded to D + 4 floats, so the 16 K rows
//     a half-warp reads fall on distinct banks;
//   - the softmax runs on S's registers (masking the ragged tail), rescales
//     O and the partial row sums, and stores P to shared memory; O += P V
//     reads four P values of a row per 16-byte load and V as 4-byte loads
//     along its rows, consecutive across the half-warp;
//   - the partial row sums meet once, at the end; O / l is stored.
// exp2f without fast math (the library's 2-ulp exp2, not ex2.approx.ftz):
// a relative error near 1e-7 per probability, far inside the 2e-5
// relative L2 that chip_smoke.py holds the kernel to.
// Shared memory per block, 64-row Q and K tiles of D + 4 floats, V 64 x D,
// P 64 x 68: 50,176 B at D = 40, 68,608 B at D = 64, 80,896 B at D = 80,
// 142,336 B at D = 160 (above 48 KB: the launcher opts in, within 227 KB).
// O takes 4 ceil(D / 16) registers a thread: 40 at D = 160.
// Bound: 4 Sq Skv D flops per (batch, head) against (Sq + 2 Skv) 4 D bytes
// read and Sq 4 D written: compute bound at the path's lengths, at the
// H100's 67 TFLOP/s of fp32 on the CUDA cores. Each KV tile is read once
// per 64 query rows (from L2), and every 16 FFMAs of S cost two 16-byte
// shared loads; making it fast (TF32x3 or wgmma tf32 splits, TMA, a
// warp-specialised ring) is later work.
//
// Layout: tensors are (B, S, H, D) with arbitrary batch/sequence/head
// strides in elements (multiples of 4, with a 16-byte aligned base: the
// wrapper clones anything else) and unit stride along the head dim.
#include "common.cuh"

namespace {

constexpr int kF32Rows = 64;      // query rows per block
constexpr int kF32Cols = 64;      // KV tokens per tile
constexpr int kF32Threads = 256;  // 16 x 16
constexpr int kF32PLd = kF32Cols + 4;  // row stride of the P tile (floats)

template <int D>
struct F32Cfg {
  static constexpr int kLd = D + 4;  // row stride of the Q and K tiles (floats)
  static constexpr int kOCols = (D + 15) / 16;  // O columns a thread owns
  static constexpr int kOffK = kF32Rows * kLd;
  static constexpr int kOffV = kOffK + kF32Cols * kLd;
  static constexpr int kOffP = kOffV + kF32Cols * D;
  static constexpr uint32_t kSmemBytes = (kOffP + kF32Rows * kF32PLd) * 4;
  static_assert(D % 4 == 0 && D <= 256, "head dim");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

// rows row0 .. row0 + 63 of a (S, D) slice with row stride `stride` into
// `dst` (row stride ld floats); rows >= n_rows are zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          long long stride, int row0, int n_rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kF32Rows * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq, int skv,
              long long qsb, long long qss, long long qsh, long long ksb, long long kss,
              long long ksh, long long vsb, long long vss, long long vsh, long long osb,
              long long oss, long long osh, float scale_log2) {
  using C = F32Cfg<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + C::kOffK;
  float* vs = qs + C::kOffV;
  float* ps = qs + C::kOffP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  load_rows<D>(qs, C::kLd, q + b * qsb + h * qsh, qss, q0, sq);

  float acc[4][C::kOCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = tf::neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kOCols; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < skv; kv0 += kF32Cols) {
    __syncthreads();  // the previous tile's K, V and P are read (and Q stored)
    load_rows<D>(ks, C::kLd, kb, kss, kv0, skv);
    load_rows<D>(vs, D, vb, vss, kv0, skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * C::kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * C::kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
        }
    }

    // online softmax in the exp2 domain; the ragged tail is -inf
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = tf::neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kv0 + tx + 16 * j < skv ? s[i][j] * scale_log2 : tf::neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: a tile holds a token < skv
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < C::kOCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        l[i] += p;
        ps[(4 * ty + i) * kF32PLd + tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int j = 0; j < kF32Cols; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kF32PLd + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (j + e) * D + tx;
#pragma unroll
        for (int c = 0; c < C::kOCols; ++c) {
          if (D % 16 != 0 && tx + 16 * c >= D) continue;
          const float vv = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
            acc[i][c] = fmaf(p, vv, acc[i][c]);
          }
        }
      }
    }
  }

  // every lane shuffles before any lane branches on its row
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < C::kOCols; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 != 0 && col >= D) continue;
      ob[row * oss + col] = acc[i][c] / l[i];
    }
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o, int batch,
               int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb, long long vss,
               long long vsh, long long osb, long long oss, long long osh, float scale,
               void* stream) {
  using C = F32Cfg<D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + kF32Rows - 1) / kF32Rows, heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_f32<D><<<grid, kF32Threads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, sq, skv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 in fp32: launches on `stream` for head dim 40, 64, 80 or 160, with
// the bf16 entry point's arguments (tf_flash_attention); returns 0, a
// cudaError_t of the launch, or tf::kErrHeadDim for another head dim.
extern "C" int tf_flash_attention_f32(
    int head_dim, const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int skv, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale,
    void* stream) {
#define TF_FLASH_F32_ARGS                                                          \
  static_cast<const float*>(q), static_cast<const float*>(k),                     \
      static_cast<const float*>(v), static_cast<float*>(o), batch, heads, sq, skv, \
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, scale, stream
  switch (head_dim) {
    case 40: return launch_f32<40>(TF_FLASH_F32_ARGS);
    case 64: return launch_f32<64>(TF_FLASH_F32_ARGS);
    case 80: return launch_f32<80>(TF_FLASH_F32_ARGS);
    case 160: return launch_f32<160>(TF_FLASH_F32_ARGS);
    default: return tf::kErrHeadDim;
  }
#undef TF_FLASH_F32_ARGS
}
