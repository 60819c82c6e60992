// Shared device helpers for the hand-written Hopper kernels: the bf16
// tensor-core MMA (mma.sync m16n8k16, fp32 accumulate), bf16 packing, and
// the tile loads and first-maximum reduce of the token-match kernels.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major), four .b32 registers of two bf16 each:
//     a0: row g,   cols 2t, 2t+1        a1: row g+8, cols 2t, 2t+1
//     a2: row g,   cols 2t+8, 2t+9      a3: row g+8, cols 2t+8, 2t+9
//   B (16x8, "col"), two .b32 registers:
//     b0: rows(k) 2t, 2t+1, col(n) g    b1: rows(k) 2t+8, 2t+9, col(n) g
//   C/D (16x8 fp32), four floats:
//     c0, c1: row g, cols 2t, 2t+1      c2, c3: row g+8, cols 2t, 2t+1
// The lower 16 bits of a register hold the element with the lower index.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---- token match (K2 token_match.cu, K3 token_match_split.cu) -----------
// A block of 4 warps holds a 64-row query tile (rows zero-padded to kMatchBQ,
// columns to d_pad, pitch d_pad + 8) in shared memory and streams pivot
// tokens through a 64-token x 64-dim tile (pitch kMatchLdp). Warp w owns
// query rows 16w + g and 16w + g + 8 (g = lane / 4).

constexpr int kMatchBQ = 64;       // query rows per block
constexpr int kMatchBZ = 64;       // pivot tokens per tile
constexpr int kMatchBD = 64;       // head-dim chunk per tile
constexpr int kMatchThreads = 128;
constexpr int kMatchLdp = kMatchBD + 8;

__device__ __forceinline__ void load_query_tile(
    __nv_bfloat16* xs, int ldx, const __nv_bfloat16* __restrict__ xf, int q0,
    int s_len, int d, int d_pad) {
  const int chunks = d_pad / 8;
  for (int i = threadIdx.x; i < kMatchBQ * chunks; i += kMatchThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < s_len && c < d)
      val = *reinterpret_cast<const uint4*>(xf + (long long)(q0 + r) * d + c);
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = val;
  }
}

// tokens z0.. and dims d0.. of one pivot's (S, D) table, zero-filled past
// s_len and d
__device__ __forceinline__ void load_pivot_tile(
    __nv_bfloat16* ps, const __nv_bfloat16* __restrict__ pp, int z0, int d0,
    int s_len, int d) {
  for (int i = threadIdx.x; i < kMatchBZ * (kMatchBD / 8); i += kMatchThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (z0 + r < s_len && d0 + c < d)
      val = *reinterpret_cast<const uint4*>(pp + (long long)(z0 + r) * d + d0 + c);
    *reinterpret_cast<uint4*>(ps + r * kMatchLdp + c) = val;
  }
}

// s[n] += (this warp's 16 query rows) . (pivot tile tokens 8n..8n+7) over
// dims d0 .. d0 + 63
__device__ __forceinline__ void match_tile_mma(
    float (&s)[8][4], const __nv_bfloat16* xs, int ldx,
    const __nv_bfloat16* ps, int row0, int d0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kMatchBD / 16; ++kk) {
    const __nv_bfloat16* xa = xs + row0 * ldx + d0 + kk * 16 + 2 * t;
    uint32_t a[4];
    a[0] = ld32(xa);
    a[1] = ld32(xa + 8 * ldx);
    a[2] = ld32(xa + 8);
    a[3] = ld32(xa + 8 * ldx + 8);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* pr = ps + (n * 8 + g) * kMatchLdp + kk * 16 + 2 * t;
      mma_16816(s[n], a, ld32(pr), ld32(pr + 8));
    }
  }
}

// Folds one tile of similarities (columns z0 .. z0 + 63) into the running
// first maximum of this thread's two rows: an ascending column scan with
// '>' inside the thread, the lower index on ties across the quad (whose
// four threads cover the row's 64 columns), and a strict '>' against the
// earlier tiles, so the result is jnp.argmax's first maximum.
__device__ __forceinline__ void first_max_update(
    const float (&s)[8][4], int z0, int s_len, int t, float& best0, int& bidx0,
    float& best1, int& bidx1) {
  float tv0 = neg_inf(), tv1 = neg_inf();
  int ti0 = 0x7fffffff, ti1 = 0x7fffffff;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = z0 + n * 8 + 2 * t + e;
      if (col < s_len) {
        if (s[n][e] > tv0) { tv0 = s[n][e]; ti0 = col; }
        if (s[n][2 + e] > tv1) { tv1 = s[n][2 + e]; ti1 = col; }
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ov0 = __shfl_xor_sync(0xffffffffu, tv0, off);
    const int oi0 = __shfl_xor_sync(0xffffffffu, ti0, off);
    const float ov1 = __shfl_xor_sync(0xffffffffu, tv1, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, ti1, off);
    if (ov0 > tv0 || (ov0 == tv0 && oi0 < ti0)) { tv0 = ov0; ti0 = oi0; }
    if (ov1 > tv1 || (ov1 == tv1 && oi1 < ti1)) { tv1 = ov1; ti1 = oi1; }
  }
  if (tv0 > best0) { best0 = tv0; bidx0 = ti0; }
  if (tv1 > best1) { best1 = tv1; bidx1 = ti1; }
}

}  // namespace tf
