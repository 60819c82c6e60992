// Token match + gather (K2) for Hopper (sm_90a), bf16 tables, fp32 math.
//
// Replaces the Pallas TPU kernel tokenflow_tpu/kernels/token_match.py:105
// (token_match_gather_pallas / _kernel); the large-S sites go to K3
// (token_match_split.cu), chosen as in the JAX package. For each frame f:
//   i1[s] = first argmax_z  x[f,s] . p_hat[pa[f], z]
//   i2[s] = first argmax_z  x[f,s] . p_hat[pb[f], z]
//   out[c,f,s] = w1[f] * kf[c,pa[f],i1[s]] + (1 - w1[f]) * kf[c,pb[f],i2[s]]
// without building the (F, S, S) similarity tensor.
//
// One launch of the token-match core (token_match_core.cuh), shared with
// K3: a producer warpgroup streams both pivots' tokens by TMA through an
// mbarrier ring past a resident query tile, consumer warpgroups run wgmma
// with fp32 accumulation and fold each z tile into a running first argmax,
// then gather and blend the matched keyframe rows in their epilogue
// (indexed 16-byte loads; the TPU kernel's one-hot matmul gather is not
// carried over). Indices go to a (2, F, S) int32 buffer, i1 in row 0 and i2
// in row 1.
// Bound: 4 S^2 D flops per frame (operations: 989 TFLOP/s bf16); the gather
// moves 3 ns S D * 2 bytes per frame, a few percent of that. The core keeps
// the tensor cores fed by TMA and takes the argmax fold off their critical
// path (its header).
#include "token_match_core.cuh"

// K2: indices into idx[0] (pivot pa) and idx[1] (pivot pb) of a (2, F, S)
// int32 buffer, and, unless out is null, the blended rows into out (ns, F,
// S, D). n_piv is the pivot count K of p_hat (K, S, D) and kf (ns, K, S, D),
// the extent of p_hat's tensor map. Returns 0, the cudaError_t of the
// launch, or a negative tensor-map code (tf_error_string).
extern "C" int tf_token_match(const void* x, const void* phat, const void* kf,
                              const int* pa, const int* pb, const float* w1,
                              int* idx, void* out, int ns, int f_total, int n_piv,
                              int s_len, int d, void* stream) {
  return launch_match_core(x, phat, kf, pa, pb, w1, idx,
                           idx + (long long)f_total * s_len, out, ns, f_total, n_piv,
                           s_len, d, stream);
}
