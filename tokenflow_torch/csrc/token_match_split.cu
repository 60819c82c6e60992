// Split token match (K3) for Hopper (sm_90a), bf16 tables, fp32 math: the
// large-S sites of the propagation (768p top level, S = 9216, D = 320).
//
// Replaces the Pallas TPU kernel tokenflow_tpu/kernels/token_match_split.py:123
// (token_match_gather_split: _match_kernel, then _gather_kernel). Same
// contract as K2 (token_match.cu), with the indices between the TPU
// kernel's two stages as outputs: int32 ia, ib shaped (F, 1, S), one per
// pivot. The gather is the core's epilogue, as in K2.
//   ia[f,s] = first argmax_z  x[f,s] . p_hat[pa[f], z]   (ib: pivot pb[f])
//   out[c,f,s] = w1[f] * kf[c,pa[f],ia[f,s]] + (1 - w1[f]) * kf[c,pb[f],ib[f,s]]
//
// K3 is one launch of the token-match core (token_match_core.cuh), the one
// K2 launches: the query tile is loaded once and both pivots stream through
// the same block, each z tile updating both running first maxima, as the TPU
// kernel updates both per z block (token_match_split.py:79-80). The same
// arithmetic in the same order as K2, so its indices equal K2's bit for bit.
// Bound: 4 S^2 D flops per frame (operations); what the core does about it
// is in its header.
#include "token_match_core.cuh"

// K3: indices into ia and ib, (F, 1, S) int32 each, and, unless out is
// null, the blended rows into out (ns, F, S, D). n_piv is the pivot count
// K of p_hat (K, S, D) and kf (ns, K, S, D). Returns 0, the cudaError_t of
// the launch, or a negative tensor-map code.
extern "C" int tf_token_match_split(const void* x, const void* phat, const void* kf,
                                    const int* pa, const int* pb, const float* w1,
                                    int* ia, int* ib, void* out, int ns, int f_total,
                                    int n_piv, int s_len, int d, void* stream) {
  return launch_match_core(x, phat, kf, pa, pb, w1, ia, ib, out, ns, f_total, n_piv,
                           s_len, d, stream);
}
