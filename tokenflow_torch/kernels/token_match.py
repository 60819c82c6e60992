"""K2: token match + gather, the hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``tokenflow_tpu/kernels/token_match.py``
(``token_match_gather_pallas``, kernel ``_kernel``); the large-S sites go to
K3 (``kernels/token_match_split.py``), chosen as in the JAX package. For
each frame f and query token s: the first argmax over pivot tokens of
``x . p_hat`` for pivots ``pa[f]`` and ``pb[f]``, then ``w1[f] * kf[:, pa[f],
i1] + (1 - w1[f]) * kf[:, pb[f], i2]`` for all streams. The CUDA source is
``tokenflow_torch/csrc/token_match.cu`` (its header gives the design): a
tensor-core match stage with a running first-max per row writes (2, F, S)
int32 indices, and a gather stage blends with indexed 16-byte loads. Bound
on the H100: the match stage is compute bound (4 S^2 D flops per frame),
the gather stage memory bound.
"""

from __future__ import annotations

import torch

from tokenflow_torch.kernels import _build

# kernel-pair launches made by :func:`token_match_gather_kernel`
launches = 0

_MAX_D = 1728  # largest head width whose query tile fits shared memory
_PLAIN_FRAMES = 8  # frames per plain-version chunk: bounds the (f, S, S) sims


def token_match_gather_plain(
    xq: torch.Tensor,  # (F, S, D) query tokens (need not be normalized)
    p_hat: torch.Tensor,  # (K, S, D) L2-normalized pivot tokens
    kf_attn: torch.Tensor,  # (ns, K, S, D)
    pa: torch.Tensor,  # (F,)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
    *,
    return_indices: bool = False,
):
    """Dense NN match + two-pivot blended gather in plain PyTorch.

    Mirrors ``jnp_match_gather`` (tokenflow_tpu/ops/propagation.py:89-123):
    fp32 similarities, first-max argmax, gather of every stream. The blend
    runs in fp32 and is cast to kf_attn's dtype once, as the Pallas kernel
    does (token_match.py:82); for fp32 tables this is the jnp expression
    exactly. Frames run in chunks so the (F, S, S) similarity tensor is
    never whole. Returns (ns, F, S, D) in kf_attn's dtype, and with
    ``return_indices`` also the (2, F, S) matched token indices.
    """
    pa = pa.long()
    pb = pb.long()
    w = w1.float()
    ns, _, s, d = kf_attn.shape
    f_total = xq.shape[0]
    out = torch.empty((ns, f_total, s, d), dtype=kf_attn.dtype, device=kf_attn.device)
    idx = torch.empty((2, f_total, s), dtype=torch.long, device=kf_attn.device)
    ph = p_hat.float()
    for f0 in range(0, f_total, _PLAIN_FRAMES):
        sl = slice(f0, f0 + _PLAIN_FRAMES)
        x = xq[sl].float()
        gathered = []
        for j, p_idx in enumerate((pa[sl], pb[sl])):
            sim = torch.einsum("fsd,fzd->fsz", x, ph[p_idx])
            idx[j, sl] = sim.argmax(dim=-1)  # first maximum, as jnp.argmax
            table = kf_attn[:, p_idx]  # (ns, f, S, D)
            gathered.append(
                torch.gather(
                    table, 2, idx[j, sl][None, :, :, None].expand(ns, -1, -1, d)
                ).float()
            )
        wf = w[sl][None, :, None, None]
        out[:, sl] = (wf * gathered[0] + (1 - wf) * gathered[1]).to(kf_attn.dtype)
    return (out, idx) if return_indices else out


def prepare_operands(name, norm_h, p_hat, kf_attn, pa, pb, w1, max_d):
    """The checks shared by the token-match wrappers (K2 and K3): one CUDA
    device, bf16 tables, agreeing shapes, D % 8 == 0 and D <= max_d, pivot
    indices in [0, K) (IndexError; the kernels address the tables with them
    directly). Returns contiguous tables, int32 pa/pb and fp32 w1."""
    dev = norm_h.device
    tensors = (norm_h, p_hat, kf_attn, pa, pb, w1)
    if not norm_h.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device")
    if not (norm_h.dtype == p_hat.dtype == kf_attn.dtype == torch.bfloat16):
        raise NotImplementedError(
            "the CUDA token-match kernels are instantiated for bf16 tables; got "
            f"{norm_h.dtype}, {p_hat.dtype}, {kf_attn.dtype}"
        )
    f_total, s, d = norm_h.shape
    k = kf_attn.shape[1]
    if p_hat.shape != (k, s, d) or kf_attn.shape[2:] != (s, d):
        raise ValueError(
            f"shapes disagree: norm_h {tuple(norm_h.shape)}, p_hat "
            f"{tuple(p_hat.shape)}, kf_attn {tuple(kf_attn.shape)}"
        )
    if pa.shape != (f_total,) or pb.shape != (f_total,) or w1.shape != (f_total,):
        raise ValueError("pa, pb and w1 must have one entry per frame")
    if d % 8 or d > max_d:
        raise NotImplementedError(
            f"{name} needs D % 8 == 0 and D <= {max_d}, got {d}"
        )
    if f_total > 65535:
        raise ValueError(f"{f_total} frames exceed the grid limit")
    piv = torch.cat([pa.reshape(-1), pb.reshape(-1)])
    if piv.numel() and bool(((piv < 0) | (piv >= k)).any()):
        raise IndexError(f"pivot indices must lie in [0, {k})")
    return (
        norm_h.contiguous(), p_hat.contiguous(), kf_attn.contiguous(),
        pa.to(torch.int32).contiguous(), pb.to(torch.int32).contiguous(),
        w1.to(torch.float32).contiguous(),
    )


def token_match_gather_kernel(
    norm_h: torch.Tensor,  # (F, S, D) bf16
    p_hat: torch.Tensor,  # (K, S, D) bf16, pre-normalized
    kf_attn: torch.Tensor,  # (ns, K, S, D) bf16
    pa: torch.Tensor,  # (F,) pivot index in [0, K)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
    *,
    return_indices: bool = False,
):
    """Launch K2 (match stage, then gather stage) on CUDA tensors. Pivot
    indices outside [0, K) raise IndexError. Returns a new (ns, F, S, D)
    bf16 tensor, and with ``return_indices`` also the (2, F, S) int32
    matched token indices."""
    global launches
    norm_h, p_hat, kf_attn, pa, pb, w1 = prepare_operands(
        "token_match_gather_kernel", norm_h, p_hat, kf_attn, pa, pb, w1, _MAX_D
    )
    dev = norm_h.device
    f_total, s, d = norm_h.shape
    ns, k = kf_attn.shape[:2]
    idx = torch.empty((2, f_total, s), dtype=torch.int32, device=dev)
    out = torch.empty((ns, f_total, s, d), dtype=kf_attn.dtype, device=dev)
    if f_total == 0 or s == 0:
        return (out, idx) if return_indices else out
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tf_token_match(
            norm_h.data_ptr(), p_hat.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            idx.data_ptr(), f_total, s, d, stream,
        )
        _build.check(lib, rc, "token-match (match stage) launch")
        rc = lib.tf_token_gather(
            kf_attn.data_ptr(), idx.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            w1.data_ptr(), out.data_ptr(), ns, k, f_total, s, d, stream,
        )
        _build.check(lib, rc, "token-match (gather stage) launch")
    launches += 1
    return (out, idx) if return_indices else out
