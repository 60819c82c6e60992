"""K3: split token match + gather for the large-S propagation sites, the
hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``tokenflow_tpu/kernels/token_match_split.py``
(``token_match_gather_split``: ``_match_kernel``, then ``_gather_kernel``).
Same contract as K2 (``kernels/token_match.py``), with the indices between
the TPU kernel's two stages as outputs: the running first maximum of BOTH
pivots is updated per z step, and the int32 indices ``ia``, ``ib`` come
out shaped (F, 1, S) beside the gathered and blended output. The CUDA
entry point is ``tokenflow_torch/csrc/token_match_split.cu``, one launch
of the token-match core that K2 launches too (``csrc/token_match_core.cuh``,
whose header gives the design; the gather is its epilogue). Bound on the
H100: compute (4 S^2 D flops per frame). fp32 tables launch the fp32 match
core K2 launches too (``csrc/token_match_f32.cu``).

:func:`use_split` keeps the port's K2/K3 choice at the JAX package's sites.
"""

from __future__ import annotations

import torch

from tokenflow_torch.kernels.token_match import (
    launch,
    prepare_operands,
    token_match_gather_plain,
)

# kernel-pair launches made by :func:`token_match_gather_split_kernel`
launches = 0
# launches by dtype ("bfloat16", "float32"), the same launches as ``launches``
launches_by_dtype: dict[str, int] = {}
# launches by the kf table's stream count (3: [source|uncond|cond], 2: the
# approximate pass's [uncond|cond]), the same launches as ``launches``
launches_by_streams: dict[int, int] = {}

# The JAX package's profitability cap for K2 (tokenflow_tpu/kernels/
# token_match.py:94-96, fits_vmem): a site whose one (ns, S, D) bf16
# keyframe table exceeds it runs K3 there (ops/propagation.py:186-209). At
# 768p that is the top level (3 * 9216 * 320 * 2 B = 16.9 MiB). Whether the
# threshold suits the H100 is not measured. The byte count is bf16's at
# every dtype, as in the JAX dispatch, which calls the same predicate for
# fp32 tables: K2 and K3 share the sites in both dtypes.
SPLIT_KF_TABLE_BYTES = 12 << 20


def use_split(s: int, d: int, ns: int = 3) -> bool:
    """True where the JAX dispatch takes K3 instead of K2: one (ns, S, D)
    keyframe table larger than :data:`SPLIT_KF_TABLE_BYTES` counted in bf16
    (whatever the tables' dtype)."""
    return ns * s * d * 2 > SPLIT_KF_TABLE_BYTES


def token_match_gather_split_plain(
    xq: torch.Tensor,  # (F, S, D)
    p_hat: torch.Tensor,  # (K, S, D) L2-normalized pivot tokens
    kf_attn: torch.Tensor,  # (ns, K, S, D)
    pa: torch.Tensor,  # (F,)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
    *,
    return_indices: bool = False,
):
    """K3's plain version: the dense match and gather of K2's plain version
    (the two kernels share one contract); with ``return_indices`` also the
    int32 ``ia``, ``ib`` in K3's (F, 1, S) shape."""
    out, idx = token_match_gather_plain(
        xq, p_hat, kf_attn, pa, pb, w1, return_indices=True
    )
    if not return_indices:
        return out
    ia, ib = (i.to(torch.int32)[:, None] for i in idx)
    return out, ia, ib


def token_match_gather_split_kernel(
    norm_h: torch.Tensor,  # (F, S, D) bf16 or fp32
    p_hat: torch.Tensor,  # (K, S, D) pre-normalized, norm_h's dtype
    kf_attn: torch.Tensor,  # (ns, K, S, D) norm_h's dtype
    pa: torch.Tensor,  # (F,) pivot index in [0, K)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
    *,
    return_indices: bool = False,
):
    """Launch K3 (match, gather and blend in one kernel) on CUDA tensors, with K2's
    checks (pivot indices outside [0, K) raise IndexError). Returns a new
    (ns, F, S, D) tensor in the tables' dtype, and with ``return_indices``
    also ``ia``, ``ib``: (F, 1, S) int32."""
    global launches
    ops = prepare_operands(
        "token_match_gather_split_kernel", norm_h, p_hat, kf_attn, pa, pb, w1
    )
    f_total, s, d = ops[0].shape
    ns = ops[2].shape[0]
    dev = ops[0].device
    # ia and ib are the two rows of one (2, F, S) buffer, K2's index layout
    idx = torch.empty((2, f_total, s), dtype=torch.int32, device=dev)
    ia, ib = idx[0, :, None], idx[1, :, None]
    out = torch.empty((ns, f_total, s, d), dtype=ops[2].dtype, device=dev)
    if f_total == 0 or s == 0:
        return (out, ia, ib) if return_indices else out
    launch(ops, idx, out, split=True)
    launches += 1
    name = str(out.dtype).removeprefix("torch.")
    launches_by_dtype[name] = launches_by_dtype.get(name, 0) + 1
    launches_by_streams[ns] = launches_by_streams.get(ns, 0) + 1
    return (out, ia, ib) if return_indices else out
