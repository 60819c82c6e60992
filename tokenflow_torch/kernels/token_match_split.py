"""K3: split token match + gather for the large-S propagation sites, the
hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``tokenflow_tpu/kernels/token_match_split.py``
(``token_match_gather_split``: ``_match_kernel``, then ``_gather_kernel``).
Same contract as K2 (``kernels/token_match.py``), in two stages with the TPU
kernel's interface between them: a match stage that updates the running
first maximum of BOTH pivots per z step and writes int32 indices ``ia``,
``ib`` shaped (F, 1, S), then the gather and blend. The match stage's CUDA
source is ``tokenflow_torch/csrc/token_match_split.cu`` (its header gives
the design); the gather stage is K2's, fed ``ia`` and ``ib`` as the rows of
one (2, F, S) buffer. Bound on the H100: the match stage is compute bound
(4 S^2 D flops per frame), the gather stage memory bound.

:func:`use_split` keeps the port's K2/K3 choice at the JAX package's sites.
"""

from __future__ import annotations

import torch

from tokenflow_torch.kernels import _build
from tokenflow_torch.kernels.token_match import (
    prepare_operands,
    token_match_gather_plain,
)

# kernel-pair launches made by :func:`token_match_gather_split_kernel`
launches = 0

# The JAX package's profitability cap for K2 (tokenflow_tpu/kernels/
# token_match.py:94-96, fits_vmem): a site whose one (ns, S, D) bf16
# keyframe table exceeds it runs K3 there (ops/propagation.py:186-209). At
# 768p that is the top level (3 * 9216 * 320 * 2 B = 16.9 MiB). Whether the
# threshold suits the H100 is not measured.
SPLIT_KF_TABLE_BYTES = 12 << 20

_MAX_D = 1728  # largest head width whose query tile fits shared memory (as K2)


def use_split(s: int, d: int, ns: int = 3) -> bool:
    """True where the JAX dispatch takes K3 instead of K2: one (ns, S, D)
    bf16 keyframe table larger than :data:`SPLIT_KF_TABLE_BYTES`."""
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
    norm_h: torch.Tensor,  # (F, S, D) bf16
    p_hat: torch.Tensor,  # (K, S, D) bf16, pre-normalized
    kf_attn: torch.Tensor,  # (ns, K, S, D) bf16
    pa: torch.Tensor,  # (F,) pivot index in [0, K)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
    *,
    return_indices: bool = False,
):
    """Launch K3 (match stage, then gather stage) on CUDA tensors, with K2's
    checks (pivot indices outside [0, K) raise IndexError). Returns a new
    (ns, F, S, D) bf16 tensor, and with ``return_indices`` also ``ia``,
    ``ib``: (F, 1, S) int32."""
    global launches
    norm_h, p_hat, kf_attn, pa, pb, w1 = prepare_operands(
        "token_match_gather_split_kernel", norm_h, p_hat, kf_attn, pa, pb, w1,
        _MAX_D,
    )
    dev = norm_h.device
    f_total, s, d = norm_h.shape
    ns, k = kf_attn.shape[:2]
    # ia and ib are the two rows of one (2, F, S) buffer, the index layout
    # of K2's gather stage, which K3 shares
    idx = torch.empty((2, f_total, s), dtype=torch.int32, device=dev)
    ia, ib = idx[0, :, None], idx[1, :, None]
    out = torch.empty((ns, f_total, s, d), dtype=kf_attn.dtype, device=dev)
    if f_total == 0 or s == 0:
        return (out, ia, ib) if return_indices else out
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tf_token_match_split(
            norm_h.data_ptr(), p_hat.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            ia.data_ptr(), ib.data_ptr(), f_total, s, d, stream,
        )
        _build.check(lib, rc, "split token-match (match stage) launch")
        rc = lib.tf_token_gather(
            kf_attn.data_ptr(), idx.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            w1.data_ptr(), out.data_ptr(), ns, k, f_total, s, d, stream,
        )
        _build.check(lib, rc, "split token-match (gather stage) launch")
    launches += 1
    return (out, ia, ib) if return_indices else out
