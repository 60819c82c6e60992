"""Operands a TMA tensor map accepts, shared by the kernels that load by
TMA (K1's flash attention, the token-match core of K2 and K3) and by
their fp32 versions, which load rows with 16-byte vector loads.

``cuTensorMapEncodeTiled`` needs a 16-byte aligned base, a unit stride
along the last dim and byte strides that are positive multiples of 16
(so element strides that are positive multiples of 8 for bf16 and of 4
for fp32; a broadcast ``expand`` view has stride 0). A tensor that breaks
a rule is cloned; one that keeps them all is passed as it is.
"""

from __future__ import annotations

import torch


def tma_operand(t: torch.Tensor, *, contiguous: bool = False) -> torch.Tensor:
    """``t`` itself if a tensor map can address it (with ``contiguous``: and
    it is contiguous, for kernels that are given no strides), else a
    contiguous clone. A clone, not ``.contiguous()``, which returns a
    contiguous view at a misaligned base as it is."""
    step = 16 // t.element_size()  # elements per 16 bytes
    *outer, last = t.stride()
    ok = (
        last == 1
        and min(outer, default=1) > 0
        and not any(s % step for s in outer)
        and t.data_ptr() % 16 == 0
        and (not contiguous or t.is_contiguous())
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)
