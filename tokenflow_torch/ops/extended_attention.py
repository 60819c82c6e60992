"""Keyframe extended attention.

PyTorch counterpart of ``tokenflow_tpu/ops/extended_attention.py``: the
uncond and cond streams attend over the K/V of all keyframes at once, which
is dense self-attention over the flattened (K * S) token sequence per
stream; the source stream keeps per-frame self-attention. Over a frames
group with the keyframes split across ranks, the two extended streams'
K and V are all-gathered along the sequence axis here (the JAX package's
``_sharded_flash`` partitioning rule), and the rank's queries attend
over them through the same :func:`flash_attention` call as without a
group: the gather is the only difference, and it is exact because softmax
rows are independent. This is the one place the frames group reaches
attention.
"""

from __future__ import annotations

import torch

from tokenflow_torch.ops.attention import flash_attention, merge_heads, split_heads
from tokenflow_torch.sharding import mesh


def inject_source_qk(
    q: torch.Tensor, k: torch.Tensor, gate: bool | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """PnP q/k injection: when ``gate`` is set (t in the injection
    schedule), the uncond and cond streams take the source stream's q and
    k; v is not injected (reference tokenflow_utils.py:124-130).
    q, k: (3, F, S, inner)."""
    if not gate:
        return q, k
    return q[:1].expand_as(q), k[:1].expand_as(k)


def extended_attention(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    *,
    heads: int,
    scale: float | None = None,
    kv_block: int = 2048,
    group=None,
    kf_counts=None,
) -> torch.Tensor:
    """Multi-stream keyframe attention.

    q3/k3/v3: (3, K, S, inner) projected q/k/v for [source|uncond|cond], or
    (2, K, S, inner) for [uncond|cond]. Returns (ns, K, S, inner): the
    source stream (when present) is per-frame self-attention; uncond and
    cond attend over all K frames' keys/values jointly. With a frames
    ``group`` (``sharding/mesh.py``) the K here are this rank's keyframes,
    ``kf_counts`` every rank's count in rank order: uncond and cond attend
    over all ranks' keyframes, whose K and V are all-gathered
    (``mesh.all_gather_along``, kind ``kv_all_gather``), and the source
    stream stays per frame and local.
    """
    ns, kf, s, inner = q3.shape
    if ns not in (2, 3):
        raise ValueError(f"expected 2 or 3 streams, got {ns}")
    d = inner // heads
    scale = d**-0.5 if scale is None else scale

    def ext(t):
        return split_heads(t[ns - 2 :].reshape(2, kf * s, inner), heads)

    q_ext, k_ext, v_ext = ext(q3), ext(k3), ext(v3)
    if group is not None:
        k_ext, v_ext = (mesh.all_gather_along(group, t, 1, [c * s for c in kf_counts],
                                              "kv_all_gather") for t in (k_ext, v_ext))
    out_ext = flash_attention(q_ext, k_ext, v_ext, scale=scale, kv_block=kv_block)
    out_ext = merge_heads(out_ext).reshape(2, kf, s, inner)
    if ns == 2:
        return out_ext
    out_src = flash_attention(
        split_heads(q3[0], heads),
        split_heads(k3[0], heads),
        split_heads(v3[0], heads),
        scale=scale,
        kv_block=kv_block,
    )
    return torch.cat([merge_heads(out_src).reshape(1, kf, s, inner), out_ext], dim=0)
