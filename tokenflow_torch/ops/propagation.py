"""Nearest-neighbour token propagation.

PyTorch counterpart of ``tokenflow_tpu/ops/propagation.py``. During a
propagation pass each frame's self-attention output is gathered from the
cached keyframe attention outputs through cosine-similarity nearest-
neighbour token matches against two pivots, then blended. The reference
quirks are kept on purpose: the blend weight assumes the pivot at the
window centre and goes through a sigmoid, matching runs on the source
stream only, and window 0 uses its own pivot twice. Only the pivot side is
L2-normalized (a positive row scale does not move the query's argmax).
"""

from __future__ import annotations

import numpy as np
import torch

from tokenflow_torch.kernels.token_match import (
    token_match_gather_kernel,
    token_match_gather_plain as match_gather,
    token_match_gather_sharded,
)
from tokenflow_torch.kernels.token_match_split import (
    token_match_gather_split_kernel,
    use_split,
)

__all__ = ["match_gather", "propagation_indices", "token_propagation",
           "token_propagation_sharded"]


def propagation_indices(
    n_frames: int, window_size: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side per-frame propagation metadata (pa, pb, w1): own-window
    pivot, previous-window pivot (window 0 reuses its own) and the blend
    weight of pa (reference tokenflow_utils.py:331-333, 375-383)."""
    f = np.arange(n_frames)
    w = f // window_size
    pa = w
    pb = np.maximum(w - 1, 0)
    center = window_size // 2
    p1 = pa * window_size + center
    p2 = pb * window_size + center
    d1 = np.abs(f - p1).astype(np.float64)
    d2 = np.abs(f - p2).astype(np.float64)
    w1 = 1.0 / (1.0 + np.exp(-(d2 / (d1 + d2 + 1e-8))))
    return pa.astype(np.int32), pb.astype(np.int32), w1.astype(np.float32)


def _pivots_hat(pivot_h_src: torch.Tensor, norm_h_src: torch.Tensor) -> torch.Tensor:
    """The L2-normalized pivot states, in fp32 and then in the query dtype
    on CUDA (as the TPU dispatch casts them, tokenflow_tpu/ops/propagation.py:
    186-209), in fp32 on the CPU."""
    p = pivot_h_src.float()
    p_hat = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    return p_hat.to(norm_h_src.dtype) if norm_h_src.is_cuda else p_hat


def token_propagation(
    norm_h_src: torch.Tensor,  # (F, S, D) stream-0 normed states
    pivot_h_src: torch.Tensor,  # (K, S, D) cached pivot states of that stream
    kf_attn: torch.Tensor,  # (ns, K, S, D) cached keyframe outputs
    pa: torch.Tensor,  # (F,)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
) -> torch.Tensor:
    """Gather per-frame attention outputs from the keyframe cache; returns
    (ns, F, S, D) in kf_attn's dtype. Stream 0 is the source stream, or
    uncond in the approximate pass, whose ns = 2 tables are [uncond|cond].
    CUDA tensors launch K3 where :func:`use_split` holds (the large-S
    sites) and K2 elsewhere, with the normalized pivots cast to the query
    dtype (as the TPU dispatch does, tokenflow_tpu/ops/propagation.py:
    186-209); CPU tensors run the plain version on fp32 normalized pivots."""
    p_hat = _pivots_hat(pivot_h_src, norm_h_src)
    if norm_h_src.is_cuda:
        _, s, d = norm_h_src.shape
        kernel = (
            token_match_gather_split_kernel if use_split(s, d, kf_attn.shape[0])
            else token_match_gather_kernel
        )
        return kernel(norm_h_src, p_hat, kf_attn, pa, pb, w1)
    if norm_h_src.device.type != "cpu":
        raise ValueError(f"no propagation path for device {norm_h_src.device}")
    return match_gather(norm_h_src, p_hat, kf_attn, pa, pb, w1)


def token_propagation_sharded(norm_h_src, pivot_h_src, kf_attn, pa, pb, w1) -> torch.Tensor:
    """:func:`token_propagation` over a frames group: ``norm_h_src`` and the
    per-frame ``pa``/``pb``/``w1`` are the rank's block of the frames, the
    cache replicated, and the pivot indices global; the match and gather go
    through ``token_match_gather_sharded``, which chooses K2 or K3 as
    :func:`token_propagation` does."""
    return token_match_gather_sharded(
        norm_h_src, _pivots_hat(pivot_h_src, norm_h_src), kf_attn, pa, pb, w1)
