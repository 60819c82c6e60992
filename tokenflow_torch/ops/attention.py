"""Attention primitives (plain tensor functions).

PyTorch counterpart of ``tokenflow_tpu/ops/attention.py``. Layout is
batch-first ``(B, S, H, D)``; logits and softmax run in fp32 and the output
comes back in the input dtype. :func:`flash_attention` keeps the JAX
shortcut to dense attention when the KV sequence fits one block
(``Skv <= kv_block``): a CUDA call with bf16 q, k and v at one of K6's head
dims launches the hand-written short-key kernel K6
(``kernels/short_attention.py``), every other one runs the plain
:func:`sdp_attention` (CPU tensors, the fp32 stack). Longer sequences go to
the hand-written CUDA kernel K1 for CUDA tensors and to its plain blockwise
version for CPU tensors. The routing reads only the call's device, dtypes,
head dim and key length; there is no switch to choose otherwise.
"""

from __future__ import annotations

import torch

from tokenflow_torch.kernels import short_attention
from tokenflow_torch.kernels.flash_attention import (
    flash_attention_kernel,
    flash_attention_plain,
)
from tokenflow_torch.profiling import span

# CUDA calls of :func:`flash_attention` that took :func:`sdp_attention`
# (reset by callers): 0 on the UNet's, ControlNet's and DiT's bf16 paths,
# where K6 takes every short-key call
plain_on_cuda = 0


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, S, H, D)."""
    b, s, inner = x.shape
    return x.reshape(b, s, heads, inner // heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H*D)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def sdp_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """softmax(Q K^T * scale) V with fp32 logits and fp32 products in P V.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D). Returns (B, Sq, H, D) in q.dtype.
    Mirrors the jnp version (``preferred_element_type=float32`` on both
    products, probabilities cast to the input dtype before P V). Runs
    inside a ``tf.sdp`` span.
    """
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    with span("tf.sdp"):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits * scale, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
        return out.to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    kv_block: int = 2048,
) -> torch.Tensor:
    """Attention that never materializes the full (Sq, Skv) logits once
    Skv exceeds ``kv_block`` (the JAX package's rule,
    tokenflow_tpu/ops/attention.py:116-118): CUDA tensors launch K1 (or
    raise), CPU tensors run the plain blockwise version. At or under
    ``kv_block``, bf16 CUDA tensors at one of K6's head dims launch K6
    inside a ``tf.sdp`` span; other calls run :func:`sdp_attention`."""
    global plain_on_cuda
    if k.shape[1] <= kv_block:
        if (q.is_cuda and q.dtype == k.dtype == v.dtype == torch.bfloat16
                and q.shape[-1] in short_attention.HEAD_DIMS):
            with span("tf.sdp"):
                return short_attention.short_attention_kernel(
                    q, k, v, scale=scale, kv_block=kv_block)
        if q.is_cuda:
            plain_on_cuda += 1
        return sdp_attention(q, k, v, scale=scale)
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
    return flash_attention_plain(q, k, v, scale=scale, kv_block=kv_block)
