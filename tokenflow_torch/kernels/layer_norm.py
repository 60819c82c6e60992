"""K5: LayerNorm over the last axis, the hand-written CUDA kernel and its
plain version.

The transformer blocks' and the CLIP text towers' ``LayerNorm32``
(``models/layers.py``) on a bf16 stack: fp32 statistics and affine, the
output rounded to bf16 once, as the fp32 path (``F.layer_norm`` on an fp32
copy of the activation, cast back) computes it, without that copy in
device memory. The statistics take two passes over the row (the mean, then
the mean of squared deviations), so rows far from zero lose nothing to an
``E[x^2] - E[x]^2`` cancellation. The CUDA source is
``tokenflow_torch/csrc/layer_norm.cu`` (its header gives the design: a row
per segment of a warp, held in registers, one row group per warp);
:func:`plan` picks the segment from C alone. Instantiated for bf16 (x, weight and bias
alike) with C a multiple of 8 up to 2816; another dtype or width on CUDA
raises.

The rotary entry (:func:`layer_norm_rope_kernel`, ``tf_layer_norm_rope``)
is HunyuanDiT's per-head q/k norm and 2-D RoPE in one launch: each head of
each token of a (B, S, H, D) tensor normed as K5 norms it and rounded to
bf16, then rotated on interleaved pairs by the fp32 (S, D) cos / sin
tables at the token's position and rounded again, as
:func:`layer_norm_rope_plain` computes it. Its plan is :func:`plan`'s at D
(``ROPE_LANES`` lanes a row, D up to ``ROPE_MAX_HEAD_DIM``); it counts its
launches apart from K5's (``rope_launches``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tokenflow_torch.kernels import _build

# kernel launches made by :func:`layer_norm_kernel`
launches = 0
# launches by dtype ("bfloat16"), the same launches as ``launches``
launches_by_dtype: dict[str, int] = {}
# launches by (rows, C), the same launches as ``launches``
launches_by_shape: dict[tuple[int, int], int] = {}
# launches made by :func:`layer_norm_rope_kernel` (not in ``launches``)
rope_launches = 0

LANES = (4, 8, 16, 32)  # lanes a row can take (csrc/layer_norm.cu)
# 16-byte vectors a lane can hold (at 32 lanes: the plan gives fewer lanes
# at most 5): C up to 2816, HunyuanDiT's long-skip norm of two 1408-wide
# states
MAX_VECS = 11
_VECS_TARGET = 5  # the plan's most vectors a lane, below 32 lanes
MAX_CHANNELS = 32 * MAX_VECS * 8
_WARPS = 8  # warps a CTA
# the rotary entry's lanes a row and most vectors a lane (csrc/layer_norm.cu
# kRopeLanes, kRopeMaxVecs): the head dims whose plan takes 4 lanes
ROPE_LANES = 4
ROPE_MAX_VECS = 5
ROPE_MAX_HEAD_DIM = ROPE_LANES * ROPE_MAX_VECS * 8


class Plan(NamedTuple):
    """How K5 runs rows of C: ``lanes`` lanes of a warp per row, ``vecs``
    16-byte vectors (8 bf16) per lane."""

    lanes: int
    vecs: int


@functools.lru_cache(maxsize=64)
def plan(c: int) -> Plan:
    """The fewest lanes whose vectors per lane stay at ``_VECS_TARGET`` or
    under, else 32 lanes: rows held in registers with the most independent
    loads a lane that keep registers low (C = 320: 8 x 5, 640: 16 x 5,
    1280: 32 x 5, 768: 32 x 3, 1024: 32 x 4; HunyuanDiT's 88: 4 x 3,
    1408: 32 x 6, 2816: 32 x 11)."""
    if c <= 0 or c % 8 or c > MAX_CHANNELS:
        raise NotImplementedError(
            f"the CUDA LayerNorm kernel takes C a multiple of 8 up to {MAX_CHANNELS}, not {c}"
        )
    n_vec = c // 8
    for lanes in LANES:
        if -(-n_vec // lanes) <= _VECS_TARGET:
            return Plan(lanes, -(-n_vec // lanes))
    return Plan(32, -(-n_vec // 32))


def layer_norm_plain(
    x: torch.Tensor,  # (..., C)
    weight: torch.Tensor,  # (C,)
    bias: torch.Tensor,  # (C,)
    eps: float,
) -> torch.Tensor:
    """LayerNorm in plain PyTorch with K5's maths: fp32 mean, then the fp32
    mean of squared deviations, ``(x - mean) * rsqrt(var + eps) * weight +
    bias``, returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def prepare_operands(x, weight, bias):
    """The wrapper's checks: one CUDA device; x, weight and bias bf16;
    per-channel parameters over x's last axis; C that :func:`plan` takes.
    Returns x contiguous and 16-byte aligned (a misaligned one is cloned),
    weight and bias likewise."""
    dev = x.device
    if not x.is_cuda or weight.device != dev or bias.device != dev:
        raise ValueError("layer_norm_kernel needs every operand on one CUDA device")
    if not (x.dtype == weight.dtype == bias.dtype == torch.bfloat16):
        raise NotImplementedError(
            "the CUDA LayerNorm kernel is instantiated for bf16 x, weight and bias; "
            f"got {x.dtype}, {weight.dtype}, {bias.dtype}"
        )
    c = x.shape[-1] if x.dim() else 0
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must be ({c},), the last axis of x")
    ops = []
    for t in (x, weight, bias):
        t = t.contiguous()
        ops.append(t.clone() if t.data_ptr() % 16 else t)
    return tuple(ops)


def launch(ops, out: torch.Tensor, eps: float, p: Plan) -> None:
    """One launch of K5 on operands from :func:`prepare_operands` into
    ``out`` (x's shape, contiguous, 16-byte aligned). The wrapper counts
    its launches."""
    x, weight, bias = ops
    c = x.shape[-1]
    _call("tf_layer_norm", x, "LayerNorm launch", x.data_ptr(), weight.data_ptr(),
          bias.data_ptr(), out.data_ptr(), x.numel() // c, c, p.lanes, p.vecs, float(eps))


def _call(name: str, x: torch.Tensor, what: str, *args) -> None:
    """Call the library's launcher ``name`` with ``args`` and x's current
    raw stream, on x's device; raise on a CUDA error."""
    lib = _build.load_library()
    fn = getattr(lib, name)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, stream)
    _build.check(lib, rc, what)


def grid(rows: int, p: Plan) -> int:
    """CTAs K5 launches for ``rows`` rows: one row group (32 / lanes rows)
    per warp, 8 warps a CTA (csrc/layer_norm.cu ``grid_for``)."""
    return -(-rows // (_WARPS * (32 // p.lanes)))


def layer_norm_kernel(
    x: torch.Tensor,  # (..., C) bf16
    weight: torch.Tensor,  # (C,) bf16
    bias: torch.Tensor,  # (C,) bf16
    eps: float,
) -> torch.Tensor:
    """Launch K5 on CUDA tensors; returns a new tensor of x's shape, bf16."""
    global launches
    ops = prepare_operands(x, weight, bias)
    x = ops[0]
    c = x.shape[-1]
    p = plan(c)
    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    launch(ops, out, eps, p)
    launches += 1
    launches_by_dtype["bfloat16"] = launches_by_dtype.get("bfloat16", 0) + 1
    launches_by_shape[(rows, c)] = launches_by_shape.get((rows, c), 0) + 1
    return out


def layer_norm_rope_plain(
    x: torch.Tensor,  # (B, S, H, D)
    weight: torch.Tensor,  # (D,)
    bias: torch.Tensor,  # (D,)
    eps: float,
    cos: torch.Tensor,  # (S, D) fp32
    sin: torch.Tensor,  # (S, D) fp32
) -> torch.Tensor:
    """The rotary entry in plain PyTorch: :func:`layer_norm_plain` over each
    head, rounded to x's dtype, then in fp32 ``y cos + rot(y) sin`` with
    rot(y)_{2k, 2k+1} = (-y_{2k+1}, y_{2k}), the tables' row s for token s,
    rounded to x's dtype again."""
    y = layer_norm_plain(x, weight, bias, eps).float()
    pairs = y.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    out = y * cos[:, None, :]
    out.addcmul_(rot, sin[:, None, :])
    return out.to(x.dtype)


def rope_plan(d: int) -> Plan:
    """:func:`plan` at head dim d, which the rotary entry must take whole:
    ``ROPE_LANES`` lanes a row (d up to ``ROPE_MAX_HEAD_DIM``)."""
    p = plan(d)
    if p.lanes != ROPE_LANES:
        raise NotImplementedError(
            f"the rotary LayerNorm kernel takes head dims up to {ROPE_MAX_HEAD_DIM}, not {d}")
    return p


def layer_norm_rope_kernel(
    x: torch.Tensor,  # (B, S, H, D) bf16
    weight: torch.Tensor,  # (D,) bf16
    bias: torch.Tensor,  # (D,) bf16
    eps: float,
    cos: torch.Tensor,  # (S, D) fp32
    sin: torch.Tensor,  # (S, D) fp32
) -> torch.Tensor:
    """Launch the rotary entry on CUDA tensors; returns a new (B, S, H, D)
    bf16 tensor."""
    global rope_launches
    if x.dim() != 4:
        raise ValueError(f"the rotary LayerNorm takes x (B, S, H, D), not {tuple(x.shape)}")
    _, s, h, d = x.shape
    if cos.shape != (s, d) or sin.shape != (s, d):
        raise ValueError(f"cos and sin must be ({s}, {d}), one row a token of x")
    if not (cos.dtype == sin.dtype == torch.float32) or cos.device != x.device \
            or sin.device != x.device:
        raise ValueError("cos and sin must be fp32 on x's device")
    p = rope_plan(d)
    x, weight, bias = prepare_operands(x, weight, bias)
    cos, sin = (t.contiguous() for t in (cos, sin))
    cos, sin = (t.clone() if t.data_ptr() % 16 else t for t in (cos, sin))
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    _call("tf_layer_norm_rope", x, "rotary LayerNorm launch", x.data_ptr(), weight.data_ptr(),
          bias.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), rows, d, p.lanes,
          p.vecs, h, s, float(eps))
    rope_launches += 1
    return out
