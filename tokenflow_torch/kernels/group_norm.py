"""K4: GroupNorm (+ optional SiLU), the hand-written CUDA kernel and its
plain version.

Replaces the Pallas TPU kernels of ``tokenflow_tpu/kernels/group_norm.py``
(``_group_norm_3d``'s stats and apply calls, reached through
``group_norm_nhwc``). Works on the port's NCHW activations: one (batch,
group) is one contiguous span, so the TPU's "bl"/"cl" layout transposes do
not carry over. Statistics in fp32 with ``var = E[x^2] - E[x]^2``, a
per-channel affine, SiLU when asked, the output in the input dtype. The
CUDA source is ``tokenflow_torch/csrc/group_norm.cu`` (its header gives the
design): memory bound, one bf16 read and one write for spans that fit
shared memory, two reads and one write for larger ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from tokenflow_torch.kernels import _build

# kernel launches made by :func:`group_norm_kernel`
launches = 0

# spans up to this many bytes run the resident variant (held in shared
# memory); larger ones are split into chunks of _SPLIT_CHUNK elements
_RESIDENT_MAX_BYTES = 200 * 1024
_SPLIT_CHUNK = 32768
_MAX_GROUP_CHANNELS = 1024  # per-channel affine held in shared memory


def group_norm_plain(
    x: torch.Tensor,  # (B, C, *spatial)
    weight: torch.Tensor,  # (C,)
    bias: torch.Tensor,  # (C,)
    groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm in plain PyTorch, mirroring ``group_norm_ref``
    (tokenflow_tpu/kernels/group_norm.py:57-77): fp32 statistics with
    ``var = E[x^2] - E[x]^2`` (not ``F.group_norm``'s own variance),
    ``(x - mean) * rsqrt(var + eps) * weight + bias``, then SiLU if
    ``act == "silu"``; returned in x's dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_kernel(
    x: torch.Tensor,  # (B, C, *spatial) bf16
    weight: torch.Tensor,  # (C,)
    bias: torch.Tensor,  # (C,)
    groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Launch K4 on a CUDA tensor; returns a new bf16 tensor of x's shape.
    Only bf16 activations and affine parameters are instantiated (the
    kernel widens gamma and beta itself, so a call is the kernel's launches
    alone): another dtype raises."""
    global launches
    dev = x.device
    if not x.is_cuda or weight.device != dev or bias.device != dev:
        raise ValueError("group_norm_kernel needs every operand on one CUDA device")
    if not (x.dtype == weight.dtype == bias.dtype == torch.bfloat16):
        raise NotImplementedError(
            "the CUDA GroupNorm kernel is instantiated for bf16; got "
            f"{x.dtype}, {weight.dtype}, {bias.dtype}"
        )
    if x.dim() < 2 or x.shape[1] % groups:
        raise ValueError(f"x {tuple(x.shape)}: channels must split into {groups} groups")
    b, c = x.shape[:2]
    cg = c // groups
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must be ({c},)")
    if cg > _MAX_GROUP_CHANNELS:
        raise NotImplementedError(
            f"{cg} channels per group exceed the kernel's {_MAX_GROUP_CHANNELS}"
        )
    if act not in (None, "silu"):
        raise ValueError(f"act must be None or 'silu', got {act!r}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel's 16-byte loads count from the base
        x = x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if x.numel() == 0:
        return out
    hw = x.numel() // (b * c)
    span = cg * hw
    chunk = 0 if span * x.element_size() <= _RESIDENT_MAX_BYTES else _SPLIT_CHUNK
    n_chunks = -(-span // chunk) if chunk else 0
    partials = torch.empty((b * groups * n_chunks, 2), dtype=torch.float32, device=dev)
    weight, bias = weight.contiguous(), bias.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.tf_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), partials.data_ptr(),
            out.data_ptr(), b * groups, groups, cg, hw, chunk, float(eps),
            int(act == "silu"), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "GroupNorm launch")
    launches += 1
    return out
