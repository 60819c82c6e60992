"""K6: short-key attention, the hand-written CUDA kernel.

softmax(Q K^T scale) V for the attention calls whose keys fit the UNet's
``kv_block`` (1024): every cross-attention call (77 text tokens; HunyuanDiT's
333 CLIP and mT5 tokens at head dim 88), the source
stream's own self attention at the 32^2, 16^2 and 8^2 levels, the 8^2 mid
block's extended attention and, on passes without an edit (the inversion,
the ControlNet), the plain self attention at those levels.
``ops/attention.py::flash_attention`` sends a call here when it lies on
CUDA, q, k and v are bf16, the head dim is one of ``HEAD_DIMS`` and the keys
are at most ``kv_block``; every other short-key call takes the plain version,
``ops/attention.py::sdp_attention`` (the CPU, the fp32 stack, the VAE's one
512-wide head). K6 keeps that version's precision: fp32 logits and softmax
statistics on chip, probabilities cast to bf16 before P V, P V summed in
fp32, bf16 output.

The CUDA source is ``tokenflow_torch/csrc/short_attention.cu``; its header
gives the design: persistent blocks that walk many 128-row query steps of
one head after another, a producer warpgroup feeding Q through a TMA ring,
wgmma products, and O leaving through a staged TMA store. Two plans, by the
key length alone (:func:`plan`): up to ``ONE_TILE_KEYS`` keys the row is
one tile whose K and V a block loads once per head, and P is normalised
before its bf16 cast, as ``sdp_attention`` does; longer rows stream K/V
tiles with K1's online softmax. What bounds it: bytes where the keys are
few (cross attention reads Q and writes O at about 77 flops a byte),
operations at 1024 keys.

Per call the wrapper does only what a launch needs, as K1's does: the
checks, ``tma_operand`` on each operand, the output (``new_empty``) and the
device's current stream as a raw handle.
"""

from __future__ import annotations

import torch

from tokenflow_torch.kernels import _build
from tokenflow_torch.kernels._operands import tma_operand

# kernel launches made by :func:`short_attention_kernel` (reset by callers)
launches = 0
# launches by head dim, the same launches as ``launches``
launches_by_head_dim: dict[int, int] = {}
# launches by (B, Sq, Skv, H, D), the same launches as ``launches``
launches_by_shape: dict[tuple[int, int, int, int, int], int] = {}
# launches by plan ("one_tile", "streamed"), the same launches as ``launches``
launches_by_plan: dict[str, int] = {}
# the head dims the CUDA kernel is instantiated for (K1's bf16 ones: SD's
# and HunyuanDiT's 88)
HEAD_DIMS = (40, 64, 80, 88, 160)
# the UNet's kv_block: the longest key sequence the kernel is sent
KV_BLOCK = 1024
# the most keys the one-tile plan takes (csrc/short_attention.cu, dispatch)
ONE_TILE_KEYS = 128


def plan(skv: int) -> str:
    """The plan K6 takes at ``skv`` keys: the whole row in one tile, or the
    row streamed through a ring of tiles."""
    return "one_tile" if skv <= ONE_TILE_KEYS else "streamed"


def short_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    kv_block: int = KV_BLOCK,
) -> torch.Tensor:
    """Launch K6 on CUDA tensors q (B, Sq, H, D), k/v (B, Skv, H, D), all
    bf16 on one device, D in ``HEAD_DIMS``, Skv at most ``kv_block``.
    Returns a new (B, Sq, H, D) bf16 tensor."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B,Sq,H,D), k/v (B,Skv,H,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    kb, skv, kh, kd = k.shape
    if kb != b or kh != h or kd != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or d not in HEAD_DIMS:
        raise NotImplementedError(
            "the CUDA short-key attention kernel is instantiated for bf16 q, k and v "
            f"with head dims {HEAD_DIMS}; got {q.dtype}, {k.dtype}, {v.dtype}, head dim {d}"
        )
    if skv > kv_block:
        raise ValueError(f"{skv} keys exceed kv_block {kv_block}: that call is K1's")
    device = q.device
    if device.type != "cuda" or k.device != device or v.device != device:
        raise ValueError(
            "short_attention_kernel needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    scale = d**-0.5 if scale is None else scale
    if not scale > 0:
        raise ValueError(f"the kernel's softmax takes a positive scale, got {scale}")
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    out = q.new_empty((b, sq, h, d))
    if b == 0 or sq == 0 or h == 0:
        return out
    if skv == 0:
        raise ValueError("attention over an empty key sequence")
    lib = _build.load_library()
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    args = (
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), stream,
    )
    if device.index == torch.cuda.current_device():
        rc = lib.tf_short_attention(*args)
    else:
        with torch.cuda.device(device):
            rc = lib.tf_short_attention(*args)
    _build.check(lib, rc, "short_attention_kernel launch")
    launches += 1
    launches_by_head_dim[d] = launches_by_head_dim.get(d, 0) + 1
    shape = (b, sq, skv, h, d)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    p = plan(skv)
    launches_by_plan[p] = launches_by_plan.get(p, 0) + 1
    return out
