"""K1: flash attention, the hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``tokenflow_tpu/kernels/flash_attention.py``
(``flash_attention_bhsd``, kernel ``_flash_kernel``): softmax(Q K^T scale) V
with an online softmax that keeps (acc, m, l) in fp32 on chip across KV
tiles. The CUDA source is ``tokenflow_torch/csrc/flash_attention.cu``; its
header comment gives the design (TMA loads into an mbarrier ring, wgmma
products, a producer warpgroup and two or three consumer warpgroups). Each
head dim has its own tile plan (``Cfg<D, kCons>`` there; the library
reports a launch's plan through ``tf_flash_attention_plan``): Q K^T runs
ceil(D / 16) k-steps deep and P V exactly D columns wide, so D = 40, 80,
88 and 160 multiply no zero-padded columns into O; D = 40 and 64 take 192
query rows a block, D = 80 and 88 128, and D = 160 whichever of 192 and 128 ends
its grid first on the card's SMs (128 on one-wave grids such as 4
keyframes at 512^2, 192 at 5). Bound on the H100: compute (4 Sq Skv D
flops against (Sq + 2 Skv) D bf16 bytes per head). Measured by device
time on an H100 80GB HBM3 at 700 W: about half the bound at D = 64 on the
path's long rows, 33-39% at D = 40, 46% at D = 80, 39% at D = 160
(PERF.md; the header comment says what holds D = 40 back).

Per call the wrapper does only what a launch needs (its enqueue read
21-32 us on the short rows, against 28-56 before): the checks,
``tma_operand`` on each operand, the output (``new_empty``), the device's
current stream as a raw handle, and the device context only when the
operands lie on another device than the current one; the library sets
each kernel's shared-memory limit once per device.

The wrapper takes the framework's (B, S, H, D) layout and passes strides
to the kernel (no (B, H, S, D) copy), from which the kernel's TMA tensor
maps are built. TMA needs a 16-byte aligned base and byte strides that are
positive multiples of 16, so a tensor whose strides are not positive
multiples of 8 elements (a broadcast ``expand`` view has stride 0) or whose
base is not 16-byte aligned is first copied into a new contiguous tensor
(``kernels/_operands.py``, the rule the token-match core shares).
Instantiated for bf16 at ``HEAD_DIMS``: D = 64 (every SD-2.x site), D =
40, 80, 160 (SD-1.5's 8 heads over 320, 640 and 1280 channels) and D = 88
(HunyuanDiT's 16 heads over 1408: Q K^T six k-steps deep, the last over
the zero-filled columns 88-95, P V at m64n88k16); for fp32 at
``HEAD_DIMS_F32``, SD's four. fp32 (the stack's ``dtype: f32``) launches its own kernel,
``tokenflow_torch/csrc/flash_attention_f32.cu``: the same function with
both products on the tensor cores as 3xTF32 splits, fp32-class error
(relative L2 at most 1.1e-6 against the plain version in fp32 at the
paths' shapes on the H100), after a split pre-pass into a workspace
the wrapper allocates (``tf_flash_attention_f32_workspace`` bytes); bound
at 3 x its flops on the 495 TFLOP/s TF32 tensor cores (and, read at the
plain fp32 rate, at 67 TFLOP/s of FFMA). Its operands follow ``tma_operand``'s rule at 4 elements. An fp32
operand is never cast to bf16. Mixed dtypes, any other dtype (fp16) or
head dim on CUDA raise.

The module knows one device only. Over a frames group the pivotal pass's
K/V all-gather is made by ``ops/extended_attention.py``, which then calls
the same ``ops/attention.py::flash_attention`` as without a group.
"""

from __future__ import annotations

import torch

from tokenflow_torch.kernels import _build
from tokenflow_torch.kernels._operands import tma_operand

# kernel launches made by :func:`flash_attention_kernel` (reset by callers)
launches = 0
# launches by head dim, the same launches as ``launches``
launches_by_head_dim: dict[int, int] = {}
# launches by dtype ("bfloat16", "float32"), the same launches as ``launches``
launches_by_dtype: dict[str, int] = {}
# launches by (B, Sq, Skv, H, D), the same launches as ``launches``
launches_by_shape: dict[tuple[int, int, int, int, int], int] = {}
# the head dims the CUDA kernels are instantiated for: bf16 (HunyuanDiT's 88
# besides SD's) and fp32
HEAD_DIMS = (40, 64, 80, 88, 160)
HEAD_DIMS_F32 = (40, 64, 80, 160)
# the C entry point of each dtype's kernel
ENTRY_POINTS = {torch.bfloat16: "tf_flash_attention", torch.float32: "tf_flash_attention_f32"}
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    kv_block: int = 2048,
) -> torch.Tensor:
    """Blockwise online-softmax attention in plain PyTorch.

    Mirrors the jnp scan of ``tokenflow_tpu/ops/attention.py:139-182``:
    fp32 logits per KV block of ``kv_block`` tokens, a running (acc, m, l)
    in fp32, probabilities cast to the value dtype before the P V product
    (whose products are taken in fp32). The ragged last block is sliced
    instead of padded with masked tokens, which adds the same zeros.
    q: (B, Sq, H, D); k, v: (B, Skv, H, D). Returns (B, Sq, H, D), q.dtype.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    qf = q.float()
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, skv, kv_block):
        k_i = k[:, start : start + kv_block].float()
        v_i = v[:, start : start + kv_block]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_i) * scale
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum(
            "bhqk,bkhd->bqhd", p.to(v.dtype).float(), v_i.float()
        )
        acc = acc * corr.permute(0, 2, 1)[..., None] + pv
        m = m_new
    out = acc / l.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch K1 on CUDA tensors q (B, Sq, H, D), k/v (B, Skv, H, D), all
    bf16 (D in ``HEAD_DIMS``) or all fp32 (D in ``HEAD_DIMS_F32``) on one
    device. Returns a new (B, Sq, H, D) tensor in their dtype."""
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
    dtype = q.dtype
    dims = HEAD_DIMS_F32 if dtype == torch.float32 else HEAD_DIMS
    if d not in dims or dtype not in ENTRY_POINTS or k.dtype != dtype or v.dtype != dtype:
        raise NotImplementedError(
            "the CUDA flash-attention kernels are instantiated for bf16 (head dims "
            f"{HEAD_DIMS}) and fp32 (head dims {HEAD_DIMS_F32}), q, k, v alike; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}, head dim {d}"
        )
    device = q.device
    if device.type != "cuda" or k.device != device or v.device != device:
        raise ValueError(
            "flash_attention_kernel needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit")
    scale = d**-0.5 if scale is None else scale
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    out = q.new_empty((b, sq, h, d))
    if b == 0 or sq == 0 or h == 0:
        return out
    if skv == 0:
        raise ValueError("attention over an empty key sequence")
    lib = _build.load_library()
    # the fp32 kernel's split tables (hi and lo parts of Q, K and V^T)
    workspace = (
        [q.new_empty(lib.tf_flash_attention_f32_workspace(d, b, h, sq, skv),
                     dtype=torch.uint8)]
        if dtype == torch.float32 else []
    )
    # the device's current stream as a raw handle, without building a
    # torch.cuda.Stream (a few microseconds a call on short rows)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    args = (
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), *(w.data_ptr() for w in workspace), stream,
    )
    entry = getattr(lib, ENTRY_POINTS[dtype])
    if device.index == torch.cuda.current_device():
        rc = entry(*args)
    else:
        with torch.cuda.device(device):
            rc = entry(*args)
    _build.check(lib, rc, "flash_attention_kernel launch")
    launches += 1
    launches_by_head_dim[d] = launches_by_head_dim.get(d, 0) + 1
    name = DTYPE_NAMES[dtype]
    launches_by_dtype[name] = launches_by_dtype.get(name, 0) + 1
    shape = (b, sq, skv, h, d)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return out

