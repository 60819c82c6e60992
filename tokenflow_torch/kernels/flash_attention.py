"""K1: flash attention, the hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``tokenflow_tpu/kernels/flash_attention.py``
(``flash_attention_bhsd``, kernel ``_flash_kernel``): softmax(Q K^T scale) V
with an online softmax that keeps (acc, m, l) in fp32 on chip across KV
tiles. The CUDA source is ``tokenflow_torch/csrc/flash_attention.cu``; its
header comment gives the design (TMA loads into an mbarrier ring, wgmma
products, a producer warpgroup and two or three consumer warpgroups, tiles
cut along D into 64-column boxes). Bound on the H100: compute (4 Sq Skv D
flops against (Sq + 2 Skv) D bf16 bytes per head).

The wrapper takes the framework's (B, S, H, D) layout and passes strides
to the kernel (no (B, H, S, D) copy), from which the kernel's TMA tensor
maps are built. TMA needs a 16-byte aligned base and byte strides that are
positive multiples of 16, so a tensor whose strides are not positive
multiples of 8 elements (a broadcast ``expand`` view has stride 0) or whose
base is not 16-byte aligned is first copied into a new contiguous tensor
(``kernels/_operands.py``, the rule the token-match core shares).
Instantiated for bf16 and for fp32 at ``HEAD_DIMS``: D = 64 (every SD-2.x
site) and D = 40, 80, 160 (SD-1.5's 8 heads over 320, 640 and 1280
channels). fp32 (the stack's ``dtype: f32``) launches its own kernel,
``tokenflow_torch/csrc/flash_attention_f32.cu``: the same function with
both products on the tensor cores as 3xTF32 splits, fp32-class error
(relative L2 at most 1.1e-6 against the plain version in fp32 at the
paths' shapes on the H100), after a split pre-pass into a workspace
the wrapper allocates (``tf_flash_attention_f32_workspace`` bytes); bound
at 3 x its flops on the 495 TFLOP/s TF32 tensor cores (and, read at the
plain fp32 rate, at 67 TFLOP/s of FFMA). Its operands follow ``tma_operand``'s rule at 4 elements. An fp32
operand is never cast to bf16. Mixed dtypes, any other dtype (fp16) or
head dim on CUDA raise.

:func:`flash_attention_sharded` is the entry over a frames group (the JAX
package's ``_sharded_flash`` partitioning rule): it all-gathers K/V across
the ranks and runs K1 on the rank's queries, counting its launches apart.
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
# the head dims the CUDA kernels are instantiated for, in both dtypes
HEAD_DIMS = (40, 64, 80, 160)
# the C entry point of each dtype's kernel
ENTRY_POINTS = {torch.bfloat16: "tf_flash_attention", torch.float32: "tf_flash_attention_f32"}


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
    bf16 or all fp32 on one device, D in ``HEAD_DIMS``. Returns a new (B,
    Sq, H, D) tensor in their dtype."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B,Sq,H,D), k/v (B,Skv,H,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS or q.dtype not in ENTRY_POINTS or not (
        q.dtype == k.dtype == v.dtype
    ):
        raise NotImplementedError(
            "the CUDA flash-attention kernels are instantiated for bf16 and fp32 "
            f"(q, k, v alike) with head dims {HEAD_DIMS}; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}, head dim {d}"
        )
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            "flash_attention_kernel needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit")
    skv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    q, k, v = (tma_operand(t) for t in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return out
    if skv == 0:
        raise ValueError("attention over an empty key sequence")
    lib = _build.load_library()
    # the fp32 kernel's split tables (hi and lo parts of Q, K and V^T)
    workspace = (
        [torch.empty(lib.tf_flash_attention_f32_workspace(d, b, h, sq, skv),
                     dtype=torch.uint8, device=q.device)]
        if q.dtype == torch.float32 else []
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, ENTRY_POINTS[q.dtype])(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, skv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            float(scale), *(w.data_ptr() for w in workspace), stream,
        )
    _build.check(lib, rc, "flash_attention_kernel launch")
    launches += 1
    launches_by_head_dim[d] = launches_by_head_dim.get(d, 0) + 1
    name = str(q.dtype).removeprefix("torch.")
    launches_by_dtype[name] = launches_by_dtype.get(name, 0) + 1
    return out


# launches of K1 made through :func:`flash_attention_sharded` (also counted
# in ``launches``), and by the per-rank (Sq, Skv) of each
launches_sharded = 0
launches_sharded_by_shape: dict[tuple[int, int], int] = {}


def flash_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    kv_sizes,
    scale: float | None = None,
    kv_block: int = 2048,
) -> torch.Tensor:
    """K1 over a frames group, the counterpart of ``flash_attention_sharded``
    (``tokenflow_tpu/kernels/flash_attention.py:300``, partitioning rule
    ``_sharded_flash`` :210): the queries stay on their rank, K and V are
    all-gathered along the sequence axis (rank r holds ``kv_sizes[r]``
    tokens of it, the keyframe axis flattened in: ``sharding/mesh.py``), and
    each rank attends its queries against the full K/V, which is exact
    because softmax rows are independent. The attention itself is
    ``ops/attention.py::flash_attention`` on the gathered K/V: dense when it
    fits ``kv_block``, else K1 on CUDA tensors and the plain version on CPU
    ones. q: (B, Sq, H, D); k, v: (B, Skv_rank, H, D); returns (B, Sq, H,
    D)."""
    global launches_sharded
    from tokenflow_torch.ops.attention import flash_attention
    from tokenflow_torch.sharding.mesh import all_gather_along

    k, v = (all_gather_along(group, t, 1, kv_sizes, "kv_all_gather") for t in (k, v))
    before = launches
    out = flash_attention(q, k, v, scale=scale, kv_block=kv_block)
    if launches > before:  # K1 launched
        launches_sharded += 1
        shape = (q.shape[1], k.shape[1])
        launches_sharded_by_shape[shape] = launches_sharded_by_shape.get(shape, 0) + 1
    return out
