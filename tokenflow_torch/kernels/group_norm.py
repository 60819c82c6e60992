"""K4: GroupNorm (+ optional SiLU), the hand-written CUDA kernel and its
plain version.

Replaces the Pallas TPU kernels of ``tokenflow_tpu/kernels/group_norm.py``
(``_group_norm_3d``'s stats and apply calls, reached through
``group_norm_nhwc``). Works on the port's NCHW activations: one (batch,
group) is one contiguous span, so the TPU's "bl"/"cl" layout transposes do
not carry over. Statistics in fp32 with ``var = E[x^2] - E[x]^2``, a
per-channel affine, SiLU when asked, the output in the input dtype (bf16 or
fp32). The CUDA source is ``tokenflow_torch/csrc/group_norm.cu`` (its header
gives the design); :func:`plan` picks its variant from the shape and dtype
alone: the cluster variant, one device-memory read and one write, for every
span a thread-block cluster holds in shared memory, and the split variant,
two reads and one write, for larger ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from tokenflow_torch.kernels import _build

# kernel launches made by :func:`group_norm_kernel`
launches = 0
# launches by dtype ("bfloat16", "float32"), the same launches as ``launches``
launches_by_dtype: dict[str, int] = {}
# launches by (B, C, H * W), the same launches as ``launches``
launches_by_shape: dict[tuple[int, int, int], int] = {}

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
_MAX_GROUP_CHANNELS = 1024  # channels per group the kernels take

# the cluster variant's limits (csrc/group_norm.cu)
# CTAs per span: 1 runs without a cluster; 16 is a non-portable cluster size
CLUSTER_SIZES = (1, 2, 4, 8, 16)
_SMEM_MAX = 232_448  # dynamic shared memory one CTA can use on the H100
_SMEM_PER_SM = 233_472  # an SM's shared memory, 1 KB of it reserved per CTA
_RESERVED_PER_CTA = 1024
_MAX_CTAS_PER_SM = 8  # 2048 threads of 256-thread CTAs
_HEADER_BYTES = 256  # piece barriers, reduction slots, the CTA's partial
_MAX_PIECES = 16  # mbarriers per CTA
_PIECE_BYTES = (8 * 1024, 32 * 1024)  # a bulk copy's least and largest size
_PIECES_PER_SLICE = 8  # pieces a slice is cut into, within those sizes
# A CTA's own phases (load, sum, cluster barrier, normalise and store) run
# one after the other, so other CTAs on its SM keep the memory busy: a span
# runs on one CTA, without a cluster, when that CTA fits _MIN_CTAS_PER_SM
# times on an SM, or _ALONE_PER_SM times with at least _ALONE_MIN_WAVES
# waves of spans to overlap; otherwise it is cut for _MIN_CTAS_PER_SM CTAs
# per SM where a cluster allows. Slices much smaller only add cluster
# traffic (chip_smoke.sweep_group_norm_clusters on the H100)
_MIN_CTAS_PER_SM = 3
_ALONE_PER_SM = 2
_ALONE_MIN_WAVES = 4
_SMS = 132  # the H100 SXM's streaming multiprocessors
_SPLIT_CHUNK = 32768  # elements per block of the split variant


class Plan(NamedTuple):
    """How K4 runs one shape: the ``cluster`` variant (``cluster`` CTAs per
    span, each holding ``slice`` elements in shared memory, loaded by bulk
    copies of ``piece`` elements; ``smem`` bytes of dynamic shared memory
    per CTA) or the ``split`` variant (blocks of ``chunk`` elements).
    ``ragged``: a span's byte length is not a multiple of 16, so slices have
    single-element ends beside their bulk-copied middle."""

    variant: str
    cluster: int
    slice: int
    piece: int
    chunk: int
    smem: int
    ragged: bool


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _ctas_per_sm(smem: int) -> int:
    """CTAs of the cluster variant that fit one SM by shared memory and
    threads."""
    return min(_MAX_CTAS_PER_SM, _SMEM_PER_SM // (smem + _RESERVED_PER_CTA))


def cluster_smem(cg: int, hw: int, slice_: int, esize: int) -> int:
    """Dynamic shared memory of one cluster-variant CTA: the header, (a, b)
    for each channel a slice can touch, then the slice (csrc/group_norm.cu
    ``affine_slots``, ``data_offset``)."""
    slots = min(cg, slice_ // hw + 2)
    return _round_up(_HEADER_BYTES + 8 * slots, 128) + slice_ * esize


@functools.lru_cache(maxsize=256)
def plan(b: int, c: int, hw: int, groups: int, dtype: torch.dtype,
         cluster: Optional[int] = None) -> Plan:
    """The variant, cluster size, slice and pieces for GroupNorm over (b, c,
    hw) in ``groups`` groups, from the shape and dtype alone. The cluster
    variant runs one CTA per span where the rule beside ``_MIN_CTAS_PER_SM``
    allows, else the smallest cluster whose CTAs fit ``_MIN_CTAS_PER_SM``
    per SM, else the cluster that fits the most; a span no cluster holds
    goes to the split variant. ``cluster`` forces a cluster size (a
    measurement's override; ValueError if its slice does not fit)."""
    if dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"K4 is instantiated for bf16 and fp32, not {dtype}")
    esize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // esize
    cg = c // groups
    span = cg * hw
    ragged = (span * esize) % 16 != 0

    def slice_for(n):
        return _round_up(-(-span // n), vec)

    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster sizes are {CLUSTER_SIZES}, not {cluster}")
    per_sm = {}  # CTAs per SM of each cluster size whose CTA fits
    for n in CLUSTER_SIZES if cluster is None else (cluster,):
        smem = cluster_smem(cg, hw, slice_for(n), esize)
        if smem <= _SMEM_MAX:
            per_sm[n] = _ctas_per_sm(smem)
    if not per_sm:
        if cluster is not None:
            raise ValueError(f"cluster {cluster} cannot hold a span of {span} elements")
        return Plan("split", 0, 0, 0, _SPLIT_CHUNK, 0, ragged)
    alone = per_sm.get(1, 0)
    if alone >= _MIN_CTAS_PER_SM or (
        alone >= _ALONE_PER_SM and b * groups >= _ALONE_MIN_WAVES * _SMS * alone
    ):
        n = 1
    else:
        n = next((n for n in per_sm if n > 1 and per_sm[n] >= _MIN_CTAS_PER_SM),
                 max(per_sm, key=lambda n: (per_sm[n], -n)))
    slice_ = slice_for(n)
    piece_bytes = min(max(_round_up(-(-(slice_ * esize) // _PIECES_PER_SLICE), 16),
                          _PIECE_BYTES[0]), _PIECE_BYTES[1])
    piece = piece_bytes // esize
    assert -(-slice_ // piece) <= _MAX_PIECES, (slice_, piece)
    return Plan("cluster", n, slice_, piece, 0, cluster_smem(cg, hw, slice_, esize), ragged)


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


def prepare_operands(x, weight, bias, groups: int, act: Optional[str]):
    """The wrapper's checks: one CUDA device, x, weight and bias of one
    dtype K4 is instantiated for (bf16, fp32), channels that split into
    ``groups``, per-channel parameters, ``act`` None or "silu". Returns x
    contiguous and 16-byte aligned (a misaligned one is cloned: the bulk
    copies count from its base), weight and bias contiguous."""
    dev = x.device
    if not x.is_cuda or weight.device != dev or bias.device != dev:
        raise ValueError("group_norm_kernel needs every operand on one CUDA device")
    if not (x.dtype == weight.dtype == bias.dtype) or x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            "the CUDA GroupNorm kernel is instantiated for bf16 and fp32, with x, "
            f"weight and bias of one dtype; got {x.dtype}, {weight.dtype}, {bias.dtype}"
        )
    if x.dim() < 2 or x.shape[1] % groups:
        raise ValueError(f"x {tuple(x.shape)}: channels must split into {groups} groups")
    c = x.shape[1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must be ({c},)")
    if c // groups > _MAX_GROUP_CHANNELS:
        raise NotImplementedError(
            f"{c // groups} channels per group exceed the kernel's {_MAX_GROUP_CHANNELS}"
        )
    if act not in (None, "silu"):
        raise ValueError(f"act must be None or 'silu', got {act!r}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, weight.contiguous(), bias.contiguous()


def scratch(x: torch.Tensor, groups: int, p: Plan) -> torch.Tensor:
    """The split variant's (sum, sumsq) per chunk of each span (empty for
    the cluster variant)."""
    b, c = x.shape[:2]
    n_chunks = -(-(c // groups) * (x.numel() // (b * c)) // p.chunk) if p.chunk else 0
    return torch.empty((b * groups * n_chunks, 2), dtype=torch.float32, device=x.device)


def launch(ops, out: torch.Tensor, partials: Optional[torch.Tensor], groups: int,
           eps: float, act: Optional[str], p: Plan) -> None:
    """One run of K4 (the split variant's two kernels) on operands from
    :func:`prepare_operands` into ``out`` (x's shape and dtype, 16-byte
    aligned), as ``p`` plans it; ``partials`` is the split variant's
    :func:`scratch` (None for the cluster variant). The stream is the
    device's current one as a raw handle, and the device context is entered
    only when x lies on another device than the current one. The wrapper
    counts its launches."""
    x, weight, bias = ops
    b, c = x.shape[:2]
    lib = _build.load_library()
    args = (
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        0 if partials is None else partials.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], b * groups, groups, c // groups, x.numel() // (b * c),
        p.cluster, p.slice, p.piece, p.chunk, float(eps), int(act == "silu"),
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    if x.device.index == torch.cuda.current_device():
        rc = lib.tf_group_norm(*args)
    else:
        with torch.cuda.device(x.device):
            rc = lib.tf_group_norm(*args)
    _build.check(lib, rc, "GroupNorm launch")


def occupancy(x: torch.Tensor, groups: int, act: Optional[str], p: Plan) -> tuple[int, int]:
    """(CTAs per SM, co-resident clusters) of the cluster variant's plan on
    x's device, as the CUDA occupancy calculator gives them."""
    b, c = x.shape[:2]
    per_sm, clusters = ctypes.c_int(), ctypes.c_int()
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.tf_group_norm_occupancy(
            _DTYPE_CODES[x.dtype], int(act == "silu"), c // groups, x.numel() // (b * c),
            p.cluster, p.slice, p.piece, ctypes.byref(per_sm), ctypes.byref(clusters),
        )
    _build.check(lib, rc, "GroupNorm occupancy")
    return per_sm.value, clusters.value


def group_norm_kernel(
    x: torch.Tensor,  # (B, C, *spatial) bf16 or fp32
    weight: torch.Tensor,  # (C,) x's dtype
    bias: torch.Tensor,  # (C,)
    groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Launch K4 on CUDA tensors; returns a new tensor of x's shape and
    dtype. x, weight and bias share one dtype, bf16 or fp32 (the kernel
    widens gamma and beta itself, so a call is the kernel's launches
    alone); another dtype raises. Per call the host does the checks, the
    output, the plan (cached per shape) and the launch: the cluster variant
    allocates no scratch."""
    global launches
    ops = prepare_operands(x, weight, bias, groups, act)
    x = ops[0]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    p = plan(b, c, hw, groups, x.dtype)
    launch(ops, out, scratch(x, groups, p) if p.chunk else None, groups, eps, act, p)
    launches += 1
    name = _DTYPE_NAMES[x.dtype]
    launches_by_dtype[name] = launches_by_dtype.get(name, 0) + 1
    launches_by_shape[(b, c, hw)] = launches_by_shape.get((b, c, hw), 0) + 1
    return out
