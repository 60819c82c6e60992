"""K2: token match + gather, the hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``tokenflow_tpu/kernels/token_match.py``
(``token_match_gather_pallas``, kernel ``_kernel``); the large-S sites go to
K3 (``kernels/token_match_split.py``), chosen as in the JAX package. For
each frame f and query token s: the first argmax over pivot tokens of
``x . p_hat`` for pivots ``pa[f]`` and ``pb[f]``, then ``w1[f] * kf[:, pa[f],
i1] + (1 - w1[f]) * kf[:, pb[f], i2]`` for all streams. The CUDA source is
``tokenflow_torch/csrc/token_match.cu``, one launch of the token-match core
that K3 shares (``csrc/token_match_core.cuh``, whose header gives the
design: TMA pivot stream, wgmma, a running first argmax per row, the
gather and blend in its epilogue with indexed 16-byte loads); it writes
(2, F, S) int32 indices and the output. Bound on the H100: compute (4 S^2
D flops per frame; the gather's bytes are a few percent of that time).
fp32 tables (the stack's ``dtype: f32``) launch the fp32 match core,
``tokenflow_torch/csrc/token_match_f32.cu`` (wgmma on the tensor cores as
3xTF32 splits, fp32-class error: against the plain version in fp32 on
the H100 no index flipped on separated or tied inputs and at most 1.8e-5
on random and all-negative ones, near ties; the same first-max rule and
fused gather; a split pre-pass into a workspace the wrapper allocates;
bound at 3 x its flops on the 495 TFLOP/s TF32 tensor cores, and at 67
TFLOP/s of FFMA read at the plain fp32 rate), which K3 launches too; an fp32 table is never cast to
bf16. The pivot indices' range is checked on host values: the main path
passes them on the host, so no call waits for the device.

The module knows one device only. Over a frames group a rank runs its own
frames against the replicated tables with global pivot indices, the same
call as without a group (``ops/propagation.py::token_propagation``, where
K2 or K3 is chosen).
"""

from __future__ import annotations

import torch

from tokenflow_torch.kernels import _build
from tokenflow_torch.kernels._operands import tma_operand

# kernel-pair launches made by :func:`token_match_gather_kernel`
launches = 0
# launches by dtype ("bfloat16", "float32"), the same launches as ``launches``
launches_by_dtype: dict[str, int] = {}
# launches by the kf table's stream count (3: [source|uncond|cond], 2: the
# approximate pass's [uncond|cond]), the same launches as ``launches``
launches_by_streams: dict[int, int] = {}
# the table dtypes the match cores are instantiated for
DTYPES = (torch.bfloat16, torch.float32)

# largest head width the match cores take: the bf16 core's resident query
# tile of 64 rows (128 D bytes) beside a 4-stage ring in 227 KB of shared
# memory up to 1280, beside a 3-stage ring up to 1408 (HunyuanDiT's width;
# csrc/token_match_core.cuh); the fp32 core, which sums over D in chunks,
# keeps 1280, the widest it is checked at
MAX_D = 1408
MAX_D_F32 = 1280
_PLAIN_FRAMES = 8  # frames per plain-version chunk: bounds the (f, S, S) sims


def token_match_gather_plain(
    xq: torch.Tensor,  # (F, S, D) query tokens (need not be normalized)
    p_hat: torch.Tensor,  # (K, S, D) L2-normalized pivot tokens
    kf_attn: torch.Tensor,  # (ns, K, S, D)
    pa: torch.Tensor,  # (F,)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
    *,
    return_indices: bool = False,
):
    """Dense NN match + two-pivot blended gather in plain PyTorch.

    Mirrors ``jnp_match_gather`` (tokenflow_tpu/ops/propagation.py:89-123):
    fp32 similarities, first-max argmax, gather of every stream. The blend
    runs in fp32 and is cast to kf_attn's dtype once, as the Pallas kernel
    does (token_match.py:82); for fp32 tables this is the jnp expression
    exactly. Frames run in chunks so the (F, S, S) similarity tensor is
    never whole. Returns (ns, F, S, D) in kf_attn's dtype, and with
    ``return_indices`` also the (2, F, S) matched token indices.
    """
    pa = pa.long()
    pb = pb.long()
    w = w1.float()
    ns, _, s, d = kf_attn.shape
    f_total = xq.shape[0]
    out = torch.empty((ns, f_total, s, d), dtype=kf_attn.dtype, device=kf_attn.device)
    idx = torch.empty((2, f_total, s), dtype=torch.long, device=kf_attn.device)
    ph = p_hat.float()
    for f0 in range(0, f_total, _PLAIN_FRAMES):
        sl = slice(f0, f0 + _PLAIN_FRAMES)
        x = xq[sl].float()
        for j, p_idx in enumerate((pa[sl], pb[sl])):
            sim = torch.einsum("fsd,fzd->fsz", x, ph[p_idx])
            idx[j, sl] = sim.argmax(dim=-1)  # first maximum, as jnp.argmax
        out[:, sl] = gather_blend(kf_attn, idx[:, sl], pa[sl], pb[sl], w[sl])
    return (out, idx) if return_indices else out


def gather_blend(kf_attn: torch.Tensor, idx: torch.Tensor, pa: torch.Tensor,
                 pb: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """The plain version's gather and blend at given (2, F, S) matched
    indices: w1 * kf_attn[:, pa][idx[0]] + (1 - w1) * kf_attn[:, pb][idx[1]]
    in fp32, cast to kf_attn's dtype once; (ns, F, S, D)."""
    ns, d = kf_attn.shape[0], kf_attn.shape[-1]
    rows = [torch.gather(kf_attn[:, p.long()], 2, i[None, :, :, None].expand(ns, -1, -1, d))
            .float() for p, i in ((pa, idx[0]), (pb, idx[1]))]
    w = w1.float()[None, :, None, None]
    return (w * rows[0] + (1 - w) * rows[1]).to(kf_attn.dtype)


def prepare_operands(name, norm_h, p_hat, kf_attn, pa, pb, w1):
    """The checks shared by the token-match wrappers (K2 and K3): three bf16
    or three fp32 tables (NotImplementedError otherwise), one CUDA device
    (pa and pb on it or on the host),
    agreeing shapes, D % 8 == 0 and D <= MAX_D (MAX_D_F32 for fp32 tables),
    pivot indices in [0, K)
    (IndexError; the kernels address the tables with them directly).
    Returns tables a TMA tensor map accepts, contiguous and 16-byte aligned
    (``_operands.tma_operand``: a misaligned or strided table is cloned),
    int32 pa/pb and fp32 w1."""
    if norm_h.dtype not in DTYPES or not (norm_h.dtype == p_hat.dtype == kf_attn.dtype):
        raise NotImplementedError(
            "the CUDA token-match kernels are instantiated for three bf16 or three "
            f"fp32 tables; got {norm_h.dtype}, {p_hat.dtype}, {kf_attn.dtype}"
        )
    dev = norm_h.device
    tensors = (norm_h, p_hat, kf_attn, w1)
    if (not norm_h.is_cuda or any(t.device != dev for t in tensors)
            or any(t.device not in (dev, torch.device("cpu")) for t in (pa, pb))):
        raise ValueError(
            f"{name} needs every operand on one CUDA device (pa and pb there or "
            "on the host)"
        )
    return check_operands(name, norm_h, p_hat, kf_attn, pa, pb, w1)


def check_operands(name, norm_h, p_hat, kf_attn, pa, pb, w1):
    """:func:`prepare_operands` past its device and dtype checks: shapes,
    D, the grid, pivot indices, and the TMA rule on the tables."""
    f_total, s, d = norm_h.shape
    k = kf_attn.shape[1]
    if p_hat.shape != (k, s, d) or kf_attn.shape[2:] != (s, d):
        raise ValueError(
            f"shapes disagree: norm_h {tuple(norm_h.shape)}, p_hat "
            f"{tuple(p_hat.shape)}, kf_attn {tuple(kf_attn.shape)}"
        )
    if pa.shape != (f_total,) or pb.shape != (f_total,) or w1.shape != (f_total,):
        raise ValueError("pa, pb and w1 must have one entry per frame")
    max_d = MAX_D_F32 if norm_h.dtype == torch.float32 else MAX_D
    if d % 8 or d > max_d:
        raise NotImplementedError(
            f"{name} needs D % 8 == 0 and D <= {max_d} for {norm_h.dtype} tables, got {d}"
        )
    if f_total > 65535:
        raise ValueError(f"{f_total} frames exceed the grid limit")
    # the range check reads host values: pa and pb on the host (the main
    # path's, from propagation_indices) are checked without a device sync and
    # copied to the device asynchronously; a device copy is read back once
    piv = torch.cat([pa.reshape(-1), pb.reshape(-1)]).cpu()
    if piv.numel() and bool(((piv < 0) | (piv >= k)).any()):
        raise IndexError(f"pivot indices must lie in [0, {k})")
    dev = norm_h.device
    return (
        *(tma_operand(t, contiguous=True) for t in (norm_h, p_hat, kf_attn)),
        *(t.to(device=dev, dtype=torch.int32, non_blocking=True).contiguous()
          for t in (pa, pb)),
        w1.to(torch.float32).contiguous(),
    )


def launch(ops, idx: torch.Tensor, out: torch.Tensor | None, *, split: bool = False) -> None:
    """One launch of the match core of the tables' dtype, K2's (``split``
    False) or K3's, on operands from :func:`prepare_operands`: the matched
    indices into the (2, F, S) int32 ``idx`` (pivot a's in row 0, pivot
    b's in row 1) and the blended rows into ``out``; with ``out`` None the
    indices only (the match timed alone). bf16 tables launch the wgmma
    core through K2's or K3's C entry (one core; K3's takes the two index
    rows apart), fp32 tables the 3xTF32 core through its one entry. The
    wrappers count their launches."""
    norm_h, p_hat, kf_attn, pa, pb, w1 = ops
    f_total, s, d = norm_h.shape
    ns, k = kf_attn.shape[:2]
    lib = _build.load_library()
    workspace = ()
    if norm_h.dtype == torch.float32:
        entry, rows = lib.tf_token_match_f32, (idx[0], idx[1])
        # the split tables (hi and lo parts of norm_h and p_hat)
        workspace = (torch.empty(lib.tf_token_match_f32_workspace(f_total, k, s, d),
                                 dtype=torch.uint8, device=norm_h.device),)
    elif split:
        entry, rows = lib.tf_token_match_split, (idx[0], idx[1])
    else:
        entry, rows = lib.tf_token_match, (idx,)
    with torch.cuda.device(norm_h.device):
        rc = entry(
            norm_h.data_ptr(), p_hat.data_ptr(), kf_attn.data_ptr(), pa.data_ptr(),
            pb.data_ptr(), w1.data_ptr(), *(r.data_ptr() for r in rows),
            None if out is None else out.data_ptr(), ns, f_total, k, s, d,
            *(w.data_ptr() for w in workspace),
            torch.cuda.current_stream(norm_h.device).cuda_stream,
        )
    _build.check(lib, rc, f"{'K3' if split else 'K2'} {norm_h.dtype} token-match launch")


def token_match_gather_kernel(
    norm_h: torch.Tensor,  # (F, S, D) bf16 or fp32
    p_hat: torch.Tensor,  # (K, S, D) pre-normalized, norm_h's dtype
    kf_attn: torch.Tensor,  # (ns, K, S, D) norm_h's dtype
    pa: torch.Tensor,  # (F,) pivot index in [0, K)
    pb: torch.Tensor,  # (F,)
    w1: torch.Tensor,  # (F,)
    *,
    return_indices: bool = False,
):
    """Launch K2 (match, gather and blend in one kernel) on CUDA tensors. Pivot
    indices outside [0, K) raise IndexError. Returns a new (ns, F, S, D)
    tensor in the tables' dtype, and with ``return_indices`` also the (2,
    F, S) int32 matched token indices."""
    global launches
    ops = prepare_operands("token_match_gather_kernel", norm_h, p_hat, kf_attn, pa, pb, w1)
    f_total, s, d = ops[0].shape
    ns = ops[2].shape[0]
    dev = ops[0].device
    idx = torch.empty((2, f_total, s), dtype=torch.int32, device=dev)
    out = torch.empty((ns, f_total, s, d), dtype=ops[2].dtype, device=dev)
    if f_total == 0 or s == 0:
        return (out, idx) if return_indices else out
    launch(ops, idx, out)
    launches += 1
    name = str(out.dtype).removeprefix("torch.")
    launches_by_dtype[name] = launches_by_dtype.get(name, 0) + 1
    launches_by_streams[ns] = launches_by_streams.get(ns, 0) + 1
    return (out, idx) if return_indices else out

