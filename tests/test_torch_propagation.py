"""Port parity for K2's module: tokenflow_torch.ops.propagation against the
JAX propagation ops and both Pallas token-match kernels (interpret mode).

Inputs are well separated (every pivot table holds permuted, slightly
perturbed copies of the query rows), so matched indices must agree
exactly; gathered values then agree to fp32 rounding of the blend (atol
1e-6). One case duplicates pivot rows to check the first-maximum rule.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenflow_torch.kernels import token_match as ttm
from tokenflow_torch.ops import propagation as tprop
from tokenflow_tpu.kernels.token_match import token_match_gather_pallas
from tokenflow_tpu.kernels.token_match_split import token_match_gather_split
from tokenflow_tpu.ops import propagation as jprop

torch.set_num_threads(2)

ATOL = 1e-6


@pytest.mark.parametrize("n,ws", [(8, 4), (40, 8), (10, 3), (12, 1)])
def test_propagation_indices_equal(n, ws):
    for a, b in zip(tprop.propagation_indices(n, ws), jprop.propagation_indices(n, ws)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _separated(f, k, s, d, ns=3, seed=0, ties=False):
    """x rows are noisy copies of base rows; each pivot table holds the
    base rows in its own order (with ``ties``: each twice, adjacent)."""
    rng = np.random.default_rng(seed)
    n_base = s // 2 if ties else s
    base = rng.standard_normal((n_base, d))
    x = base[rng.integers(0, n_base, (f, s))] + 0.01 * rng.standard_normal((f, s, d))
    p = np.stack([base[rng.permutation(n_base)] for _ in range(k)])
    p = p + 0.01 * rng.standard_normal(p.shape)
    if ties:
        p = np.repeat(p, 2, axis=1)
    kf = rng.standard_normal((ns, k, s, d))
    pa, pb, w1 = jprop.propagation_indices(f, f // k)
    return [a.astype(np.float32) for a in (x, p, kf)] + [pa, pb, w1]


def _p_hat(p):
    return p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)


def _torch_args(x, p_hat, kf, pa, pb, w1):
    return (
        torch.from_numpy(x), torch.from_numpy(p_hat), torch.from_numpy(kf),
        torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(w1),
    )


@pytest.mark.parametrize("f,k,s,d", [(10, 2, 128, 16), (6, 3, 256, 24)])
def test_match_gather_matches_jnp_and_pallas(f, k, s, d):
    x, p, kf, pa, pb, w1 = _separated(f, k, s, d, seed=s)
    p_hat = _p_hat(p).astype(np.float32)
    got, idx = ttm.token_match_gather_plain(
        *_torch_args(x, p_hat, kf, pa, pb, w1), return_indices=True
    )
    jargs = [jnp.asarray(a) for a in (x, p_hat, kf, pa, pb, w1)]
    want = jprop.jnp_match_gather(*jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    fused = token_match_gather_pallas(*jargs, bq=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), rtol=0, atol=ATOL)
    split = token_match_gather_split(
        *jargs, bq_match=64, bz=64, bq_gather=64, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(split), rtol=0, atol=ATOL)
    # indices: the exact nearest neighbour of every query row
    sim = np.einsum("fsd,fzd->fsz", x, p_hat[pa])
    assert np.array_equal(idx[0].numpy(), sim.argmax(-1))


def test_match_gather_first_maximum_on_ties():
    """Pivot rows appear twice (rows 2m and 2m+1 equal): the match must
    take the first, as jnp.argmax and both Pallas kernels do."""
    f, k, s, d = 4, 2, 128, 16
    x, p, kf, pa, pb, w1 = _separated(f, k, s, d, seed=5, ties=True)
    p_hat = _p_hat(p).astype(np.float32)
    got, idx = ttm.token_match_gather_plain(
        *_torch_args(x, p_hat, kf, pa, pb, w1), return_indices=True
    )
    assert not (idx.numpy() % 2).any()
    jargs = [jnp.asarray(a) for a in (x, p_hat, kf, pa, pb, w1)]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jprop.jnp_match_gather(*jargs)), rtol=0, atol=ATOL
    )
    split = token_match_gather_split(
        *jargs, bq_match=64, bz=32, bq_gather=64, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(split), rtol=0, atol=ATOL)


@pytest.mark.parametrize("ns", [3, 2])
def test_token_propagation_matches_jax(ns):
    f, k, s, d = 8, 2, 64, 16
    x, p, kf, pa, pb, w1 = _separated(f, k, s, d, ns=ns, seed=11)
    got = tprop.token_propagation(*_torch_args(x, p, kf, pa, pb, w1))
    want = jprop.token_propagation(*(jnp.asarray(a) for a in (x, p, kf, pa, pb, w1)))
    assert got.shape == (ns, f, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("f,k,s,d", [(4, 2, 144, 16), (4, 3, 200, 24)])
def test_match_gather_negative_similarities_match_jnp(f, k, s, d):
    """Every similarity below 0 (negative query rows, positive pivot rows)
    at a ragged S: the match must still pick the largest real similarity,
    as jnp_match_gather does (a kernel tail read as 0 would win instead)."""
    rng = np.random.default_rng(s + d)
    x = -np.abs(rng.standard_normal((f, s, d))).astype(np.float32)
    p_hat = _p_hat(np.abs(rng.standard_normal((k, s, d)))).astype(np.float32)
    kf = rng.standard_normal((3, k, s, d)).astype(np.float32)
    pa, pb, w1 = jprop.propagation_indices(f, -(-f // k))
    got, idx = ttm.token_match_gather_plain(
        *_torch_args(x, p_hat, kf, pa, pb, w1), return_indices=True
    )
    assert (np.einsum("fsd,fzd->fsz", x, p_hat[pa]) < 0).all()
    want = jprop.jnp_match_gather(*(jnp.asarray(a) for a in (x, p_hat, kf, pa, pb, w1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert int(idx.max()) < s


def _operand_case(case):
    f, k, s = 2, 3, 16
    d = ttm.MAX_D + 8 if case == "d_too_large" else 64
    norm_h = torch.zeros(f, s, d, dtype=torch.bfloat16)
    if case == "misaligned":  # contiguous, base 2 bytes past a 16-byte boundary
        norm_h = torch.zeros(f * s * d + 1, dtype=torch.bfloat16)[1:].view(f, s, d)
    elif case == "strided":  # every other row of a larger table
        norm_h = torch.zeros(f, 2 * s, d, dtype=torch.bfloat16)[:, ::2]
    args = (
        norm_h, torch.zeros(k, s, d, dtype=torch.bfloat16),
        torch.zeros(3, k, s, d, dtype=torch.bfloat16),
        torch.zeros(f, dtype=torch.int32), torch.ones(f, dtype=torch.int32),
        torch.full((f,), 0.5),
    )
    return args, case == "aligned"


@pytest.mark.parametrize("case", ["aligned", "misaligned", "strided", "d_too_large"])
def test_match_operands_meet_tma_rules(case):
    """The match core loads x and p_hat by TMA with contiguous strides: the
    wrappers' operands must be contiguous with a 16-byte aligned base (a
    misaligned contiguous view is cloned, not passed through by
    .contiguous()), and D past the core's limit raises."""
    args, kept = _operand_case(case)
    if case == "d_too_large":
        with pytest.raises(NotImplementedError, match="D <="):
            ttm.check_operands("test", *args)
        return
    got = ttm.check_operands("test", *args)
    for t, g in zip(args[:3], got[:3]):
        assert torch.equal(g, t) and g.is_contiguous() and g.data_ptr() % 16 == 0
    assert (got[0].data_ptr() == args[0].data_ptr()) is kept


@pytest.mark.parametrize("pivot", [2, 3, -1], ids=["in_range", "past_k", "negative"])
def test_pivot_range_is_checked_on_host(pivot):
    """The match wrappers check the pivot indices on host values: the main
    path hands them over on the host (``propagation_indices``), so no call
    waits for the device. K = 3 here: an index outside [0, 3) raises
    IndexError before any launch; valid ones come back as int32 on the
    tables' device."""
    args, _ = _operand_case("aligned")
    args = list(args)
    args[3] = torch.full_like(args[3], pivot)
    if pivot in (0, 1, 2):
        got = ttm.check_operands("test", *args)
        assert got[3].dtype == torch.int32 and got[3].device == args[0].device
        assert torch.equal(got[3].long(), args[3].long())
    else:
        with pytest.raises(IndexError, match="pivot indices"):
            ttm.check_operands("test", *args)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fold(sims, fault, tile=128):
    """The match core's fold over z tiles of ``tile`` columns, in plain
    torch, with one planted fault: "tail_as_zero" (the zero-filled columns
    past S compared as similarity 0), "later_ties" (a tie inside a tile
    resolved to the later column), "across_tiles_ge" ('>=' instead of a
    strict '>' against earlier tiles), or none."""
    s = sims.shape[-1]
    fill = 0.0 if fault == "tail_as_zero" else float("-inf")
    tiles = torch.cat(
        [sims, sims.new_full((*sims.shape[:-1], -s % tile), fill)], -1
    ).unflatten(-1, (-1, tile))
    t_max = tiles.amax(-1)
    t_arg = tiles.argmax(-1)  # the first maximum
    if fault == "later_ties":
        t_arg = tile - 1 - tiles.flip(-1).argmax(-1)
    best = sims.new_full(sims.shape[:-1], float("-inf"))
    idx = torch.zeros(sims.shape[:-1], dtype=torch.long)
    for j in range(tiles.shape[-2]):
        take = t_max[..., j] >= best if fault == "across_tiles_ge" else t_max[..., j] > best
        best = torch.where(take, t_max[..., j], best)
        idx = torch.where(take, j * tile + t_arg[..., j], idx)
    return idx


@pytest.mark.parametrize(
    "mode,fault,passes",
    [("negative", None, True), ("negative", "tail_as_zero", False),
     ("ties", None, True), ("ties", "later_ties", False),
     ("ties", "across_tiles_ge", False)],
)
def test_match_verdict_separates_right_from_wrong(mode, fault, passes):
    """chip_smoke.py's token-match verdict on the CPU, at its rows for
    ``mode`` (the ragged all-negative row; the ties row's S and D at a
    small F): the fold's indices pass, and each planted fault fails."""
    smoke = _chip_smoke()
    s, d, f, k = smoke.K2_NEGATIVE if mode == "negative" else smoke.K2_SHAPES[1]
    f = min(f, 4)
    x, p_hat, kf, pa, pb, w1 = smoke._match_inputs(
        torch.Generator().manual_seed(0), s, d, mode, f, k, device="cpu"
    )
    ref, ref_idx = ttm.token_match_gather_plain(x, p_hat, kf, pa, pb, w1, return_indices=True)
    sims = [
        torch.einsum("fsd,fzd->fsz", x.float(), p_hat.float()[p.long()]) for p in (pa, pb)
    ]
    idx = torch.stack([_fold(sm, fault) for sm in sims])
    ns, d = kf.shape[0], kf.shape[-1]
    rows = [
        torch.gather(kf[:, p.long()], 2, i.clamp(max=s - 1)[None, :, :, None].expand(ns, -1, -1, d))
        for p, i in zip((pa, pb), idx)
    ]
    w = w1.float()[None, :, None, None]
    out = (w * rows[0].float() + (1 - w) * rows[1].float()).bfloat16()
    if passes:
        assert torch.equal(idx, ref_idx)
        smoke._match_verdict("[test]", mode, idx, ref_idx, out, ref)
    else:
        with pytest.raises(AssertionError):
            smoke._match_verdict("[test]", mode, idx, ref_idx, out, ref)


def test_kernel_wrapper_rejects_cpu_tensors():
    args = _torch_args(*_separated(4, 2, 64, 8, seed=3))
    with pytest.raises(ValueError, match="CUDA"):
        ttm.token_match_gather_kernel(*args)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """K2 against its plain version on the card (skips without a GPU;
    chip_smoke.py covers the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x, p, kf, pa, pb, w1 = _separated(8, 2, 256, 64, seed=4)
    args = [
        torch.from_numpy(a).cuda() for a in (x, _p_hat(p).astype(np.float32), kf, pa, pb, w1)
    ]
    for i in range(3):
        args[i] = args[i].bfloat16()
    before = ttm.launches
    out, idx = ttm.token_match_gather_kernel(*args, return_indices=True)
    assert ttm.launches == before + 1
    ref, ref_idx = ttm.token_match_gather_plain(*args, return_indices=True)
    assert torch.equal(idx.long(), ref_idx)
    assert torch.equal(out, ref)
    args[3] = torch.full_like(args[3], 2)  # K = 2 pivots: index 2 is out of range
    with pytest.raises(IndexError, match="pivot indices"):
        ttm.token_match_gather_kernel(*args)
