"""The fp32 halves of K1 (flash attention) and of the token-match core (K2,
K3): the wrappers' dtype rules and routing on the CPU, chip_smoke.py's fp32
limits against right and wrong answers, and the kernels against their plain
versions on the card (``cuda``-marked; skip without a GPU).

The fp32 plain versions these kernels are held to are held to the JAX
functions by tests/test_torch_attention.py, test_torch_propagation.py and
test_torch_token_match_split.py (fp32 on both sides); they are not
repeated here.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenflow_torch.kernels import flash_attention as tfa
from tokenflow_torch.kernels import token_match as ttm
from tokenflow_torch.kernels import token_match_split as tms
from tokenflow_tpu.kernels.flash_attention import flash_attention_bhsd
from tokenflow_tpu.kernels.token_match import fits_vmem
from tokenflow_tpu.kernels.token_match_split import split_fits_vmem
from tokenflow_tpu.ops import propagation as jprop

torch.set_num_threads(2)

HEAD_DIMS = (40, 64, 80, 160)
# the propagation sites (S, D) of both SD-2.1 paths: PnP 512^2 and SDEdit 768p
SITES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280),
         (9216, 320), (2304, 640), (576, 1280), (144, 1280)]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _match_args(f=4, k=2, s=64, d=64, ns=3, dtypes=(torch.float32,) * 3, seed=0):
    rng = np.random.default_rng(seed)
    x, p, kf = (rng.standard_normal(shape).astype(np.float32)
                for shape in ((f, s, d), (k, s, d), (ns, k, s, d)))
    pa, pb, w1 = jprop.propagation_indices(f, f // k)
    tables = [torch.from_numpy(a).to(t) for a, t in zip((x, p, kf), dtypes)]
    return tables + [torch.from_numpy(a) for a in (pa, pb, w1)]


MATCH_WRAPPERS = [ttm.token_match_gather_kernel, tms.token_match_gather_split_kernel]


@pytest.mark.parametrize("q,k,v", [
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.bfloat16),
])
def test_k1_mixed_dtypes_raise(q, k, v):
    """q, k and v share one dtype; mixed operands are never cast to one."""
    args = [torch.zeros(1, 8, 1, 64, dtype=t) for t in (q, k, v)]
    with pytest.raises(NotImplementedError, match="alike"):
        tfa.flash_attention_kernel(*args)


@pytest.mark.parametrize("wrapper", MATCH_WRAPPERS, ids=["K2", "K3"])
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float16,) * 3,
], ids=["x_kf_f32", "kf_f32", "fp16"])
def test_match_mixed_or_other_dtypes_raise(wrapper, dtypes):
    """Three bf16 or three fp32 tables; anything else raises before any
    device check or launch."""
    with pytest.raises(NotImplementedError, match="three bf16 or three fp32"):
        wrapper(*_match_args(dtypes=dtypes))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k1_f32_passes_the_dtype_check(d):
    """An fp32 operand at every instantiated head dim is K1's now: on the
    CPU it stops at the CUDA-device check, no longer at the dtype check."""
    q = torch.zeros(1, 8, 1, d)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_kernel(q, q, q)


@pytest.mark.parametrize("wrapper", MATCH_WRAPPERS, ids=["K2", "K3"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_match_f32_passes_the_dtype_check(wrapper, d):
    """Three fp32 tables are the match core's now: on the CPU they stop at
    the CUDA-device check, no longer at the dtype check."""
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*_match_args(d=d))


@pytest.mark.parametrize("ns", [3, 2])
@pytest.mark.parametrize("s,d", SITES)
def test_use_split_is_the_jax_route_at_both_dtypes(s, d, ns):
    """K2 or K3 by the JAX dispatch's predicates, which count the keyframe
    table in bf16 whatever its dtype: the same site runs the same kernel in
    bf16 and in fp32, and neither path's site falls to the jnp version."""
    jax_route = (
        "K2" if fits_vmem(s, d, ns=ns) else "K3" if split_fits_vmem(s, d, ns=ns) else "jnp"
    )
    assert jax_route != "jnp"
    assert ("K3" if tms.use_split(s, d, ns) else "K2") == jax_route
    # an fp32 table twice the cap's bytes at the PnP top level still runs K2
    if (s, d, ns) == (4096, 320, 3):
        assert ns * s * d * 4 > tms.SPLIT_KF_TABLE_BYTES and jax_route == "K2"


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10-bit mantissa, round to nearest)."""
    i = x.view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("case,passes", [
    ("other_block_order", True), ("tf32_products", False), ("tail_as_zero", False),
])
def test_k1_f32_limits_separate_right_from_wrong(case, passes):
    """chip_smoke.py's K1-f32 limits on the CPU at a ragged shape: the
    plain version in another KV block order passes; single-pass TF32
    products, or a ragged tail counted as zero logits, fail."""
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, n, 2, 64), generator=g) for n in (200, 1000, 1000))
    ref = tfa.flash_attention_plain(q, k, v, kv_block=128)
    if case == "other_block_order":
        out = tfa.flash_attention_plain(q, k, v, kv_block=96)
    elif case == "tf32_products":
        out = tfa.flash_attention_plain(_tf32(q), _tf32(k), _tf32(v), kv_block=128)
    else:
        pad = torch.zeros((1, 24, 2, 64))
        out = tfa.flash_attention_plain(q, torch.cat([k, pad], 1), torch.cat([v, pad], 1),
                                        kv_block=128)
    m = smoke.k1_f32_mismatch(out, ref)
    assert smoke.k1_within_limits(m) is passes, m


@pytest.mark.parametrize("mode,fault,passes", [
    ("separated", None, True), ("ties", None, True), ("random", None, True),
    ("ties", "later_ties", False), ("separated", "blend_bf16", False),
])
def test_match_f32_verdict_separates_right_from_wrong(mode, fault, passes):
    """chip_smoke.py's fp32 token-match verdict on the CPU: the plain
    version against itself passes; a tie resolved to a later row, or rows
    blended and rounded through bf16, fail."""
    smoke = _chip_smoke()
    x, p_hat, kf, pa, pb, w1 = smoke._match_inputs(
        torch.Generator().manual_seed(0), 256, 64, mode, 4, 2, device="cpu",
        dtype=torch.float32,
    )
    ref, ref_idx = ttm.token_match_gather_plain(x, p_hat, kf, pa, pb, w1,
                                                return_indices=True)
    out, idx = ref.clone(), ref_idx.clone()
    if fault == "later_ties":  # the odd twin of every matched even row
        idx = idx + 1
    elif fault == "blend_bf16":
        out = out.bfloat16().float()
    args = ("[test]", mode, idx, ref_idx, out, ref)
    kf_max = float(kf.abs().max())
    if passes:
        smoke._match_verdict(*args, kf_max=kf_max)
    else:
        with pytest.raises(AssertionError):
            smoke._match_verdict(*args, kf_max=kf_max)


def _two_sites(x, p, kf, pa, pb, w1, moved: bool):
    """Two propagation sites through ``ops/propagation.token_propagation``
    on the CPU; with ``moved`` the second site's token 5 of frame 0 is
    moved onto pivot row 9, so exactly that token matches another row."""
    from tokenflow_torch.ops import propagation as prop

    for site in range(2):
        q = x.clone()
        if moved and site == 1:
            q[0, 5] = p[pa[0], 9] * 10.0
        prop.token_propagation(q, p, kf, pa, pb, w1)


def test_flipped_matches_counts_each_site():
    """chip_smoke.py's per-site flip share, which every small reference
    reports: two runs' matches recorded by ``record_matches`` at two sites,
    the "card" run with one token moved at the second; the sites' functions
    are restored afterwards."""
    from tokenflow_torch.ops import propagation as prop

    smoke = _chip_smoke()
    saved = prop.match_gather
    args = _match_args(f=4, k=2, s=32, d=16)
    want, got = [], []
    with smoke.record_matches(want):
        _two_sites(*args, moved=False)
    with smoke.record_matches(got):
        _two_sites(*args, moved=True)
    assert prop.match_gather is saved
    flips = smoke.flipped_matches(got, want)
    share = 1 / (2 * 4 * 32)  # one index of (2, F, S), pa[0] == pb[0]: both rows
    assert flips[0] == 0.0 and flips[1] == pytest.approx(2 * share)


@pytest.mark.parametrize("tie", [True, False], ids=["near_tie", "no_tie"])
def test_replay_matches_takes_only_near_ties(tie):
    """chip_smoke.py's fp32 references replay the card's matches into the
    CPU run: the gathered rows follow the card's index, through the plain
    version's blend, and each site records its flips' largest similarity
    gap; a flip between two pivot rows equal to within REF_TIE_TOL passes
    ``check_ties``, any other flip fails it."""
    from tokenflow_torch.ops import propagation as prop

    smoke = _chip_smoke()
    saved = prop.match_gather
    x, p, kf, pa, pb, w1 = _match_args(f=4, k=2, s=32, d=16)
    p[:, 9] = p[:, 3] * (1 + 1e-7)  # rows 3 and 9 tie to within fp32 rounding
    p_hat = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    ref, idx = ttm.token_match_gather_plain(x, p_hat, kf, pa, pb, w1, return_indices=True)
    card = idx.clone()
    if tie:
        card[idx == 3] = 9
        assert bool((card != idx).any())
    else:  # another row, no partner of a tie
        card[0, 0, 0] = next(r for r in range(32) if r not in (int(idx[0, 0, 0]), 3, 9))
    ties = []
    with smoke.replay_matches([card], ties):
        out = prop.token_propagation(x, p, kf, pa, pb, w1)
    assert prop.match_gather is saved
    assert len(ties) == 1 and ties[0][0] == int((card != idx).sum())
    torch.testing.assert_close(out, ttm.gather_blend(kf, card, pa, pb, w1), rtol=0, atol=0)
    assert not torch.equal(out, ref)
    if not tie:
        assert smoke.tie_gap(ties) > smoke.REF_TIE_TOL
        with pytest.raises(AssertionError, match="no near tie"):
            smoke.check_ties(ties)
        return
    assert smoke.tie_gap(ties) <= smoke.REF_TIE_TOL
    smoke.check_ties(ties)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k1_f32_matches_plain_on_cuda(d):
    """K1-f32 against its plain version in fp32, TF32 off, with ragged Q
    and KV tails and on head-split views (skips without a GPU;
    chip_smoke.py covers the paths' shapes)."""
    _cuda()
    smoke = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(d)
    # head-split views of wider projections: strided, 16-byte aligned
    q, k, v = (torch.randn((2, n, 4 * d), generator=g, device="cuda")[..., d:]
               .unflatten(-1, (3, d)) for n in (100, 300, 300))
    before = dict(tfa.launches_by_dtype)
    out = tfa.flash_attention_kernel(q, k, v)
    assert tfa.launches_by_dtype["float32"] == before.get("float32", 0) + 1
    assert out.dtype == torch.float32
    m = smoke.k1_f32_mismatch(out, tfa.flash_attention_plain(q, k, v, kv_block=64))
    assert smoke.k1_within_limits(m), m


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [3, 2])
def test_match_f32_matches_plain_on_cuda(ns):
    """The fp32 match core through K2 and K3 against the plain version on
    separated inputs with a ragged tail (S = 200): identical indices, rows
    within the fp32 limit, K2 and K3 bitwise equal (skips without a GPU)."""
    _cuda()
    smoke = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = smoke._match_inputs(torch.Generator(device="cuda").manual_seed(ns), 200, 64,
                               "separated", 8, 2, ns=ns, dtype=torch.float32)
    before = dict(ttm.launches_by_dtype)
    out, idx = ttm.token_match_gather_kernel(*args, return_indices=True)
    assert ttm.launches_by_dtype["float32"] == before.get("float32", 0) + 1
    ref, ref_idx = ttm.token_match_gather_plain(*args, return_indices=True)
    smoke._match_verdict("[test]", "separated", idx, ref_idx, out, ref,
                         kf_max=float(args[2].abs().max()))
    k3_out, ia, ib = tms.token_match_gather_split_kernel(*args, return_indices=True)
    assert torch.equal(k3_out, out)
    assert torch.equal(torch.stack([ia[:, 0], ib[:, 0]]), idx)


# ---- the 3xTF32 split of the fp32 kernels, emulated on the CPU ----
# csrc/tf32.cuh: hi = rna(x) (cvt.rna.tf32.f32, _tf32 above), lo = rna(x -
# hi); a product a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, cross terms
# first. TF32 x TF32 products are exact in fp32, so fp32 matmuls of the
# parts give the tensor cores' products; "tf32" is the one-pass control
# (a_hi b_hi alone). The emulation checks the split's rounding, not the
# tensor cores' accumulation: their sums are taken here as the CPU's fp32
# matmul takes them (round to nearest, the match's D in one sum), while the
# hardware's fp32 accumulation is not round-to-nearest and the match core
# chains 32-dim chunks. A kernel that went back to one accumulation chain
# over every KV tile would pass these tests; the card's rows in
# chip_smoke.py hold the accumulation.


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split_product(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """a @ b (last dim of a against the second-last of b) as the kernels
    take it: three TF32 products ("3xtf32") or one ("tf32")."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if scheme == "tf32":
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _emulated_k1(q, k, v, scheme, kv_tile):
    """K1-f32's arithmetic: per KV tile S = Q K^T (split), the online
    softmax in the exp2 domain in fp32, the tile's P V (split, P split as
    the kernel splits it in registers) added to O in fp32; (B, S, H, D)."""
    d = q.shape[-1]
    scale_log2 = np.float32(d**-0.5 * 1.4426950408889634)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    b, h, sq, _ = qh.shape
    acc = torch.zeros((b, h, sq, d))
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    for j in range(0, kh.shape[2], kv_tile):
        s = _split_product(qh, kh[:, :, j:j + kv_tile].transpose(-1, -2), scheme)
        s = s * scale_log2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _split_product(p, vh[:, :, j:j + kv_tile], scheme)
        m = m_new
    return (acc / l).transpose(1, 2)


@pytest.mark.parametrize("scheme,passes", [("3xtf32", True), ("tf32", False)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k1_split_arithmetic_against_jax(d, scheme, passes):
    """K1-f32's 3xTF32 arithmetic (emulated, the kernel's KV tile per head
    dim, a ragged KV tail) against the JAX package's fp32 flash attention
    in interpret mode: within chip_smoke.py's K1-f32 limits (2e-5 relative
    L2, 1e-4 max|err|); one TF32 pass per product fails them."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, n, 2, d)).astype(np.float32) for n in (96, 300, 300))
    want = flash_attention_bhsd(
        *(jnp.asarray(t).transpose(0, 2, 1, 3) for t in (q, k, v)),
        scale=d**-0.5, bq=32, bk=64, interpret=True,
    ).transpose(0, 2, 1, 3)
    got = _emulated_k1(*(torch.from_numpy(t) for t in (q, k, v)), scheme,
                       kv_tile=64 if d <= 64 else 32)
    m = smoke.k1_f32_mismatch(got, torch.from_numpy(np.array(want)))
    assert smoke.k1_within_limits(m) is passes, m


def _match_tables(mode, f=16, k=2, s=1024, d=64, seed=0):
    """numpy (x, p_hat): "random", or "separated" (every pivot row a
    permuted base row plus noise, so each query has one clear match)."""
    rng = np.random.default_rng(seed)
    if mode == "random":
        x = rng.standard_normal((f, s, d))
        p = rng.standard_normal((k, s, d))
    else:
        base = rng.standard_normal((s, d))
        x = np.stack([base[rng.permutation(s)] for _ in range(f)])
        p = np.stack([base[rng.permutation(s)] for _ in range(k)])
        x = x + 0.01 * rng.standard_normal(x.shape)
        p = p + 0.01 * rng.standard_normal(p.shape)
    p_hat = p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)
    return x.astype(np.float32), p_hat.astype(np.float32)


def _jax_indices(x, p_hat, pa, pb):
    """(2, F, S) indices of jnp_match_gather: keyframe rows that hold their
    own token index, gathered with w1 = 1 (pivot a's) and w1 = 0 (b's)."""
    k, s, d = p_hat.shape
    kf = np.broadcast_to(np.arange(s, dtype=np.float32)[None, None, :, None],
                         (3, k, s, d))
    f = x.shape[0]
    rows = [np.asarray(jprop.jnp_match_gather(
        jnp.asarray(x), jnp.asarray(p_hat), jnp.asarray(kf), jnp.asarray(pa),
        jnp.asarray(pb), jnp.full((f,), w, jnp.float32)))[0, :, :, 0] for w in (1.0, 0.0)]
    return np.stack(rows).astype(np.int64)


@pytest.mark.parametrize("scheme", ["3xtf32", "tf32"])
@pytest.mark.parametrize("mode", ["separated", "random"])
def test_match_split_arithmetic_against_jax(mode, scheme):
    """The fp32 match core's 3xTF32 similarities (emulated) against
    jnp_match_gather's indices: equal on separated inputs, at most
    chip_smoke.py's K2_F32_MAX_FLIP_SHARE flipped on random ones. One TF32
    pass per product flips more than that on the random inputs."""
    smoke = _chip_smoke()
    x, p_hat = _match_tables(mode)
    f, k = x.shape[0], p_hat.shape[0]
    pa, pb, _ = jprop.propagation_indices(f, f // k)
    want = _jax_indices(x, p_hat, pa, pb)
    xt, pt = torch.from_numpy(x), torch.from_numpy(p_hat)
    got = np.stack([
        _split_product(xt, pt[torch.from_numpy(piv).long()].transpose(-1, -2), scheme)
        .argmax(-1).numpy() for piv in (pa, pb)
    ])
    flipped = float((got != want).mean())
    if mode == "separated":
        assert flipped == 0.0
    elif scheme == "3xtf32":
        assert flipped <= smoke.K2_F32_MAX_FLIP_SHARE, flipped
    else:
        assert flipped > smoke.K2_F32_MAX_FLIP_SHARE, flipped

