"""Port parity for K4's module: ``group_norm_plain`` against the JAX
GroupNorm reference (``group_norm_ref``) and the Pallas kernel
(``group_norm_nhwc`` in interpret mode, both layouts, as
tests/test_kernels.py runs it), and the ``FusedGroupNorm`` switch.

Inputs are NHWC, made with numpy, and permuted to NCHW for the port.
Tolerances: fp32 rtol/atol 1e-5 (sums in another order, ~1e-7 relative on
the statistics); bf16 at most 1 bf16 step, counted at max(|ref|, 2^-6)
(near zero the fp32 rounding of the affine's terms exceeds a bf16 step of
the tiny result).
"""

import functools
import importlib.util
import itertools
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenflow_torch.kernels import group_norm as tgn
from tokenflow_torch.models import layers
from tokenflow_torch.models.layers import FusedGroupNorm
from tokenflow_torch.models.unet2d import UNet2DConditionModel, UNet2DConfig
from tokenflow_torch.models.vae import AutoencoderKL, AutoencoderKLConfig
from tokenflow_tpu.kernels.group_norm import group_norm_nhwc, group_norm_ref

torch.set_num_threads(2)


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    b, hh, ww, c = shape
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    scale = (1 + 0.5 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    if dtype == "bf16":  # round once, feed both sides the same values
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, groups, eps, act, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(tdt)
    y = tgn.group_norm_plain(
        x, torch.from_numpy(scale), torch.from_numpy(bias), groups, eps, act
    )
    assert y.dtype == tdt
    return y.float().permute(0, 2, 3, 1).numpy()


def _bf16_steps(got, want, floor=2.0**-6):
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), floor))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _check(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_steps(got, want) <= 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("layout", ["bl", "cl"])
def test_plain_matches_ref_and_pallas_interpret(layout, act, dtype):
    b, hh, ww, c, g = 3, 8, 8, 32, 8
    x, scale, bias = _inputs((b, hh, ww, c), seed=3, dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    got = _port(x, scale, bias, g, 1e-5, act, dtype)
    ref = group_norm_ref(
        xj.reshape(b, -1, c), jnp.asarray(scale), jnp.asarray(bias),
        groups=g, eps=1e-5, act=act,
    ).reshape(x.shape)
    _check(got, ref, dtype)
    pallas = group_norm_nhwc(
        xj, jnp.asarray(scale), jnp.asarray(bias), groups=g, eps=1e-5, act=act,
        layout=layout, interpret=True,
    )
    _check(got, pallas, dtype)


@pytest.mark.parametrize("shape,g", [((2, 16, 16, 96), 32), ((3, 7, 9, 96), 32)])
def test_plain_matches_ref_more_shapes(shape, g):
    """Many channels per group and a ragged spatial extent (63 per channel),
    bf16 with SiLU and the transformer norms' eps."""
    x, scale, bias = _inputs(shape, seed=4, dtype="bf16")
    got = _port(x, scale, bias, g, 1e-6, "silu", "bf16")
    ref = group_norm_ref(
        jnp.asarray(x, jnp.bfloat16).reshape(shape[0], -1, shape[-1]),
        jnp.asarray(scale), jnp.asarray(bias), groups=g, eps=1e-6, act="silu",
    ).reshape(shape)
    _check(got, ref, "bf16")


def test_fused_group_norm_switch():
    """On the CPU, use_kernel unset (the default) and off are the
    F.group_norm path, unchanged; on is the plain version."""
    torch.manual_seed(0)
    m = FusedGroupNorm(8, 32, eps=1e-5, act="silu")
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    x = torch.randn(2, 32, 5, 5)
    assert m.use_kernel is None
    want = torch.nn.functional.silu(
        torch.nn.functional.group_norm(x, 8, m.weight, m.bias, 1e-5)
    )
    assert torch.equal(m(x), want)
    m.use_kernel = False
    off = m(x)
    assert torch.equal(off, want)
    m.use_kernel = True
    on = m(x)
    assert torch.equal(on, tgn.group_norm_plain(x, m.weight, m.bias, 8, 1e-5, "silu"))
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1", "meta"])
@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_group_norm_path_rule(use_kernel, device):
    """The dispatch rule: unset, the device decides (K4 on CUDA,
    F.group_norm elsewhere); false forces F.group_norm on every device;
    true runs K4 on CUDA and the plain version on the CPU, and has no path
    on another device."""
    kind = torch.device(device).type
    want = {
        (None, "cuda"): "kernel", (None, "cpu"): "torch", (None, "meta"): "torch",
        (False, "cuda"): "torch", (False, "cpu"): "torch", (False, "meta"): "torch",
        (True, "cuda"): "kernel", (True, "cpu"): "plain", (True, "meta"): None,
    }[(use_kernel, kind)]
    if want is None:
        with pytest.raises(ValueError, match="no GroupNorm kernel path"):
            layers.group_norm_path(use_kernel, device)
    else:
        assert layers.group_norm_path(use_kernel, device) == want
        assert layers.group_norm_path(use_kernel, torch.device(device)) == want


@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_fused_group_norm_dispatches_by_path(use_kernel, monkeypatch):
    """``FusedGroupNorm.forward`` calls the function its resolved path
    names, with the module's groups, eps and act (the CUDA case is read
    off the rule with the device stubbed, since no card is here)."""
    calls = []

    def fake(name):
        def norm(x, w, b, groups, eps, act):
            calls.append((name, groups, eps, act))
            return x
        return norm

    monkeypatch.setattr(layers, "group_norm_kernel", fake("kernel"))
    monkeypatch.setattr(layers, "group_norm_plain", fake("plain"))
    monkeypatch.setattr(layers, "group_norm_path",
                        lambda uk, device: {None: "kernel", False: "torch", True: "plain"}[uk])
    m = FusedGroupNorm(8, 32, eps=1e-6, act="silu")
    m.use_kernel = use_kernel
    x = torch.randn(2, 32, 3, 3)
    y = m(x)
    if use_kernel is False:
        assert calls == [] and y.shape == x.shape
    else:
        assert calls == [("kernel" if use_kernel is None else "plain", 8, 1e-6, "silu")]


def test_kernel_wrapper_rejects_cpu_tensors():
    x, w = torch.randn(2, 32, 4, 4).bfloat16(), torch.ones(32)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_kernel(x, w, w, 8, 1e-5)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """K4 against its plain version on the card, resident and split spans,
    ragged extents (skips without a GPU; chip_smoke.py covers the SDEdit
    path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(3, 96, 7, 9), (2, 64, 40, 40), (2, 64, 300, 301)]:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        w = torch.randn((shape[1],), generator=gen, device="cuda").bfloat16()
        b = torch.randn((shape[1],), generator=gen, device="cuda").bfloat16()
        for act in (None, "silu"):
            before = tgn.launches
            got = tgn.group_norm_kernel(x, w, b, 32, 1e-5, act)
            assert tgn.launches == before + 1
            want = tgn.group_norm_plain(x, w, b, 32, 1e-5, act)
            assert _bf16_steps(got.float().cpu().numpy(), want.float().cpu().numpy()) <= 2
    with pytest.raises(NotImplementedError, match="bf16"):
        tgn.group_norm_kernel(x.float(), w, b, 32, 1e-5)


# ---------------------------------------------------------------------------
# K4's plan and summation order (the CUDA kernel itself runs only on the card)

_SMOKE = None


def _chip_smoke():
    global _SMOKE
    if _SMOKE is None:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        _SMOKE = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_SMOKE)
    return _SMOKE


@functools.lru_cache(maxsize=None)
def _sd21_sites(model: str, latent: int) -> tuple:
    """(channels, H * W, groups) of every FusedGroupNorm the SD-2.1 UNet
    (latent^2 input) or the VAE (decode from latent^2, encode from its 8x
    pixels) runs, read from modules on the meta device (no weights are
    made; attention is stubbed out, its output shape is all that counts)."""
    sites = set()

    def hook(module, args):
        x = args[0]
        sites.add((x.shape[1], x.shape[2] * x.shape[3], module.num_groups))

    with torch.device("meta"):
        net = (UNet2DConditionModel(UNet2DConfig.sd21_base()) if model == "unet"
               else AutoencoderKL(AutoencoderKLConfig.sd()))
    for m in net.modules():
        if isinstance(m, FusedGroupNorm):
            m.register_forward_pre_hook(hook)
    stub = lambda q, k, v, **kw: torch.empty_like(q)  # noqa: E731
    with torch.no_grad(), mock.patch.object(layers, "flash_attention", stub):
        if model == "unet":
            net(torch.empty(1, latent, latent, 4, device="meta"), 1,
                torch.empty(1, 77, 1024, device="meta"))
        else:
            net.decode(torch.empty(1, latent, latent, 4, device="meta"))
            net.encode(torch.empty(1, 8 * latent, 8 * latent, 3, device="meta"))
    return tuple(sorted(sites))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("model,latent", [("unet", 64), ("unet", 96), ("vae", 64), ("vae", 96)])
def test_plan_covers_every_sd21_site(model, latent, dtype):
    """At every GroupNorm of the SD-2.1 UNet at 512^2 and 768^2 (64^2 and
    96^2 latents) and of the VAE there: the slices cover each span exactly
    (no CTA empty, none past the span), slice and piece boundaries fall on
    16 bytes, a slice fits shared memory with its header, at most 16 pieces
    of < 2^20 bytes, clusters of at most 16; every UNet site in bf16 gets the
    one-pass cluster variant."""
    sites = _sd21_sites(model, latent)
    assert len(sites) >= 8
    esize = torch.empty((), dtype=dtype).element_size()
    batches = (1, 9, 24, 40, 120) if model == "unet" else (1, 10)
    for (c, hw, groups), b in itertools.product(sites, batches):
        p = tgn.plan(b, c, hw, groups, dtype)
        span = c // groups * hw
        if model == "unet" and dtype == torch.bfloat16:
            assert p.variant == "cluster", (c, hw)
        if p.variant == "split":
            assert p.chunk > 0 and p.cluster == 0
            assert tgn.cluster_smem(c // groups, hw, -(-span // 8), esize) > tgn._SMEM_MAX
            continue
        assert p.cluster in tgn.CLUSTER_SIZES and p.cluster <= 16
        assert p.cluster * p.slice >= span > (p.cluster - 1) * p.slice
        assert (p.slice * esize) % 16 == 0 and (p.piece * esize) % 16 == 0
        assert p.ragged == ((span * esize) % 16 != 0) and not p.ragged
        assert p.piece * esize < 2**20 and -(-p.slice // p.piece) <= 16
        assert p.smem == tgn.cluster_smem(c // groups, hw, p.slice, esize)
        assert p.slice * esize < p.smem <= tgn._SMEM_MAX


def test_plan_constants_match_the_cuda_source():
    """The plan's shared-memory layout and limits are the ones
    csrc/group_norm.cu validates."""
    src = (Path(tgn.__file__).resolve().parents[1] / "csrc" / "group_norm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSmemMax") == tgn._SMEM_MAX
    assert const("kHeaderBytes") == tgn._HEADER_BYTES
    assert const("kMaxPieces") == tgn._MAX_PIECES
    assert const("kMaxCluster") == max(tgn.CLUSTER_SIZES)
    assert const("kMaxGroupChannels") == tgn._MAX_GROUP_CHANNELS
    assert 2048 // const("kThreads") == tgn._MAX_CTAS_PER_SM


def test_plan_rules():
    """Ragged spans, forced cluster sizes, the split variant and the dtype
    rule."""
    p = tgn.plan(3, 96, 63, 32, torch.bfloat16)  # 3 channels x 63: 378-byte spans
    assert p.variant == "cluster" and p.ragged and p.cluster == 1
    assert p.slice >= 189 and p.slice % 8 == 0
    assert tgn.plan(9, 320, 9216, 32, torch.bfloat16, cluster=2).cluster == 2
    with pytest.raises(ValueError):
        tgn.plan(9, 320, 9216, 32, torch.bfloat16, cluster=3)
    with pytest.raises(ValueError):  # 184 KB in one CTA does fit; 1.2 MB does not
        tgn.plan(10, 512, 36864, 32, torch.bfloat16, cluster=1)
    assert tgn.plan(10, 128, 768 * 768, 32, torch.bfloat16).variant == "split"
    # one CTA per 80 KB span with many spans to overlap, 2-CTA clusters with few
    assert tgn.plan(120, 320, 4096, 32, torch.bfloat16).cluster == 1
    assert tgn.plan(15, 320, 4096, 32, torch.bfloat16).cluster == 2
    with pytest.raises(NotImplementedError):
        tgn.plan(9, 320, 9216, 32, torch.float16)


def _emulate(x, w, b, groups, eps, act, p, fault=None):
    """K4's cluster variant in plain PyTorch, in the kernel's order as plan
    ``p`` cuts each span: each CTA (rank) sums (x, x^2) over its slice piece
    by piece, the ranks' partials are summed in rank order, then (a, b) per
    channel with a = gamma / sqrt(var + eps), b = beta - mean * a, and y = x
    * a + b (SiLU). ``fault`` plants one error: "drop_rank" (the last
    rank's partial dropped), "zero_piece" (rank 0's first piece read as
    zeros), "no_silu", "channel_shift" (each slice after the first starts one
    channel late: its elements before the next channel take that channel's
    affine)."""
    bsz, c = x.shape[:2]
    cg = c // groups
    xf = x.float().reshape(bsz * groups, -1)
    span = xf.shape[1]
    hw = span // cg
    if fault == "zero_piece":
        xf = xf.clone()
        xf[:, : min(p.piece, p.slice)] = 0
    parts = []
    for r in range(p.cluster):
        part = xf[:, r * p.slice:(r + 1) * p.slice]
        s = torch.zeros(xf.shape[0])
        q = torch.zeros(xf.shape[0])
        for k in range(0, part.shape[1], p.piece):
            piece = part[:, k:k + p.piece]
            s, q = s + piece.sum(1), q + (piece * piece).sum(1)
        parts.append((s, q))
    if fault == "drop_rank":
        parts[-1] = (torch.zeros_like(parts[-1][0]), torch.zeros_like(parts[-1][1]))
    total_s, total_q = torch.zeros(xf.shape[0]), torch.zeros(xf.shape[0])
    for s, q in parts:
        total_s, total_q = total_s + s, total_q + q
    mean = total_s / span
    inv = 1.0 / torch.sqrt(total_q / span - mean * mean + eps)
    a = inv[:, None] * w.float().reshape(groups, cg).repeat(bsz, 1)
    bb = b.float().reshape(groups, cg).repeat(bsz, 1) - mean[:, None] * a
    chan = torch.arange(span) // hw
    if fault == "channel_shift":
        for r in range(1, p.cluster):
            lo = r * p.slice
            hi = min((lo // hw + 1) * hw, span)
            chan[lo:hi] = torch.clamp(chan[lo:hi] + 1, max=cg - 1)
    y = xf * a[:, chan] + bb[:, chan]
    if act == "silu" and fault != "no_silu":
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def _nchw_inputs(shape, seed, dtype):
    """Seeded NCHW inputs (numpy), with a mean offset and weights around 1."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = torch.from_numpy((rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32))
    w = torch.from_numpy((1 + 0.5 * rng.standard_normal(c)).astype(np.float32))
    b = torch.from_numpy((0.5 * rng.standard_normal(c)).astype(np.float32))
    return x.to(dtype), w.to(dtype), b.to(dtype)


# (shape, groups, cluster, piece): 9 x 9 spatial (81 per channel), so every
# slice boundary but multiples of 81 cuts a channel; pieces of 48 elements
# put several pieces in each slice
_EMULATED = [((2, 32, 9, 9), 4, 4, 48), ((3, 64, 7, 9), 8, 8, 16), ((2, 24, 10, 10), 8, 2, 40)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("case", _EMULATED)
def test_emulated_kernel_order_matches_plain_and_ref(case, act, dtype):
    """The kernel's summation order (per piece, per CTA, then rank order)
    and its affine form agree with group_norm_plain and with the JAX
    group_norm_ref where slice boundaries cut channels: fp32 within rtol =
    atol = 1e-5, bf16 within 1 step at max(|ref|, 2^-6)."""
    shape, g, n, piece = case
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, w, b = _nchw_inputs(shape, 7, tdt)
    p = tgn.plan(shape[0], shape[1], shape[2] * shape[3], g, tdt, cluster=n)._replace(piece=piece)
    hw = shape[2] * shape[3]
    assert any((r * p.slice) % hw for r in range(1, n)), "no slice boundary cuts a channel"
    got = _emulate(x, w, b, g, 1e-5, act, p)
    plain = tgn.group_norm_plain(x, w, b, g, 1e-5, act)
    xj = x.float().permute(0, 2, 3, 1).reshape(shape[0], hw, shape[1]).numpy()
    ref = group_norm_ref(
        jnp.asarray(xj, jnp.float32 if dtype == "f32" else jnp.bfloat16),
        jnp.asarray(w.float().numpy()), jnp.asarray(b.float().numpy()),
        groups=g, eps=1e-5, act=act,
    )
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(shape[0], shape[2], shape[3], -1)
    got_nhwc = got.float().permute(0, 2, 3, 1).numpy()
    _check(got_nhwc, ref, dtype)
    _check(got_nhwc, plain.float().permute(0, 2, 3, 1).numpy(), dtype)


@pytest.mark.parametrize("fault", [None, "drop_rank", "zero_piece", "no_silu", "channel_shift"])
def test_gn_verdict_catches_planted_faults(fault):
    """chip_smoke.py's K4 verdict (at most 2 bf16 steps at max(|ref|,
    2^-6)) passes the kernel's order and fails each planted fault, in bf16
    and in fp32 (rtol = atol = 1e-5)."""
    smoke = _chip_smoke()
    shape, g = (2, 32, 9, 9), 4
    for dtype in (torch.bfloat16, torch.float32):
        x, w, b = _nchw_inputs(shape, 11, dtype)
        p = tgn.plan(shape[0], shape[1], 81, g, dtype, cluster=4)._replace(
            piece=48 // x.element_size()
        )
        got = _emulate(x, w, b, g, 1e-5, "silu", p, fault)
        want = tgn.group_norm_plain(x, w, b, g, 1e-5, "silu")
        if fault is None:
            smoke.gn_verdict("emulated", got, want)
        else:
            with pytest.raises(AssertionError):
                smoke.gn_verdict(f"planted {fault}", got, want)


@pytest.mark.cuda
def test_kernel_f32_and_repeat_on_cuda():
    """K4 in fp32 within rtol = atol = 1e-5 of its plain version, and two
    launches on the same input bitwise equal (skips without a GPU;
    chip_smoke.py covers both paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, dtype in [((2, 64, 40, 40), torch.float32), ((3, 96, 7, 9), torch.float32),
                         ((2, 320, 96, 96), torch.bfloat16)]:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = torch.randn((shape[1],), generator=gen, device="cuda").to(dtype)
        b = torch.randn((shape[1],), generator=gen, device="cuda").to(dtype)
        for act in (None, "silu"):
            got = tgn.group_norm_kernel(x, w, b, 32, 1e-5, act)
            assert torch.equal(got, tgn.group_norm_kernel(x, w, b, 32, 1e-5, act))
            want = tgn.group_norm_plain(x, w, b, 32, 1e-5, act)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            else:
                assert _bf16_steps(got.float().cpu().numpy(), want.float().cpu().numpy()) <= 2


@pytest.mark.parametrize("value", [None, False, True])
def test_load_stack_sets_the_switch_as_given(value):
    """``load_stack(group_norm_kernel=)`` sets every UNet and VAE GroupNorm's
    ``use_kernel`` to the value as given (None, the default, lets the device
    decide), on every call to the held stack."""
    from tokenflow_torch import runtime

    kw = {} if value is None else {"group_norm_kernel": value}
    stack = runtime.load_stack("tiny", device="cpu", init="random", dtype=torch.float32, **kw)
    norms = [m for model in (stack.unet, stack.vae) for m in model.modules()
             if isinstance(m, FusedGroupNorm)]
    assert norms and all(m.use_kernel is value for m in norms)
