"""The port's approximate (source-free) propagation against the JAX package,
on the tiny UNet with the same JAX-initialised weights
(``state_dict_from_flax``) and inputs from a numpy seed:

- ``tokenflow_sample_loop(prop_approx=True)`` (PnP and SDEdit, whole and
  chunked, and with a ControlNet) against the JAX approximate loop, pivots
  pinned: a NON-PARITY mode, held to the JAX package's approximate output;
- the structural properties of ``tests/test_prop_approx.py`` on the port,
  the two-stream ops against the JAX ops, the plain match's gather at given
  indices, and the match wrappers' ``launches_by_streams`` on a mocked
  launch.

Tolerance: fp32 on both sides, rtol/atol 1e-4 against JAX (the TOL of
tests/test_torch_pipeline.py); a chunked run against a whole one rtol 2e-4
/ atol 2e-5 (the two-pass tolerance of tests/test_pipeline.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_goldens import _build_controlnet_sd
from tokenflow_torch.diffusion import ddim as tddim
from tokenflow_torch.editing import pipeline as tpipe
from tokenflow_torch.kernels import token_match as ttm
from tokenflow_torch.kernels import token_match_split as ttms
from tokenflow_torch.models import controlnet as tcn
from tokenflow_torch.models import layers as tlayers
from tokenflow_torch.models import unet2d as tunet
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_torch.ops import editctx as tctx
from tokenflow_torch.ops import extended_attention as text
from tokenflow_torch.ops import propagation as tprop
from tokenflow_tpu.diffusion import ddim as jddim
from tokenflow_tpu.editing import pipeline as jpipe
from tokenflow_tpu.models import controlnet as jcn
from tokenflow_tpu.models import unet2d as junet
from tokenflow_tpu.models import weights as jw
from tokenflow_tpu.ops import extended_attention as jext
from tokenflow_tpu.ops import propagation as jprop

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-5)
HW, F, WS, STEPS = 8, 4, 2, 2  # latent size, frames, window (2 pivots), steps
PIVOTS = np.asarray([[1, 2], [0, 3]], np.int32)


@pytest.fixture(scope="module")
def stack():
    model = junet.UNet2DConditionModel(junet.UNet2DConfig.tiny())
    params = jax.jit(model.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, HW, HW, 4)), jnp.asarray(0),
        jnp.zeros((1, 7, 32)),
    )
    port = tunet.UNet2DConditionModel(tunet.UNet2DConfig.tiny())
    port.load_state_dict(state_dict_from_flax(params, "unet"), strict=True)
    rng = np.random.default_rng(7)
    data = {
        "x0": rng.standard_normal((F, HW, HW, 4)).astype(np.float32),
        "embeds3": rng.standard_normal((3, 7, 32)).astype(np.float32),
        "traj": rng.standard_normal((STEPS, F, HW, HW, 4)).astype(np.float32) * 0.8,
        "cond": rng.uniform(0, 1, (F, 8 * HW, 8 * HW, 3)).astype(np.float32),
    }
    return model, params, port.eval(), data


@pytest.fixture(scope="module")
def controlnet_pair():
    """The JAX and the port ControlNet on one diffusers state dict."""
    cfg = junet.UNet2DConfig.tiny()
    sd = {k: v.numpy().astype(np.float32) for k, v in _build_controlnet_sd(cfg).items()}
    params = {"params": jw.convert_controlnet_state_dict(sd)}
    port = tcn.ControlNetModel(tunet.UNet2DConfig.tiny(), cond_downsamples=3)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jcn.ControlNetModel(cfg), params, port.eval()


def _schedules():
    sched_t, sched_j = tddim.make_schedule(STEPS), jddim.make_schedule(STEPS)
    save_ts = sched_j.timesteps[::-1].copy()
    return (tpipe.make_edit_schedule(sched_t, save_ts, pnp_attn_t=0.5, pnp_f_t=0.8),
            jpipe.make_edit_schedule(sched_j, save_ts, pnp_attn_t=0.5, pnp_f_t=0.8))


def _jax_loop(stack, controlnet=None, **kw):
    model, params, _, data = stack
    extra = {}
    if controlnet is not None:
        cn_model, cn_params, _ = controlnet
        extra = dict(controlnet_fn=lambda s, t, c, cn: cn_model.apply(cn_params, s, t, c, cn),
                     cond_image=jnp.asarray(data["cond"]))
    out = jpipe.tokenflow_sample_loop(
        lambda p, s, t, c, e, **r: model.apply(p, s, t, c, edit=e, **r),
        params, jnp.asarray(data["x0"]), jnp.asarray(data["traj"]),
        jnp.asarray(data["embeds3"]), _schedules()[1],
        window_size=WS, guidance_scale=7.5, rng=jax.random.PRNGKey(0),  # pivots pinned
        pivot_indices=PIVOTS, **extra, **kw,
    )
    return np.asarray(out)


def _port_loop(stack, traj=None, controlnet=None, passes=None, pivots=PIVOTS, **kw):
    _, _, port, data = stack
    extra = {}
    if controlnet is not None:
        extra = dict(controlnet_fn=controlnet[2], cond_image=torch.from_numpy(data["cond"]))

    def phase(name):
        if passes is not None:
            passes.append(name)
        return torch.autograd.profiler.record_function(name)

    return tpipe.tokenflow_sample_loop(
        port, torch.from_numpy(data["x0"]),
        torch.from_numpy(data["traj"] if traj is None else traj),
        torch.from_numpy(data["embeds3"]), _schedules()[0],
        window_size=WS, guidance_scale=7.5, pivot_indices=pivots, phase=phase,
        **extra, **kw,
    )


@pytest.mark.parametrize("propagate_chunk", [None, WS])
@pytest.mark.parametrize("pnp", [True, False], ids=["pnp", "sdedit"])
def test_approx_loop_matches_jax(stack, pnp, propagate_chunk):
    kw = dict(pnp=pnp, propagate_chunk=propagate_chunk, prop_approx=True)
    want = _jax_loop(stack, **kw)
    passes = []
    got = _port_loop(stack, passes=passes, **kw)
    assert passes == ["pivotal", "propagate"] * STEPS
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a different program from the exact loop (non-parity mode)
    exact = _port_loop(stack, pnp=pnp, propagate_chunk=propagate_chunk)
    assert (exact - got).abs().max() > 1e-3


@pytest.mark.parametrize("propagate_chunk", [None, WS])
def test_controlnet_approx_loop_matches_jax(stack, controlnet_pair, propagate_chunk):
    """ControlNet + approx: both passes source-free, the residuals of each
    pass (each chunk) on its two streams' cond images."""
    kw = dict(pnp=False, prop_approx=True, propagate_chunk=propagate_chunk)
    want = _jax_loop(stack, controlnet=controlnet_pair, **kw)
    got = _port_loop(stack, controlnet=controlnet_pair, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    without = _port_loop(stack, **kw)
    assert (without - got).abs().max() > 1e-3  # the residuals count


@pytest.mark.parametrize("pnp", [True, False], ids=["pnp", "sdedit"])
def test_approx_ignores_nonpivot_source_frames(stack, pnp):
    traj = stack[3]["traj"]
    # each window's pivot is its first frame: frames 1 and 3 never pivot
    first = np.tile(np.arange(0, F, WS, dtype=np.int32), (STEPS, 1))
    kw = dict(pnp=pnp, prop_approx=True, pivots=first)
    approx_a = _port_loop(stack, **kw)
    nonpiv = traj.copy()
    nonpiv[:, [1, 3]] += 0.7
    # source-free propagation: non-pivot source frames are dead inputs
    assert torch.equal(approx_a, _port_loop(stack, traj=nonpiv, **kw))
    assert torch.isfinite(approx_a).all()
    # the exact loop consumes them
    exact = _port_loop(stack, pnp=pnp, pivots=first)
    assert (exact - _port_loop(stack, traj=nonpiv, pnp=pnp, pivots=first)).abs().max() > 1e-3
    # pivot source frames: PnP approx consumes them (injection and matching
    # in its three-stream pivotal pass); SDEdit approx consumes none
    piv = traj.copy()
    piv[:, [0, 2]] += 0.7
    approx_c = _port_loop(stack, traj=piv, **kw)
    if pnp:
        assert (approx_c - approx_a).abs().max() > 1e-3
    else:
        assert torch.equal(approx_c, approx_a)


@pytest.mark.parametrize("pnp", [True, False], ids=["pnp", "sdedit"])
def test_approx_chunked_matches_full(stack, pnp):
    full = _port_loop(stack, pnp=pnp, prop_approx=True)
    chunked = _port_loop(stack, pnp=pnp, prop_approx=True, propagate_chunk=WS)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), **CHUNK_TOL)


@pytest.mark.parametrize("pnp,approx", [(True, True), (True, False), (False, True)],
                         ids=["pnp_approx", "pnp_exact", "sdedit_approx"])
def test_pivotal_cache_entries(stack, pnp, approx):
    """pivot_h_uncond and conv_src come only under PnP approx; the
    source-free SDEdit pivotal cache is two-stream."""
    port = stack[2]
    kf, ns = 2, 2 if (approx and not pnp) else 3
    rng = np.random.default_rng(3)
    sample = torch.from_numpy(rng.standard_normal((ns * kf, HW, HW, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((ns * kf, 7, 32)).astype(np.float32))
    edit = tctx.UNetEdit(mode=tctx.EditMode.PIVOTAL, n_frames=kf, pnp=pnp,
                         prop_approx=approx, qk_gate=True, conv_gate=True)
    with torch.inference_mode():
        _, cache = port(sample, 5, ctx, edit)
    attn_sites = [k for k in cache if k != tctx.CONV_INJECT_SITE]
    assert attn_sites
    for site in attn_sites:
        entry = cache[site]
        assert entry["kf_attn"].shape[:2] == (ns, kf)
        if pnp and approx:
            assert set(entry) == {"pivot_h", "pivot_h_uncond", "kf_attn"}
            assert entry["pivot_h_uncond"].shape == entry["pivot_h"].shape
            assert (entry["pivot_h_uncond"] - entry["pivot_h"]).abs().max() > 1e-3
        else:
            assert set(entry) == {"pivot_h", "kf_attn"}
    if pnp and approx:
        conv = cache[tctx.CONV_INJECT_SITE]
        assert set(conv) == {"conv_src"} and conv["conv_src"].shape[0] == kf
    else:
        assert tctx.CONV_INJECT_SITE not in cache


def test_conv_blend_uses_cached_pivot_features():
    """At the conv site the approximate PROPAGATE pass injects w1 * cache[pa]
    + (1 - w1) * cache[pb] into both streams when the gate is on, and leaves
    the streams alone when it is off."""
    rng = np.random.default_rng(4)
    f, k, hw, c = 3, 2, 4, 8
    block = tlayers.ResnetBlock2D(c, c, groups=2, temb_channels=16).eval()
    x = torch.from_numpy(rng.standard_normal((2 * f, c, hw, hw)).astype(np.float32))
    temb = torch.from_numpy(rng.standard_normal((2 * f, 16)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((k, c, hw, hw)).astype(np.float32))
    pa, pb = torch.tensor([0, 0, 1]), torch.tensor([0, 0, 0])
    w1 = torch.tensor([0.6, 0.7, 0.55])

    def run(gate):
        edit = tctx.ConvEdit(mode=tctx.EditMode.PROPAGATE, n_frames=f, n_streams=2,
                             approx=True, gate=gate, src_cache=table, prop_pa=pa,
                             prop_pb=pb, prop_w1=w1)
        with torch.inference_mode():
            out, cache = block(x, temb, edit)
        assert cache is None
        return out

    with torch.inference_mode():
        plain = block(x, temb)
    assert torch.equal(run(False), plain)
    w = w1[:, None, None, None]
    blend = (w * table[pa] + (1 - w) * table[pb]).repeat_interleave(2, dim=0)
    torch.testing.assert_close(run(True), x + blend, rtol=0, atol=0)


def test_two_stream_ops_match_jax():
    """The source-free pivotal pass's extended attention and the approximate
    pass's propagation, two streams, against the JAX ops."""
    rng = np.random.default_rng(5)
    kf, s, inner, heads, f = 2, 16, 32, 2, 3
    qkv = [rng.standard_normal((2, kf, s, inner)).astype(np.float32) for _ in range(3)]
    want = jext.extended_attention(*map(jnp.asarray, qkv), heads=heads)
    got = text.extended_attention(*map(torch.from_numpy, qkv), heads=heads)
    assert got.shape == (2, kf, s, inner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = rng.standard_normal((f, s, inner)).astype(np.float32)
    piv = rng.standard_normal((kf, s, inner)).astype(np.float32)
    kf3 = rng.standard_normal((3, kf, s, inner)).astype(np.float32)
    pa, pb, w1 = tprop.propagation_indices(f, 2)
    want = jprop.token_propagation(*map(jnp.asarray, (x, piv, kf3[1:], pa, pb, w1)))
    # the PnP approximate pass gathers the [uncond|cond] slice of a
    # three-stream cache
    got = tprop.token_propagation(
        torch.from_numpy(x), torch.from_numpy(piv), torch.from_numpy(kf3)[1:],
        *map(torch.as_tensor, (pa, pb, w1)),
    )
    assert got.shape == (2, f, s, inner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ns", [2, 3])
def test_gather_blend_at_given_indices(ns):
    """``gather_blend`` at the plain match's own indices is its output, and
    at other indices it gathers those tokens' rows (the CPU side of a
    reference that takes a card run's matches)."""
    rng = np.random.default_rng(8)
    f, k, s, d = 3, 2, 16, 8
    x = torch.from_numpy(rng.standard_normal((f, s, d)).astype(np.float32))
    p = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((k, s, d)).astype(np.float32)), dim=-1
    )
    kf = torch.from_numpy(rng.standard_normal((ns, k, s, d)).astype(np.float32))
    pa, pb, w1 = (torch.as_tensor(a) for a in tprop.propagation_indices(f, 2))
    out, idx = ttm.token_match_gather_plain(x, p, kf, pa, pb, w1, return_indices=True)
    assert torch.equal(ttm.gather_blend(kf, idx, pa, pb, w1), out)
    other = torch.from_numpy(rng.integers(0, s, (2, f, s)))
    got = ttm.gather_blend(kf, other, pa, pb, w1)
    w = w1[None, :, None, None]
    want = w * kf[:, pa[:, None], other[0]] + (1 - w) * kf[:, pb[:, None], other[1]]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("module,kernel", [
    (ttm, "token_match_gather_kernel"), (ttms, "token_match_gather_split_kernel"),
], ids=["K2", "K3"])
def test_launches_by_streams_counts_each_launch(monkeypatch, module, kernel):
    """Each launch adds one at its kf table's stream count, beside the
    dtype count (the launch itself mocked: the plain version fills the
    outputs of CPU tensors)."""

    def fake_launch(ops, idx, out, split=False):
        ref, ref_idx = ttm.token_match_gather_plain(*ops, return_indices=True)
        idx.copy_(ref_idx)
        out.copy_(ref)

    monkeypatch.setattr(module, "prepare_operands", ttm.check_operands)
    monkeypatch.setattr(module, "launch", fake_launch)
    monkeypatch.setattr(module, "launches_by_streams", {})
    monkeypatch.setattr(module, "launches_by_dtype", {})
    rng = np.random.default_rng(6)
    f, k, s, d = 3, 2, 16, 8
    x = torch.from_numpy(rng.standard_normal((f, s, d)).astype(np.float32))
    p = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((k, s, d)).astype(np.float32)), dim=-1
    )
    pa, pb, w1 = (torch.as_tensor(a) for a in tprop.propagation_indices(f, 2))
    kf3 = torch.from_numpy(rng.standard_normal((3, k, s, d)).astype(np.float32))
    for kf in (kf3, kf3[1:], kf3[1:]):
        out = getattr(module, kernel)(x, p, kf, pa, pb, w1)
        torch.testing.assert_close(out, ttm.token_match_gather_plain(x, p, kf, pa, pb, w1))
    assert module.launches_by_streams == {3: 1, 2: 2}
    assert module.launches_by_dtype == {"float32": 3}
