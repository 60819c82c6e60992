"""The port's single-pass FUSED edit step and the edit loop's trace.

- ``EditMode.FUSED``'s directives against the JAX ``editctx``; one FUSED
  UNet call (extended attention on the pivot segment, propagation of the
  frame segment from its cache, conv injection over both) against the JAX
  UNet's; the conv injection over ``[pivots | frames]`` against the
  PIVOTAL and PROPAGATE calls of the two segments apart.
- ``tokenflow_sample_loop(fused=True)`` with pinned pivots against the JAX
  fused loop and against the port's two passes, for PnP, SDEdit
  (``pnp=False``) and the depth UNet, one "fused" phase a step; JAX's three
  fallbacks (a chunked propagation, a ControlNet, ``prop_approx``) run the
  two passes, bit for bit.
- ``trace_dir``: the tiny PnP CLI on the CPU writes a ``torch.profiler``
  trace of the edit loop, and nothing without the key; ``profiling.trace``
  raises when no trace is written.

Tolerance: fp32 on both sides, tiny UNet, JAX-initialised weights
(``state_dict_from_flax``), inputs from a numpy seed that keep the matches
clear of near ties. One UNet call, and the fused loop against the port's
two passes: rtol 2e-4, atol 2e-5, the fused-against-two-pass tolerance of
tests/test_pipeline.py::test_fused_step_matches_two_pass. A loop against
the JAX loop: rtol = atol = 1e-4, the port's parity tolerance for its loops
(tests/test_torch_pipeline.py): on these inputs the port's two-pass loop
reads up to 3.9e-5 from the JAX two-pass loop (values up to 16), and
the fused loops differ by that rounding across the two frameworks, not by
the fused step.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from test_torch_goldens import _build_controlnet_sd
from tokenflow_torch import profiling
from tokenflow_torch.cli import common as tcommon
from tokenflow_torch.cli import preprocess as tpre
from tokenflow_torch.cli import run_pnp as trun
from tokenflow_torch.diffusion import ddim as tddim
from tokenflow_torch.editing import pipeline as tpipe
from tokenflow_torch.models import controlnet as tcn
from tokenflow_torch.models import layers as tlayers
from tokenflow_torch.models import unet2d as tunet
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_torch.ops import editctx as tctx
from tokenflow_torch.ops.propagation import propagation_indices
from tokenflow_tpu.diffusion import ddim as jddim
from tokenflow_tpu.editing import pipeline as jpipe
from tokenflow_tpu.models import unet2d as junet
from tokenflow_tpu.ops import editctx as jctx

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-5)
JAX_LOOP_TOL = dict(rtol=1e-4, atol=1e-4)
HW, F, WS, STEPS = 8, 4, 2, 2  # latent size, frames, window (2 pivots), steps
PIVOTS = np.asarray([[1, 2], [0, 3]], np.int32)
CLI_F, CLI_HW, CLI_STEPS = 4, 32, 4


def _stack(in_channels: int):
    cfg = dataclasses.replace(junet.UNet2DConfig.tiny(), in_channels=in_channels)
    model = junet.UNet2DConditionModel(cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, HW, HW, in_channels)), jnp.asarray(0),
        jnp.zeros((1, 7, 32)),
    )
    port = tunet.UNet2DConditionModel(
        dataclasses.replace(tunet.UNet2DConfig.tiny(), in_channels=in_channels))
    port.load_state_dict(state_dict_from_flax(params, "unet"), strict=True)
    rng = np.random.default_rng(7)
    data = {
        "x0": rng.standard_normal((F, HW, HW, 4)).astype(np.float32),
        "embeds3": rng.standard_normal((3, 7, 32)).astype(np.float32),
        "traj": rng.standard_normal((STEPS, F, HW, HW, 4)).astype(np.float32) * 0.8,
        "cond": rng.uniform(0, 1, (F, 8 * HW, 8 * HW, 3)).astype(np.float32),
        "depth": rng.uniform(-1, 1, (F, HW, HW, 1)).astype(np.float32),
    }
    return model, params, port.eval(), data


@pytest.fixture(scope="module")
def stacks():
    """The tiny UNet and the tiny depth UNet (5 input channels), each as
    JAX model, JAX params, the port's copy and the shared inputs."""
    return {"plain": _stack(4), "depth": _stack(5)}


def _schedules():
    sched_t, sched_j = tddim.make_schedule(STEPS), jddim.make_schedule(STEPS)
    save_ts = sched_j.timesteps[::-1].copy()
    return (tpipe.make_edit_schedule(sched_t, save_ts, pnp_attn_t=0.5, pnp_f_t=0.8),
            jpipe.make_edit_schedule(sched_j, save_ts, pnp_attn_t=0.5, pnp_f_t=0.8))


def _jax_loop(stack, depth=False, **kw):
    model, params, _, data = stack
    out = jpipe.tokenflow_sample_loop(
        lambda p, s, t, c, e: model.apply(p, s, t, c, edit=e),
        params, jnp.asarray(data["x0"]), jnp.asarray(data["traj"]),
        jnp.asarray(data["embeds3"]), _schedules()[1],
        window_size=WS, guidance_scale=7.5, rng=jax.random.PRNGKey(0),  # pivots pinned
        pivot_indices=PIVOTS, depth=jnp.asarray(data["depth"]) if depth else None, **kw,
    )
    return np.asarray(out)


def _port_loop(stack, passes=None, depth=False, controlnet=None, unet=None, **kw):
    _, _, port, data = stack
    extra = {}
    if controlnet is not None:
        extra = dict(controlnet_fn=controlnet, cond_image=torch.from_numpy(data["cond"]))

    def phase(name):
        if passes is not None:
            passes.append(name)
        return torch.autograd.profiler.record_function(name)

    return tpipe.tokenflow_sample_loop(
        unet or port, torch.from_numpy(data["x0"]), torch.from_numpy(data["traj"]),
        torch.from_numpy(data["embeds3"]), _schedules()[0],
        window_size=WS, guidance_scale=7.5, pivot_indices=PIVOTS, phase=phase,
        depth=torch.from_numpy(data["depth"]) if depth else None, **extra, **kw,
    )


def test_fused_directives_match_jax():
    """for_site and for_conv of a FUSED directive, field by field, as the
    JAX ones: the pivots ride along (n_pivots), three streams, and the conv
    site spans K + F frames."""
    args = dict(mode="fused", n_frames=6, n_pivots=3, pnp=True)
    port, ref = tctx.UNetEdit(**args), jctx.UNetEdit(**args)
    assert tctx.EditMode.FUSED == jctx.EditMode.FUSED == "fused"
    for site in jctx.SELF_ATTN_SITES:
        got, want = port.for_site(site), ref.for_site(site)
        for name in ("mode", "n_frames", "n_pivots", "qk_inject_site", "n_streams",
                     "cache_uncond"):
            assert getattr(got, name) == getattr(want, name), (site, name)
    got, want = port.for_conv(tctx.CONV_INJECT_SITE), ref.for_conv(jctx.CONV_INJECT_SITE)
    for name in ("mode", "n_frames", "n_streams", "approx"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_frames == 9 and got.n_streams == 3


@pytest.mark.parametrize("gates", [True, False], ids=["injecting", "not_injecting"])
def test_fused_unet_call_matches_jax(stacks, gates):
    """One FUSED UNet call on [3K pivots | 3F frames] (PnP, q/k and conv
    injection on or off) against the JAX UNet's: eps of every item."""
    model, params, port, data = stacks["plain"]
    rng = np.random.default_rng(11)
    kf = F // WS
    sample = rng.standard_normal((3 * (kf + F), HW, HW, 4)).astype(np.float32)
    ctx = np.repeat(data["embeds3"][None], kf + F, axis=0).reshape(-1, 7, 32)
    pa, pb, w1 = propagation_indices(F, WS)
    kw = dict(mode="fused", n_frames=F, n_pivots=kf, pnp=True)
    want, _ = model.apply(
        params, jnp.asarray(sample), jnp.asarray(501), jnp.asarray(ctx),
        edit=jctx.UNetEdit(**kw, qk_gate=jnp.asarray(gates), conv_gate=jnp.asarray(gates),
                           prop_pa=jnp.asarray(pa), prop_pb=jnp.asarray(pb),
                           prop_w1=jnp.asarray(w1)),
    )
    with torch.inference_mode():
        got, cache = port(
            torch.from_numpy(sample), 501, torch.from_numpy(ctx),
            tctx.UNetEdit(**kw, qk_gate=gates, conv_gate=gates, prop_pa=torch.as_tensor(pa),
                          prop_pb=torch.as_tensor(pb), prop_w1=torch.as_tensor(w1)),
        )
    assert cache == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_conv_injection_spans_both_segments():
    """The exact conv injection needs no FUSED branch: on the (K + F, 3)
    view it equals the PIVOTAL call on the pivots and the PROPAGATE call on
    the frames, concatenated."""
    torch.manual_seed(0)
    block = tlayers.ResnetBlock2D(32, 32, temb_channels=16).eval()
    kf, f = 2, 4
    x = torch.randn(3 * (kf + f), 32, 8, 8)
    temb = torch.randn(3 * (kf + f), 16)
    fused = tctx.UNetEdit(mode=tctx.EditMode.FUSED, n_frames=f, n_pivots=kf, pnp=True,
                          conv_gate=True).for_conv(tctx.CONV_INJECT_SITE)
    piv = tctx.UNetEdit(mode=tctx.EditMode.PIVOTAL, n_frames=kf, pnp=True,
                        conv_gate=True).for_conv(tctx.CONV_INJECT_SITE)
    prop = tctx.UNetEdit(mode=tctx.EditMode.PROPAGATE, n_frames=f, pnp=True,
                         conv_gate=True).for_conv(tctx.CONV_INJECT_SITE)
    with torch.inference_mode():
        got, _ = block(x, temb, fused)
        want = torch.cat([block(x[: 3 * kf], temb[: 3 * kf], piv)[0],
                          block(x[3 * kf :], temb[3 * kf :], prop)[0]])
        plain = block(x, temb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert (got - plain).abs().max() > 1e-3  # the injection happened


@pytest.mark.parametrize("variant", ["pnp", "sdedit", "depth"])
def test_fused_loop_matches_jax(stacks, variant):
    """fused=True: one UNet call a step ("fused" phase), equal to the JAX
    fused loop and to the port's own two passes."""
    stack = stacks["depth" if variant == "depth" else "plain"]
    kw = dict(pnp=variant != "sdedit", depth=variant == "depth")
    want = _jax_loop(stack, fused=True, **kw)
    passes, calls = [], []
    port = stack[2]

    def unet(*args, **kwargs):
        calls.append(args[3].mode)
        return port(*args, **kwargs)

    got = _port_loop(stack, passes=passes, unet=unet, fused=True, **kw)
    assert passes == ["fused"] * STEPS
    assert calls == [tctx.EditMode.FUSED] * STEPS
    np.testing.assert_allclose(got.numpy(), want, **JAX_LOOP_TOL)
    two_pass = _port_loop(stack, **kw)
    np.testing.assert_allclose(got.numpy(), two_pass.numpy(), **TOL)


@pytest.fixture(scope="module")
def controlnet():
    sd = _build_controlnet_sd(tunet.UNet2DConfig.tiny())
    model = tcn.ControlNetModel(tunet.UNet2DConfig.tiny(), cond_downsamples=3)
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("fallback", ["chunked", "controlnet", "prop_approx"])
def test_fused_falls_back_to_two_passes(stacks, controlnet, fallback):
    """Where the JAX loop runs its two passes under fused=True (a chunked
    propagation, a ControlNet, prop_approx), so does the port's: the two
    phases a step, and the two-pass result bit for bit."""
    kw = {"chunked": dict(propagate_chunk=WS), "controlnet": dict(controlnet=controlnet),
          "prop_approx": dict(prop_approx=True)}[fallback]
    stack = stacks["plain"]
    passes = []
    got = _port_loop(stack, passes=passes, pnp=True, fused=True, **kw)
    assert passes == ["pivotal", "propagate"] * STEPS
    assert torch.equal(got, _port_loop(stack, pnp=True, **kw))


def test_fused_fallback_reasons():
    assert tpipe.fused_fallback(8, None, False, False) is None
    assert tpipe.fused_fallback(8, 8, False, False) is None
    assert tpipe.fused_fallback(8, 4, False, False) == "chunked"
    assert tpipe.fused_fallback(8, None, True, True) == "ControlNet | prop_approx"


# ---------------------------------------------------------------------------
# the edit loop's trace (trace_dir)
# ---------------------------------------------------------------------------


def _traces(root) -> list:
    return sorted(glob.glob(os.path.join(str(root), "**", "*.pt.trace.json"), recursive=True))


def test_trace_dir_traces_the_pnp_edit_loop(tmp_path, monkeypatch, capsys):
    """The tiny PnP CLI on the CPU with ``trace_dir`` and ``fused_step``:
    one TensorBoard trace that holds the fused steps and their ``aten::``
    events; the same CLI without the key writes no trace."""
    data = tmp_path / "data" / "clip"
    data.mkdir(parents=True)
    base = np.random.default_rng(0).integers(40, 210, (CLI_HW, CLI_HW, 3), dtype=np.uint8)
    for i in range(CLI_F):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
    monkeypatch.chdir(tmp_path)
    tpre.main([
        "--data_path", "data/clip", "--H", str(CLI_HW), "--W", str(CLI_HW),
        "--sd_version", "tiny", "--init", "random", "--dtype", "f32", "--device", "cpu",
        "--steps", str(CLI_STEPS), "--save_steps", str(CLI_STEPS),
        "--n_frames", str(CLI_F), "--batch_size", "2",
        "--inversion_prompt", "a test clip", "--skip_reconstruction",
    ])
    config = dict(
        seed=1, device="cpu", output_path="results", data_path="data/clip",
        latents_path="latents", n_inversion_steps=CLI_STEPS, n_frames=CLI_F,
        sd_version="tiny", init="random", dtype="f32", guidance_scale=7.5,
        n_timesteps=CLI_STEPS, prompt="a stylized test clip", negative_prompt="ugly",
        batch_size=2, pnp_attn_t=0.5, pnp_f_t=0.8, image_size=CLI_HW, fused_step=True,
    )
    with open("traced.yaml", "w") as f:
        yaml.safe_dump(dict(config, trace_dir="trace"), f)
    capsys.readouterr()
    trun.main(["--config_path", "traced.yaml"])
    assert "fused_step: fused, one UNet call a step" in capsys.readouterr().out
    traces = _traces(tmp_path)
    assert [os.path.dirname(p) for p in traces] == [str(tmp_path / "trace")]
    with open(traces[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert names.count("edit_fused") == CLI_STEPS
    assert "edit_loop" in names and sum(n.startswith("aten::") for n in names) > 100
    out = tmp_path / trun.resolve_output_path(dict(config))["output_path"]
    phases = json.loads((out / "metrics.json").read_text())["phases_seconds"]
    assert "edit_fused" in phases and "edit_pivotal" not in phases

    with open("plain.yaml", "w") as f:
        yaml.safe_dump(dict(config, output_path="results_plain"), f)
    trun.main(["--config_path", "plain.yaml"])
    assert _traces(tmp_path) == traces


def test_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for trace_dir in (None, ""):
        with profiling.trace(trace_dir):
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_trace_raises_when_no_trace_is_written(tmp_path, monkeypatch):
    """A trace that was asked for and not written raises (the JAX trace
    swallows a profiler failure)."""
    monkeypatch.setattr(torch.profiler, "tensorboard_trace_handler",
                        lambda trace_dir: lambda prof: None)
    with pytest.raises(RuntimeError, match="wrote no trace"):
        with profiling.trace(str(tmp_path / "trace")):
            torch.ones(4).sum()


@pytest.mark.parametrize("mode", ["sdedit", "controlnet"])
def test_trace_dir_is_refused_outside_pnp(mode):
    """As in the JAX package, only the PnP editor traces its edit loop."""
    config = {k: 1 for k in tcommon.REQUIRED_KEYS["base"] + tcommon.REQUIRED_KEYS[mode]}
    config.update(sd_version="tiny", device="cpu", batch_size=2, trace_dir="trace")
    with pytest.raises(ValueError, match="trace_dir"):
        tcommon.validate_config(config, mode)
    config.pop("trace_dir")
    tcommon.validate_config(config, mode)
