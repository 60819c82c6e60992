"""The port's depth-conditioned path against the JAX package, on the tiny
UNet with 5 input channels (4 latent channels and the depth map).

- The depth configs (``depth``, ``tiny-depth``) and ``is_depth``.
- DDIM inversion and reconstruction through ``build_eps_fn(depth=...)``,
  whole and in frame chunks, against the JAX ``build_eps_fn``.
- ``tokenflow_sample_loop(depth=...)`` against the JAX loop with pinned
  pivots: exact, ``prop_approx``, and a ``propagate_chunk`` smaller than F.
- Cross-backend trajectories on the ``tiny-depth`` stack, both ways, on
  precomputed depth maps: a JAX-written inversion edited by the port's
  ``run_pnp`` and a port-written one edited by the JAX editor (each side
  its own random weights: the check is the shared format and the output
  tree).

Tolerance: fp32 on both sides, rtol/atol 1e-4 (the TOL of
tests/test_torch_pipeline.py: per-layer summation-order differences of
~1e-6 relative, compounded over UNet calls and DDIM steps).
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tokenflow_torch import runtime as truntime
from tokenflow_torch.cli import preprocess as tpre
from tokenflow_torch.cli import run_pnp as trun
from tokenflow_torch.diffusion import ddim as tddim
from tokenflow_torch.diffusion import inversion as tinv
from tokenflow_torch.editing import pipeline as tpipe
from tokenflow_torch.models import unet2d as tunet
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_tpu import runtime as jruntime
from tokenflow_tpu.cli import preprocess as jpre
from tokenflow_tpu.cli import run_pnp as jrun
from tokenflow_tpu.diffusion import ddim as jddim
from tokenflow_tpu.diffusion import inversion as jinv
from tokenflow_tpu.editing import pipeline as jpipe
from tokenflow_tpu.models import unet2d as junet
from test_torch_sd15 import _jax_fields  # noqa: E402  (the port-only fields checked)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
HW, F, WS = 8, 4, 2  # latent size, frames, window (2 pivots)
CLI_F, CLI_HW, CLI_STEPS = 4, 32, 4


@pytest.mark.parametrize("version", ["depth", "tiny-depth"])
def test_depth_configs_match_jax(version):
    got = truntime.configs_for(version)
    want = jruntime.configs_for(version)
    assert [_jax_fields(c) for c in got] == [dataclasses.asdict(c) for c in want]
    assert got[0].in_channels == 5 and got[0].out_channels == 4
    assert truntime.is_depth(version) and jruntime.is_depth(version)
    assert truntime.MODEL_KEYS.get(version) == jruntime.MODEL_KEYS.get(version)
    assert version in truntime.SD_VERSIONS
    assert _jax_fields(tunet.UNet2DConfig.sd21_depth()) == dataclasses.asdict(
        junet.UNet2DConfig.sd21_depth())


@pytest.fixture(scope="module")
def stack():
    cfg = dataclasses.replace(junet.UNet2DConfig.tiny(), in_channels=5)
    model = junet.UNet2DConditionModel(cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, HW, HW, 5)), jnp.asarray(0),
        jnp.zeros((1, 7, 32)),
    )
    port = tunet.UNet2DConditionModel(
        dataclasses.replace(tunet.UNet2DConfig.tiny(), in_channels=5))
    port.load_state_dict(state_dict_from_flax(params, "unet"), strict=True)
    rng = np.random.default_rng(7)
    data = {
        "x0": rng.standard_normal((F, HW, HW, 4)).astype(np.float32),
        "embeds3": rng.standard_normal((3, 7, 32)).astype(np.float32),
        "depth": rng.uniform(-1, 1, (F, HW, HW, 1)).astype(np.float32),
    }
    return model, params, port.eval(), data


@pytest.mark.parametrize("frame_chunk", [None, 2], ids=["whole", "chunked"])
def test_inversion_and_reconstruction_with_depth_match_jax(stack, frame_chunk):
    model, params, port, data = stack
    steps, save_steps = 6, 3
    cond = data["embeds3"][2:3]
    sched_t, sched_j = tddim.make_schedule(steps), jddim.make_schedule(steps)
    jstack = types.SimpleNamespace(
        unet_apply=lambda p, s, t, c, e, **kw: model.apply(p, s, t, c, edit=e, **kw))
    jfn = jpre.build_eps_fn(jstack, jnp.asarray(cond), depth=jnp.asarray(data["depth"]),
                            frame_chunk=frame_chunk)

    def jeps(x, t):
        return jfn({"unet": params}, x, t)

    tstack = types.SimpleNamespace(unet_apply=port, dtype=torch.float32)
    teps = tpre.build_eps_fn(tstack, torch.from_numpy(cond), frame_chunk,
                             depth=torch.from_numpy(data["depth"]))

    xj, trj = jax.jit(
        lambda x: jinv.ddim_inversion(jeps, x, sched_j, save_steps)[:2]
    )(jnp.asarray(data["x0"]))
    x_t, tr_t, _ = tinv.ddim_inversion(teps, torch.from_numpy(data["x0"]), sched_t, save_steps)
    assert x_t.shape == (F, HW, HW, 4)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(trj), **TOL)

    rec_j = jax.jit(lambda x: jinv.ddim_reconstruction(jeps, x, sched_j))(xj)
    rec_t = tinv.ddim_reconstruction(teps, torch.tensor(np.asarray(xj)), sched_t)
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), **TOL)

    # the maps reach the UNet: other maps give other noise
    other = tpre.build_eps_fn(tstack, torch.from_numpy(cond), frame_chunk,
                              depth=torch.from_numpy(-data["depth"]))
    x0 = torch.from_numpy(data["x0"])
    assert (other(x0, 501) - teps(x0, 501)).abs().max() > 1e-3


@pytest.mark.parametrize(
    "prop_approx,propagate_chunk",
    [(False, None), (True, None), (False, WS), (True, WS)],
    ids=["exact", "prop_approx", "exact_chunked", "prop_approx_chunked"],
)
def test_depth_edit_loop_matches_jax(stack, prop_approx, propagate_chunk):
    """Three PnP edit steps with injection: the pivotal pass with
    depth[pivots] on every stream, the propagation pass with its chunk's
    maps, [src|x|x] exact and [x|x] under prop_approx."""
    model, params, port, data = stack
    steps = 3
    sched_t, sched_j = tddim.make_schedule(steps), jddim.make_schedule(steps)
    save_ts = sched_j.timesteps[::-1].copy()
    traj = np.random.default_rng(8).standard_normal(
        (steps, F, HW, HW, 4)
    ).astype(np.float32) * 0.8
    pivots = np.asarray([[0, 3], [1, 2], [1, 3]], np.int32)
    kw = dict(window_size=WS, guidance_scale=7.5, pnp=True, propagate_chunk=propagate_chunk,
              prop_approx=prop_approx)
    want = jpipe.tokenflow_sample_loop(
        lambda p, s, t, c, e: model.apply(p, s, t, c, edit=e),
        params, jnp.asarray(data["x0"]), jnp.asarray(traj), jnp.asarray(data["embeds3"]),
        jpipe.make_edit_schedule(sched_j, save_ts, pnp_attn_t=0.5, pnp_f_t=0.8),
        rng=jax.random.PRNGKey(0),  # unused: pivots pinned
        pivot_indices=pivots, depth=jnp.asarray(data["depth"]),
        **kw,
    )

    def port_loop(depth):
        return tpipe.tokenflow_sample_loop(
            port, torch.from_numpy(data["x0"]), torch.from_numpy(traj),
            torch.from_numpy(data["embeds3"]),
            tpipe.make_edit_schedule(sched_t, save_ts, pnp_attn_t=0.5, pnp_f_t=0.8),
            pivot_indices=pivots, depth=torch.from_numpy(depth), **kw,
        )

    got = port_loop(data["depth"])
    assert got.shape == (F, HW, HW, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # each frame's own map reaches the loop: reversed maps give another edit
    assert (port_loop(data["depth"][::-1].copy()) - got).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# cross-backend trajectories on the tiny-depth stack
# ---------------------------------------------------------------------------


def _config(**kw):
    config = dict(
        seed=1, output_path="results", data_path="data/clip", latents_path="latents",
        n_inversion_steps=CLI_STEPS, n_frames=CLI_F, sd_version="tiny-depth",
        init="random", dtype="f32", guidance_scale=7.5, n_timesteps=CLI_STEPS,
        prompt="a stylized test clip", negative_prompt="ugly", batch_size=2,
        pnp_attn_t=0.5, pnp_f_t=0.8, image_size=CLI_HW,
    )
    config.update(kw)
    return config


@pytest.fixture()
def clip_dir(tmp_path, monkeypatch):
    """Frames with precomputed raw depth maps of another size than the
    latents (as tests/test_e2e_cli.py::test_depth_edit_e2e makes them)."""
    data = tmp_path / "data" / "clip"
    (data / "depth").mkdir(parents=True)
    base = np.random.default_rng(0).integers(40, 210, (CLI_HW, CLI_HW, 3), dtype=np.uint8)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:37, 0:41]
    for i in range(CLI_F):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
        np.save(data / "depth" / f"{i:05d}.npy",
                (yy * 10.0 + xx + rng.random((37, 41)) * 5 + i).astype(np.float32))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _preprocess_args():
    return [
        "--data_path", "data/clip", "--H", str(CLI_HW), "--W", str(CLI_HW),
        "--sd_version", "tiny-depth", "--init", "random", "--dtype", "f32",
        "--steps", str(CLI_STEPS), "--save_steps", str(CLI_STEPS),
        "--n_frames", str(CLI_F), "--batch_size", "2",
        "--inversion_prompt", "a test clip", "--skip_reconstruction",
    ]


def _assert_pnp_tree(out, decoded):
    assert decoded.shape == (CLI_F, CLI_HW, CLI_HW, 3)
    assert np.isfinite(decoded).all()
    for name in ("img_ode/00000.png", "tokenflow_PnP_fps_10.mp4", "tokenflow_PnP_fps_30.mp4",
                 "input_fps10.mp4", "vae_recon_10.mp4"):
        assert (out / name).exists(), name


def test_jax_trajectory_edits_in_port(clip_dir):
    jpre.run(jpre.build_parser().parse_args(_preprocess_args() + ["--data_parallel", "off"]))
    config = _config(device="cpu")
    with open("config_pnp.yaml", "w") as f:
        yaml.safe_dump(config, f)
    decoded = trun.main(["--config_path", "config_pnp.yaml"])
    out = clip_dir / trun.resolve_output_path(dict(config))["output_path"]
    assert out.parts[-6].endswith("results_pnp_SD_tiny-depth")
    _assert_pnp_tree(out, decoded)
    assert (out / "metrics.json").exists() and (out / "pivots.json").exists()


def test_port_trajectory_edits_in_jax(clip_dir):
    tpre.main(_preprocess_args() + ["--device", "cpu"])
    config = jrun.resolve_output_path(_config(data_parallel="off"))
    os.makedirs(config["output_path"], exist_ok=True)
    decoded = jrun.edit_video(config)
    _assert_pnp_tree(clip_dir / config["output_path"], np.asarray(decoded))
