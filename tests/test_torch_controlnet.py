"""The port's ControlNet against the JAX package.

- ``ControlNetModel`` with weights from ``_build_controlnet_sd`` (diffusers
  keys, non-zero projections) against the JAX ``ControlNetModel``, at
  conditioning scales 1.0 and 0.7; the tiny UNet with residuals against the
  JAX UNet; ``canny_cond`` bit for bit.
- The ControlNet edit loop (``tokenflow_sample_loop`` with
  ``controlnet_fn``/``cond_image``, pinned pivots) against the JAX loop.
- Cross-backend trajectories on the ``tiny-controlnet`` stack, both ways: a
  JAX-written inversion edited by the port's ``run_controlnet`` and a
  port-written one edited by the JAX editor (each side its own random
  weights: the check is the shared format and the output tree).

Tolerance: fp32 on both sides, rtol/atol 1e-4 (the TOL of
tests/test_torch_unet.py: convolution and matmul summation orders differ by
~1e-6 relative per layer, compounded over the network and DDIM steps).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from test_torch_goldens import _build_controlnet_sd
from tokenflow_torch import runtime as truntime
from tokenflow_torch.cli import controlnet_utils as tcu
from tokenflow_torch.cli import preprocess as tpre
from tokenflow_torch.cli import run_controlnet as trun
from tokenflow_torch.diffusion import ddim as tddim
from tokenflow_torch.editing import pipeline as tpipe
from tokenflow_torch.models import controlnet as tcn
from tokenflow_torch.models import unet2d as tunet
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_tpu.cli import controlnet_utils as jcu
from tokenflow_tpu.cli import preprocess as jpre
from tokenflow_tpu.cli import run_controlnet as jrun
from tokenflow_tpu.diffusion import ddim as jddim
from tokenflow_tpu.editing import pipeline as jpipe
from tokenflow_tpu.models import controlnet as jcn
from tokenflow_tpu.models import unet2d as junet
from tokenflow_tpu.models import weights as jw

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
HW, F, WS = 8, 4, 2  # latent size, frames, window (2 pivots)
CLI_F, CLI_HW, CLI_STEPS = 4, 32, 4


@pytest.fixture(scope="module")
def controlnet_pair():
    """The JAX and the port ControlNet on one diffusers state dict (the
    cond embedder of `_build_controlnet_sd`: three stride-2 stages, cond at 8x
    the latent)."""
    cfg = junet.UNet2DConfig.tiny()
    sd = {k: v.numpy().astype(np.float32) for k, v in _build_controlnet_sd(cfg).items()}
    params = {"params": jw.convert_controlnet_state_dict(sd)}
    port = tcn.ControlNetModel(tunet.UNet2DConfig.tiny(), cond_downsamples=3)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jcn.ControlNetModel(cfg), params, port.eval()


def _inputs(seed, b, hw=HW, factor=8):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, hw, hw, 4)).astype(np.float32),
        rng.standard_normal((b, 7, 32)).astype(np.float32),
        rng.uniform(0, 1, (b, hw * factor, hw * factor, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_controlnet_matches_jax(controlnet_pair, scale):
    model, params, port = controlnet_pair
    x, ctx, cond = _inputs(0, 2)
    t = np.asarray([981, 21])
    want_down, want_mid = model.apply(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(cond),
        conditioning_scale=scale,
    )
    with torch.inference_mode():
        down, mid = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         torch.from_numpy(cond), conditioning_scale=scale)
    assert len(down) == len(want_down) == 4
    for got, want in zip(down, want_down):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(mid.numpy(), np.asarray(want_mid), **TOL)


def test_controlnet_refuses_another_cond_ratio(controlnet_pair):
    _, _, port = controlnet_pair
    x, ctx, cond = _inputs(0, 1, factor=2)
    with pytest.raises(ValueError, match="2\\^3"):
        port(torch.from_numpy(x), 5, torch.from_numpy(ctx), torch.from_numpy(cond))


@pytest.fixture(scope="module")
def unet_pair():
    model = junet.UNet2DConditionModel(junet.UNet2DConfig.tiny())
    params = jax.jit(model.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, HW, HW, 4)), jnp.asarray(0),
        jnp.zeros((1, 7, 32)),
    )
    port = tunet.UNet2DConditionModel(tunet.UNet2DConfig.tiny())
    port.load_state_dict(state_dict_from_flax(params, "unet"), strict=True)
    return model, params, port.eval()


def test_unet_with_residuals_matches_jax(unet_pair):
    """Residuals of the skips' shapes (conv_in, level 0, its downsample,
    level 1) and the mid block's, added by both UNets."""
    model, params, port = unet_pair
    x, ctx, _ = _inputs(1, 2)
    rng = np.random.default_rng(2)
    shapes = [(2, 8, 8, 32), (2, 8, 8, 32), (2, 4, 4, 32), (2, 4, 4, 64)]
    down = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    mid = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    want, _ = model.apply(
        params, jnp.asarray(x), jnp.asarray(501), jnp.asarray(ctx),
        down_block_residuals=[jnp.asarray(d) for d in down],
        mid_block_residual=jnp.asarray(mid),
    )
    plain, _ = model.apply(params, jnp.asarray(x), jnp.asarray(501), jnp.asarray(ctx))
    with torch.inference_mode():
        got, _ = port(
            torch.from_numpy(x), 501, torch.from_numpy(ctx),
            down_block_residuals=[torch.from_numpy(d) for d in down],
            mid_block_residual=torch.from_numpy(mid),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(np.asarray(want) - np.asarray(plain)).max() > 1e-2  # residuals count


def test_canny_cond_is_bitwise_the_jax_one():
    rng = np.random.default_rng(3)
    base = rng.random((3, 48, 48, 3)).astype(np.float32)
    base[:, 10:30, 12:36] += 0.6  # a bright square: strong edges
    frames = np.clip(base, 0, 1)
    got = tcu.canny_cond(frames)
    want = jcu.canny_cond(frames)
    assert got.dtype == want.dtype == np.float32 and got.shape == frames.shape
    assert np.array_equal(got, want)
    assert set(np.unique(got)) == {0.0, 1.0}
    assert np.array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("propagate_chunk", [None, WS])
def test_controlnet_loop_matches_jax(unet_pair, controlnet_pair, propagate_chunk):
    """Two ControlNet edit steps (no injection) on the tiny UNet: the pivotal
    pass on the pivots' cond images, the propagation pass on its chunk's,
    each repeated per stream frame-major."""
    model, params, port = unet_pair
    cn_model, cn_params, cn_port = controlnet_pair
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((F, HW, HW, 4)).astype(np.float32)
    embeds3 = rng.standard_normal((3, 7, 32)).astype(np.float32)
    cond = rng.uniform(0, 1, (F, 8 * HW, 8 * HW, 3)).astype(np.float32)
    n_timesteps = 2
    save_ts = jddim.make_schedule(n_timesteps).timesteps[::-1].copy()
    traj = rng.standard_normal((n_timesteps, F, HW, HW, 4)).astype(np.float32) * 0.8
    pivots = np.asarray([[1, 2], [0, 3]], np.int32)
    kw = dict(window_size=WS, guidance_scale=7.5, pnp=False, propagate_chunk=propagate_chunk)
    want = jpipe.tokenflow_sample_loop(
        lambda p, s, t, c, e, **r: model.apply(p, s, t, c, edit=e, **r),
        params, jnp.asarray(x0), jnp.asarray(traj), jnp.asarray(embeds3),
        jpipe.make_edit_schedule(jddim.make_schedule(n_timesteps), save_ts),
        rng=jax.random.PRNGKey(0),  # unused: pivots pinned
        pivot_indices=pivots,
        controlnet_fn=lambda s, t, c, cn: cn_model.apply(cn_params, s, t, c, cn),
        cond_image=jnp.asarray(cond),
        **kw,
    )
    got = tpipe.tokenflow_sample_loop(
        port, torch.from_numpy(x0), torch.from_numpy(traj), torch.from_numpy(embeds3),
        tpipe.make_edit_schedule(tddim.make_schedule(n_timesteps), save_ts),
        pivot_indices=pivots, controlnet_fn=cn_port, cond_image=torch.from_numpy(cond),
        **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the cond images reach the loop: another cond gives another result
    other = tpipe.tokenflow_sample_loop(
        port, torch.from_numpy(x0), torch.from_numpy(traj), torch.from_numpy(embeds3),
        tpipe.make_edit_schedule(tddim.make_schedule(n_timesteps), save_ts),
        pivot_indices=pivots, controlnet_fn=cn_port,
        cond_image=torch.from_numpy(cond[::-1].copy()), **kw,
    )
    assert (other - got).abs().max() > 1e-3


def test_random_controlnet_leaves_the_unet_as_it_is():
    """A fresh ControlNet's zero projections give residuals of exactly
    zero (the reason chip_smoke.py fills them from its seed)."""
    stack = truntime.load_stack("tiny-controlnet", device="cpu", dtype=torch.float32,
                                init="random")
    frames = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    model, canny = tcu.build_controlnet(stack, frames, init="random")
    assert model is tcu.load_controlnet(stack, init="random")  # held for the editor
    assert canny.shape == (2, 32, 32, 3) and canny.dtype == torch.float32
    x = torch.randn(2, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    ctx = torch.zeros(2, 77, 32)
    with torch.inference_mode():
        down, mid = model(x, 501, ctx, canny)
    assert all(not d.any() for d in down) and not mid.any()


# ---------------------------------------------------------------------------
# cross-backend trajectories on the tiny-controlnet stack
# ---------------------------------------------------------------------------


def _config(**kw):
    config = dict(
        seed=1, output_path="results", data_path="data/clip", latents_path="latents",
        n_inversion_steps=CLI_STEPS, n_frames=CLI_F, sd_version="tiny-controlnet",
        init="random", dtype="f32", guidance_scale=7.5, n_timesteps=CLI_STEPS,
        prompt="a stylized test clip", negative_prompt="ugly", batch_size=2,
        image_size=CLI_HW,
    )
    config.update(kw)
    return config


@pytest.fixture()
def clip_dir(tmp_path, monkeypatch):
    data = tmp_path / "data" / "clip"
    data.mkdir(parents=True)
    base = np.random.default_rng(0).integers(40, 210, (CLI_HW, CLI_HW, 3), dtype=np.uint8)
    base[8:20, 6:22] = 250  # edges for the canny conditioning
    for i in range(CLI_F):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _preprocess_args():
    return [
        "--data_path", "data/clip", "--H", str(CLI_HW), "--W", str(CLI_HW),
        "--sd_version", "tiny-controlnet", "--init", "random", "--dtype", "f32",
        "--steps", str(CLI_STEPS), "--save_steps", str(CLI_STEPS),
        "--n_frames", str(CLI_F), "--batch_size", "2",
        "--inversion_prompt", "a test clip", "--skip_reconstruction",
    ]


def _assert_controlnet_tree(out, decoded):
    assert decoded.shape == (CLI_F, CLI_HW, CLI_HW, 3)
    assert np.isfinite(decoded).all()
    for name in ("img_ode/00000.png", "tokenflow_ControlNet_fps_10.mp4",
                 "tokenflow_ControlNet_fps_30.mp4", "input_fps10.mp4", "vae_recon_10.mp4"):
        assert (out / name).exists(), name


def test_jax_trajectory_edits_in_port(clip_dir):
    jpre.run(jpre.build_parser().parse_args(_preprocess_args() + ["--data_parallel", "off"]))
    config = _config(device="cpu")
    with open("config_controlnet.yaml", "w") as f:
        yaml.safe_dump(config, f)
    decoded = trun.main(["--config_path", "config_controlnet.yaml"])
    out = clip_dir / trun.resolve_output_path(dict(config))["output_path"]
    assert out.parts[-5].endswith("results_controlnet")
    _assert_controlnet_tree(out, decoded)
    assert (out / "metrics.json").exists() and (out / "pivots.json").exists()


def test_port_trajectory_edits_in_jax(clip_dir):
    tpre.main(_preprocess_args() + ["--device", "cpu"])
    config = jrun.resolve_output_path(_config(data_parallel="off"))
    os.makedirs(config["output_path"], exist_ok=True)
    decoded = jrun.edit_video(config)
    _assert_controlnet_tree(clip_dir / config["output_path"], np.asarray(decoded))
