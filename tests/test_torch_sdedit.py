"""The port's SDEdit editor against the JAX package.

- Cross-backend trajectories, both ways, on the tiny stack on the CPU: a
  trajectory the JAX preprocess writes edits through the port's
  ``run_sdedit``, and one the port's preprocess writes edits through the
  JAX ``run_sdedit.edit_video``. Each side runs its own random weights, so
  the check is the shared npz format and the output tree, with finite
  frames.
- The SDEdit loop (``tokenflow_sample_loop(pnp=False)`` on the truncated
  schedule, pinned pivots) and the per-frame ``vanilla_sample_loop``, each
  against the JAX loop on the tiny UNet with JAX-initialised weights.
  Tolerance: fp32 on both sides, rtol/atol 1e-4 (the TOL of
  tests/test_torch_pipeline.py: per-layer summation-order differences of
  ~1e-6 relative, compounded over UNet calls and DDIM steps).
- The tiny UNet and VAE with every GroupNorm on ``use_kernel`` (the plain
  version of K4 on the CPU) against the JAX models with their default flax
  GroupNorm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tokenflow_torch.cli import preprocess as tpre
from tokenflow_torch.cli import run_sdedit as tsdedit
from tokenflow_torch.diffusion import ddim as tddim
from tokenflow_torch.editing import pipeline as tpipe
from tokenflow_torch.models import layers as tlayers
from tokenflow_torch.models import unet2d as tunet
from tokenflow_torch.models import vae as tvae
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_torch.ops import editctx as tctx
from tokenflow_tpu.cli import preprocess as jpre
from tokenflow_tpu.cli import run_sdedit as jsdedit
from tokenflow_tpu.diffusion import ddim as jddim
from tokenflow_tpu.editing import pipeline as jpipe
from tokenflow_tpu.models import layers as jlayers
from tokenflow_tpu.models import unet2d as junet
from tokenflow_tpu.models import vae as jvae
from tokenflow_tpu.ops import editctx as jctx
from tokenflow_tpu.ops.propagation import propagation_indices

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
HW, F, WS = 8, 4, 2  # latent size, frames, window (2 pivots)
CLI_F, CLI_HW, CLI_STEPS, CLI_SAVE = 4, 32, 4, 4


# ---------------------------------------------------------------------------
# cross-backend trajectories
# ---------------------------------------------------------------------------


def _sdedit_config(**kw):
    config = dict(
        seed=1, output_path="results", data_path="data/clip",
        latents_path="latents", n_frames=CLI_F, sd_version="tiny",
        init="random", dtype="f32", guidance_scale=7.5, n_timesteps=CLI_SAVE,
        prompt="a stylized test clip", negative_prompt="ugly", batch_size=2,
        start=0.9, image_size=CLI_HW,
    )
    config.update(kw)
    return config


@pytest.fixture()
def clip_dir(tmp_path, monkeypatch):
    data = tmp_path / "data" / "clip"
    data.mkdir(parents=True)
    base = np.random.default_rng(0).integers(40, 210, (CLI_HW, CLI_HW, 3), dtype=np.uint8)
    for i in range(CLI_F):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _preprocess_args():
    return [
        "--data_path", "data/clip", "--H", str(CLI_HW), "--W", str(CLI_HW),
        "--sd_version", "tiny", "--init", "random", "--dtype", "f32",
        "--steps", str(CLI_STEPS), "--save_steps", str(CLI_SAVE),
        "--n_frames", str(CLI_F), "--batch_size", str(CLI_F),
        "--inversion_prompt", "a test clip", "--skip_reconstruction",
    ]


def _assert_sdedit_tree(out, decoded):
    assert decoded.shape == (CLI_F, CLI_HW, CLI_HW, 3)
    assert np.isfinite(decoded).all()
    for name in ("img_ode/00000.png", "tokenflow_SDEdit_fps_10.mp4",
                 "tokenflow_SDEdit_fps_30.mp4", "input_fps10.mp4"):
        assert (out / name).exists(), name


def test_jax_trajectory_edits_in_port(clip_dir):
    jpre.run(jpre.build_parser().parse_args(_preprocess_args() + ["--data_parallel", "off"]))
    config = _sdedit_config(device="cpu")
    with open("config_sdedit.yaml", "w") as f:
        yaml.safe_dump(config, f)
    decoded = tsdedit.main(["--config_path", "config_sdedit.yaml"])
    out = clip_dir / tsdedit.resolve_output_path(dict(config))["output_path"]
    _assert_sdedit_tree(out, decoded)
    assert (out / "metrics.json").exists() and (out / "pivots.json").exists()


def test_port_trajectory_edits_in_jax(clip_dir):
    tpre.main(_preprocess_args() + ["--device", "cpu"])
    config = jsdedit.resolve_output_path(_sdedit_config(data_parallel="off"))
    os.makedirs(config["output_path"], exist_ok=True)
    decoded = jsdedit.edit_video(config)
    _assert_sdedit_tree(clip_dir / config["output_path"], np.asarray(decoded))


def test_start_noise_fresh_branch_is_one_shared_map():
    eps = torch.randn(3, 4, 4, 4)
    assert tsdedit.start_noise({"seed": 5}, eps) is eps
    fresh = tsdedit.start_noise({"seed": 5, "use_ddim_noise": False}, eps)
    assert fresh.shape == eps.shape and fresh.dtype == torch.float32
    assert torch.equal(fresh[0], fresh[2]) and not torch.equal(fresh[0], eps[0])
    again = tsdedit.start_noise({"seed": 5, "use_ddim_noise": False}, eps)
    assert torch.equal(fresh, again)


def test_sdedit_refuses_depth():
    with pytest.raises(ValueError, match="depth"):
        tsdedit.edit_video(_sdedit_config(sd_version="depth"))


# ---------------------------------------------------------------------------
# the SDEdit and vanilla loops against the JAX loops
# ---------------------------------------------------------------------------


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
    }
    return model, params, port.eval(), data


def _truncated(n_timesteps, start):
    return (
        tddim.truncate_schedule(tddim.make_schedule(n_timesteps), start),
        jddim.truncate_schedule(jddim.make_schedule(n_timesteps), start),
    )


@pytest.mark.parametrize("propagate_chunk", [None, WS])
def test_sdedit_loop_matches_jax(stack, propagate_chunk):
    model, params, port, data = stack
    n_timesteps = 4
    sched_t, sched_j = _truncated(n_timesteps, 0.9)
    assert np.array_equal(sched_t.timesteps, sched_j.timesteps)
    steps = len(sched_t.timesteps)
    assert steps == 2  # timesteps[int(1 - 0.9 * 4):], the reference precedence
    save_ts = jddim.make_schedule(n_timesteps).timesteps[::-1].copy()
    traj = np.random.default_rng(9).standard_normal(
        (n_timesteps, F, HW, HW, 4)
    ).astype(np.float32) * 0.8
    pivots = np.asarray([[1, 2], [0, 3]], np.int32)
    kw = dict(window_size=WS, guidance_scale=7.5, pnp=False, propagate_chunk=propagate_chunk)
    want = jpipe.tokenflow_sample_loop(
        lambda p, s, t, c, e: model.apply(p, s, t, c, edit=e),
        params,
        jnp.asarray(data["x0"]),
        jnp.asarray(traj),
        jnp.asarray(data["embeds3"]),
        jpipe.make_edit_schedule(sched_j, save_ts),
        rng=jax.random.PRNGKey(0),  # unused: pivots pinned
        pivot_indices=pivots,
        **kw,
    )
    got = tpipe.tokenflow_sample_loop(
        port,
        torch.from_numpy(data["x0"]),
        torch.from_numpy(traj),
        torch.from_numpy(data["embeds3"]),
        tpipe.make_edit_schedule(sched_t, save_ts),
        pivot_indices=pivots,
        **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("frame_chunk", [None, 2])
def test_vanilla_loop_matches_jax(stack, frame_chunk):
    model, params, port, data = stack
    sched_t, sched_j = _truncated(5, 0.9)
    save_ts = jddim.make_schedule(5).timesteps[::-1].copy()
    embeds2 = data["embeds3"][1:]
    want = jpipe.vanilla_sample_loop(
        lambda p, s, t, c, e: model.apply(p, s, t, c, edit=e),
        params,
        jnp.asarray(data["x0"]),
        jnp.asarray(embeds2),
        jpipe.make_edit_schedule(sched_j, save_ts),
        guidance_scale=7.5,
        frame_chunk=frame_chunk,
    )
    got = tpipe.vanilla_sample_loop(
        port,
        torch.from_numpy(data["x0"]),
        torch.from_numpy(embeds2),
        tpipe.make_edit_schedule(sched_t, save_ts),
        guidance_scale=7.5,
        frame_chunk=frame_chunk,
    )
    assert got.shape == data["x0"].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="divide"):
        tpipe.vanilla_sample_loop(
            port, torch.from_numpy(data["x0"]), torch.from_numpy(embeds2),
            tpipe.make_edit_schedule(sched_t, save_ts), guidance_scale=7.5,
            frame_chunk=3,
        )


# ---------------------------------------------------------------------------
# the GroupNorm kernel switch on the tiny models
# ---------------------------------------------------------------------------


def _use_kernel(model, on=True):
    n = 0
    for m in model.modules():
        if isinstance(m, tlayers.FusedGroupNorm):
            m.use_kernel = on
            n += 1
    return n


def _nn_indices(norm_h, pivot_h, pa):
    """First-max NN indices of each query row against pivot pa[f] (the
    propagation's match), in float64 numpy so both backends are read alike."""
    x = np.asarray(norm_h, np.float64)
    p = np.asarray(pivot_h, np.float64)
    return np.einsum("fsd,fzd->fsz", x, p[np.asarray(pa)]).argmax(-1)


def test_unet_with_group_norm_kernel_matches_jax(stack, monkeypatch):
    """The port's tiny UNet with every GroupNorm through K4's plain version
    against the JAX UNet: the pivotal pass (no NN match) elementwise at
    TOL, then the propagation pass on each side's own pivotal cache by the
    share of NN matches that differ (GroupNorm ulps flip near-ties on tiny
    random stacks, ROADMAP C; bound 5%) and the relative L2 error of eps
    (bound 1e-3)."""
    model, params, port, data = stack
    assert _use_kernel(port) == 21  # the tiny UNet's GroupNorm sites
    try:
        k = 2
        rng = np.random.default_rng(3)
        xp = rng.standard_normal((3 * k, HW, HW, 4)).astype(np.float32)
        xf = rng.standard_normal((3 * F, HW, HW, 4)).astype(np.float32)
        ctx = data["embeds3"]
        jpiv = jctx.UNetEdit(mode=jctx.EditMode.PIVOTAL, n_frames=k, pnp=False,
                             qk_gate=jnp.asarray(False), conv_gate=jnp.asarray(False))
        tpiv = tctx.UNetEdit(mode=tctx.EditMode.PIVOTAL, n_frames=k, pnp=False,
                             qk_gate=False, conv_gate=False)
        want_p, jcache = model.apply(params, jnp.asarray(xp), jnp.asarray(501),
                                     jnp.asarray(np.tile(ctx, (k, 1, 1))), edit=jpiv)
        with torch.inference_mode():
            got_p, tcache = port(torch.from_numpy(xp), 501,
                                 torch.from_numpy(np.tile(ctx, (k, 1, 1))), tpiv)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)

        matches = {"jax": [], "torch": []}
        orig_j, orig_t = jlayers.token_propagation, tlayers.token_propagation

        def spy(side, orig):
            def fn(norm_h, pivot_h, kf_attn, pa, pb, w1):
                matches[side].append(_nn_indices(norm_h, pivot_h, pa))
                return orig(norm_h, pivot_h, kf_attn, pa, pb, w1)
            return fn

        monkeypatch.setattr(jlayers, "token_propagation", spy("jax", orig_j))
        monkeypatch.setattr(tlayers, "token_propagation", spy("torch", orig_t))
        pa, pb, w1 = propagation_indices(F, F // k)
        jprop = jctx.UNetEdit(
            mode=jctx.EditMode.PROPAGATE, n_frames=F, pnp=False,
            qk_gate=jnp.asarray(False), conv_gate=jnp.asarray(False), cache=jcache,
            prop_pa=jnp.asarray(pa), prop_pb=jnp.asarray(pb), prop_w1=jnp.asarray(w1),
        )
        tprop = tctx.UNetEdit(
            mode=tctx.EditMode.PROPAGATE, n_frames=F, pnp=False, qk_gate=False,
            conv_gate=False, cache=tcache, prop_pa=torch.from_numpy(pa),
            prop_pb=torch.from_numpy(pb), prop_w1=torch.from_numpy(w1),
        )
        fctx = np.tile(ctx, (F, 1, 1))
        want = np.asarray(model.apply(params, jnp.asarray(xf), jnp.asarray(501),
                                      jnp.asarray(fctx), edit=jprop)[0])
        with torch.inference_mode():
            got = port(torch.from_numpy(xf), 501, torch.from_numpy(fctx), tprop)[0].numpy()
    finally:
        _use_kernel(port, False)
    assert len(matches["jax"]) == len(matches["torch"]) == 4  # propagation sites
    flipped = np.mean(np.concatenate([
        (a != b).ravel() for a, b in zip(matches["jax"], matches["torch"])
    ]))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert flipped <= 0.05, flipped
    assert rel <= 1e-3, rel


def test_vae_with_group_norm_kernel_matches_jax():
    """Every VAE GroupNorm through K4's plain version against the JAX VAE
    (no NN match on this path: elementwise at TOL)."""
    cfg = jvae.AutoencoderKLConfig.tiny()
    model = jvae.AutoencoderKL(cfg)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    port = tvae.AutoencoderKL(tvae.AutoencoderKLConfig.tiny())
    port.load_state_dict(state_dict_from_flax(params, "vae"), strict=True)
    assert _use_kernel(port.eval()) > 0
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    want_mean = model.apply(params, jnp.asarray(img), method=model.encode)
    want_img = model.apply(params, jnp.asarray(z), method=model.decode)
    with torch.inference_mode():
        got_mean = port.encode(torch.from_numpy(img))
        got_img = port.decode(torch.from_numpy(z))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), **TOL)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), **TOL)
