"""The port's DPT depth estimator and depth IO against the JAX package.

- ``DPTDepthModel`` at ``DPTConfig.tiny()`` with numpy-seeded JAX
  parameters carried across by ``state_dict_from_flax(..., "dpt")``, on the
  native 64^2 input and on inputs whose grid differs (the position table's
  bilinear resize), square and not; ``F.interpolate`` against the JAX
  ``resize_bilinear`` in both ``align_corners`` modes.
- ``compute_dpt_depth`` of both packages from one tiny checkpoint directory
  written with safetensors (HF key names, with the keys the model never
  reads): the cached ``depth/*.npy`` and the normalized maps.
- ``load_or_compute_depth``'s precomputed path against the JAX one, bit
  for bit (both resize with cv2 bicubic), and its error when no source has
  maps; the checkpoint loader refuses any other missing or unexpected key.
- An HF ``DPTForDepthEstimation`` state dict loads by key name and the
  port's forward equals HF's (where ``transformers`` is installed).

Tolerance: fp32 on both sides, rtol/atol 1e-5 on the raw predictions and
the normalized maps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from safetensors.torch import save_file

from tokenflow_torch.io import depth as tdepth
from tokenflow_torch.models import dpt as tdpt
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_tpu.io import depth as jdepth
from tokenflow_tpu.models import dpt as jdpt

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
N_FRAMES, FRAME_HW, LATENT_HW = 3, 48, (8, 8)


def _seeded_params(seed: int) -> dict:
    """The tiny JAX DPT's parameter tree filled from numpy: kernels at
    variance 1/fan_in, norm scales near 1, small biases, and the last head
    conv scaled down under a positive bias so that the final ReLU passes
    most pixels."""
    shapes = jax.eval_shape(
        jdpt.DPTDepthModel(jdpt.DPTConfig.tiny()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3)),
    )["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("kernel", "resize_kernel"):
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    params = jax.tree.map(np.asarray, params)
    params["head_conv3"]["kernel"] *= np.float32(0.05)
    params["head_conv3"]["bias"] = np.asarray([0.5], np.float32)
    return params


def _unread(seed: int) -> dict:
    """The keys an HF checkpoint has and the model never reads, random."""
    rng = np.random.default_rng(seed)
    c = jdpt.DPTConfig.tiny().fusion_hidden_size
    keys = {"dpt.layernorm.weight": (32,), "dpt.layernorm.bias": (32,)}
    for i in (1, 2):
        keys[f"neck.fusion_stage.layers.0.residual_layer1.convolution{i}.weight"] = (c, c, 3, 3)
        keys[f"neck.fusion_stage.layers.0.residual_layer1.convolution{i}.bias"] = (c,)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in keys.items()}


@pytest.fixture(scope="module")
def dpt_pair():
    params = _seeded_params(0)
    port = tdpt.DPTDepthModel(tdpt.DPTConfig.tiny())
    port.load_state_dict(state_dict_from_flax({"params": params}, "dpt"), strict=True)
    return jdpt.DPTDepthModel(jdpt.DPTConfig.tiny()), params, port.eval()


def test_dpt_configs_match_jax():
    import dataclasses

    for name in ("dpt_large", "tiny"):
        got = dataclasses.asdict(getattr(tdpt.DPTConfig, name)())
        assert got == dataclasses.asdict(getattr(jdpt.DPTConfig, name)())


@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (96, 128)],
                         ids=["native", "square_resized_grid", "non_square"])
def test_dpt_matches_jax(dpt_pair, hw):
    model, params, port = dpt_pair
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw)
    assert (want > 0).mean() > 0.5  # the ReLU head passes most pixels
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (8, 8)), ((5, 7), (16, 16)),
                                          ((8, 8), (3, 5)), ((24, 24), (30, 20))])
def test_interpolate_matches_jax_resize(align_corners, in_hw, out_hw):
    x = np.random.default_rng(2).standard_normal((2, *in_hw, 3)).astype(np.float32)
    want = jdpt.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align_corners)
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw,
                        mode="bilinear", align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _frames(root) -> str:
    data = root / "clip"
    data.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(N_FRAMES):
        img = rng.integers(0, 255, (FRAME_HW, FRAME_HW, 3), dtype=np.uint8)
        Image.fromarray(img).save(data / f"{i:05d}.png")
    return str(data)


@pytest.fixture()
def checkpoint_dir(tmp_path, dpt_pair):
    """A tiny HF-layout DPT checkpoint directory (one safetensors file)."""
    _, params, _ = dpt_pair
    sd = {**state_dict_from_flax({"params": params}, "dpt"), **_unread(3)}
    ckpt = tmp_path / "dpt_tiny"
    ckpt.mkdir()
    save_file({k: v.contiguous() for k, v in sd.items()}, str(ckpt / "model.safetensors"))
    return ckpt


def test_compute_dpt_depth_matches_jax(tmp_path, checkpoint_dir):
    """Both packages from one checkpoint directory: the raw predictions
    cached to depth/%05d.npy and the normalized maps."""
    cfg_kw = dict(batch=2, input_size=64)
    want = jdepth.compute_dpt_depth(_frames(tmp_path / "jax"), N_FRAMES, LATENT_HW,
                                    str(checkpoint_dir), config=jdpt.DPTConfig.tiny(),
                                    **cfg_kw)
    data = _frames(tmp_path / "port")
    got = tdepth.compute_dpt_depth(data, N_FRAMES, LATENT_HW, str(checkpoint_dir),
                                   config=tdpt.DPTConfig.tiny(), device="cpu", **cfg_kw)
    assert got.shape == want.shape == (N_FRAMES, *LATENT_HW, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    assert got.min() == -1.0 and got.max() == 1.0
    for i in range(N_FRAMES):
        raw = np.load(os.path.join(data, "depth", f"{i:05d}.npy"))
        raw_jax = np.load(tmp_path / "jax" / "clip" / "depth" / f"{i:05d}.npy")
        assert raw.shape == (64, 64) and raw.std() > 0
        np.testing.assert_allclose(raw, raw_jax, **TOL)
    # cached: the precomputed path now reads them back
    again = tdepth.load_or_compute_depth(data, N_FRAMES, LATENT_HW, device="cpu")
    np.testing.assert_array_equal(again, got)


def test_checkpoint_file_loads_alike(checkpoint_dir, dpt_pair):
    """One weight file (not a directory) loads the same model."""
    _, _, port = dpt_pair
    model = tdepth.load_dpt_model(str(checkpoint_dir / "model.safetensors"),
                                  tdpt.DPTConfig.tiny())
    for k, v in port.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("change", ["missing", "unexpected"])
def test_checkpoint_loader_refuses_other_keys(tmp_path, dpt_pair, change):
    _, params, _ = dpt_pair
    sd = state_dict_from_flax({"params": params}, "dpt")
    if change == "missing":
        del sd["neck.convs.0.weight"]
    else:
        sd["dpt.encoder.layer.0.extra.weight"] = torch.zeros(2)
    path = tmp_path / "dpt.safetensors"
    save_file({k: v.contiguous() for k, v in sd.items()}, str(path))
    with pytest.raises(RuntimeError, match="neck.convs.0.weight|extra"):
        tdepth.load_dpt_model(str(path), tdpt.DPTConfig.tiny())


@pytest.mark.parametrize("pred_hw", [(37, 41), (384, 384), (8, 8)])
def test_precomputed_maps_match_jax_bitwise(tmp_path, pred_hw):
    data = tmp_path / "clip"
    (data / "depth").mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i in range(N_FRAMES):
        yy, xx = np.mgrid[0 : pred_hw[0], 0 : pred_hw[1]]
        np.save(data / "depth" / f"{i:05d}.npy",
                (yy * 10.0 + xx + rng.random(pred_hw) * 5 + i).astype(np.float32))
    got = tdepth.load_or_compute_depth(str(data), N_FRAMES, (16, 12), device="cpu")
    want = jdepth.load_or_compute_depth(str(data), N_FRAMES, (16, 12))
    assert got.shape == (N_FRAMES, 16, 12, 1) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_no_depth_source_is_a_clear_error(tmp_path, monkeypatch):
    def no_hub(*args, **kwargs):
        raise RuntimeError("no hub cache")

    monkeypatch.setattr(torch.hub, "load", no_hub)
    data = _frames(tmp_path)
    with pytest.raises(RuntimeError, match="depth maps unavailable.*no hub cache.*"
                                           "--depth_model_dir"):
        tdepth.load_or_compute_depth(data, N_FRAMES, LATENT_HW, device="cpu")


def test_fp32_products_restores_the_flags():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with tdepth.fp32_products():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_hf_state_dict_loads_by_key_name(tmp_path, dpt_pair):
    """A tiny HF DPTForDepthEstimation, filled with the seeded weights,
    saved as a .bin: the port's loader reads it by key name and its forward
    equals HF's."""
    transformers = pytest.importorskip("transformers")
    _, params, _ = dpt_pair
    hf_cfg = transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2, intermediate_size=64,
        image_size=64, patch_size=16, backbone_out_indices=[0, 1, 2, 3],
        neck_hidden_sizes=[8, 12, 16, 16], fusion_hidden_size=16, attn_implementation="eager",
    )
    ref = transformers.DPTForDepthEstimation(hf_cfg).eval()
    sd = {**state_dict_from_flax({"params": params}, "dpt"), **_unread(4)}
    assert set(sd) == set(ref.state_dict())
    ref.load_state_dict(sd, strict=True)
    path = tmp_path / "pytorch_model.bin"
    torch.save(ref.state_dict(), path)
    port = tdepth.load_dpt_model(str(path), tdpt.DPTConfig.tiny())
    x = np.random.default_rng(8).standard_normal((2, 96, 96, 3)).astype(np.float32)
    with torch.inference_mode():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).predicted_depth
        got = tdepth.predict_depth(port, x, batch=1)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
