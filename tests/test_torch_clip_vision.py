"""The port's CLIP metrics (``tokenflow_torch/models/clip_vision.py``,
``cli/compare_outputs.py``, ``cli/prop_approx_ab.py``) against the JAX
package's.

- ``CLIPVisionModel``, ``CLIPScorer.image_features``, ``text_features``
  and the CLIP score at tiny size, on numpy-seeded JAX parameters carried
  over by ``state_dict_from_flax(..., "clip_vision")`` and ``"clip"``:
  fp32, rtol/atol 1e-5. The layout of the bias-free patch kernel
  ((p, p, 3, hidden) -> OIHW) and HF's ``pre_layrnorm`` key are checked
  key by key.
- ``preprocess_images`` at 512 -> 224, a non-square 480 x 640 frame and
  64 -> 224 (upsampling): the resized pixels (the normalization undone)
  against JAX's at atol 1e-5, and against ``jax.image.resize``'s own
  float32 weights applied in float64 at atol 1e-6. The second check is the
  tighter one: JAX's CPU resize sits up to 8.1e-6 from that product, and
  the normalization (1/std, about 3.8) scales it to 3.1e-5.
- An HF-layout ``CLIPModel`` state dict, made by ``transformers`` here
  only, loads by key name (only ``position_ids`` and ``logit_scale``
  dropped) and matches transformers at the JAX test's 2e-4.
- ``compare_outputs``'s report against ``scripts/compare_outputs.py``'s on
  the same two frame dirs and tiny CLIP checkpoint: the same keys, PSNR
  equal, CLIP values within 1e-3 (both round them to 3-4 decimals).
- ``clip_geometry``'s eos id: the config's, and 49407 for a legacy 2 or
  none (exact).
- ``prop_approx_ab`` on the tiny stack on the CPU: both edits run, the
  pivots are pinned and the report has the PSNR keys.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compare_outputs import clip_ckpt, frame_dirs  # noqa: F401  (fixtures)
from tokenflow_torch.cli import compare_outputs, prop_approx_ab
from tokenflow_torch.models import clip_vision as tcv
from tokenflow_torch.models import weights as tw
from tokenflow_torch.models.clip_text import CLIPTextConfig
from tokenflow_tpu.models import clip_vision as jcv
from tokenflow_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
HF_TOL = dict(rtol=2e-4, atol=2e-4)
EOS = 999
TEXT = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, hidden_act="quick_gelu")


def _seeded(shapes, seed):
    """A JAX parameter tree of ``shapes`` filled from numpy: kernels at
    variance 1/fan_in, norm scales near 1, small biases and embeddings."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def scorers():
    vis = jcv.CLIPVisionConfig.tiny()
    jscorer = jcv.CLIPScorer(vision_config=vis, text_config=JCLIPTextConfig(**TEXT),
                             eos_token_id=EOS)
    shapes = jax.eval_shape(
        jscorer.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 77), jnp.int32),
    )["params"]
    params = _seeded(shapes, 3)
    tscorer = tcv.CLIPScorer(tcv.CLIPVisionConfig.tiny(), CLIPTextConfig(**TEXT),
                             eos_token_id=EOS).eval()
    tscorer.load_state_dict(tw.state_dict_from_flax(params, "clip"), strict=True)
    return jscorer, params, tscorer


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 900, (2, 77)).astype(np.int32)
    ids[0, 9] = ids[0, 30] = EOS  # pooled at the first eos
    ids[1, 40] = EOS
    return x, ids


def test_clip_vision_model_matches_jax(scorers):
    _, params, _ = scorers
    model = jcv.CLIPVisionModel(jcv.CLIPVisionConfig.tiny())
    sd = tw.state_dict_from_flax(params["vision"], "clip_vision")
    port = tcv.CLIPVisionModel(tcv.CLIPVisionConfig.tiny()).eval()
    port.load_state_dict(sd, strict=True)
    # the patch kernel (p, p, 3, hidden) becomes OIHW, without a bias; the
    # pre-encoder LayerNorm takes HF's spelling
    kernel = params["vision"]["patch_embed"]["kernel"]
    patch = sd["vision_model.embeddings.patch_embedding.weight"].numpy()
    assert patch.shape == (32, 3, 8, 8)
    np.testing.assert_array_equal(patch, kernel.transpose(3, 2, 0, 1))
    assert "vision_model.embeddings.patch_embedding.bias" not in sd
    np.testing.assert_array_equal(sd["vision_model.pre_layrnorm.weight"].numpy(),
                                  params["vision"]["pre_layernorm"]["scale"])
    np.testing.assert_array_equal(sd["vision_model.embeddings.class_embedding"].numpy(),
                                  params["vision"]["class_embedding"])
    x, _ = _inputs(0)
    want = np.asarray(model.apply({"params": params["vision"]}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_clip_scorer_matches_jax(scorers):
    jscorer, params, tscorer = scorers
    x, ids = _inputs(1)
    v = {"params": params}
    want_img = np.asarray(jscorer.apply(v, jnp.asarray(x), method=jscorer.image_features))
    want_txt = np.asarray(jscorer.apply(v, jnp.asarray(ids), method=jscorer.text_features))
    want_score = np.asarray(jscorer.apply(v, jnp.asarray(x), jnp.asarray(ids)))
    with torch.inference_mode():
        img = tscorer.image_features(torch.from_numpy(x)).numpy()
        txt = tscorer.text_features(torch.from_numpy(ids).long()).numpy()
        score = tscorer(torch.from_numpy(x), torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(img, want_img, **TOL)
    np.testing.assert_allclose(txt, want_txt, **TOL)
    np.testing.assert_allclose(score, want_score, **TOL)


def _resize_f64(frames: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``jax.image.resize(method="bicubic")``'s weights, computed as JAX
    computes them in float32 (``compute_weight_mat``: the Keys cubic with
    a = -0.5 at half-pixel centres, widened by the shrink factor, columns
    normalized to 1), applied to the frames in float64."""
    f32 = np.float32

    def weights(n_in, n_out):
        inv = 1.0 / (n_out / n_in)
        sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
        x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / f32(max(inv, 1.0))
        w = np.where(x < 1, ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1),
                     np.where(x < 2, ((f32(-0.5) * x + f32(2.5)) * x - f32(4)) * x + f32(2),
                              f32(0)))
        return (w / w.sum(axis=0, keepdims=True)).astype(np.float64)

    _, h, w, _ = frames.shape
    x = np.einsum("bhwc,hi->biwc", frames.astype(np.float64), weights(h, nh))
    return np.einsum("biwc,wj->bijc", x, weights(w, nw))


@pytest.mark.parametrize("shape,resized", [((2, 512, 512, 3), (224, 224)),
                                           ((2, 480, 640, 3), (224, 298)),
                                           ((2, 64, 64, 3), (224, 224))],
                         ids=["512to224", "non_square", "upsample"])
def test_preprocess_images_matches_jax(shape, resized):
    frames = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jcv.preprocess_images(jnp.asarray(frames)))
    got = tcv.preprocess_images(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    mean, std = np.asarray(tcv.CLIP_MEAN), np.asarray(tcv.CLIP_STD)
    pixels = got * std + mean
    np.testing.assert_allclose(pixels, want * std + mean, rtol=0, atol=1e-5)
    nh, nw = resized
    top, left = (nh - 224) // 2, (nw - 224) // 2
    exact = _resize_f64(frames, nh, nw)[:, top : top + 224, left : left + 224]
    np.testing.assert_allclose(pixels, exact, rtol=0, atol=1e-6)


def test_hf_clip_model_loads_by_key_name():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=77, eos_token_id=EOS),
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=64, image_size=32, patch_size=8),
        projection_dim=16,
    )
    torch.manual_seed(0)
    ref = transformers.CLIPModel(cfg).eval()
    # older HF checkpoints also carry the position_ids buffers
    hf_sd = {**ref.state_dict(),
             "text_model.embeddings.position_ids": torch.arange(77)[None],
             "vision_model.embeddings.position_ids": torch.arange(17)[None]}
    sd = tw.normalize_state_dict(hf_sd, "clip")
    dropped = set(hf_sd) - set(sd)
    assert dropped == {"logit_scale", "text_model.embeddings.position_ids",
                       "vision_model.embeddings.position_ids"}
    port = tcv.CLIPScorer(tcv.CLIPVisionConfig.tiny(), CLIPTextConfig(**TEXT),
                          eos_token_id=EOS).eval()
    port.load_state_dict(sd, strict=True)
    x, ids = _inputs(4)
    pix = torch.from_numpy(x)
    with torch.inference_mode():
        out = ref(input_ids=torch.from_numpy(ids).long(), pixel_values=pix.permute(0, 3, 1, 2))
        pooled = ref.vision_model(pix.permute(0, 3, 1, 2)).pooler_output
        img_t = torch.nn.functional.normalize(out.image_embeds, dim=-1)
        txt_t = torch.nn.functional.normalize(out.text_embeds, dim=-1)
        np.testing.assert_allclose(port.vision_model(pix).numpy(), pooled.numpy(), **HF_TOL)
        np.testing.assert_allclose(port.image_features(pix).numpy(), img_t.numpy(), **HF_TOL)
        np.testing.assert_allclose(port.text_features(torch.from_numpy(ids).long()).numpy(),
                                   txt_t.numpy(), **HF_TOL)
        score_t = (img_t @ txt_t.T).clamp(min=0)[:, 0] * 100.0
        np.testing.assert_allclose(port(pix, torch.from_numpy(ids).long()).numpy(),
                                   score_t.numpy(), rtol=2e-4, atol=2e-3)


def test_compare_outputs_report_matches_jax_script(clip_ckpt, frame_dirs):  # noqa: F811
    spec = importlib.util.spec_from_file_location(
        "jax_compare_outputs", os.path.join(REPO, "scripts", "compare_outputs.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    a, b = frame_dirs
    fa, fb = jax_script.load_dir(a), jax_script.load_dir(b)
    per_frame = [jax_script.psnr(x, y) for x, y in zip(fa, fb)]
    want = {
        "frames_compared": len(per_frame),
        "psnr_per_frame": [round(p, 3) for p in per_frame],
        "psnr_mean": round(float(np.mean(per_frame)), 3),
        "psnr_min": round(float(np.min(per_frame)), 3),
        **jax_script.clip_metrics(fa, "hello world", clip_ckpt),
    }
    got = compare_outputs.main([a, b, "--clip_ckpt", clip_ckpt, "--prompt", "hello world",
                                "--device", "cpu"])
    assert set(got) == set(want)
    for key in ("frames_compared", "psnr_per_frame", "psnr_mean", "psnr_min"):
        assert got[key] == want[key], key
    for key in ("clip_temporal_consistency", "clip_score_mean", "clip_score_min"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])


@pytest.mark.parametrize("eos,want", [(2, 49407), (999, 999), (None, 49407)],
                         ids=["legacy_2", "given", "absent"])
def test_clip_geometry_eos(tmp_path, eos, want):
    """The text tower pools at the config's eos id; the legacy 2 of
    openai/clip-vit-large-patch14's config.json reads as CLIP's end-of-text
    id, 49407, where HF's argmax(ids) pooling lands."""
    text = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64)
    if eos is not None:
        text["eos_token_id"] = eos
    vision = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, image_size=32, patch_size=8)
    (tmp_path / "config.json").write_text(json.dumps(
        {"text_config": text, "vision_config": vision, "projection_dim": 16}))
    v, t, got = compare_outputs.clip_geometry(str(tmp_path))
    assert got == want
    assert (v.hidden_size, v.patch_size, t.num_layers) == (32, 8, 2)


def test_prop_approx_ab_on_the_tiny_stack(tmp_path):
    report = prop_approx_ab.main([
        str(tmp_path), "--device", "cpu", "--sd_version", "tiny", "--dtype", "f32",
        "--frames", "4", "--window", "2", "--hw", "64", "--steps", "8",
        "--save_steps", "4", "--timesteps", "4",
    ])
    assert report["frames_compared"] == 4
    assert np.isfinite(report["psnr_mean"]) and report["psnr_min"] <= report["psnr_mean"]
    assert (tmp_path / "approx_ab_report.json").exists()
