"""The port's loading path from a local diffusers-layout checkpoint: the
synthetic tiny checkpoint of tests/test_pretrained_load.py (diffusers keys,
a transformers CLIPTextModel state dict, a BPE tokenizer) loads strictly
into the port's modules, and the port's text encoder matches transformers'
CLIPTextModel on the same weights. A copy whose config.json disagrees with
the preset in a key no weight shape carries is refused before any weight
loads, with the JAX package's mismatch lines.

Tolerance: fp32 on both sides, atol 1e-5 (same ops, different kernels).
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_pretrained_load import ckpt_dir  # noqa: E402,F401  (fixture)
from tokenflow_torch import runtime  # noqa: E402
from tokenflow_tpu import runtime as jax_runtime  # noqa: E402

torch.set_num_threads(2)


def test_load_stack_from_diffusers_dir(ckpt_dir):  # noqa: F811
    root, unet_sd = ckpt_dir
    stack = runtime.load_stack(
        "tiny", device="cpu", model_dir=str(root), dtype=torch.float32,
        init="pretrained",
    )
    for key in ("conv_in.weight", "up_blocks.1.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"):
        got = dict(stack.unet.named_parameters())[key]
        assert torch.equal(got, torch.from_numpy(unet_sd[key])), key
    assert type(stack.tokenizer).__name__ == "CLIPTokenizer"

    hf = transformers.CLIPTextModel.from_pretrained(str(root / "text_encoder")).eval()
    ids = np.stack([stack.tokenizer("the cat"), stack.tokenizer("a dog")])
    with torch.inference_mode():
        want = hf(torch.as_tensor(ids)).last_hidden_state
    got = stack.encode_tokens(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

    frames = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    lat = stack.encode_frames(frames)
    assert lat.shape == (2, 16, 16, 4)
    assert np.isfinite(stack.decode_latents(lat).numpy()).all()


def test_pretrained_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        runtime.load_stack(
            "tiny", device="cpu", model_dir=str(tmp_path / "none"), init="pretrained"
        )


@pytest.mark.parametrize(
    "component,key,value",
    [("unet", "cross_attention_dim", 768), ("text_encoder", "hidden_act", "quick_gelu"),
     ("unet", "attention_head_dim", 8), ("vae", "scaling_factor", 0.5)],
    ids=["cross_attention_dim", "hidden_act", "attention_head_dim", "scaling_factor"],
)
def test_checkpoint_config_mismatch_refused_as_jax(ckpt_dir, tmp_path, component, key,
                                                   value):  # noqa: F811
    """C1: a checkpoint whose config.json disagrees with the sd_version
    preset is refused by the port's ``load_stack`` with the ValueError, and
    the mismatch lines, of ``tokenflow_tpu.runtime.load_stack`` on the same
    directory."""
    root, _ = ckpt_dir
    bad = tmp_path / "wrong_cfg"
    shutil.copytree(root, bad)
    cfg_path = bad / component / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg[key] = value
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError) as want:
        jax_runtime.load_stack("tiny", model_dir=str(bad), init="pretrained",
                               dtype=jnp.float32, param_dtype=jnp.float32)
    with pytest.raises(ValueError) as got:
        runtime.load_stack("tiny", device="cpu", model_dir=str(bad), dtype=torch.float32,
                           init="pretrained")
    assert f"{component}: {key}: checkpoint={value!r}" in str(got.value)
    assert str(got.value) == str(want.value)
