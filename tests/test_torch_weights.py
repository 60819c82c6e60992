"""Port weights: ``state_dict_from_flax`` is the exact inverse of the JAX
package's checkpoint converters (UNet with linear and 1x1-conv projections,
VAE, CLIP text, ControlNet), and its output loads strictly into the port's
modules (so every diffusers key has its module attribute).

Tolerance: none, the round trip only transposes and renames (exact).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_goldens import _SD, _build_controlnet_sd, _build_unet_sd, _build_vae_sd
from tokenflow_torch.models import weights as tw
from tokenflow_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tokenflow_torch.models.controlnet import ControlNetModel
from tokenflow_torch.models.unet2d import UNet2DConditionModel, UNet2DConfig
from tokenflow_torch.models.vae import AutoencoderKL, AutoencoderKLConfig
from tokenflow_tpu.models import weights as jw

torch.set_num_threads(2)


def _build_clip_sd(cfg, seed=3):
    sd = _SD(seed)
    w = cfg.hidden_size
    sd["text_model.embeddings.token_embedding.weight"] = sd._t(cfg.vocab_size, w)
    sd["text_model.embeddings.position_embedding.weight"] = sd._t(
        cfg.max_position_embeddings, w
    )
    for i in range(cfg.num_layers):
        p = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.lin(f"{p}.self_attn.{proj}", w, w)
        sd.norm(f"{p}.layer_norm1", w)
        sd.norm(f"{p}.layer_norm2", w)
        sd.lin(f"{p}.mlp.fc1", w, cfg.intermediate_size)
        sd.lin(f"{p}.mlp.fc2", cfg.intermediate_size, w)
    sd.norm("text_model.final_layer_norm", w)
    return sd


def _np(sd):
    return {k: v.numpy().astype(np.float32) for k, v in sd.items()}


CASES = {
    "unet": (
        lambda: _build_unet_sd(UNet2DConfig.tiny()),
        jw.convert_unet_state_dict,
        lambda: UNet2DConditionModel(UNet2DConfig.tiny()),
    ),
    "unet_conv_proj": (
        lambda: _build_unet_sd(
            dataclasses.replace(UNet2DConfig.tiny(), use_linear_projection=False)
        ),
        jw.convert_unet_state_dict,
        lambda: UNet2DConditionModel(
            dataclasses.replace(UNet2DConfig.tiny(), use_linear_projection=False)
        ),
    ),
    "vae": (
        lambda: _build_vae_sd(AutoencoderKLConfig.tiny()),
        jw.convert_vae_state_dict,
        lambda: AutoencoderKL(AutoencoderKLConfig.tiny()),
    ),
    "clip_text": (
        lambda: _build_clip_sd(CLIPTextConfig.tiny()),
        jw.convert_clip_text_state_dict,
        lambda: CLIPTextModel(CLIPTextConfig.tiny()),
    ),
    # _build_controlnet_sd's cond embedder has diffusers' three stride-2 stages
    "controlnet": (
        lambda: _build_controlnet_sd(UNet2DConfig.tiny()),
        jw.convert_controlnet_state_dict,
        lambda: ControlNetModel(UNet2DConfig.tiny(), cond_downsamples=3),
    ),
    "controlnet_conv_proj": (
        lambda: _build_controlnet_sd(
            dataclasses.replace(UNet2DConfig.tiny(), use_linear_projection=False)
        ),
        jw.convert_controlnet_state_dict,
        lambda: ControlNetModel(
            dataclasses.replace(UNet2DConfig.tiny(), use_linear_projection=False)
        ),
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_from_flax_inverts_the_converter(case):
    build, convert, make_module = CASES[case]
    sd = _np(build())
    kind = case.removesuffix("_conv_proj")
    back = tw.state_dict_from_flax(convert(sd), kind)
    assert sorted(back) == sorted(sd)
    for key, want in sd.items():
        got = back[key].numpy()
        assert got.shape == want.shape, key
        assert np.array_equal(got, want), key
    # and the port's module has exactly these keys and shapes
    make_module().load_state_dict(back, strict=True)


def test_state_dict_from_flax_accepts_the_variables_dict():
    sd = _np(_build_vae_sd(AutoencoderKLConfig.tiny()))
    params = jw.convert_vae_state_dict(sd)
    a = tw.state_dict_from_flax(params, "vae")
    b = tw.state_dict_from_flax({"params": params}, "vae")
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError):
        tw.state_dict_from_flax(params, "no_such_kind")


def test_normalize_state_dict_renames_legacy_vae_attention():
    legacy = {
        "encoder.mid_block.attentions.0.query.weight": torch.ones(4, 4, 1, 1),
        "encoder.mid_block.attentions.0.proj_attn.bias": torch.ones(4),
        "text_model.embeddings.position_ids": torch.arange(4),
    }
    out = tw.normalize_state_dict(legacy, "vae")
    assert set(out) == {
        "encoder.mid_block.attentions.0.to_q.weight",
        "encoder.mid_block.attentions.0.to_out.0.bias",
    }
    assert out["encoder.mid_block.attentions.0.to_q.weight"].shape == (4, 4)


def test_random_init_uses_the_jax_scales():
    gen = torch.Generator().manual_seed(0)
    unet = UNet2DConditionModel(UNet2DConfig.tiny())
    tw.init_random_(unet, gen)
    w = unet.down_blocks[0].resnets[0].conv1.weight  # fan_in 32*3*3
    assert abs(w.std().item() - (1 / 288) ** 0.5) < 0.15 * (1 / 288) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / 288) ** 0.5 / 0.87962566103423978 + 1e-6
    assert torch.all(unet.down_blocks[0].resnets[0].conv1.bias == 0)
    assert torch.all(unet.conv_norm_out.weight == 1)
    again = UNet2DConditionModel(UNet2DConfig.tiny())
    tw.init_random_(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(unet.parameters(), again.parameters()))


def test_random_init_zeroes_the_controlnet_projections():
    """As Flax's kernel_init zeros: cond_embedding.conv_out, every
    controlnet_down_* and controlnet_mid start at zero; the rest is drawn."""
    model = ControlNetModel(UNet2DConfig.tiny(), cond_downsamples=1)
    tw.init_random_(model, torch.Generator().manual_seed(0))
    zero = [n for n, m in model.named_modules() if tw.ZERO_INIT.match(n)]
    assert zero == (["controlnet_cond_embedding.conv_out"]
                    + [f"controlnet_down_blocks.{i}" for i in range(4)]
                    + ["controlnet_mid_block"])
    for name in zero:
        assert not model.get_submodule(name).weight.any(), name
    assert model.controlnet_cond_embedding.conv_in.weight.abs().sum() > 0
    assert model.conv_in.weight.abs().sum() > 0
