"""The port's SD-1.5 family against the JAX package: the configs field for
field, an SD-1.5-shaped tiny UNet (1x1-conv projections, 4 heads over 160
and 320 channels, so head dims 40 and 80 as SD-1.5's 8 heads over 320 and
640) in NONE, PIVOTAL and PROPAGATE modes, and the CLIP text encoder with
``quick_gelu``, each with JAX-initialised weights carried over by
``state_dict_from_flax``. ``kv_block`` 16 sends the 64-token level and the
pivotal pass's extended attention at both levels through the blockwise
path (K1's plain version on the CPU).

Tolerance: fp32 on both sides, rtol/atol 1e-4 (the TOL of
tests/test_torch_unet.py). The PROPAGATE pass reads the JAX pivotal cache on
both sides so that near-tie NN matches cannot differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenflow_torch import runtime as truntime
from tokenflow_torch.models import clip_text as tclip
from tokenflow_torch.models import unet2d as tunet
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_torch.ops import editctx as tctx
from tokenflow_tpu import runtime as jruntime
from tokenflow_tpu.models import clip_text as jclip
from tokenflow_tpu.models import unet2d as junet
from tokenflow_tpu.ops import editctx as jctx
from tokenflow_tpu.ops.propagation import propagation_indices

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
HW, K, F = 8, 2, 4  # latent size, pivots, frames (window 2)
KV_BLOCK = 16


# the port's config fields that the JAX configs lack (SD-XL's), and their
# values in every SD config: one block a site, no added conditioning, no
# text projection
PORT_ONLY = {
    tunet.UNet2DConfig: {"transformer_layers": None, "addition_time_embed_dim": 0,
                         "projection_class_embeddings_input_dim": 0},
    tclip.CLIPTextConfig: {"projection_dim": 0},
}


def _jax_fields(port_cfg) -> dict:
    """The port config's fields that the JAX config has; the port's own
    ones must hold their SD values."""
    got = dataclasses.asdict(port_cfg)
    own = PORT_ONLY.get(type(port_cfg), {})
    assert {k: got.pop(k) for k in own} == own
    return got


@pytest.mark.parametrize("name", ["sd15", "sd21_base", "tiny"])
def test_unet_config_matches_jax(name):
    got = _jax_fields(getattr(tunet.UNet2DConfig, name)())
    want = dataclasses.asdict(getattr(junet.UNet2DConfig, name)())
    assert got == want


def test_sd15_head_dims():
    cfg = tunet.UNet2DConfig.sd15()
    assert [cfg.head_dim(i) for i in range(4)] == [40, 80, 160, 160]


@pytest.mark.parametrize("name", ["sd15", "sd21", "tiny"])
def test_clip_config_matches_jax(name):
    got = _jax_fields(getattr(tclip.CLIPTextConfig, name)())
    want = dataclasses.asdict(getattr(jclip.CLIPTextConfig, name)())
    assert got == want


@pytest.mark.parametrize("version", ["1.5", "ControlNet", "tiny-controlnet", "2.1", "tiny"])
def test_runtime_configs_match_jax(version):
    got = truntime.configs_for(version)
    want = jruntime.configs_for(version)
    assert [_jax_fields(c) for c in got] == [dataclasses.asdict(c) for c in want]
    assert truntime.is_controlnet(version) == jruntime.is_controlnet(version)
    assert truntime.MODEL_KEYS.get(version) == jruntime.MODEL_KEYS.get(version)


def _sd15_tiny(mod):
    return mod.UNet2DConfig(
        block_out_channels=(160, 320), layers_per_block=1, cross_attention_dim=32,
        num_heads=(4, 4), use_linear_projection=False, attn_down=(True, False),
        attn_up=(False, True),
    )


@pytest.fixture(scope="module")
def unet_pair():
    model = junet.UNet2DConditionModel(_sd15_tiny(junet), kv_block=KV_BLOCK)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 4)), jnp.asarray(0),
        jnp.zeros((1, 7, 32)),
    )
    cfg = _sd15_tiny(tunet)
    assert [cfg.head_dim(0), cfg.head_dim(1)] == [40, 80]
    port = tunet.UNet2DConditionModel(cfg, kv_block=KV_BLOCK)
    port.load_state_dict(state_dict_from_flax(params, "unet"), strict=True)
    assert isinstance(port.down_blocks[0].attentions[0].proj_in, torch.nn.Conv2d)
    rng = np.random.default_rng(0)
    data = {
        "piv": rng.standard_normal((3 * K, HW, HW, 4)).astype(np.float32),
        "prop": rng.standard_normal((3 * F, HW, HW, 4)).astype(np.float32),
        "ctx3": rng.standard_normal((3, 7, 32)).astype(np.float32),
    }
    return jax.jit(model.apply), params, port.eval(), data


def _edit_pair(mode, n_frames, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, (bool, np.ndarray)) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return (
        jctx.UNetEdit(mode=mode, n_frames=n_frames, pnp=True, **jkw),
        tctx.UNetEdit(mode=mode, n_frames=n_frames, pnp=True, **tkw),
    )


def test_sd15_unet_none_mode_matches_jax(unet_pair):
    apply, params, port, data = unet_pair
    x, ctx = data["prop"][:4], np.repeat(data["ctx3"][1:2], 4, axis=0)
    want, _ = apply(params, jnp.asarray(x), jnp.asarray(981), jnp.asarray(ctx))
    with torch.inference_mode():
        got, cache = port(torch.from_numpy(x), 981, torch.from_numpy(ctx))
    assert cache == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gates", [(True, True), (False, False)])
def test_sd15_unet_pivotal_cache_matches_jax(unet_pair, gates):
    apply, params, port, data = unet_pair
    x, ctx = data["piv"], np.tile(data["ctx3"], (K, 1, 1))
    jedit, tedit = _edit_pair(jctx.EditMode.PIVOTAL, K, qk_gate=gates[0], conv_gate=gates[1])
    want, jcache = apply(params, jnp.asarray(x), jnp.asarray(501), jnp.asarray(ctx), edit=jedit)
    with torch.inference_mode():
        got, cache = port(torch.from_numpy(x), 501, torch.from_numpy(ctx), tedit)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(cache) == sorted(jcache)
    for site, entry in jcache.items():
        for key in ("pivot_h", "kf_attn"):
            np.testing.assert_allclose(cache[site][key].numpy(), np.asarray(entry[key]), **TOL)


def test_sd15_unet_propagate_matches_jax(unet_pair):
    apply, params, port, data = unet_pair
    jedit_piv, _ = _edit_pair(jctx.EditMode.PIVOTAL, K, qk_gate=True, conv_gate=True)
    _, jcache = apply(
        params, jnp.asarray(data["piv"]), jnp.asarray(501),
        jnp.asarray(np.tile(data["ctx3"], (K, 1, 1))), edit=jedit_piv,
    )
    tcache = {
        site: {k: torch.tensor(np.asarray(v)) for k, v in entry.items()}
        for site, entry in jcache.items()
    }
    pa, pb, w1 = propagation_indices(F, F // K)
    jedit, _ = _edit_pair(
        jctx.EditMode.PROPAGATE, F, qk_gate=True, conv_gate=True,
        prop_pa=pa, prop_pb=pb, prop_w1=w1,
    )
    jedit = jedit.replace(cache=jcache)
    tedit = tctx.UNetEdit(
        mode=tctx.EditMode.PROPAGATE, n_frames=F, pnp=True, qk_gate=True,
        conv_gate=True, cache=tcache, prop_pa=torch.from_numpy(pa),
        prop_pb=torch.from_numpy(pb), prop_w1=torch.from_numpy(w1),
    )
    x, ctx = data["prop"], np.tile(data["ctx3"], (F, 1, 1))
    want, _ = apply(params, jnp.asarray(x), jnp.asarray(501), jnp.asarray(ctx), edit=jedit)
    with torch.inference_mode():
        got, _ = port(torch.from_numpy(x), 501, torch.from_numpy(ctx), tedit)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_quick_gelu_matches_jax():
    cfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(), hidden_act="quick_gelu")
    model = jclip.CLIPTextModel(cfg)
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))
    port = tclip.CLIPTextModel(
        dataclasses.replace(tclip.CLIPTextConfig.tiny(), hidden_act="quick_gelu")
    )
    port.load_state_dict(state_dict_from_flax(params, "clip_text"), strict=True)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 77))
    want = model.apply(params, jnp.asarray(ids, jnp.int32))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # quick_gelu is not gelu: the activation reaches the output
    gelu = tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny())
    gelu.load_state_dict(port.state_dict())
    with torch.inference_mode():
        assert (gelu.eval()(torch.from_numpy(ids)) - got).abs().max() > 1e-4
