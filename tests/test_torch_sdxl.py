"""SD-XL on the port, held to the benchmark's plain reference
(``benchmark/reference/sdxl.py``: plain torch, fp32, written from the
published architecture) on a tiny SD-XL layout on the CPU in fp32 with
seeded random weights: three levels, no attention at level 0, 1, 2 and 3
transformer blocks a site, the text-time embedding. The JAX package has no
SD-XL, so the reference is the benchmark's.

- the plain UNet call and the add embedding alone;
- one two-pass exact SDEdit edit step (pivotal pass, then propagation, three
  streams) through ``tokenflow_sample_loop`` against the reference's
  ``edit_step``, and the same step as one fused call against the two
  passes; the nearest-neighbour matches of both sides are compared site by
  site first, and a token whose match differs must be a near tie
  (ROADMAP C: ``REF_TIE_TOL`` = 1e-5 |x|, as ``chip_smoke.py``'s fp32
  references), its frame then left out of the state comparison;
- strict loading of the reference's state-dict keys, and at full size of
  SD-XL's published layout (on the meta device);
- the OpenCLIP-bigG tower's penultimate and pooled outputs against a few
  lines of plain torch;
- the CLIs' preprocess and SDEdit (TokenFlow and per-frame) on a tiny random
  SD-XL directory in diffusers layout, to their output tree;
- the refusals: PnP and the ControlNet on SD-XL, and its edit loop over a
  frames group.

Tolerances: fp32 on both sides with the same operations in another order
(blocked attention and matches in the reference, einsums in the port):
1e-4 relative and absolute, as ``tests/test_torch_pretrained.py`` and the
port's other parity tests hold fp32; 1e-5 for the add embedding and the
text tower, short chains of products.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from PIL import Image
from safetensors.torch import save_file

from tokenflow_torch import runtime
from tokenflow_torch.cli import common, preprocess, run_sdedit
from tokenflow_torch.diffusion import ddim
from tokenflow_torch.editing import pipeline
from tokenflow_torch.models import clip_text, layers
from tokenflow_torch.models.clip_text import CLIPTextConfig, CLIPTextModelWithProjection
from tokenflow_torch.models.controlnet import ControlNetModel
from tokenflow_torch.models.unet2d import UNet2DConditionModel, UNet2DConfig
from tokenflow_torch.models.vae import AutoencoderKL
from tokenflow_torch.models.weights import init_random_
from tokenflow_torch.ops import editctx

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "benchmark"))

from reference import model as M  # noqa: E402
from reference import schedule as ref_schedule  # noqa: E402
from reference import sdxl as R  # noqa: E402
from reference.precision import Precision  # noqa: E402
from reference.steps import edit_step  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
TIE_TOL = 1e-5  # a flipped match's similarity gap, relative to the similarity
# the port's tiny_xl preset as a diffusers unet/config.json
TINY_XL = {
    "act_fn": "silu", "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "attention_head_dim": [2, 2, 4], "block_out_channels": [32, 64, 64],
    "cross_attention_dim": 32,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4, "layers_per_block": 1,
    "norm_eps": 1e-05, "norm_num_groups": 32, "out_channels": 4,
    "projection_class_embeddings_input_dim": 80, "sample_size": 8,
    "transformer_layers_per_block": [1, 2, 3],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "use_linear_projection": True,
}
SCHEDULER = {"beta_end": 0.012, "beta_schedule": "scaled_linear", "beta_start": 0.00085,
             "num_train_timesteps": 1000, "prediction_type": "epsilon",
             "set_alpha_to_one": False, "steps_offset": 1}
F_, HW, WS = 4, 8, 2  # frames, latent size, window (2 pivots)


def _random_state(model: torch.nn.Module, seed: int) -> dict:
    """Every parameter drawn normal from ``seed``: weights at 1/sqrt(fan-in),
    biases 0.1 z, norm scales 1 + 0.1 z (the benchmark's weights)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        z = torch.randn(p.shape, generator=gen)
        if p.dim() >= 2:
            out[name] = z / np.sqrt(p[0].numel())
        elif name.endswith("bias"):
            out[name] = 0.1 * z
        else:
            out[name] = 1.0 + 0.1 * z
    return out


@pytest.fixture(scope="module")
def models():
    """(the port's tiny SD-XL UNet, the reference holding the same state
    dict, its added-conditioning inputs: 3 prompts' pooled rows and ids)."""
    ref_meta = R.build("unet", TINY_XL)
    sd = _random_state(ref_meta, 21)
    ref = R.build("unet", TINY_XL, sd)
    port = UNet2DConditionModel(UNet2DConfig.tiny_xl(), kv_block=16)
    port.load_state_dict(sd, strict=True)
    port.eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(5)
    text = torch.randn((3, 32), generator=gen)
    ids = torch.tensor([64.0, 64.0, 0.0, 0.0, 64.0, 64.0]).expand(3, -1).contiguous()
    return port, ref, {"text_embeds": text, "time_ids": ids}


def test_the_port_and_the_reference_have_one_layout():
    """The tiny preset is the config.json the reference reads; at full size
    the port's SD-XL UNet holds diffusers' SD-XL state dict strictly (1680
    tensors, 2.5675 B parameters, ``add_embedding`` 2816 -> 1280 -> 1280)."""
    spec = R.XLSpec.from_config(TINY_XL)
    cfg = UNet2DConfig.tiny_xl()
    assert (spec.block_out_channels, spec.heads, spec.attn_down, spec.attn_up,
            spec.transformer_layers) == (tuple(cfg.block_out_channels), tuple(cfg.num_heads),
                                         cfg.attn_down, cfg.attn_up, cfg.transformer_layers)
    published = json.loads((REPO / "benchmark" / "configs" / "sdxl.json").read_text())["unet"]
    ref = R.build("unet", published)
    with torch.device("meta"):
        port = UNet2DConditionModel(UNet2DConfig.sdxl_base())
    sd = ref.state_dict()
    port.load_state_dict(sd, strict=True, assign=True)
    assert len(sd) == 1680 and sum(p.numel() for p in port.parameters()) == 2567463684
    assert tuple(port.add_embedding.linear_1.weight.shape) == (1280, 2816)
    assert [len(a.transformer_blocks) for b in port.down_blocks for a in b.attentions] == [
        2, 2, 10, 10]
    assert port.mid_block.attentions[0].sites == tuple(f"mid.{n}" for n in range(10))
    assert not hasattr(port.down_blocks[0], "attentions") or not len(
        port.down_blocks[0].attentions)


def test_sd_sites_keep_their_names():
    """One block a site: SD's cache keys and PnP sites are the site names."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNet2DConfig.sd21_base())
    sites = [s for m in unet.modules() if isinstance(m, layers.Transformer2DModel)
             for s in m.sites]
    assert len(sites) == 16 and "mid" in sites and "up_3_2" in sites
    assert editctx.QK_INJECT_SITES <= set(sites)
    assert UNet2DConfig.sd21_base().pnp_defined and not UNet2DConfig.sdxl_base().pnp_defined


def test_add_embedding_matches_the_reference(models):
    port, ref, added = models
    got = port.add_embed(added, 3)
    want = R.add_embed(Precision("fp32"), ref, added["text_embeds"], added["time_ids"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="needs added_cond"):
        port.add_embed(None, 3)


@pytest.mark.parametrize("t", [1, 501])
def test_plain_unet_matches_the_reference(models, t):
    port, ref, added = models
    gen = torch.Generator().manual_seed(t)
    x = torch.randn((3, HW, HW, 4), generator=gen)
    ctx = torch.randn((3, 77, 32), generator=gen)
    got, cache = port(x, t, ctx, added_cond=added)
    want, _ = ref(Precision("fp32"), x, t, ctx, **added)
    assert cache == {}
    torch.testing.assert_close(got, want, **TOL)


def _matches(x_src, pivot_h, pa, pb):
    """Similarities (F, S, S) of each frame's tokens against its pa and pb
    pivots' normalized tokens, stacked (2, F, S, S)."""
    p = pivot_h.float()
    p_hat = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    return torch.stack([x_src.float() @ p_hat[piv].transpose(1, 2) for piv in (pa, pb)])


def test_sdedit_edit_step_matches_the_reference(models, monkeypatch):
    """One exact SDEdit step (start 0.9 of 4 steps, window 2, guidance 7.5):
    the port's two passes against the reference's, from the same state,
    trajectory, embeddings and added conditioning, with every site's
    matches compared on the way."""
    port, ref, added = models
    traffic = {"timesteps": 4, "start": 0.9, "save_steps": 4, "guidance_scale": 7.5,
               "editor": "sdedit"}
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((F_, HW, HW, 4), generator=gen)
    traj = torch.randn((4, F_, HW, HW, 4), generator=gen)
    embeds3 = torch.randn((3, 77, 32), generator=gen)
    pivots = np.array([[1, 2]])

    sched = ddim.truncate_schedule(ddim.make_schedule(4), 0.9)
    save_ts = ddim.save_grid(8, 4)[0]
    step = pipeline.split_schedule(pipeline.make_edit_schedule(sched, save_ts), 1)[0]
    tables = ref_schedule.edit_tables(SCHEDULER, traffic)
    assert int(step.timesteps[0]) == int(tables["t"][0])

    seen = {"port": [], "ref": []}
    port_prop, ref_prop = layers.token_propagation, M.propagate

    def port_spy(norm_h, pivot_h, kf_attn, pa, pb, w1):
        seen["port"].append(_matches(norm_h, pivot_h, pa.long(), pb.long()))
        return port_prop(norm_h, pivot_h, kf_attn, pa, pb, w1)

    def ref_spy(P, x_src, pivot_h, kf_attn, pa, pb, w1):
        seen["ref"].append(_matches(x_src, pivot_h, pa, pb))
        return ref_prop(P, x_src, pivot_h, kf_attn, pa, pb, w1)

    monkeypatch.setattr(layers, "token_propagation", port_spy)
    monkeypatch.setattr(M, "propagate", ref_spy)
    got = pipeline.tokenflow_sample_loop(
        port, x, traj, embeds3, step, window_size=WS, guidance_scale=7.5, pnp=False,
        pivot_indices=pivots, added_cond=added)
    pa, pb, w1 = (torch.as_tensor(a) for a in ref_schedule.propagation_indices(F_, WS))
    want = edit_step(Precision("fp32"), ref, None, x, traj[int(tables["slot"][0])], embeds3,
                     tables, 0, pivots[0], traffic, (frozenset(), None), pa=pa, pb=pb, w1=w1,
                     model_kw=added)

    # 18 blocks, each a site of its own, in one order on both sides
    assert len(seen["port"]) == len(seen["ref"]) == 18
    flipped = torch.zeros(F_, dtype=torch.bool)
    for sp, sr in zip(seen["port"], seen["ref"]):
        ip, ir = sp.argmax(-1), sr.argmax(-1)
        diff = ip != ir
        if diff.any():
            best = sr.gather(-1, ir[..., None])[..., 0]
            other = sr.gather(-1, ip[..., None])[..., 0]
            gap = (best - other)[diff]
            assert (gap <= TIE_TOL * best[diff].abs()).all(), gap.max()
            flipped |= diff.any(-1).any(0)
    keep = ~flipped
    assert keep.sum() >= F_ - 1
    torch.testing.assert_close(got[keep].float(), want[keep], **TOL)
    assert (got - x).abs().max() > 1e-2  # the step moved the state

    # the fused step (one UNet call over the pivots and the frames) takes the
    # added conditioning for its [pivots | frames] batch: the same maths
    monkeypatch.undo()
    fused = pipeline.tokenflow_sample_loop(
        port, x, traj, embeds3, step, window_size=WS, guidance_scale=7.5, pnp=False,
        pivot_indices=pivots, added_cond=added, fused=True)
    torch.testing.assert_close(fused, got, **TOL)


def _tower_plain(cfg: CLIPTextConfig, sd: dict, ids: torch.Tensor, eos: int):
    """OpenCLIP-bigG's text tower in a few lines of torch: (the state after
    all but the last layer, the projected final-normed state at the first
    eos)."""
    w = {k.replace("text_model.", ""): v for k, v in sd.items()}
    d, h = cfg.hidden_size, cfg.num_heads
    x = w["embeddings.token_embedding.weight"][ids] + w["embeddings.position_embedding.weight"]
    states = [x]
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}."

        def lin(name, t):
            return t @ w[p + name + ".weight"].T + w[p + name + ".bias"]

        y = F.layer_norm(x, (d,), w[p + "layer_norm1.weight"], w[p + "layer_norm1.bias"])
        q, k, v = (lin(f"self_attn.{n}_proj", y).unflatten(-1, (h, d // h)).transpose(1, 2)
                   for n in ("q", "k", "v"))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + lin("self_attn.out_proj", o.transpose(1, 2).flatten(2))
        y = F.layer_norm(x, (d,), w[p + "layer_norm2.weight"], w[p + "layer_norm2.bias"])
        x = x + lin("mlp.fc2", F.gelu(lin("mlp.fc1", y)))
        states.append(x)
    last = F.layer_norm(x, (d,), w["final_layer_norm.weight"], w["final_layer_norm.bias"])
    at = (ids == eos).int().argmax(-1)
    return states[-2], last[torch.arange(len(ids)), at] @ sd["text_projection.weight"].T


def test_big_g_tower_penultimate_and_pooled():
    cfg = CLIPTextConfig(vocab_size=100, hidden_size=32, num_layers=3, num_heads=4,
                         intermediate_size=64, projection_dim=24)
    tower = CLIPTextModelWithProjection(cfg)
    init_random_(tower, torch.Generator().manual_seed(3))
    ids = torch.tensor([[0, 5, 7, 1, 1, 1, 1], [0, 9, 1, 1, 1, 1, 1]])
    ids = F.pad(ids, (0, 77 - ids.shape[1]), value=1)
    with torch.no_grad():
        got = tower.penultimate_and_pooled(ids, eos_token_id=1)
        want = _tower_plain(cfg, tower.state_dict(), ids, 1)
    assert got[1].shape == (2, 24)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the user's path: a tiny random SD-XL directory through the CLIs
# ---------------------------------------------------------------------------


def _write_tokenizer(d: Path, pad: str | None = None) -> None:
    d.mkdir(parents=True)
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = {"!": 0}
    for c in letters:
        vocab[c] = len(vocab)
    for c in letters:
        vocab[c + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    if pad is not None:
        (d / "special_tokens_map.json").write_text(json.dumps({"pad_token": pad}))


def _save(model: torch.nn.Module, d: Path, name: str, config: dict) -> None:
    d.mkdir(parents=True)
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, str(d / name))
    (d / "config.json").write_text(json.dumps(config))


def _clip_config(cfg: CLIPTextConfig) -> dict:
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "hidden_act": cfg.hidden_act, "projection_dim": cfg.projection_dim}


@pytest.fixture(scope="module")
def xl_dir(tmp_path_factory):
    """A tiny SD-XL checkpoint in diffusers layout with seeded random
    weights: unet, vae (scaling_factor 0.13025), text_encoder (CLIP-L's
    layout), text_encoder_2 (with its text_projection), both tokenizers
    (the second padding with "!")."""
    root = tmp_path_factory.mktemp("sdxl-tiny")
    unet_cfg, vae_cfg, clip_cfg = runtime.configs_for("tiny-xl")
    clip2_cfg = runtime.text_encoder_2_config("tiny-xl")
    gen = torch.Generator().manual_seed(9)
    unet, vae = UNet2DConditionModel(unet_cfg), AutoencoderKL(vae_cfg)
    text, text2 = clip_text.CLIPTextModel(clip_cfg), CLIPTextModelWithProjection(clip2_cfg)
    for m in (unet, vae, text, text2):
        init_random_(m, gen)
    _save(unet, root / "unet", "diffusion_pytorch_model.safetensors", dict(
        TINY_XL, _class_name="UNet2DConditionModel"))
    _save(vae, root / "vae", "diffusion_pytorch_model.safetensors", {
        "_class_name": "AutoencoderKL", "latent_channels": 4,
        "block_out_channels": list(vae_cfg.block_out_channels),
        "layers_per_block": vae_cfg.layers_per_block, "scaling_factor": 0.13025})
    _save(text, root / "text_encoder", "model.safetensors", _clip_config(clip_cfg))
    _save(text2, root / "text_encoder_2", "model.safetensors", _clip_config(clip2_cfg))
    _write_tokenizer(root / "tokenizer")
    _write_tokenizer(root / "tokenizer_2", pad="!")
    return root


def test_xl_stack_loads_by_key_name_and_encodes_two_towers(xl_dir):
    stack = runtime.load_stack("tiny-xl", device="cpu", model_dir=str(xl_dir),
                               dtype=torch.float32, init="pretrained")
    assert stack.vae.config.scaling_factor == 0.13025
    assert stack.tokenizer_2.pad_token_id == 0 and stack.tokenizer.pad_token_id != 0
    embeds, pooled = stack.encode_prompts("a cat", "")
    assert embeds.shape == (2, 77, 32) and pooled.shape == (2, 32)
    assert not embeds[0].any() and not pooled[0].any()  # the empty negative prompt
    ids = torch.tensor([stack.tokenizer("a cat")])
    torch.testing.assert_close(embeds[1, :, :16], stack.text_encoder.penultimate(ids)[0])
    added = stack.added_cond(pooled, 64, 48)
    assert added["time_ids"].tolist() == [[64, 48, 0, 0, 64, 48]] * 2


def test_preprocess_and_sdedit_on_a_tiny_sdxl_directory(xl_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data" / "clip"
    data.mkdir(parents=True)
    base = np.random.default_rng(0).integers(40, 210, (64, 64, 3), dtype=np.uint8)
    for i in range(F_):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
    pre = preprocess.main([
        "--data_path", "data/clip", "--H", "64", "--W", "64", "--sd_version", "tiny-xl",
        "--model_dir", str(xl_dir), "--init", "pretrained", "--dtype", "f32",
        "--steps", "8", "--save_steps", "4", "--n_frames", str(F_), "--batch_size", "2",
        "--inversion_prompt", "a cat", "--device", "cpu",
    ])
    assert (Path(pre["save_path"]) / "latents").is_dir()
    assert np.isfinite(pre["reconstruction_psnr"])
    config = dict(seed=1, device="cpu", output_path="results", data_path="data/clip",
                  latents_path="latents", n_inversion_steps=8, n_frames=F_,
                  sd_version="tiny-xl", model_dir=str(xl_dir), init="pretrained",
                  dtype="f32", guidance_scale=7.5, n_timesteps=4, prompt="a dog",
                  negative_prompt="", batch_size=2, image_size=64, start=0.9)
    (tmp_path / "sdedit.yaml").write_text(yaml.safe_dump(config))
    decoded = run_sdedit.main(["--config_path", "sdedit.yaml"])
    vanilla = run_sdedit.main(["--config_path", "sdedit.yaml", "--vanilla"])
    out = tmp_path / "results_sdedit" / "clip" / "a dog" / "batch_size_2" / "4start_0.9"
    for name in ("img_ode/00000.png", "tokenflow_SDEdit_fps_10.mp4", "input_fps10.mp4",
                 "config.yaml", "metrics.json", "pivots.json", "img_ode_vanilla_sde/00000.png",
                 "vanilla_sde.mp4", "metrics_vanilla.json"):
        assert (out / name).exists(), name
    for frames in (decoded, vanilla):
        assert frames.shape == (F_, 64, 64, 3) and np.isfinite(frames).all()
    assert json.loads((out / "metrics.json").read_text())["n_steps"] == 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_pnp_controlnet_and_a_frames_group_refuse_sdxl(models):
    port, _, added = models
    x = torch.zeros((F_, HW, HW, 4))
    sched = pipeline.make_edit_schedule(ddim.make_schedule(2), ddim.save_grid(2, 2)[0])
    kw = dict(window_size=WS, guidance_scale=7.5, pivot_indices=np.array([[0, 2], [1, 3]]))
    with pytest.raises(ValueError, match="PnP's injection sites are SD's"):
        pipeline.tokenflow_sample_loop(port, x, x[None].expand(2, -1, -1, -1, -1),
                                       torch.zeros((3, 77, 32)), sched, pnp=True,
                                       added_cond=added, **kw)
    with pytest.raises(NotImplementedError, match="runs in one process"):
        pipeline.tokenflow_sample_loop(port, x, x[None].expand(2, -1, -1, -1, -1),
                                       torch.zeros((3, 77, 32)), sched, pnp=False,
                                       added_cond=added, group=object(), **kw)
    with pytest.raises(ValueError, match="PnP is not defined on this UNet"):
        port(x[:3], 1, torch.zeros((3, 77, 32)),
             editctx.UNetEdit(mode=editctx.EditMode.PIVOTAL, n_frames=1, pnp=True),
             added_cond=added)
    with pytest.raises(ValueError, match="no ControlNet for this UNet"):
        ControlNetModel(UNet2DConfig.tiny_xl())
    base = dict(seed=1, output_path="o", data_path="d", latents_path="l", n_frames=4,
                sd_version="xl", guidance_scale=7.5, n_timesteps=4, prompt="p",
                negative_prompt="", batch_size=2, n_inversion_steps=8, device="cpu")
    with pytest.raises(ValueError, match="pnp editor does not take sd_version='xl'.*SD's "
                                         "four-level up path"):
        common.validate_config(dict(base, pnp_attn_t=0.5, pnp_f_t=0.8), "pnp")
    with pytest.raises(ValueError, match="no SD-XL ControlNet"):
        common.validate_config(base, "controlnet")
    common.validate_config(dict(base, start=0.9), "sdedit")
