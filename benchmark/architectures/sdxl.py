"""Stable Diffusion XL's UNet: three levels, no attention at the first,
``transformer_layers_per_block`` blocks at each attention site (1, 2, 10:
70 a call), two text encoders' 77 tokens concatenated to a 2048-wide
context, and the "text_time" added conditioning (a pooled text embedding and
six size and crop ids). No ControlNet; PnP is not defined on its layout, so
its cells edit with SDEdit.

The spec and the plain reference are ``reference/sdxl.py``'s, the program's
model the port's ``models/unet2d.py`` (``UNet2DConfig.sdxl_base``'s fields
from the configuration), imported only inside :func:`program_model`.
"""

from __future__ import annotations

from typing import Iterator

import torch

import program
from reference.sdxl import XLSpec, build
from weights import sub_seed
from yardstick import CONTEXT_LEN, Attn, Match, Pass, _conv, _linear

# what the reference runs of what a diffusers config.json may state
REFERENCE_HAS = (("act_fn", "silu"), ("center_input_sample", False),
                 ("mid_block_scale_factor", 1), ("downsample_padding", 1),
                 ("class_embed_type", None), ("addition_embed_type", "text_time"),
                 ("encoder_hid_dim", None), ("time_embedding_type", "positional"),
                 ("resnet_time_scale_shift", "default"), ("only_cross_attention", False),
                 ("dual_cross_attention", False))
# salts of the added conditioning's draws (the harness's inputs take 10-14)
SALT_POOLED = 20
# SD-XL's size and crop ids: (original h, w, crop top, left, target h, w)
TIME_IDS = ("original", "original", "crop", "crop", "target", "target")


# ---------------------------------------------------------------------------
# specs and the plain reference
# ---------------------------------------------------------------------------


def specs(config: dict) -> tuple:
    """(the UNet's spec, None: no ControlNet) of a configuration file."""
    cfg = config["unet"]
    for key, want in REFERENCE_HAS:
        if cfg.get(key, want) != want:
            raise ValueError(f"config {key}={cfg[key]!r}: the SD-XL reference has {want!r}")
    if "controlnet" in config:
        raise ValueError("SD-XL has no ControlNet here")
    return XLSpec.from_config(cfg), None


# the plain reference's UNet of a configuration's group: on the meta device
# (the state dict's names and shapes), or holding a state dict
reference_model = build


def inject_sites(spec: XLSpec) -> tuple:
    """No PnP sites: PnP's injection sites are SD's four-level up path. The
    edit driver asks for them in every edit cell; a PnP edit on SD-XL is
    refused by the reference (and by the program) when it runs."""
    return frozenset(), None


def time_ids(spec: XLSpec) -> torch.Tensor:
    """(6,) the ids of an uncropped image at the configuration's native size
    (``sample_size`` latents of 8 pixels): (H, W, 0, 0, H, W)."""
    px = 8.0 * spec.sample_size
    return torch.tensor([0.0 if k == "crop" else px for k in TIME_IDS])


def model_inputs(spec: XLSpec, prompts: int, seed: int, device, dtype) -> tuple:
    """(the program's ``added_cond``, the reference's ``text_embeds`` and
    ``time_ids``), one row per prompt: unit-normal pooled text embeddings
    (P = the add embedding's input less the ids' sinusoids) drawn from the
    seed in the served dtype, and :func:`time_ids`."""
    width = spec.projection_class_embeddings_input_dim - 6 * spec.addition_time_embed_dim
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, SALT_POOLED))
    text = torch.randn((prompts, width), generator=gen, device=device).to(dtype)
    ids = time_ids(spec).to(device).expand(prompts, -1).contiguous()
    return ({"added_cond": {"text_embeds": text, "time_ids": ids}},
            {"text_embeds": text.float(), "time_ids": ids})


# ---------------------------------------------------------------------------
# the program's model
# ---------------------------------------------------------------------------


def _port_config(spec: XLSpec):
    from tokenflow_torch.models.unet2d import UNet2DConfig

    if spec.norm_num_groups != 32:
        raise ValueError("the port's norms have 32 groups")
    return UNet2DConfig(
        in_channels=spec.in_channels, out_channels=spec.out_channels,
        block_out_channels=spec.block_out_channels, layers_per_block=spec.layers_per_block,
        cross_attention_dim=spec.cross_attention_dim, num_heads=spec.heads,
        use_linear_projection=spec.use_linear_projection, norm_eps=spec.norm_eps,
        flip_sin_to_cos=spec.flip_sin_to_cos, freq_shift=spec.freq_shift,
        attn_down=spec.attn_down, attn_up=spec.attn_up,
        transformer_layers=spec.transformer_layers,
        addition_time_embed_dim=spec.addition_time_embed_dim,
        projection_class_embeddings_input_dim=spec.projection_class_embeddings_input_dim,
    )


def program_model(kind: str, spec: XLSpec, state_dict: dict):
    """The port's UNet of ``spec``, handed the benchmark's state dict by key
    name, as the port loads a checkpoint."""
    from tokenflow_torch.models.unet2d import UNet2DConditionModel

    if kind != "unet":
        raise ValueError(f"SD-XL has no {kind!r} here")
    with torch.device("meta"):
        model = UNet2DConditionModel(_port_config(spec))
    return program.load(model, state_dict)


# ---------------------------------------------------------------------------
# the yardstick's operations
# ---------------------------------------------------------------------------


def _resnet(b, cin, cout, temb, res) -> Iterator:
    yield _conv(b, cin, cout, 3, res)
    yield _linear(b, temb, cout)
    yield _conv(b, cout, cout, 3, res)
    if cin != cout:
        yield _conv(b, cin, cout, 1, res)


def _block(spec: XLSpec, level: int, res: int, p: Pass) -> Iterator:
    """One transformer block: its self-attention (or the propagation's
    match), cross-attention and feed-forward."""
    b, s = p.batch, res * res
    heads, d = spec.heads[level], spec.head_dim(level)
    inner = heads * d
    if p.mode == "propagate":
        yield Match(p.frames, s, inner, p.pivots, p.ns)
    else:
        yield 3 * _linear(b * s, inner, inner)
        if p.mode == "pivotal":
            yield Attn(2, heads, p.frames * s, p.frames * s, d, "extended")
            if p.ns == 3:
                yield Attn(p.frames, heads, s, s, d, "source")
        else:
            yield Attn(b, heads, s, s, d, "self")
        yield _linear(b * s, inner, inner)
    yield _linear(b * s, inner, inner)  # attn2.to_q
    yield 2 * _linear(b * CONTEXT_LEN, spec.cross_attention_dim, inner)
    yield Attn(b, heads, s, CONTEXT_LEN, d, "cross")
    yield _linear(b * s, inner, inner)
    yield _linear(b * s, inner, 8 * inner)
    yield _linear(b * s, 4 * inner, inner)


def _transformer(spec: XLSpec, level: int, res: int, p: Pass) -> Iterator:
    c, inner = spec.block_out_channels[level], spec.heads[level] * spec.head_dim(level)
    yield _linear(p.batch * res * res, c, inner)  # proj_in
    for _ in range(spec.transformer_layers[level]):
        yield from _block(spec, level, res, p)
    yield _linear(p.batch * res * res, inner, c)  # proj_out


def unet_ops(spec: XLSpec, p: Pass, hw: int) -> list:
    """The operations of one UNet call at latent size ``hw``: numbers (the
    FLOPs of a convolution or linear layer), ``Attn`` and ``Match``."""
    ch, b = spec.block_out_channels, p.batch
    temb = 4 * ch[0]
    ops = [_linear(b, ch[0], temb), _linear(b, temb, temb),
           _linear(b, spec.projection_class_embeddings_input_dim, temb),
           _linear(b, temb, temb), _conv(b, spec.in_channels, ch[0], 3, hw)]
    skips, cin, res = [ch[0]], ch[0], hw
    for i, c in enumerate(ch):
        for _ in range(spec.layers_per_block):
            ops += _resnet(b, cin, c, temb, res)
            cin = c
            if spec.attn_down[i]:
                ops += _transformer(spec, i, res, p)
            skips.append(c)
        if i < len(ch) - 1:
            res //= 2
            ops.append(_conv(b, c, c, 3, res))
            skips.append(c)
    ops += _resnet(b, ch[-1], ch[-1], temb, res)
    ops += _transformer(spec, len(ch) - 1, res, p)
    ops += _resnet(b, ch[-1], ch[-1], temb, res)
    rev = ch[::-1]
    for i in range(len(ch)):
        for _ in range(spec.layers_per_block + 1):
            ops += _resnet(b, cin + skips.pop(), rev[i], temb, res)
            cin = rev[i]
            if spec.attn_up[i]:
                ops += _transformer(spec, len(ch) - 1 - i, res, p)
        if i < len(ch) - 1:
            res *= 2
            ops.append(_conv(b, rev[i], rev[i], 3, res))
    ops.append(_conv(b, ch[0], spec.out_channels, 3, hw))
    return ops


def step_ops(stage: str, unet: XLSpec, controlnet, traffic: dict) -> list:
    """Every operation of one step of ``stage`` ("edit": the pivotal pass
    over the keyframes and the propagation pass over all frames, three
    streams each; "invert": one plain call over all frames)."""
    hw = traffic["resolution"] // 8
    f = traffic["frames"]
    if stage == "edit":
        k = f // traffic["window"]
        passes = [Pass("pivotal", k, 3), Pass("propagate", f, 3, k)]
    elif stage == "invert":
        passes = [Pass("plain", f, 1)]
    else:
        raise ValueError(f"no operation count for stage {stage!r}")
    ops = []
    for p in passes:
        ops += unet_ops(unet, p, hw)
    return ops
