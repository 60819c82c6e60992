"""Stable Diffusion's UNet family (SD-1.x, SD-2.x): four levels, one
transformer block at each attention site, one text encoder's 77 tokens, no
added conditioning; with the ControlNet of the same layout. The architecture
of every configuration that names none (``manifest.architecture``).

The spec and the plain reference are ``reference/model.py``'s, the program's
models the port's ``models/unet2d.py`` and ``models/controlnet.py``, imported
only inside :func:`program_model`.
"""

from __future__ import annotations

from typing import Iterator

import torch

import program
from reference.model import UNetSpec, build
from yardstick import CONTEXT_LEN, Attn, Match, Pass, _conv, _linear

# PnP's sites under the reference's site names: q and k injected at decoder
# attention blocks 4-11 (TokenFlow's tokenflow_utils.py:208-214), features
# after conv2 of up_blocks[1].resnets[1] (tokenflow_utils.py:102)
QK_INJECT_SITES = frozenset({
    "up_1_1", "up_1_2", "up_2_0", "up_2_1", "up_2_2", "up_3_0", "up_3_1", "up_3_2",
})
CONV_INJECT_SITE = "up_1_res_1"

# the reference's forms of what a diffusers config.json may state
REFERENCE_HAS = (("act_fn", "silu"), ("center_input_sample", False),
                 ("mid_block_scale_factor", 1), ("downsample_padding", 1),
                 ("class_embed_type", None), ("addition_embed_type", None))


# ---------------------------------------------------------------------------
# specs and the plain reference
# ---------------------------------------------------------------------------


def _spec(cfg: dict) -> UNetSpec:
    for key, want in REFERENCE_HAS:
        if cfg.get(key, want) != want:
            raise ValueError(
                f"config {key}={cfg[key]!r}: the SD UNet has {want!r}; a configuration of "
                "another UNet family names its module under the \"architecture\" key "
                "(benchmark/architectures/<name>.py)")
    return UNetSpec.from_config(cfg)


def specs(config: dict) -> tuple:
    """(the UNet's spec, the ControlNet's or None) of a configuration file."""
    cn = config.get("controlnet")
    return _spec(config["unet"]), None if cn is None else _spec(cn)


# the plain reference's "unet" or "controlnet" of a configuration's group: on
# the meta device (the state dict's names and shapes), or holding a state dict
reference_model = build


def inject_sites(spec: UNetSpec) -> tuple:
    """(the sites whose q and k PnP injects, the resnet whose features it
    injects) under the reference's site names."""
    return QK_INJECT_SITES, CONV_INJECT_SITE


def model_inputs(spec: UNetSpec, prompts: int, seed: int, device, dtype) -> tuple:
    """(keyword arguments for the program's calls, for the reference's) beyond
    the ``prompts`` prompt embeddings: none for this family."""
    return {}, {}


# ---------------------------------------------------------------------------
# the program's models
# ---------------------------------------------------------------------------


def _port_config(spec: UNetSpec):
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
    )


def program_model(kind: str, spec: UNetSpec, state_dict: dict):
    """The port's UNet or ControlNet (``kind``) of ``spec``, handed the
    benchmark's state dict by key name, as the port loads a checkpoint."""
    from tokenflow_torch.models.controlnet import COND_CHANNELS, ControlNetModel
    from tokenflow_torch.models.unet2d import UNet2DConditionModel

    if kind == "controlnet" and spec.cond_channels != COND_CHANNELS:
        raise ValueError(f"the port's conditioning embedding has {COND_CHANNELS}")
    with torch.device("meta"):
        model = (UNet2DConditionModel(_port_config(spec)) if kind == "unet" else
                 ControlNetModel(_port_config(spec), len(spec.cond_channels) - 1))
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


def _transformer(spec: UNetSpec, level: int, res: int, p: Pass) -> Iterator:
    b, s = p.batch, res * res
    c = spec.block_out_channels[level]
    heads, d = spec.heads[level], spec.head_dim(level)
    inner = heads * d
    yield _linear(b * s, c, inner)  # proj_in (a 1x1 conv counts the same)
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
    yield _linear(b * s, inner, c)  # proj_out


def _encoder(spec: UNetSpec, p: Pass, hw: int, skips: list) -> Iterator:
    ch, b = spec.block_out_channels, p.batch
    temb = 4 * ch[0]
    yield _linear(b, ch[0], temb)
    yield _linear(b, temb, temb)
    yield _conv(b, spec.in_channels, ch[0], 3, hw)
    skips.append((ch[0], hw))
    cin, res = ch[0], hw
    for i, c in enumerate(ch):
        for _ in range(spec.layers_per_block):
            yield from _resnet(b, cin, c, temb, res)
            cin = c
            if spec.attn_down[i]:
                yield from _transformer(spec, i, res, p)
            skips.append((c, res))
        if i < len(ch) - 1:
            res //= 2
            yield _conv(b, c, c, 3, res)
            skips.append((c, res))
    yield from _resnet(b, ch[-1], ch[-1], temb, res)
    yield from _transformer(spec, len(ch) - 1, res, p)
    yield from _resnet(b, ch[-1], ch[-1], temb, res)


def unet_ops(spec: UNetSpec, p: Pass, hw: int) -> list:
    """The operations of one UNet call at latent size ``hw``: numbers (the
    FLOPs of a convolution or linear layer), ``Attn`` and ``Match``."""
    skips: list = []
    ops = list(_encoder(spec, p, hw, skips))
    ch, b = spec.block_out_channels, p.batch
    temb = 4 * ch[0]
    rev = ch[::-1]
    cin, res = ch[-1], hw // 2 ** (len(ch) - 1)
    for i in range(len(ch)):
        for _ in range(spec.layers_per_block + 1):
            ops += _resnet(b, cin + skips.pop()[0], rev[i], temb, res)
            cin = rev[i]
            if spec.attn_up[i]:
                ops += _transformer(spec, len(ch) - 1 - i, res, p)
        if i < len(ch) - 1:
            res *= 2
            ops.append(_conv(b, rev[i], rev[i], 3, res))
    ops.append(_conv(b, ch[0], spec.out_channels, 3, hw))
    return ops


def controlnet_ops(spec: UNetSpec, p: Pass, hw: int) -> list:
    """The operations of one ControlNet call at latent size ``hw``, its
    conditioning image 2^(len(cond_channels) - 1) times larger."""
    b, cc = p.batch, spec.cond_channels
    res = hw * 2 ** (len(cc) - 1)
    ops = [_conv(b, 3, cc[0], 3, res)]
    for i in range(len(cc) - 1):
        ops.append(_conv(b, cc[i], cc[i], 3, res))
        res //= 2
        ops.append(_conv(b, cc[i], cc[i + 1], 3, res))
    ops.append(_conv(b, cc[-1], spec.block_out_channels[0], 3, hw))
    plain = Pass("plain", p.frames, p.ns)
    skips: list = []
    ops += _encoder(spec, plain, hw, skips)
    ops += [_conv(b, c, c, 1, r) for c, r in skips]
    c = spec.block_out_channels[-1]
    ops.append(_conv(b, c, c, 1, hw // 2 ** (len(spec.block_out_channels) - 1)))
    return ops


def step_ops(stage: str, unet: UNetSpec, controlnet, traffic: dict) -> list:
    """Every operation of one step of ``stage`` ("edit": the pivotal pass
    over the keyframes and the propagation pass over all frames, three
    streams each; "invert": one plain call over all frames), ControlNet
    calls included where the configuration has one."""
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
        if controlnet is not None:
            ops += controlnet_ops(controlnet, p, hw)
    return ops
