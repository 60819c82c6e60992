"""HunyuanDiT v1.2: a 40-block diffusion transformer (hidden 1408, 16 heads
of 88) on 2 x 2 patches of the latents, with 2-D RoPE, per-head QK
LayerNorm, U-ViT long skips, an AdaLN shift, the CLIP (77 x 1024) and mT5
(256 x 2048) contexts and a learned-sigma output, predicting v. Its weights
are the configuration's "transformer" group (``DENOISER_GROUP``). No
ControlNet; PnP is defined on SD's four-level UNet, so its cells edit with
SDEdit.

The spec and the plain reference are ``reference/hunyuan_dit.py``'s, the
program's model the port's ``models/hunyuan_dit.py``, imported only inside
:func:`program_model`. Both sides get the T5 states and the two text masks
from :func:`model_inputs`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

import program
from reference.hunyuan_dit import DiTSpec, build
from weights import sub_seed
from yardstick import CONTEXT_LEN, Attn, Match, Pass, _conv, _linear

DENOISER_GROUP = "transformer"
# what the reference runs of what the config.json may state: key -> the
# one value it follows
REFERENCE_HAS = (("use_style_cond_and_image_meta_size", False), ("learn_sigma", True),
                 ("norm_type", "layer_norm"), ("activation_fn", "gelu-approximate"))
# salts of the model inputs' draws (the harness's inputs take 10-14)
SALT_T5, SALT_MASKS = 30, 31


# ---------------------------------------------------------------------------
# specs and the plain reference
# ---------------------------------------------------------------------------


def specs(config: dict) -> tuple:
    """(the DiT's spec, None: no ControlNet) of a configuration file; a key
    the reference does not follow is refused by name and value."""
    cfg = config[DENOISER_GROUP]
    for key, want in REFERENCE_HAS:
        if cfg.get(key, want) != want:
            raise ValueError(f"config {key}={cfg[key]!r}: the HunyuanDiT reference has "
                             f"{want!r}")
    if config.get("controlnet") is not None:
        raise ValueError("HunyuanDiT has no ControlNet here")
    return DiTSpec.from_config(cfg), None


# the plain reference's DiT of the configuration's group: on the meta device
# (the state dict's names and shapes), or holding a state dict
reference_model = build


def inject_sites(spec: DiTSpec) -> tuple:
    """No PnP sites: PnP's injection sites are SD's four-level up path. A
    PnP edit on the DiT is refused by the reference and by the program."""
    return frozenset(), None


def model_inputs(spec: DiTSpec, prompts: int, seed: int, device, dtype) -> tuple:
    """(the program's ``added_cond``, the reference's ``t5``, ``mask`` and
    ``mask_t5``), one row per prompt: unit-normal mT5 states (an encoder's
    output after its final norm) in the served dtype, and each prompt's
    CLIP and T5 masks, ones over a length drawn from the seed (1 .. 77, 1 ..
    256) and zeros after it."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, SALT_T5))
    t5 = torch.randn((prompts, spec.text_len_t5, spec.cross_attention_dim_t5), generator=gen,
                     device=device).to(dtype)
    lens = torch.Generator().manual_seed(sub_seed(seed, SALT_MASKS))
    masks = []
    for n in (spec.text_len, spec.text_len_t5):
        length = torch.randint(1, n + 1, (prompts, 1), generator=lens)
        masks.append((torch.arange(n)[None] < length).to(device=device, dtype=torch.int64))
    program_kw = {"encoder_hidden_states_t5": t5, "text_embedding_mask": masks[0],
                  "text_embedding_mask_t5": masks[1]}
    return ({"added_cond": program_kw},
            {"t5": t5.float(), "mask": masks[0], "mask_t5": masks[1]})


# ---------------------------------------------------------------------------
# the program's model
# ---------------------------------------------------------------------------


def _port_config(spec: DiTSpec):
    from tokenflow_torch.models.hunyuan_dit import HunyuanDiTConfig

    fields = {f.name for f in dataclasses.fields(HunyuanDiTConfig)}
    kw = {k: v for k, v in dataclasses.asdict(spec).items() if k in fields}
    return HunyuanDiTConfig(num_attention_heads=spec.heads, **kw)


def program_model(kind: str, spec: DiTSpec, state_dict: dict):
    """The port's DiT of ``spec``, handed the benchmark's state dict by key
    name, as the port loads a diffusers checkpoint."""
    from tokenflow_torch.models.hunyuan_dit import HunyuanDiT2DModel

    if kind != "unet":
        raise ValueError(f"HunyuanDiT has no {kind!r} here")
    with torch.device("meta"):
        model = HunyuanDiT2DModel(_port_config(spec))
    return program.load(model, state_dict)


# ---------------------------------------------------------------------------
# the yardstick's operations
# ---------------------------------------------------------------------------


def _embed(spec: DiTSpec, b: int, grid: int) -> Iterator:
    """The patch embedding, the time and text conditioning and the context's
    text projection of ``b`` images."""
    h, t5, n5 = spec.hidden_size, spec.cross_attention_dim_t5, spec.text_len_t5
    yield _conv(b, spec.in_channels, h, spec.patch_size, grid)
    yield _linear(b, spec.time_proj_dim, h)
    yield _linear(b, h, h)
    # the pool: q of the mean token, k and v of all L + 1, one query's scores
    # and weighted sum (not an attention site: plain numbers), c_proj
    yield _linear(b, t5, t5)
    yield 2 * _linear(b * (n5 + 1), t5, t5)
    yield 4.0 * b * (n5 + 1) * t5
    yield _linear(b, t5, spec.pooled_projection_dim)
    yield _linear(b, spec.pooled_projection_dim, 4 * h)
    yield _linear(b, 4 * h, h)
    yield _linear(b * n5, t5, 4 * t5)
    yield _linear(b * n5, 4 * t5, spec.cross_attention_dim)


def _block(spec: DiTSpec, n: int, s: int, p: Pass) -> Iterator:
    """Block n: its long skip, AdaLN shift, self-attention (or the
    propagation's match), cross-attention over the 333-token context and
    feed-forward."""
    b, h, heads, d = p.batch, spec.hidden_size, spec.heads, spec.head_dim
    ctx = CONTEXT_LEN + spec.text_len_t5
    if n > spec.num_layers // 2:
        yield _linear(b * s, 2 * h, h)
    yield _linear(b, h, h)
    if p.mode == "propagate":
        yield Match(p.frames, s, h, p.pivots, p.ns)
    else:
        yield 3 * _linear(b * s, h, h)
        if p.mode == "pivotal":
            yield Attn(2, heads, p.frames * s, p.frames * s, d, "extended")
            if p.ns == 3:
                yield Attn(p.frames, heads, s, s, d, "source")
        else:
            yield Attn(b, heads, s, s, d, "self")
        yield _linear(b * s, h, h)
    yield _linear(b * s, h, h)  # attn2.to_q
    yield 2 * _linear(b * ctx, spec.cross_attention_dim, h)
    yield Attn(b, heads, s, ctx, d, "cross")
    yield _linear(b * s, h, h)
    yield _linear(b * s, h, spec.ff_inner)
    yield _linear(b * s, spec.ff_inner, h)


def dit_ops(spec: DiTSpec, p: Pass, hw: int) -> list:
    """The operations of one DiT call at latent size ``hw``: numbers (the
    FLOPs of a convolution, a linear layer or the pool's one query),
    ``Attn`` and ``Match``."""
    grid = hw // spec.patch_size
    s, b, h = grid * grid, p.batch, spec.hidden_size
    ops = list(_embed(spec, b, grid))
    for n in range(spec.num_layers):
        ops += _block(spec, n, s, p)
    ops.append(_linear(b, h, 2 * h))  # norm_out's scale and shift
    ops.append(_linear(b * s, h, spec.patch_size**2 * spec.out_channels))
    return ops


def step_ops(stage: str, unet: DiTSpec, controlnet, traffic: dict) -> list:
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
        ops += dit_ops(unet, p, hw)
    return ops
