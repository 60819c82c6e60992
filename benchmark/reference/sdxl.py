"""Stable Diffusion XL's conditional UNet in plain PyTorch, built from its
diffusers ``unet/config.json`` under diffusers' state-dict names, with
TokenFlow's edit at every transformer block's self-attention.

It is SD's UNet (``reference/model.py``, whose modules, products, norms,
attention, propagation, resnets and time embedding it imports) with:

* ``transformer_layers_per_block``: each attention site of a level holds
  that many transformer blocks between ``proj_in`` and ``proj_out``, run in
  order; the mid block takes the last level's count;
* levels without attention (``DownBlock2D`` / ``UpBlock2D`` in any place);
* ``addition_embed_type`` "text_time": the pooled text embedding
  ``text_embeds`` (B, P) and the six ids ``time_ids`` (B, 6) (original
  size, crop corner, target size), each id through
  ``addition_time_embed_dim`` sinusoids, concatenated to
  ``projection_class_embeddings_input_dim`` = P + 6 x that, through
  ``add_embedding`` (linear, SiLU, linear) and added to the time embedding.

Each transformer block is an edit site: a site of one block keeps the
site's name (``down_{i}_{j}``, ``mid``, ``up_{i}_{j}``), block n of a
deeper site is ``<site>.<n>``; the pivotal pass caches every block's
``pivot_h`` and ``kf_attn``, and the propagation pass gathers each block's
self-attention output from its own entry.

Departures from diffusers' ``UNet2DConditionModel`` on this configuration:
public layout NHWC; every product goes through the ``Precision`` (fp32, TF32
off, or the fp8 control); norms and softmax in fp32; attention scores in
blocks of query rows. Not built (the configuration states none of them):
class embeddings, ``encoder_hid_proj``, other addition types, attention
masks, ``cross_attention_kwargs``, upcasting switches, ControlNet residuals
(there is no SD-XL ControlNet here) and PnP (its injection sites are SD's
four-level up path): a PnP edit or residuals raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference import model as M
from reference.precision import Precision


@dataclasses.dataclass(frozen=True)
class XLSpec(M.UNetSpec):
    """SD's spec with the fields SD-XL's config.json adds."""

    transformer_layers: tuple = ()  # blocks a site, per level
    addition_time_embed_dim: int = 0
    projection_class_embeddings_input_dim: int = 0
    sample_size: int = 128  # the native latent size (x 8: pixels)

    @staticmethod
    def from_config(cfg: dict) -> "XLSpec":
        base = M.UNetSpec.from_config(cfg)
        levels = len(base.block_out_channels)
        tl = cfg.get("transformer_layers_per_block", 1)
        return XLSpec(
            **dataclasses.asdict(base),
            transformer_layers=tuple([tl] * levels if isinstance(tl, int) else tl),
            addition_time_embed_dim=int(cfg["addition_time_embed_dim"]),
            projection_class_embeddings_input_dim=int(
                cfg["projection_class_embeddings_input_dim"]),
            sample_size=int(cfg.get("sample_size", 128)),
        )


def block_sites(site: str, n: int) -> tuple:
    return (site,) if n == 1 else tuple(f"{site}.{k}" for k in range(n))


class Transformer2D(M.Transformer2D):
    """SD's ``Transformer2D`` holding ``n`` transformer blocks."""

    def __init__(self, channels, heads, dim_head, context_dim, linear, groups, n):
        super().__init__(channels, heads, dim_head, context_dim, linear, groups)
        self.transformer_blocks = nn.ModuleList(
            [M.TransformerBlock(heads * dim_head, heads, dim_head, context_dim)
             for _ in range(n)])


def _attn(spec: XLSpec, level: int) -> Transformer2D:
    return Transformer2D(spec.block_out_channels[level], spec.heads[level],
                         spec.head_dim(level), spec.cross_attention_dim,
                         spec.use_linear_projection, spec.norm_num_groups,
                         spec.transformer_layers[level])


class UNet(nn.Module):
    def __init__(self, spec: XLSpec):
        super().__init__()
        self.spec = spec
        ch, g, eps = spec.block_out_channels, spec.norm_num_groups, spec.norm_eps
        temb = 4 * ch[0]
        self.conv_in = nn.Conv2d(spec.in_channels, ch[0], 3, padding=1)
        self.time_embedding = M.TimeEmbedding(ch[0], temb)
        self.add_embedding = M.TimeEmbedding(spec.projection_class_embeddings_input_dim, temb)
        cin, skips, down = ch[0], [ch[0]], []
        for i, c in enumerate(ch):
            resnets, attns = [], []
            for _ in range(spec.layers_per_block):
                resnets.append(M.Resnet(cin, c, temb, g, eps))
                cin = c
                if spec.attn_down[i]:
                    attns.append(_attn(spec, i))
                skips.append(c)
            ds = M.Sampler(c, 2) if i < len(ch) - 1 else None
            if ds is not None:
                skips.append(c)
            down.append(M.Block(resnets, attns, down=ds))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = M.Block([M.Resnet(ch[-1], ch[-1], temb, g, eps) for _ in range(2)],
                                 [_attn(spec, len(ch) - 1)])
        rev, cin, up = ch[::-1], ch[-1], []
        for i in range(len(ch)):
            resnets, attns = [], []
            for _ in range(spec.layers_per_block + 1):
                resnets.append(M.Resnet(cin + skips.pop(), rev[i], temb, g, eps))
                cin = rev[i]
                if spec.attn_up[i]:
                    attns.append(_attn(spec, len(ch) - 1 - i))
            up.append(M.Block(resnets, attns,
                              up=M.Sampler(rev[i], 1) if i < len(ch) - 1 else None))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps)
        self.conv_out = nn.Conv2d(ch[0], spec.out_channels, 3, padding=1)

    def forward(self, P: Precision, sample, t: int, context, edit=None, down_residuals=None,
                mid_residual=None, text_embeds=None, time_ids=None):
        return unet_forward(P, self, sample, t, context, edit, down_residuals, mid_residual,
                            text_embeds, time_ids)


def build(kind: str, config: dict, state_dict: Optional[dict] = None) -> nn.Module:
    """The ``UNet`` of ``config`` (``kind`` "unet"; SD-XL has no ControlNet
    here), on the meta device, or holding ``state_dict`` as fp32 copies."""
    if kind != "unet":
        raise ValueError(f"the SD-XL reference builds a UNet, not a {kind!r}")
    with torch.device("meta"):
        model = UNet(XLSpec.from_config(config))
    if state_dict is not None:
        model.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True,
                              assign=True)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def add_embed(P: Precision, model: UNet, text_embeds, time_ids):
    """The "text_time" embedding (B, 4 C0) of the pooled text (B, P) and
    the ids (B, 6)."""
    spec = model.spec
    b = time_ids.shape[0]
    ids = M.timestep_embedding(time_ids.flatten().float(), spec.addition_time_embed_dim,
                               spec.flip_sin_to_cos, spec.freq_shift).reshape(b, -1)
    ae = model.add_embedding
    h = torch.cat([text_embeds.float(), ids], dim=-1)
    return P.linear(F.silu(P.linear(h, ae.linear_1)), ae.linear_2)


def transformer2d(P, t: Transformer2D, x, context, edit, site: str, cache: dict):
    """SD's ``transformer2d`` over the site's blocks in order, each block
    its own edit site; the pivotal pass's entries go into ``cache``."""
    b, c, hh, ww = x.shape
    h = M._group_norm(x, t.norm)
    if t.linear:
        h = P.linear(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c), t.proj_in)
    else:
        h = P.conv(h, t.proj_in)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, h.shape[1])
    for name, blk in zip(block_sites(site, len(t.transformer_blocks)), t.transformer_blocks):
        h, entry = M.transformer_block(P, blk, h, context, edit, name)
        if entry is not None:
            cache[name] = entry
    if t.linear:
        h = P.linear(h, t.proj_out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    else:
        h = P.conv(h.reshape(b, hh, ww, h.shape[-1]).permute(0, 3, 1, 2), t.proj_out)
    return h + x


def unet_forward(P: Precision, model: UNet, sample, t: int, context,
                 edit: Optional[M.Edit] = None, down_residuals=None, mid_residual=None,
                 text_embeds=None, time_ids=None):
    """eps (B, h, w, C_out) NHWC fp32 and the pivotal pass's cache."""
    if edit is not None and edit.pnp:
        raise ValueError("PnP is not defined on SD-XL: its injection sites are SD's "
                         "four-level up path")
    if down_residuals is not None or mid_residual is not None:
        raise ValueError("there is no SD-XL ControlNet here")
    if text_embeds is None or time_ids is None:
        raise ValueError("SD-XL needs text_embeds and time_ids")
    cache: dict = {}
    b = sample.shape[0]
    temb = M._embed(P, model, t, b, sample.device) + add_embed(P, model, text_embeds, time_ids)
    h = P.conv(sample.float().permute(0, 3, 1, 2), model.conv_in)
    skips = [h]
    for i, block in enumerate(model.down_blocks):
        for j, r in enumerate(block.resnets):
            h = M.resnet(P, r, h, temb)
            if len(block.attentions):
                h = transformer2d(P, block.attentions[j], h, context, edit, f"down_{i}_{j}",
                                  cache)
            skips.append(h)
        if hasattr(block, "downsamplers"):
            h = P.conv(h, block.downsamplers[0].conv)
            skips.append(h)
    mid = model.mid_block
    h = M.resnet(P, mid.resnets[0], h, temb)
    h = transformer2d(P, mid.attentions[0], h, context, edit, "mid", cache)
    h = M.resnet(P, mid.resnets[1], h, temb)
    for i, block in enumerate(model.up_blocks):
        for j, r in enumerate(block.resnets):
            h = M.resnet(P, r, torch.cat([h, skips.pop()], dim=1), temb)
            if len(block.attentions):
                h = transformer2d(P, block.attentions[j], h, context, edit, f"up_{i}_{j}",
                                  cache)
        if hasattr(block, "upsamplers"):
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = P.conv(h, block.upsamplers[0].conv)
    eps = P.conv(M._group_norm(h, model.conv_norm_out, silu=True), model.conv_out)
    return eps.permute(0, 2, 3, 1), cache
