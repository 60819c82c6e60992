"""Stable Diffusion's conditional UNet and the ControlNet in plain PyTorch,
built from a diffusers ``config.json`` (``unet/config.json``, a
ControlNet's ``config.json``) under diffusers' state-dict names, with
TokenFlow's edit at the self-attention and PnP sites.

Public layout is NHWC (the latents as the program holds them); the body
runs NCHW. Modules hold the weights, and the forward takes the
:class:`~reference.precision.Precision` that every product goes through, so
one model serves the fp32 reference and the fp8 control.

The edit (``Edit``) follows TokenFlow (Geyer et al., 2023) as the measured
program implements it:

* pivotal pass, batch frame-major over K keyframes and ``ns`` streams
  ([source|uncond|cond]): at every self-attention site the uncond and cond
  streams attend over the keys and values of all K keyframes at once, the
  source stream per frame; with PnP the q and k of the uncond and cond
  streams are the source stream's at the sites ``qk_sites`` while
  ``qk_gate`` holds. Each site caches the source stream's normed states
  (``pivot_h``) and the attention output after ``to_out`` (``kf_attn``);
* propagation pass over F frames: each site's self-attention output is
  gathered from ``kf_attn`` at the nearest pivot token (first argmax of the
  frame's source-stream normed state against the L2-normalised
  ``pivot_h``), for the frame's own-window pivot ``pa`` and the previous
  window's ``pb``, and blended ``w1 * a + (1 - w1) * b``;
* both passes: with PnP and ``conv_gate``, the uncond and cond streams take
  the source stream's features after ``conv2`` of the resnet ``conv_site``.

The PnP sites (``Edit.qk_sites``, ``Edit.conv_site``) are named as the forward
names them (``down_{i}_{j}``, ``mid``, ``up_{i}_{j}``, ``up_{i}_res_{j}``); the
architecture module (``architectures/sd.py``) says which they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.precision import Precision

TRANSFORMER_NORM_EPS = 1e-6
LAYER_NORM_EPS = 1e-5
# fp32 elements of one block of attention scores or match similarities
BLOCK_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    """The architecture a diffusers UNet (or ControlNet) config.json states."""

    in_channels: int
    out_channels: int
    block_out_channels: tuple
    layers_per_block: int
    cross_attention_dim: int
    heads: tuple  # per level (diffusers' ``attention_head_dim`` of SD UNets)
    use_linear_projection: bool
    norm_eps: float
    norm_num_groups: int
    flip_sin_to_cos: bool
    freq_shift: float
    attn_down: tuple
    attn_up: tuple
    cond_channels: tuple = ()  # a ControlNet's conditioning embedding

    @staticmethod
    def from_config(cfg: dict) -> "UNetSpec":
        """The fields of ``cfg``; what the reference cannot run is refused
        before this by ``architectures/sd.py::specs``."""
        levels = len(cfg["block_out_channels"])
        ahd = cfg["attention_head_dim"]
        heads = tuple([ahd] * levels if isinstance(ahd, int) else ahd)
        down = tuple(cfg["down_block_types"])
        up = tuple(cfg.get("up_block_types", ()))
        return UNetSpec(
            in_channels=cfg["in_channels"],
            out_channels=cfg.get("out_channels", cfg["in_channels"]),
            block_out_channels=tuple(cfg["block_out_channels"]),
            layers_per_block=cfg["layers_per_block"],
            cross_attention_dim=cfg["cross_attention_dim"],
            heads=heads,
            use_linear_projection=bool(cfg.get("use_linear_projection", False)),
            norm_eps=float(cfg.get("norm_eps", 1e-5)),
            norm_num_groups=int(cfg.get("norm_num_groups", 32)),
            flip_sin_to_cos=bool(cfg.get("flip_sin_to_cos", True)),
            freq_shift=float(cfg.get("freq_shift", 0)),
            attn_down=tuple(t.startswith("CrossAttn") for t in down),
            attn_up=tuple(t.startswith("CrossAttn") for t in up),
            cond_channels=tuple(cfg.get("conditioning_embedding_out_channels", ())),
        )

    def head_dim(self, level: int) -> int:
        return self.block_out_channels[level] // self.heads[level]


@dataclasses.dataclass
class Edit:
    """One pass's edit: mode "pivotal" (K keyframes) or "propagate" (F
    frames), ``ns`` streams frame-major, PnP gates and sites, and for
    "propagate" the pivotal pass's cache and the frames' (pa, pb, w1)."""

    mode: str
    n_frames: int
    ns: int = 3
    pnp: bool = False
    qk_gate: bool = False
    conv_gate: bool = False
    qk_sites: frozenset = frozenset()
    conv_site: Optional[str] = None
    cache: Optional[dict] = None
    pa: Optional[torch.Tensor] = None
    pb: Optional[torch.Tensor] = None
    w1: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# modules: weight holders under diffusers' names
# ---------------------------------------------------------------------------


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, LAYER_NORM_EPS)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, LAYER_NORM_EPS)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, LAYER_NORM_EPS)
        self.ff = FeedForward(dim)


class Transformer2D(nn.Module):
    def __init__(self, channels, heads, dim_head, context_dim, linear, groups):
        super().__init__()
        inner = heads * dim_head
        self.linear = linear
        self.norm = nn.GroupNorm(groups, channels, TRANSFORMER_NORM_EPS)
        if linear:
            self.proj_in, self.proj_out = nn.Linear(channels, inner), nn.Linear(inner, channels)
        else:
            self.proj_in = nn.Conv2d(channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, heads, dim_head, context_dim)])


class Block(nn.Module):
    def __init__(self, resnets, attentions=(), down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


class Sampler(nn.Module):
    def __init__(self, channels, stride):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride, padding=1)


class TimeEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1, self.linear_2 = nn.Linear(cin, dim), nn.Linear(dim, dim)


def _encoder(module: nn.Module, spec: UNetSpec):
    """conv_in, time_embedding, down_blocks and mid_block on ``module``;
    returns the channels of the skips the down blocks leave, and the
    attention block constructor by level."""
    ch, g, eps = spec.block_out_channels, spec.norm_num_groups, spec.norm_eps
    temb = 4 * ch[0]
    module.conv_in = nn.Conv2d(spec.in_channels, ch[0], 3, padding=1)
    module.time_embedding = TimeEmbedding(ch[0], temb)

    def attn(level):
        return Transformer2D(ch[level], spec.heads[level], spec.head_dim(level),
                             spec.cross_attention_dim, spec.use_linear_projection, g)

    cin, skips, down = ch[0], [ch[0]], []
    for i, c in enumerate(ch):
        resnets, attns = [], []
        for _ in range(spec.layers_per_block):
            resnets.append(Resnet(cin, c, temb, g, eps))
            cin = c
            if spec.attn_down[i]:
                attns.append(attn(i))
            skips.append(c)
        ds = Sampler(c, 2) if i < len(ch) - 1 else None
        if ds is not None:
            skips.append(c)
        down.append(Block(resnets, attns, down=ds))
    module.down_blocks = nn.ModuleList(down)
    module.mid_block = Block([Resnet(ch[-1], ch[-1], temb, g, eps) for _ in range(2)],
                             [attn(len(ch) - 1)])
    return skips, attn


class UNet(nn.Module):
    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = spec
        skips, attn = _encoder(self, spec)
        ch, g, eps = spec.block_out_channels, spec.norm_num_groups, spec.norm_eps
        rev, cin, up = ch[::-1], ch[-1], []
        for i in range(len(ch)):
            resnets, attns = [], []
            for _ in range(spec.layers_per_block + 1):
                resnets.append(Resnet(cin + skips.pop(), rev[i], 4 * ch[0], g, eps))
                cin = rev[i]
                if spec.attn_up[i]:
                    attns.append(attn(len(ch) - 1 - i))
            up.append(Block(resnets, attns, up=Sampler(rev[i], 1) if i < len(ch) - 1 else None))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps)
        self.conv_out = nn.Conv2d(ch[0], spec.out_channels, 3, padding=1)

    def forward(self, P: Precision, sample, t: int, context, edit=None, down_residuals=None,
                mid_residual=None):
        return unet_forward(P, self, sample, t, context, edit, down_residuals, mid_residual)


class CondEmbedding(nn.Module):
    def __init__(self, channels: tuple, out_channels: int):
        super().__init__()
        self.conv_in = nn.Conv2d(3, channels[0], 3, padding=1)
        blocks = []
        for i in range(len(channels) - 1):
            blocks.append(nn.Conv2d(channels[i], channels[i], 3, padding=1))
            blocks.append(nn.Conv2d(channels[i], channels[i + 1], 3, padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)


class ControlNet(nn.Module):
    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = spec
        skips, _ = _encoder(self, spec)
        self.controlnet_cond_embedding = CondEmbedding(spec.cond_channels,
                                                       spec.block_out_channels[0])
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skips])
        c = spec.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(c, c, 1)

    def forward(self, P: Precision, sample, t: int, context, cond):
        return controlnet_forward(P, self, sample, t, context, cond)


def build(kind: str, config: dict, state_dict: Optional[dict] = None) -> nn.Module:
    """A ``UNet`` or ``ControlNet`` (``kind``) of ``config``, on the meta
    device, or holding ``state_dict`` as fp32 copies."""
    spec = UNetSpec.from_config(config)
    with torch.device("meta"):
        model = (UNet if kind == "unet" else ControlNet)(spec)
    if state_dict is not None:
        model.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True,
                              assign=True)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _group_norm(x, norm: nn.GroupNorm, silu: bool = False):
    y = F.group_norm(x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return F.silu(y) if silu else y


def _layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, shift: float):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * torch.exp(exponent / (half - shift))[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def attention(P: Precision, q, k, v, heads: int):
    """softmax(q k^T / sqrt(D)) v per head; q (B, Sq, inner), k and v (B,
    Skv, inner); the scores in blocks of query rows."""
    b, sq, inner = q.shape
    skv, d = k.shape[1], inner // heads
    qh = q.reshape(b, sq, heads, d).transpose(1, 2)
    kt = k.reshape(b, skv, heads, d).permute(0, 2, 3, 1)
    vh = v.reshape(b, skv, heads, d).transpose(1, 2)
    out = torch.empty((b, heads, sq, d), dtype=torch.float32, device=q.device)
    rows = max(1, BLOCK_ELEMS // (b * heads * skv))
    for r in range(0, sq, rows):
        s = P.matmul(qh[:, :, r : r + rows], kt) * d**-0.5
        out[:, :, r : r + rows] = P.matmul(torch.softmax(s, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, sq, inner)


def propagate(P: Precision, x_src, pivot_h, kf_attn, pa, pb, w1):
    """TokenFlow's token propagation: (ns, F, S, C) from the frames'
    source-stream states ``x_src`` (F, S, C), the cache's ``pivot_h`` (K, S,
    C) and ``kf_attn`` (ns, K, S, C)."""
    f, s, c = x_src.shape
    ns = kf_attn.shape[0]
    p = pivot_h.float()
    p_hat = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    out = torch.empty((ns, f, s, c), dtype=torch.float32, device=x_src.device)
    frames = max(1, BLOCK_ELEMS // (s * s))
    w = w1.float()
    for f0 in range(0, f, frames):
        sl = slice(f0, f0 + frames)
        rows = []
        for piv in (pa[sl], pb[sl]):
            sim = P.matmul(x_src[sl], p_hat[piv].transpose(1, 2))  # (f, S, S)
            idx = sim.argmax(dim=-1)  # the first maximum
            table = kf_attn[:, piv].float()  # (ns, f, S, C)
            rows.append(torch.gather(table, 2, idx[None, :, :, None].expand(ns, -1, -1, c)))
        wf = w[sl][None, :, None, None]
        out[:, sl] = wf * rows[0] + (1 - wf) * rows[1]
    return out


def transformer_block(P, blk: TransformerBlock, x, context, edit: Optional[Edit], site: str):
    b, s, dim = x.shape
    h = _layer_norm(x, blk.norm1)
    cache = None
    a = blk.attn1
    if edit is None:
        q, k, v = (P.linear(h, m) for m in (a.to_q, a.to_k, a.to_v))
        attn_out = P.linear(attention(P, q, k, v, a.heads), a.to_out[0])
    elif edit.mode == "pivotal":
        ns = edit.ns
        kf = b // ns
        h3 = h.reshape(kf, ns, s, dim).transpose(0, 1)  # (ns, K, S, C)
        q, k, v = (P.linear(h3, m) for m in (a.to_q, a.to_k, a.to_v))
        if edit.pnp and edit.qk_gate and site in edit.qk_sites:
            q, k = q[:1].expand_as(q), k[:1].expand_as(k)
        inner = q.shape[-1]

        def joint(t):  # the extended streams: one sequence over all K frames
            return t[ns - 2 :].reshape(2, kf * s, inner)

        o = attention(P, joint(q), joint(k), joint(v), a.heads).reshape(2, kf, s, inner)
        if ns == 3:
            o = torch.cat([attention(P, q[0], k[0], v[0], a.heads)[None], o])
        kf_attn = P.linear(o, a.to_out[0])  # (ns, K, S, C)
        attn_out = kf_attn.transpose(0, 1).reshape(b, s, dim)
        cache = {"pivot_h": h3[0], "kf_attn": kf_attn}
    elif edit.mode == "propagate":
        entry = edit.cache[site]
        o3 = propagate(P, h.reshape(edit.n_frames, edit.ns, s, dim)[:, 0], entry["pivot_h"],
                       entry["kf_attn"], edit.pa, edit.pb, edit.w1)
        attn_out = o3.transpose(0, 1).reshape(b, s, dim)
    else:
        raise ValueError(f"unknown edit mode {edit.mode!r}")
    x = x + attn_out
    h = _layer_norm(x, blk.norm2)
    a = blk.attn2
    ctx = context.float()
    q, k, v = P.linear(h, a.to_q), P.linear(ctx, a.to_k), P.linear(ctx, a.to_v)
    x = x + P.linear(attention(P, q, k, v, a.heads), a.to_out[0])
    hh, gate = P.linear(_layer_norm(x, blk.norm3), blk.ff.net[0].proj).chunk(2, dim=-1)
    return x + P.linear(hh * F.gelu(gate), blk.ff.net[2]), cache


def transformer2d(P, t: Transformer2D, x, context, edit, site):
    b, c, hh, ww = x.shape
    h = _group_norm(x, t.norm)
    if t.linear:
        h = P.linear(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c), t.proj_in)
    else:
        h = P.conv(h, t.proj_in)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, h.shape[1])
    h, cache = transformer_block(P, t.transformer_blocks[0], h, context, edit, site)
    if t.linear:
        h = P.linear(h, t.proj_out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    else:
        h = P.conv(h.reshape(b, hh, ww, h.shape[-1]).permute(0, 3, 1, 2), t.proj_out)
    return h + x, cache


def resnet(P, r: Resnet, x, temb, edit: Optional[Edit] = None, inject: bool = False):
    h = P.conv(_group_norm(x, r.norm1, silu=True), r.conv1)
    h = h + P.linear(F.silu(temb), r.time_emb_proj)[:, :, None, None]
    h = P.conv(_group_norm(h, r.norm2, silu=True), r.conv2)
    if inject and edit is not None and edit.pnp and edit.conv_gate:
        h3 = h.reshape(h.shape[0] // edit.ns, edit.ns, *h.shape[1:])
        h = h3[:, :1].expand_as(h3).reshape(h.shape)
    if hasattr(r, "conv_shortcut"):
        x = P.conv(x, r.conv_shortcut)
    return x + h


def _embed(P, model, t: int, b: int, device):
    spec = model.spec
    emb = timestep_embedding(torch.full((b,), t, device=device), spec.block_out_channels[0],
                             spec.flip_sin_to_cos, spec.freq_shift)
    te = model.time_embedding
    return P.linear(F.silu(P.linear(emb, te.linear_1)), te.linear_2)


def _down_mid(P, model, h, temb, context, edit, cache):
    skips = [h]
    for i, block in enumerate(model.down_blocks):
        for j, r in enumerate(block.resnets):
            h = resnet(P, r, h, temb)
            if len(block.attentions):
                h, c = transformer2d(P, block.attentions[j], h, context, edit, f"down_{i}_{j}")
                if c is not None:
                    cache[f"down_{i}_{j}"] = c
            skips.append(h)
        if hasattr(block, "downsamplers"):
            h = P.conv(h, block.downsamplers[0].conv)
            skips.append(h)
    mid = model.mid_block
    h = resnet(P, mid.resnets[0], h, temb)
    h, c = transformer2d(P, mid.attentions[0], h, context, edit, "mid")
    if c is not None:
        cache["mid"] = c
    return resnet(P, mid.resnets[1], h, temb), skips


def unet_forward(P: Precision, model: UNet, sample, t: int, context,
                 edit: Optional[Edit] = None, down_residuals=None, mid_residual=None):
    """eps (B, h, w, C_out) NHWC fp32 and the pivotal pass's cache."""
    cache: dict = {}
    temb = _embed(P, model, t, sample.shape[0], sample.device)
    h = P.conv(sample.float().permute(0, 3, 1, 2), model.conv_in)
    h, skips = _down_mid(P, model, h, temb, context, edit, cache)
    if down_residuals is not None:
        skips = [s + r.permute(0, 3, 1, 2) for s, r in zip(skips, down_residuals)]
    if mid_residual is not None:
        h = h + mid_residual.permute(0, 3, 1, 2)
    for i, block in enumerate(model.up_blocks):
        for j, r in enumerate(block.resnets):
            h = torch.cat([h, skips.pop()], dim=1)
            inject = edit is not None and f"up_{i}_res_{j}" == edit.conv_site
            h = resnet(P, r, h, temb, edit, inject=inject)
            if len(block.attentions):
                h, c = transformer2d(P, block.attentions[j], h, context, edit, f"up_{i}_{j}")
                if c is not None:
                    cache[f"up_{i}_{j}"] = c
        if hasattr(block, "upsamplers"):
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = P.conv(h, block.upsamplers[0].conv)
    eps = P.conv(_group_norm(h, model.conv_norm_out, silu=True), model.conv_out)
    return eps.permute(0, 2, 3, 1), cache


def controlnet_forward(P: Precision, model: ControlNet, sample, t: int, context, cond):
    """(down residuals, mid residual), NHWC fp32; ``cond`` (B, H, W, 3)."""
    temb = _embed(P, model, t, sample.shape[0], sample.device)
    h = P.conv(sample.float().permute(0, 3, 1, 2), model.conv_in)
    ce = model.controlnet_cond_embedding
    c = F.silu(P.conv(cond.float().permute(0, 3, 1, 2), ce.conv_in))
    for conv in ce.blocks:
        c = F.silu(P.conv(c, conv))
    h = h + P.conv(c, ce.conv_out)
    h, skips = _down_mid(P, model, h, temb, context, None, {})
    down = tuple(P.conv(s, m).permute(0, 2, 3, 1)
                 for s, m in zip(skips, model.controlnet_down_blocks))
    return down, P.conv(h, model.controlnet_mid_block).permute(0, 2, 3, 1)
