"""HunyuanDiT v1.2's transformer in plain PyTorch, built from its diffusers
``transformer/config.json`` under diffusers' state-dict names
(``HunyuanDiT2DModel``), with TokenFlow's edit at every block's
self-attention. It follows diffusers' code; every product goes through the
``Precision`` (fp32 with TF32 off, or the fp8 control); norms, softmax,
RoPE and the SiLUs stay fp32.

A call on NHWC latents (B, H, W, 4), the CLIP states ``context`` (B, 77,
1024) and the model inputs ``t5`` (B, 256, 2048), ``mask`` (B, 77) and
``mask_t5`` (B, 256):

- patch embedding ``pos_embed.proj`` (2 x 2 stride-2 conv), tokens
  row-major; no positional embedding (``pos_embed_type`` None);
- temb = ``timestep_embedder``(256 sinusoids of t, cos first) +
  ``extra_embedder``(``pooler``(t5)): the pool prepends the tokens' mean,
  adds ``positional_embedding`` and lets the mean's query attend over all
  257 tokens in 8 heads (``F.multi_head_attention_forward``), then
  ``c_proj``; ``extra_embedder`` and ``text_embedder`` are linear, SiLU,
  linear;
- context = cat[CLIP, ``text_embedder``(t5)], masked tokens replaced by
  ``text_embedding_padding``; cross attention takes no mask;
- RoPE: ``get_2d_rotary_pos_embed(88, crop, (h, w), use_real=True)`` with
  the crop region of the base grid 512 / 8 / 2 = 32 in the grid
  (``get_resize_crop_region_for_grid``), applied to interleaved pairs;
- block n: for n > num_layers // 2, x = skip_linear(skip_norm(cat[x,
  skip])) with the skips popped LIFO from blocks 0 .. num_layers // 2 - 2;
  h = norm1(x) + linear(SiLU(temb)); x += attn1(h) (per-head LayerNorm of
  q and k, RoPE on both); x += attn2(norm2(x), context) (QK LayerNorm, RoPE
  on q); x += ff(norm3(x)) with tanh-GELU;
- out: LayerNorm without affine, x (1 + scale) + shift from
  linear(SiLU(temb)), ``proj_out``, unpatchify (p, q, c order) to 8
  channels, of which the first 4 (the v output; the learned sigma is
  dropped) are returned.

The edit (``reference/model.py``'s ``Edit``) is TokenFlow's, defined on
UNets, at each block's attn1 (sites "0" .. "39"). The DiT departs from it
in one place: in the pivotal pass each keyframe's q and k are normed and
rotated by its own token grid before the keyframes' tokens are joined, so
the joint sequence repeats every rotary position once per keyframe. The
pivotal pass caches the source stream's ``norm1`` output (``pivot_h``) and
attn1's output after ``to_out`` (``kf_attn``); the propagation pass
gathers attn1's output from them (``model.propagate``) on the ``norm1``
output. Not built: the style and image-size conditioning (v1.2 has
neither), attention masks, a ControlNet and PnP (their sites are SD's
four-level UNet): residuals or a PnP edit raise.

Departures from diffusers: the timestep reaches the sinusoids exactly
(diffusers' pipeline casts it to the latents' dtype first), and everything
runs in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference import model as M
from reference.precision import Precision

# fixed in diffusers' code (HunyuanDiT2DModel, the pipeline)
POOL_HEADS = 8
TIME_PROJ_DIM = 256
ROPE_BASE_PX = 512  # the pipeline's base size in pixels
VAE_FACTOR = 8


@dataclasses.dataclass(frozen=True)
class DiTSpec:
    """What ``transformer/config.json`` states."""

    in_channels: int
    patch_size: int
    hidden_size: int
    num_layers: int
    heads: int
    mlp_ratio: float
    learn_sigma: bool
    cross_attention_dim: int
    cross_attention_dim_t5: int
    pooled_projection_dim: int
    text_len: int
    text_len_t5: int
    sample_size: int
    norm_eps: float = 1e-6
    pool_heads: int = POOL_HEADS
    time_proj_dim: int = TIME_PROJ_DIM
    rope_base: int = ROPE_BASE_PX // VAE_FACTOR // 2

    @staticmethod
    def from_config(cfg: dict) -> "DiTSpec":
        """The fields of ``cfg``; ``pool_heads``, ``time_proj_dim`` and
        ``rope_base`` are the code's unless a (test) config states them."""
        p = int(cfg["patch_size"])
        return DiTSpec(
            in_channels=int(cfg["in_channels"]), patch_size=p,
            hidden_size=int(cfg["hidden_size"]), num_layers=int(cfg["num_layers"]),
            heads=int(cfg["num_attention_heads"]), mlp_ratio=float(cfg["mlp_ratio"]),
            learn_sigma=bool(cfg["learn_sigma"]),
            cross_attention_dim=int(cfg["cross_attention_dim"]),
            cross_attention_dim_t5=int(cfg["cross_attention_dim_t5"]),
            pooled_projection_dim=int(cfg["pooled_projection_dim"]),
            text_len=int(cfg["text_len"]), text_len_t5=int(cfg["text_len_t5"]),
            sample_size=int(cfg["sample_size"]),
            pool_heads=int(cfg.get("pool_heads", POOL_HEADS)),
            time_proj_dim=int(cfg.get("time_proj_dim", TIME_PROJ_DIM)),
            rope_base=int(cfg.get("rope_base", ROPE_BASE_PX // VAE_FACTOR // p)),
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads

    @property
    def ff_inner(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @property
    def context_len(self) -> int:
        return self.text_len + self.text_len_t5


# ---------------------------------------------------------------------------
# modules: weight holders under diffusers' names
# ---------------------------------------------------------------------------


class Projection(nn.Module):
    """``PixArtAlphaTextProjection``: linear_1, SiLU, linear_2."""

    def __init__(self, cin, hidden, cout):
        super().__init__()
        self.linear_1, self.linear_2 = nn.Linear(cin, hidden), nn.Linear(hidden, cout)


class Pool(nn.Module):
    def __init__(self, spacial_dim, embed_dim, out_dim):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, out_dim)


class TimeExtra(nn.Module):
    def __init__(self, s: DiTSpec):
        super().__init__()
        self.timestep_embedder = M.TimeEmbedding(s.time_proj_dim, s.hidden_size)
        self.pooler = Pool(s.text_len_t5, s.cross_attention_dim_t5, s.pooled_projection_dim)
        self.extra_embedder = Projection(s.pooled_projection_dim, 4 * s.hidden_size,
                                         s.hidden_size)


class Attention(nn.Module):
    def __init__(self, dim, heads, context_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(context_dim or dim, dim)
        self.to_v = nn.Linear(context_dim or dim, dim)
        self.norm_q = nn.LayerNorm(dim // heads, eps=1e-6)
        self.norm_k = nn.LayerNorm(dim // heads, eps=1e-6)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])


class AdaShift(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.linear = nn.Linear(dim, dim)
        self.norm = nn.LayerNorm(dim, eps=eps)


class GeluProj(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner)


class Block(nn.Module):
    def __init__(self, s: DiTSpec, skip: bool):
        super().__init__()
        d = s.hidden_size
        self.norm1 = AdaShift(d, s.norm_eps)
        self.attn1 = Attention(d, s.heads)
        self.norm2 = nn.LayerNorm(d, eps=s.norm_eps)
        self.attn2 = Attention(d, s.heads, s.cross_attention_dim)
        self.norm3 = nn.LayerNorm(d, eps=s.norm_eps)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GeluProj(d, s.ff_inner), nn.Identity(),
                                     nn.Linear(s.ff_inner, d)])
        if skip:
            self.skip_norm = nn.LayerNorm(2 * d, eps=s.norm_eps)
            self.skip_linear = nn.Linear(2 * d, d)


class DiT(nn.Module):
    def __init__(self, spec: DiTSpec):
        super().__init__()
        s = self.spec = spec
        self.pos_embed = nn.Module()
        self.pos_embed.proj = nn.Conv2d(s.in_channels, s.hidden_size, s.patch_size,
                                        stride=s.patch_size)
        self.time_extra_emb = TimeExtra(s)
        self.text_embedder = Projection(s.cross_attention_dim_t5, 4 * s.cross_attention_dim_t5,
                                        s.cross_attention_dim)
        self.text_embedding_padding = nn.Parameter(torch.empty(s.context_len,
                                                               s.cross_attention_dim))
        self.blocks = nn.ModuleList([Block(s, n > s.num_layers // 2)
                                     for n in range(s.num_layers)])
        self.norm_out = nn.Module()
        self.norm_out.linear = nn.Linear(s.hidden_size, 2 * s.hidden_size)
        self.proj_out = nn.Linear(s.hidden_size, s.patch_size**2 * s.out_channels)

    def forward(self, P: Precision, sample, t: int, context, edit=None, down_residuals=None,
                mid_residual=None, t5=None, mask=None, mask_t5=None):
        return dit_forward(P, self, sample, t, context, edit, down_residuals, mid_residual,
                           t5, mask, mask_t5)


def build(kind: str, config: dict, state_dict: Optional[dict] = None) -> nn.Module:
    """The ``DiT`` of ``config`` (``kind`` "unet": the denoiser; there is no
    ControlNet), on the meta device, or holding ``state_dict`` as fp32
    copies."""
    if kind != "unet":
        raise ValueError(f"the HunyuanDiT reference builds the denoiser, not a {kind!r}")
    with torch.device("meta"):
        model = DiT(DiTSpec.from_config(config))
    if state_dict is not None:
        model.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True,
                              assign=True)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ln(x, norm: nn.LayerNorm):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


def _project(P, m: Projection, x):
    return P.linear(F.silu(P.linear(x, m.linear_1)), m.linear_2)


def crop_region(grid_h: int, grid_w: int, base: int) -> tuple:
    """diffusers' ``get_resize_crop_region_for_grid((grid_h, grid_w), base)``."""
    r = grid_h / grid_w
    if r > 1:
        rh = base
        rw = int(round(base / grid_h * grid_w))
    else:
        rw = base
        rh = int(round(base / grid_w * grid_h))
    top, left = int(round((base - rh) / 2.0)), int(round((base - rw) / 2.0))
    return (top, left), (top + rh, left + rw)


def rope(head_dim: int, grid_h: int, grid_w: int, base: int, device) -> tuple:
    """(cos, sin) (grid_h * grid_w, head_dim): diffusers'
    ``get_2d_rotary_pos_embed(head_dim, crop_region(...), (grid_h, grid_w),
    use_real=True)``, written as its code computes it."""
    (t, l), (b, r) = crop_region(grid_h, grid_w, base)
    gh = np.linspace(t, b, grid_h, endpoint=False, dtype=np.float32)
    gw = np.linspace(l, r, grid_w, endpoint=False, dtype=np.float32)
    grid = np.stack(np.meshgrid(gw, gh), axis=0)  # [2, H, W]: w first

    def one_d(dim, pos):
        pos = torch.from_numpy(pos.reshape(-1).copy()).to(device)
        freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device)[: dim // 2]
                                   .float() / dim))
        f = torch.outer(pos, freqs)
        return f.cos().repeat_interleave(2, dim=1), f.sin().repeat_interleave(2, dim=1)

    ch, sh = one_d(head_dim // 2, grid[0])
    cw, sw = one_d(head_dim // 2, grid[1])
    return torch.cat([ch, cw], dim=1), torch.cat([sh, sw], dim=1)


def apply_rope(x, cs):
    """x (B, H, S, D) rotated on interleaved pairs (diffusers'
    ``apply_rotary_emb``, ``use_real_unbind_dim=-1``)."""
    cos, sin = cs
    xr, xi = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    rotated = torch.stack([-xi, xr], dim=-1).flatten(3)
    return x.float() * cos[None, None] + rotated.float() * sin[None, None]


def pool(P, m: Pool, x, heads: int):
    """``HunyuanDiTAttentionPool`` on x (B, L, C): (B, out)."""
    x = x.float().permute(1, 0, 2)  # LNC
    x = torch.cat([x.mean(dim=0, keepdim=True), x], dim=0)
    x = x + m.positional_embedding[:, None, :].float()
    n, b, c = x.shape
    d = c // heads
    q = P.linear(x[:1], m.q_proj).reshape(1, b * heads, d).transpose(0, 1)
    k = P.linear(x, m.k_proj).reshape(n, b * heads, d).transpose(0, 1)
    v = P.linear(x, m.v_proj).reshape(n, b * heads, d).transpose(0, 1)
    w = torch.softmax(P.matmul(q * d**-0.5, k.transpose(1, 2)), dim=-1)
    o = P.matmul(w, v).transpose(0, 1).reshape(1, b, c)
    return P.linear(o, m.c_proj)[0]


def _heads(x, heads):
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2)


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def qk(P, a: Attention, h, ctx, cs):
    """q, k, v (B, S, inner) of an attention: q and k normed per head, q
    rotated, and k too for self attention (``ctx`` None)."""
    src = h if ctx is None else ctx
    q, k, v = (P.linear(x, m) for x, m in ((h, a.to_q), (src, a.to_k), (src, a.to_v)))
    q, k = _ln(_heads(q, a.heads), a.norm_q), _ln(_heads(k, a.heads), a.norm_k)
    q = apply_rope(q, cs)
    if ctx is None:
        k = apply_rope(k, cs)
    return _merge(q), _merge(k), v


def block_forward(P, blk: Block, x, temb, ctx, cs, edit: Optional[M.Edit], site: str,
                  skip=None):
    if hasattr(blk, "skip_linear"):
        x = P.linear(_ln(torch.cat([x, skip], dim=-1), blk.skip_norm), blk.skip_linear)
    b, s, dim = x.shape
    h = _ln(x, blk.norm1.norm) + P.linear(F.silu(temb), blk.norm1.linear)[:, None]
    a = blk.attn1
    cache = None
    if edit is None:
        q, k, v = qk(P, a, h, None, cs)
        attn_out = P.linear(M.attention(P, q, k, v, a.heads), a.to_out[0])
    elif edit.mode == "pivotal":
        ns, kf = edit.ns, b // edit.ns
        h3 = h.reshape(kf, ns, s, dim).transpose(0, 1)  # (ns, K, S, C)
        # each keyframe's q and k normed and rotated on its own grid
        q, k, v = qk(P, a, h3.reshape(ns * kf, s, dim), None, cs)
        q, k, v = (t.reshape(ns, kf, s, dim) for t in (q, k, v))

        def joint(t):
            return t[ns - 2 :].reshape(2, kf * s, dim)

        o = M.attention(P, joint(q), joint(k), joint(v), a.heads).reshape(2, kf, s, dim)
        if ns == 3:
            o = torch.cat([M.attention(P, q[0], k[0], v[0], a.heads)[None], o])
        kf_attn = P.linear(o, a.to_out[0])
        attn_out = kf_attn.transpose(0, 1).reshape(b, s, dim)
        cache = {"pivot_h": h3[0], "kf_attn": kf_attn}
    elif edit.mode == "propagate":
        entry = edit.cache[site]
        o3 = M.propagate(P, h.reshape(edit.n_frames, edit.ns, s, dim)[:, 0], entry["pivot_h"],
                         entry["kf_attn"], edit.pa, edit.pb, edit.w1)
        attn_out = o3.transpose(0, 1).reshape(b, s, dim)
    else:
        raise ValueError(f"unknown edit mode {edit.mode!r}")
    x = x + attn_out
    a = blk.attn2
    q, k, v = qk(P, a, _ln(x, blk.norm2), ctx, cs)
    x = x + P.linear(M.attention(P, q, k, v, a.heads), a.to_out[0])
    ff = blk.ff.net
    y = F.gelu(P.linear(_ln(x, blk.norm3), ff[0].proj), approximate="tanh")
    return x + P.linear(y, ff[2]), cache


def embed(P, model: DiT, t: int, b: int, context, t5, mask, mask_t5, device):
    """(temb (B, C), the masked context (B, 333, C_ctx))."""
    s = model.spec
    te = model.time_extra_emb
    sin = M.timestep_embedding(torch.full((b,), t, device=device), s.time_proj_dim, True, 0)
    temb = P.linear(F.silu(P.linear(sin, te.timestep_embedder.linear_1)),
                    te.timestep_embedder.linear_2)
    temb = temb + _project(P, te.extra_embedder, pool(P, te.pooler, t5, s.pool_heads))
    ctx = torch.cat([context.float(), _project(P, model.text_embedder, t5.float())], dim=1)
    keep = torch.cat([mask, mask_t5], dim=-1).bool()[..., None]
    return temb, torch.where(keep, ctx, model.text_embedding_padding.float())


def dit_forward(P: Precision, model: DiT, sample, t: int, context, edit=None,
                down_residuals=None, mid_residual=None, t5=None, mask=None, mask_t5=None):
    """The v output (B, H, W, C) NHWC fp32 and the pivotal pass's cache."""
    if edit is not None and edit.pnp:
        raise ValueError("PnP is not defined on the DiT: its injection sites are SD's "
                         "four-level UNet up path")
    if down_residuals is not None or mid_residual is not None:
        raise ValueError("there is no HunyuanDiT ControlNet here")
    if t5 is None or mask is None or mask_t5 is None:
        raise ValueError("HunyuanDiT needs t5, mask and mask_t5")
    s = model.spec
    p = s.patch_size
    b, hh, ww, _ = sample.shape
    gh, gw = hh // p, ww // p
    temb, ctx = embed(P, model, t, b, context, t5, mask, mask_t5, sample.device)
    x = P.conv(sample.float().permute(0, 3, 1, 2), model.pos_embed.proj)
    x = x.flatten(2).transpose(1, 2)
    cs = rope(s.head_dim, gh, gw, s.rope_base, sample.device)
    cache: dict = {}
    skips = []
    half = s.num_layers // 2
    for n, blk in enumerate(model.blocks):
        x, entry = block_forward(P, blk, x, temb, ctx, cs, edit, str(n),
                                 skips.pop() if n > half else None)
        if entry is not None:
            cache[str(n)] = entry
        if n < half - 1:
            skips.append(x)
    scale, shift = P.linear(F.silu(temb), model.norm_out.linear).chunk(2, dim=1)
    x = F.layer_norm(x, (s.hidden_size,), eps=1e-6) * (1 + scale)[:, None] + shift[:, None]
    x = P.linear(x, model.proj_out)
    c = s.out_channels
    x = x.reshape(b, gh, gw, p, p, c)
    out = torch.einsum("nhwpqc->nchpwq", x).reshape(b, c, hh, ww)
    return out[:, : s.in_channels].permute(0, 2, 3, 1), cache
