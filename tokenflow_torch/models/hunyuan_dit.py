"""HunyuanDiT (PyTorch): the diffusion transformer of Tencent's HunyuanDiT
v1.2 (Li et al., 2024, arXiv:2405.08748), with TokenFlow's edit at every
block's self-attention.

Module names follow diffusers' ``HunyuanDiT2DModel`` state-dict keys, so a
diffusers ``transformer/`` checkpoint loads with ``load_state_dict``. The
public layout is the UNets' as the edit loop calls them: NHWC latents in,
NHWC output out, the 77-token CLIP context as ``encoder_hidden_states`` and
the rest through ``added_cond`` (one row per batch item, frame-major as the
loop repeats it): ``encoder_hidden_states_t5`` (B, 256, 2048) and the two
text masks ``text_embedding_mask`` (B, 77) and ``text_embedding_mask_t5``
(B, 256).

A call, on x (B, S, hidden) tokens and temb (B, hidden):

- patch embedding: a 2 x 2 stride-2 convolution, tokens in row-major order;
- conditioning (``time_extra_emb``): the timestep's 256 sinusoids through
  ``timestep_embedder``, plus ``extra_embedder`` (linear, SiLU in fp32,
  linear) of the T5 states pooled by ``pooler``, one query (the tokens'
  mean) attending over them in fp32, as ``HunyuanDiTAttentionPool`` does
  (:func:`attention_pool`);
- context: the CLIP states beside ``text_embedder`` of the T5 states, with
  every masked token replaced by the learned ``text_embedding_padding``;
- 2-D RoPE (:func:`rope_tables`): diffusers' ``get_2d_rotary_pos_embed``
  on the token grid against the pipeline's base grid (512 px / 8 / patch),
  the first half of each head's dims rotated by the column position and
  the second by the row position, on interleaved pairs, in fp32;
- block n (``HunyuanDiTBlock``): for n past num_layers / 2 the long skip
  (the output of block num_layers - 2 - n, LIFO) through ``skip_norm``
  and ``skip_linear``; ``norm1`` the AdaLN shift (LayerNorm + a linear of
  SiLU(temb)); self attention with biased projections, a per-head LayerNorm
  on q and k and RoPE on both; cross attention on the context with the
  QK LayerNorm and RoPE on q; the tanh-GELU feed-forward;
- output: ``norm_out`` (LayerNorm without affine, scaled and shifted by a
  linear of SiLU(temb)), ``proj_out`` and the unpatchify; of the learned
  sigma's 2 C channels the first C are returned (the model's v).

The TokenFlow edit is defined on UNets. On the DiT each block's attn1 is an
edit site (``"0"`` .. ``"39"``, one ``UNetEdit.for_site`` directive a
block, 40 a call), and the edit departs from the UNets' in one place: the
q and k of every keyframe are normed and rotated by that frame's own token
grid before the keyframes' tokens are joined into one sequence, so a
token's rotary position is its place in its own frame, repeated in every
keyframe, and the joint attention sees the same positions K times. The
PIVOTAL pass caches ``pivot_h`` (the source stream's ``norm1`` output, the
AdaLN-shifted state) and ``kf_attn`` (attn1's output after ``to_out``); the
PROPAGATE pass gathers attn1's output from them with ``token_propagation``
on the ``norm1`` output, as ``BasicTransformerBlock`` does. Both go
through the shared ``extended_attention`` and ``token_propagation``.
PnP and a ControlNet are refused (their sites are SD's four-level UNet);
the FUSED mode raises NotImplementedError.

Departures from diffusers: the timestep reaches the sinusoids exactly
(diffusers' pipeline casts it to the latents' dtype first); the pool runs
in fp32. On CUDA every attention call goes through ``ops/attention.py``
(K1 above 1024 keys, K6 at or under), the norms through K5 (each rotated
q or k through K5's rotary entry, the norm and the rotation in one
launch), the matches through K2/K3; the pool's one-query attention is not
an attention site and stays off ``ops/attention.py``.

Spans (``profiling.span``): ``tf.dit`` over a call, ``tf.dit_embed`` (patch
embedding, conditioning, pool, text projection and padding), one
``tf.block:<n>`` a block, inside it ``tf.skip``, ``tf.adaln``,
``tf.self_attn`` / ``tf.ext_attn`` / ``tf.propagation``, ``tf.cross_attn``,
``tf.ff``, and ``tf.rope`` (q/k norm and rotation) within the attentions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tokenflow_torch.kernels.layer_norm import layer_norm_rope_kernel
from tokenflow_torch.kernels.short_attention import KV_BLOCK
from tokenflow_torch.models.layers import (
    LayerNorm32,
    TimestepEmbedding,
    layer_norm_path,
    timestep_embedding,
)
from tokenflow_torch.ops import editctx
from tokenflow_torch.ops.attention import flash_attention, merge_heads
from tokenflow_torch.ops.extended_attention import extended_attention
from tokenflow_torch.ops.propagation import token_propagation
from tokenflow_torch.profiling import span

ROPE_THETA = 10000.0
# CUDA q/k transforms that took the plain norm and rotation (reset by
# callers): 0 on the bf16 paths, where the rotary K5 entry takes every call
plain_rope_on_cuda = 0


@dataclasses.dataclass(frozen=True)
class HunyuanDiTConfig:
    """The fields of diffusers' ``HunyuanDiT2DModel`` config.json that the
    model reads, and the pipeline's RoPE base grid."""

    in_channels: int = 4
    patch_size: int = 2
    hidden_size: int = 1408
    num_layers: int = 40
    num_attention_heads: int = 16
    mlp_ratio: float = 4.3637
    learn_sigma: bool = True
    cross_attention_dim: int = 1024
    cross_attention_dim_t5: int = 2048
    pooled_projection_dim: int = 1024
    text_len: int = 77
    text_len_t5: int = 256
    norm_eps: float = 1e-6
    # the pooler's heads, the sinusoids' width and the pipeline's RoPE base
    # grid (512 px / 8 / patch), fixed in diffusers' code
    pool_heads: int = 8
    time_proj_dim: int = 256
    rope_base: int = 32

    @staticmethod
    def hunyuan_dit_v12() -> "HunyuanDiTConfig":
        """Tencent-Hunyuan/HunyuanDiT-v1.2-Diffusers ``transformer/config.json``:
        1408 wide, 40 blocks of 16 heads of 88, FF 6144, CLIP 1024 and mT5
        2048 contexts, 8 output channels (learned sigma)."""
        return HunyuanDiTConfig()

    @staticmethod
    def tiny_dit() -> "HunyuanDiTConfig":
        """Small config for tests: 6 blocks (two long skips), 2 heads of 16,
        a 16-token T5 context."""
        return HunyuanDiTConfig(
            hidden_size=32, num_layers=6, num_attention_heads=2, mlp_ratio=2.0,
            cross_attention_dim=32, cross_attention_dim_t5=16, pooled_projection_dim=24,
            text_len_t5=16, pool_heads=2, time_proj_dim=32, rope_base=2)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ff_inner(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def out_channels(self) -> int:
        return 2 * self.in_channels if self.learn_sigma else self.in_channels


def block_site(n: int) -> str:
    """Block n's edit site (its cache key)."""
    return str(n)


def rope_tables(head_dim: int, grid_h: int, grid_w: int, base: int, device) -> tuple:
    """(cos, sin), each (grid_h * grid_w, head_dim) fp32: diffusers'
    ``get_2d_rotary_pos_embed(head_dim, crop, (grid_h, grid_w),
    use_real=True)`` with the crop region of the pipeline's base grid
    (``get_resize_crop_region_for_grid``). Token (i, j) sits at column
    position j * crop_w / grid_w and row position i * crop_h / grid_h; the
    first head_dim / 2 dims take the column, the rest the row, each with
    head_dim / 4 frequencies theta^(-2k / (head_dim / 2)) repeated twice."""
    if grid_h > grid_w:
        crop_h, crop_w = base, int(round(base / grid_h * grid_w))
    else:
        crop_w, crop_h = base, int(round(base / grid_w * grid_h))
    top, left = int(round((base - crop_h) / 2.0)), int(round((base - crop_w) / 2.0))
    rows = top + torch.arange(grid_h, dtype=torch.float32, device=device) * (crop_h / grid_h)
    cols = left + torch.arange(grid_w, dtype=torch.float32, device=device) * (crop_w / grid_w)
    half = head_dim // 2
    freqs = 1.0 / (ROPE_THETA ** (torch.arange(0, half, 2, dtype=torch.float32,
                                               device=device)[: half // 2] / half))
    pos_w = cols[None, :].expand(grid_h, grid_w).reshape(-1)
    pos_h = rows[:, None].expand(grid_h, grid_w).reshape(-1)
    angles = [torch.outer(p, freqs).repeat_interleave(2, dim=1) for p in (pos_w, pos_h)]
    return torch.cat([a.cos() for a in angles], 1), torch.cat([a.sin() for a in angles], 1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated on interleaved pairs in fp32 (diffusers'
    ``apply_rotary_emb``, ``use_real_unbind_dim=-1``): x cos + rot(x) sin,
    rot(x)_{2k, 2k+1} = (-x_{2k+1}, x_{2k}); returned in x's dtype."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    out = xf * cos[:, None, :]
    out.addcmul_(rot, sin[:, None, :])
    return out.to(x.dtype)


def norm_rope(norm: LayerNorm32, x: torch.Tensor, rope: tuple) -> torch.Tensor:
    """``apply_rope(norm(x), *rope)`` for x (B, S, H, D): where ``norm``
    would launch K5 (a bf16 CUDA tensor), the rotary K5 entry does both in
    one launch (``kernels/layer_norm.py::layer_norm_rope_kernel``, within 1
    bf16 step of the two); every other input takes the norm and
    :func:`apply_rope`, and a CUDA one is counted in ``plain_rope_on_cuda``."""
    global plain_rope_on_cuda
    if layer_norm_path(x.device, x.dtype) == "kernel":
        return layer_norm_rope_kernel(x, norm.weight, norm.bias, norm.eps, *rope)
    if x.is_cuda:
        plain_rope_on_cuda += 1
    return apply_rope(norm(x), *rope)


def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


class TextProjection(nn.Module):
    """diffusers' ``PixArtAlphaTextProjection`` with ``act_fn="silu_fp32"``:
    linear, SiLU computed in fp32, linear."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, hidden)
        self.linear_2 = nn.Linear(hidden, cout)

    def forward(self, x):
        return self.linear_2(_silu_f32(self.linear_1(x)))


class AttentionPool(nn.Module):
    """``HunyuanDiTAttentionPool``'s weights (q/k/v/c projections and the
    positional embedding of the mean token and the ``spacial_dim`` tokens)."""

    def __init__(self, spacial_dim: int, embed_dim: int, heads: int, output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x):
        return attention_pool(self, x)


def attention_pool(pool: AttentionPool, x: torch.Tensor) -> torch.Tensor:
    """(B, output_dim) in x's dtype: the tokens' mean joins them ahead,
    the positional embedding is added, and the mean's query attends over
    all L + 1 tokens (``F.multi_head_attention_forward`` with one query),
    products and softmax in fp32. Not an attention site: it stays off
    ``ops/attention.py``."""
    xf = x.float()
    xf = torch.cat([xf.mean(dim=1, keepdim=True), xf], dim=1)
    xf = xf + pool.positional_embedding.float()
    b, n, c = xf.shape
    d = c // pool.heads

    def proj(m, t):
        return F.linear(t, m.weight.float(), m.bias.float())

    q = proj(pool.q_proj, xf[:, :1]).reshape(b, pool.heads, d)
    k = proj(pool.k_proj, xf).reshape(b, n, pool.heads, d)
    v = proj(pool.v_proj, xf).reshape(b, n, pool.heads, d)
    p = torch.softmax(torch.einsum("bhd,bnhd->bhn", q, k) * d**-0.5, dim=-1)
    o = torch.einsum("bhn,bnhd->bhd", p, v).reshape(b, c)
    return proj(pool.c_proj, o).to(x.dtype)


class TimeTextEmbedding(nn.Module):
    """``HunyuanCombinedTimestepTextSizeStyleEmbedding`` without the style
    and image-size conditioning (v1.2): the timestep embedding plus the
    projected pool of the T5 states."""

    def __init__(self, cfg: HunyuanDiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.time_proj_dim = cfg.time_proj_dim
        self.timestep_embedder = TimestepEmbedding(cfg.time_proj_dim, h)
        self.pooler = AttentionPool(cfg.text_len_t5, cfg.cross_attention_dim_t5,
                                    cfg.pool_heads, cfg.pooled_projection_dim)
        self.extra_embedder = TextProjection(cfg.pooled_projection_dim, 4 * h, h)

    def forward(self, timesteps: torch.Tensor, t5: torch.Tensor) -> torch.Tensor:
        proj = timestep_embedding(timesteps, self.time_proj_dim, flip_sin_to_cos=True,
                                  freq_shift=0.0)
        temb = self.timestep_embedder(proj)
        return temb + self.extra_embedder(self.pooler(t5).to(temb.dtype))


class AdaLayerNormShift(nn.Module):
    """``norm1``: LayerNorm(x) + linear(SiLU(temb) in fp32)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.linear = nn.Linear(dim, dim)
        self.norm = LayerNorm32(dim, eps=eps)

    def forward(self, x, temb):
        shift = self.linear(_silu_f32(temb))
        return self.norm(x) + shift[:, None]


class DiTAttention(nn.Module):
    """diffusers' ``Attention`` with biased projections, ``qk_norm``
    "layer_norm" (per-head LayerNorm of q and k, eps 1e-6) and RoPE, as
    ``HunyuanAttnProcessor2_0`` runs it. The projections, the q/k transform
    and the output are separate entry points, so the edit works between
    them."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        d = dim // heads
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(context_dim or dim, dim)
        self.to_v = nn.Linear(context_dim or dim, dim)
        self.norm_q = LayerNorm32(d, eps=1e-6)
        self.norm_k = LayerNorm32(d, eps=1e-6)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def qkv(self, x, context=None):
        """q, k, v (B, S, H, D); q and k normed per head, q rotated, and k
        too for self attention (``context`` None)."""
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, h = x.shape[0], self.heads
        q, k, v = (t.reshape(b, t.shape[1], h, -1) for t in (q, k, v))
        return q, k, v

    def qk_transform(self, q, k, rope, rotate_k: bool):
        """The per-head norms of q and k, then RoPE on q (and on k when
        ``rotate_k``); (B, S, H, D) in, (B, S, H, D) out. A k left unrotated
        takes ``norm_k`` alone."""
        with span("tf.rope"):
            q = norm_rope(self.norm_q, q, rope)
            k = norm_rope(self.norm_k, k, rope) if rotate_k else self.norm_k(k)
        return q, k

    def out(self, o):
        return self.to_out[0](o)

    def forward(self, x, rope, context=None):
        q, k, v = self.qkv(x, context)
        q, k = self.qk_transform(q, k, rope, rotate_k=context is None)
        o = flash_attention(q, k, v, kv_block=KV_BLOCK)
        return self.out(merge_heads(o))


class FeedForward(nn.Module):
    """Linear, tanh-GELU, linear; diffusers keys ff.net.0.proj, ff.net.2."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(dim, inner)
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class HunyuanDiTBlock(nn.Module):
    """One block with the TokenFlow edit modes of ``BasicTransformerBlock``
    NONE, PIVOTAL and PROPAGATE (the model refuses FUSED)."""

    def __init__(self, cfg: HunyuanDiTConfig, n: int):
        super().__init__()
        dim, heads, eps = cfg.hidden_size, cfg.num_attention_heads, cfg.norm_eps
        self.site = block_site(n)
        self.span_name = f"tf.block:{self.site}"
        self.norm1 = AdaLayerNormShift(dim, eps)
        self.attn1 = DiTAttention(dim, heads)
        self.norm2 = LayerNorm32(dim, eps=eps)
        self.attn2 = DiTAttention(dim, heads, cfg.cross_attention_dim)
        self.norm3 = LayerNorm32(dim, eps=eps)
        self.ff = FeedForward(dim, cfg.ff_inner)
        if n > cfg.num_layers // 2:
            self.skip_norm = LayerNorm32(2 * dim, eps=eps)
            self.skip_linear = nn.Linear(2 * dim, dim)
        else:
            self.skip_linear = None

    def _keyframe_attention(self, hp, rope, edit: editctx.BlockEdit) -> torch.Tensor:
        """attn1 over the keyframes' normed states ``hp`` (ns, K, S, C):
        every frame's q and k normed and rotated by its own grid, then the
        extended attention of the shared code, through ``to_out``:
        kf_attn (ns, K, S, C)."""
        ns, kf, s, dim = hp.shape
        a = self.attn1
        q, k, v = a.qkv(hp.reshape(ns * kf, s, dim))
        q, k = a.qk_transform(q, k, rope, rotate_k=True)
        q3, k3, v3 = (t.reshape(ns, kf, s, dim) for t in (q, k, v))
        o3 = extended_attention(q3, k3, v3, heads=a.heads, kv_block=KV_BLOCK,
                                group=edit.group, kf_counts=edit.kf_counts)
        return a.out(o3.reshape(ns * kf, s, dim)).reshape(ns, kf, s, dim)

    def forward(self, x, temb, context, rope, edit: Optional[editctx.BlockEdit] = None,
                skip: Optional[torch.Tensor] = None):
        cache = None
        if self.skip_linear is not None:
            with span("tf.skip"):
                x = self.skip_linear(self.skip_norm(torch.cat([x, skip], dim=-1)))
        b, s, dim = x.shape
        with span("tf.adaln"):
            h = self.norm1(x, temb)
        mode = editctx.EditMode.NONE if edit is None else edit.mode
        if mode == editctx.EditMode.NONE:
            with span("tf.self_attn"):
                attn_out = self.attn1(h, rope)
        elif mode == editctx.EditMode.PIVOTAL:
            h3 = h.reshape(edit.n_frames, edit.n_streams, s, dim)
            with span("tf.ext_attn"):
                kf_attn = self._keyframe_attention(h3.transpose(0, 1), rope, edit)
                attn_out = kf_attn.transpose(0, 1).reshape(b, s, dim)
            cache = {"pivot_h": h3[:, 0], "kf_attn": kf_attn}
        elif mode == editctx.EditMode.PROPAGATE:
            f, ns = edit.n_frames, edit.n_streams
            with span("tf.propagation"):
                o3 = token_propagation(h.reshape(f, ns, s, dim)[:, 0], edit.pivot_h,
                                       edit.kf_attn, edit.prop_pa, edit.prop_pb, edit.prop_w1)
                attn_out = o3.transpose(0, 1).reshape(b, s, dim).to(x.dtype)
        else:
            raise ValueError(f"unknown edit mode {mode!r}")
        x = x + attn_out
        with span("tf.cross_attn"):
            x = x + self.attn2(self.norm2(x), rope, context)
        with span("tf.ff"):
            x = x + self.ff(self.norm3(x))
        return x, cache


class AdaLayerNormContinuous(nn.Module):
    """``norm_out``: LayerNorm without affine, x (1 + scale) + shift, with
    (scale, shift) = linear(SiLU(temb) in fp32)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, temb):
        scale, shift = self.linear(_silu_f32(temb)).chunk(2, dim=1)
        c = x.shape[-1]
        norm = LayerNorm32(c, eps=self.eps, device=x.device, dtype=x.dtype)
        return norm(x) * (1 + scale)[:, None] + shift[:, None]


class HunyuanDiT2DModel(nn.Module):
    def __init__(self, config: HunyuanDiTConfig):
        super().__init__()
        cfg = self.config = config
        h = cfg.hidden_size
        self.pos_embed = nn.Module()
        self.pos_embed.proj = nn.Conv2d(cfg.in_channels, h, cfg.patch_size,
                                        stride=cfg.patch_size)
        self.time_extra_emb = TimeTextEmbedding(cfg)
        self.text_embedder = TextProjection(cfg.cross_attention_dim_t5,
                                            4 * cfg.cross_attention_dim_t5,
                                            cfg.cross_attention_dim)
        self.text_embedding_padding = nn.Parameter(
            torch.empty(cfg.text_len + cfg.text_len_t5, cfg.cross_attention_dim))
        self.blocks = nn.ModuleList([HunyuanDiTBlock(cfg, n)
                                     for n in range(cfg.num_layers)])
        self.norm_out = AdaLayerNormContinuous(h, cfg.norm_eps)
        self.proj_out = nn.Linear(h, cfg.patch_size**2 * cfg.out_channels)
        self._rope: dict = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype

    def rope(self, grid_h: int, grid_w: int, device) -> tuple:
        key = (grid_h, grid_w, str(device))
        if key not in self._rope:
            self._rope[key] = rope_tables(self.config.head_dim, grid_h, grid_w,
                                          self.config.rope_base, device)
        return self._rope[key]

    def embed(self, sample, timesteps, encoder_hidden_states, added_cond: dict):
        """(tokens (B, S, C), temb (B, C), context (B, 333, 1024)) of a call."""
        cfg, dtype = self.config, self.dtype
        b = sample.shape[0]
        x = self.pos_embed.proj(sample.to(dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        t = torch.as_tensor(timesteps, device=sample.device)
        t = t.expand(b) if t.dim() == 0 else t
        t5 = added_cond["encoder_hidden_states_t5"].to(dtype)
        temb = self.time_extra_emb(t, t5)
        ctx = torch.cat([encoder_hidden_states.to(dtype), self.text_embedder(t5)], dim=1)
        mask = torch.cat([added_cond["text_embedding_mask"],
                          added_cond["text_embedding_mask_t5"]], dim=-1).bool()
        ctx = torch.where(mask[..., None], ctx, self.text_embedding_padding.to(dtype))
        if ctx.shape[1] != cfg.text_len + cfg.text_len_t5:
            raise ValueError(f"context of {ctx.shape[1]} tokens; the padding holds "
                             f"{cfg.text_len + cfg.text_len_t5}")
        return x, temb, ctx

    def forward(
        self,
        sample: torch.Tensor,  # (B, H, W, C_in) NHWC
        timesteps,  # int, 0-dim or (B,) tensor
        encoder_hidden_states: torch.Tensor,  # (B, 77, 1024) CLIP states
        edit: Optional[editctx.UNetEdit] = None,
        down_block_residuals=None,
        mid_block_residual=None,
        added_cond: Optional[dict] = None,  # T5 states (B, 256, 2048) and both masks
    ):
        """Returns (the v output (B, H, W, C_in) NHWC, cache {site: entry})."""
        with span("tf.dit"):
            edit = edit or editctx.UNetEdit()
            if edit.pnp:
                raise ValueError("PnP is not defined on the DiT: its injection sites are SD's "
                                 "four-level UNet up path; edit HunyuanDiT with SDEdit")
            if down_block_residuals is not None or mid_block_residual is not None:
                raise ValueError("there is no HunyuanDiT ControlNet here")
            if edit.mode == editctx.EditMode.FUSED:
                raise NotImplementedError("the DiT runs the edit's two passes; fused_step "
                                          "is not defined on it")
            if added_cond is None:
                raise ValueError("HunyuanDiT needs added_cond: encoder_hidden_states_t5, "
                                 "text_embedding_mask and text_embedding_mask_t5")
            cfg = self.config
            p = cfg.patch_size
            bsz, hh, ww, _ = sample.shape
            gh, gw = hh // p, ww // p
            with span("tf.dit_embed"):
                x, temb, ctx = self.embed(sample, timesteps, encoder_hidden_states, added_cond)
            rope = self.rope(gh, gw, sample.device)
            cache: dict = {}
            skips = []
            half = cfg.num_layers // 2
            for n, block in enumerate(self.blocks):
                with span(block.span_name):
                    x, entry = block(x, temb, ctx, rope, edit.for_site(block.site),
                                     skips.pop() if n > half else None)
                if entry is not None:
                    cache[block.site] = entry
                if n < half - 1:
                    skips.append(x)
            x = self.norm_out(x, temb)
            x = self.proj_out(x)
            c = cfg.out_channels
            out = x.reshape(bsz, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(bsz, hh, ww, c)[..., : cfg.in_channels]
            if edit.mode == editctx.EditMode.PIVOTAL:
                editctx.count_cache(cache)
            return out, cache
