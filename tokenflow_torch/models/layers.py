"""Shared building blocks of the SD UNet and VAE (PyTorch).

Counterpart of ``tokenflow_tpu/models/layers.py``. Module attribute names
follow the diffusers state-dict keys, so a diffusers checkpoint loads with
``load_state_dict``. Public tensors keep the JAX package's layouts where
editing code reads them: attention tokens are (B, S, C) with S in (h, w)
row-major order; convolutions run on NCHW tensors inside the UNet/VAE.

Dtype policy (as in JAX): weights and activations in the stack dtype (bf16
on the GPU), normalization statistics and attention logits in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tokenflow_torch.kernels.group_norm import group_norm_kernel, group_norm_plain
from tokenflow_torch.ops import editctx
from tokenflow_torch.ops.attention import flash_attention, merge_heads, split_heads
from tokenflow_torch.ops.extended_attention import extended_attention, inject_source_qk
from tokenflow_torch.ops.propagation import token_propagation, token_propagation_sharded


class FusedGroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics and an optional fused SiLU, cast back
    to the input dtype: the JAX FusedGroupNorm
    (tokenflow_tpu/models/layers.py:91-109).

    ``use_kernel`` (default off, set by ``runtime.load_stack``) is the
    counterpart of the JAX opt-in ``TOKENFLOW_PALLAS_GN=1``. Off: the
    ``F.group_norm`` path, the counterpart of the JAX default flax
    GroupNorm. On: K4 (``kernels/group_norm.py``) for CUDA tensors and its
    plain version (fp32 ``E[x^2] - E[x]^2``) for CPU tensors."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__(num_groups, num_channels, eps=eps)
        self.act = act
        self.use_kernel = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernel:
            if x.is_cuda:
                norm = group_norm_kernel
            elif x.device.type == "cpu":
                norm = group_norm_plain
            else:
                raise ValueError(f"no GroupNorm path for device {x.device}")
            return norm(x, self.weight, self.bias, self.num_groups, self.eps, self.act)
        y = F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(),
            self.eps,
        )
        if self.act == "silu":
            y = F.silu(y)
        return y.to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32, returned in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )
        return y.to(x.dtype)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """t_emb -> Linear -> silu -> Linear (the UNet's time_embedding)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.linear_1(t_emb.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(h))


class Attention(nn.Module):
    """Multi-head attention with separate projection and output entry
    points, so editing code can operate between them."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, kv_block: int = 1024):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.kv_block = kv_block
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def qkv(self, x, context=None):
        context = x if context is None else context
        return self.to_q(x), self.to_k(context), self.to_v(context)

    def out(self, attn_out):
        return self.to_out[0](attn_out)

    def forward(self, x, context=None):
        q, k, v = self.qkv(x, context)
        o = flash_attention(
            split_heads(q, self.heads), split_heads(k, self.heads),
            split_heads(v, self.heads), kv_block=self.kv_block,
        )
        return self.out(merge_heads(o))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU


class GEGLUFeedForward(nn.Module):
    """Linear(8d) -> split -> x * gelu(gate) -> Linear(d); diffusers keys
    ff.net.0.proj and ff.net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)]
        )

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """Self-attention + cross-attention + GEGLU FF with the TokenFlow edit
    modes (tokenflow_tpu/models/layers.py:244-348):
      NONE      standard self-attention;
      PIVOTAL   keyframe extended attention (+ PnP q/k injection); returns
                the site cache {pivot_h (K,S,C), kf_attn (ns,K,S,C)}, and
                pivot_h_uncond (K,S,C) when the directive asks for it;
      PROPAGATE self-attention replaced by the NN gather from the cache;
      FUSED     both in one batch [3K pivots | 3F frames]: the pivots run
                PIVOTAL's extended attention into this site's cache, and
                the frames propagate from it at once; returns no cache.
    The stream count of PIVOTAL and PROPAGATE comes from the directive: 3
    ([source|uncond|cond]) or 2 ([uncond|cond], a source-free pass); FUSED
    is three-stream.
    """

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 kv_block: int = 1024):
        super().__init__()
        self.heads = heads
        self.kv_block = kv_block
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, kv_block=kv_block)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, context_dim, kv_block=kv_block)
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def _keyframe_attention(self, hp, edit: editctx.BlockEdit, group=None,
                            kf_counts=None) -> torch.Tensor:
        """Extended attention of the keyframes' normed states ``hp`` (ns, K,
        S, C), with the PnP q/k injection, through the output projection:
        kf_attn (ns, K, S, C). Projected stream-major, so kf_attn is
        contiguous and its [1:] view reaches the match kernels uncopied."""
        ns, kf, s, dim = hp.shape
        q, k, v = self.attn1.qkv(hp.reshape(ns * kf, s, dim))
        q3, k3, v3 = (t.reshape(ns, kf, s, t.shape[-1]) for t in (q, k, v))
        if edit.qk_inject_site:
            q3, k3 = inject_source_qk(q3, k3, edit.qk_gate)
        o3 = extended_attention(q3, k3, v3, heads=self.heads, kv_block=self.kv_block,
                                group=group, kf_counts=kf_counts)
        return self.attn1.out(o3.reshape(ns * kf, s, o3.shape[-1])).reshape(ns, kf, s, dim)

    def forward(self, x, context, edit: Optional[editctx.BlockEdit] = None):
        b, s, dim = x.shape
        cache = None
        h_norm = self.norm1(x)
        mode = editctx.EditMode.NONE if edit is None else edit.mode
        if mode == editctx.EditMode.NONE:
            attn_out = self.attn1(h_norm)
        elif mode == editctx.EditMode.PIVOTAL:
            h3 = h_norm.reshape(edit.n_frames, edit.n_streams, s, dim)
            kf_attn = self._keyframe_attention(h3.transpose(0, 1), edit, edit.group,
                                               edit.kf_counts)
            attn_out = kf_attn.transpose(0, 1).reshape(b, s, dim)
            cache = {
                # stream 0's normed states drive the NN matching: the source
                # stream (reference pivot_hidden_states[0],
                # tokenflow_utils.py:335), or uncond in a source-free pass
                "pivot_h": h3[:, 0],
                "kf_attn": kf_attn,
            }
            if edit.cache_uncond:
                # the approximate propagation pass's matching table
                cache["pivot_h_uncond"] = h3[:, 1]
        elif mode == editctx.EditMode.PROPAGATE:
            f, ns = edit.n_frames, edit.n_streams
            propagate = token_propagation if edit.group is None else token_propagation_sharded
            o3 = propagate(
                h_norm.reshape(f, ns, s, dim)[:, 0],
                edit.pivot_h, edit.kf_attn,
                edit.prop_pa, edit.prop_pb, edit.prop_w1,
            )
            attn_out = o3.transpose(0, 1).reshape(b, s, dim).to(x.dtype)
        elif mode == editctx.EditMode.FUSED:
            # tokenflow_tpu/models/layers.py:313-341; each segment frame-major
            kf, f = edit.n_pivots, edit.n_frames
            h3 = h_norm.reshape(kf + f, 3, s, dim)
            hp = h3[:kf].transpose(0, 1)  # (3, K, S, C) view
            # every rank of a group holds all the keyframes: no K/V gather
            kf_attn = self._keyframe_attention(hp, edit)
            propagate = token_propagation if edit.group is None else token_propagation_sharded
            oq = propagate(h3[kf:, 0], hp[0], kf_attn,
                           edit.prop_pa, edit.prop_pb, edit.prop_w1)
            attn_out = torch.cat([
                kf_attn.transpose(0, 1).reshape(3 * kf, s, dim),
                oq.transpose(0, 1).reshape(3 * f, s, dim).to(x.dtype),
            ])
        else:
            raise ValueError(f"unknown edit mode {mode!r}")
        x = x + attn_out
        x = x + self.attn2(self.norm2(x), context)
        x = x + self.ff(self.norm3(x))
        return x, cache


class Transformer2DModel(nn.Module):
    """GroupNorm -> proj_in -> BasicTransformerBlock -> proj_out + residual;
    Linear projections (SD-2.x) or 1x1 convs (SD-1.5)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 use_linear_projection: bool = True, kv_block: int = 1024):
        super().__init__()
        inner = heads * dim_head
        self.linear = use_linear_projection
        self.norm = FusedGroupNorm(32, channels, eps=1e-6)
        if self.linear:
            self.proj_in = nn.Linear(channels, inner)
            self.proj_out = nn.Linear(inner, channels)
        else:
            self.proj_in = nn.Conv2d(channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim, kv_block)]
        )

    def forward(self, x, context, edit: Optional[editctx.BlockEdit] = None):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h)
            h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, h.shape[1])
        h, cache = self.transformer_blocks[0](h, context, edit)
        if self.linear:
            h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, h.shape[-1]).permute(0, 3, 1, 2))
        return h + x, cache


class ResnetBlock2D(nn.Module):
    """GN-silu-conv twice with the additive time embedding, and the PnP
    feature injection after conv2 (reference tokenflow_utils.py:86-91: the
    uncond/cond streams take the source stream; the shortcut is not
    injected). With an edit directive the call returns ``(out, cache)``, as
    the JAX block does (tokenflow_tpu/models/layers.py:440-467): ``cache``
    is ``{"conv_src": (K, c, h, w)}`` in an approximate PIVOTAL pass, else
    None; the approximate PROPAGATE pass, source-free, injects the pa/pb
    blend of those cached pivot features, computed in fp32."""

    def __init__(self, in_channels: int, out_channels: int, eps: float = 1e-5,
                 groups: int = 32, temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = FusedGroupNorm(groups, in_channels, eps=eps, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = FusedGroupNorm(groups, out_channels, eps=eps, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb=None, edit: Optional[editctx.ConvEdit] = None):
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        cache = None
        if edit is not None:
            # frame-major batch: (f, ns, ...) view, stream axis 1
            h3 = h.reshape(edit.n_frames, edit.n_streams, *h.shape[1:])
            if edit.approx and edit.mode == editctx.EditMode.PROPAGATE:
                src = None
                if edit.gate:
                    w = edit.prop_w1.float()[:, None, None, None]
                    table = edit.src_cache
                    src = (w * table[edit.prop_pa.long()].float()
                           + (1.0 - w) * table[edit.prop_pb.long()].float()).to(h.dtype)
                    src = src[:, None]
            else:
                src = h3[:, :1] if edit.gate else None
                if edit.approx and edit.mode == editctx.EditMode.PIVOTAL:
                    cache = {"conv_src": h3[:, 0]}
            if src is not None:
                h = src.expand_as(h3).reshape(h.shape)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        out = x + h
        return out if edit is None else (out, cache)


class Downsample2D(nn.Module):
    """3x3 stride-2 conv; ``asymmetric_pad`` is the VAE encoder's (0,1,0,1)
    padding, the UNet pads 1 on every side."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(
            channels, channels, 3, stride=2, padding=0 if asymmetric_pad else 1
        )

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
