"""SD conditional UNet (PyTorch), the counterpart of
``tokenflow_tpu/models/unet2d.py``.

Public layout is NHWC in and out, as in JAX; the body runs NCHW. Module
names follow diffusers' ``UNet2DConditionModel`` state-dict keys. The edit
directive (:class:`tokenflow_torch.ops.editctx.UNetEdit`) fans out to the
self-attention sites by name (``down_{i}_{j}``, ``mid``, ``up_{i}_{j}``) and
the PIVOTAL pass returns the per-site cache (with the PnP conv site's
``conv_src`` entry under approximate propagation). ControlNet residuals
(``down_block_residuals``, ``mid_block_residual``) are added to the skips
and to the mid block's output, as diffusers' UNet adds them.

SD-XL (``UNet2DConfig.sdxl_base``) is the same UNet with three levels, no
attention at the first, ``transformer_layers`` blocks at each attention
site of a level (1, 2 and 10: 70 blocks a call) and the "text_time" added
conditioning: ``forward``'s ``added_cond`` (the pooled text embedding and
six size and crop ids) goes through ``add_time_proj`` and ``add_embedding``
and is added to the time embedding. Each block is an edit site of its own:
a site of one block keeps its name, block n of a deeper site is
``<site>.<n>`` (``layers.block_sites``). PnP's injection sites are SD's
four-level up path, so a PnP directive on another layout raises.

Spans (``profiling.span``): ``tf.unet`` over a call, and one per block
under its site's name, fixed when the model is built:
``tf.resnet:down_{i}_res_{j}``, ``tf.resnet:mid_res_{j}``,
``tf.resnet:up_{i}_res_{j}`` (with its skip concatenation),
``tf.transformer:down_{i}_{j}``, ``tf.transformer:mid``,
``tf.transformer:up_{i}_{j}`` (around all of a site's blocks), and
``tf.add_embed`` over SD-XL's added conditioning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from tokenflow_torch.models.layers import (
    Downsample2D,
    FusedGroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Timesteps,
    Transformer2DModel,
    Upsample2D,
    nchw_body,
    timestep_embedding,
)
from tokenflow_torch.ops import editctx
from tokenflow_torch.profiling import span


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # per-level head counts (diffusers' ``attention_head_dim``): SD-2.x
    # (5, 10, 20, 20) -> head dim 64
    num_heads: Sequence[int] = (5, 10, 20, 20)
    use_linear_projection: bool = True
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    attn_down: Sequence[bool] = (True, True, True, False)
    attn_up: Sequence[bool] = (False, True, True, True)
    # transformer blocks at each attention site of a level (diffusers'
    # ``transformer_layers_per_block``; the mid block takes the last
    # level's); None: one at every level
    transformer_layers: Optional[Sequence[int]] = None
    # SD-XL's "text_time" added conditioning: the sinusoids' width for each
    # of the six time ids, and the add embedding's input width (the pooled
    # text embedding's and 6 x that); 0: none (SD)
    addition_time_embed_dim: int = 0
    projection_class_embeddings_input_dim: int = 0

    @staticmethod
    def sd21_base() -> "UNet2DConfig":
        return UNet2DConfig()

    @staticmethod
    def sd21_depth() -> "UNet2DConfig":
        """stabilityai/stable-diffusion-2-depth: SD-2.1 with 5 input channels
        (4 latent channels and the depth map); eps keeps 4."""
        return UNet2DConfig(in_channels=5)

    @staticmethod
    def sd15() -> "UNet2DConfig":
        """SD-1.5: 8 heads at every level (head dims 40, 80, 160), 1x1-conv
        projections, CLIP ViT-L context."""
        return UNet2DConfig(
            cross_attention_dim=768,
            num_heads=(8, 8, 8, 8),
            use_linear_projection=False,
        )

    @staticmethod
    def tiny(cross_attention_dim: int = 32) -> "UNet2DConfig":
        """Small config for tests: same topology, 2 resolutions."""
        return UNet2DConfig(
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attention_dim=cross_attention_dim,
            num_heads=(2, 4),
            attn_down=(True, False),
            attn_up=(False, True),
        )

    @staticmethod
    def sdxl_base() -> "UNet2DConfig":
        """stabilityai/stable-diffusion-xl-base-1.0 ``unet/config.json``: 320,
        640 and 1280 channels, head dim 64, no attention at level 0, 1, 2
        and 10 blocks a site, context 2048 (CLIP-L and OpenCLIP-bigG), the
        text-time embedding (2816 = 1280 + 6 x 256 inputs)."""
        return UNet2DConfig(
            block_out_channels=(320, 640, 1280),
            cross_attention_dim=2048,
            num_heads=(5, 10, 20),
            attn_down=(False, True, True),
            attn_up=(True, True, False),
            transformer_layers=(1, 2, 10),
            addition_time_embed_dim=256,
            projection_class_embeddings_input_dim=2816,
        )

    @staticmethod
    def tiny_xl() -> "UNet2DConfig":
        """Small SD-XL layout for tests: three levels, level 0 without
        attention, 1, 2 and 3 blocks a site, the text-time embedding over a
        32-wide pooled embedding and 8-wide sinusoids."""
        return UNet2DConfig(
            block_out_channels=(32, 64, 64),
            layers_per_block=1,
            cross_attention_dim=32,
            num_heads=(2, 2, 4),
            attn_down=(False, True, True),
            attn_up=(True, True, False),
            transformer_layers=(1, 2, 3),
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=32 + 6 * 8,
        )

    def head_dim(self, level: int) -> int:
        return self.block_out_channels[level] // self.num_heads[level]

    def depth(self, level: int) -> int:
        """Transformer blocks at each attention site of ``level``."""
        return 1 if self.transformer_layers is None else self.transformer_layers[level]

    @property
    def pnp_defined(self) -> bool:
        """PnP's injection sites (``editctx.QK_INJECT_SITES``,
        ``CONV_INJECT_SITE``) are SD's: one block a site, no added
        conditioning."""
        return (not self.addition_time_embed_dim
                and all(self.depth(i) == 1 for i in range(len(self.block_out_channels))))


def _named(block: nn.Module, kind: str, site: str) -> nn.Module:
    """``block`` with the name of the span its caller opens around it."""
    block.span_name = f"tf.{kind}:{site}"
    return block


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A residual from the NHWC public layout into the body's NCHW."""
    return x.to(dtype).permute(0, 3, 1, 2)


class _Block(nn.Module):
    """A down/mid/up block: ``resnets``, optional ``attentions`` and an
    optional down/upsampler, under diffusers' names."""

    def __init__(self, resnets, attentions=(), downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNetParts:
    """The UNet's block constructors for one config (shared with
    :class:`tokenflow_torch.models.controlnet.ControlNetModel`, whose
    encoder half has the same modules under the same names)."""

    def __init__(self, cfg: UNet2DConfig, kv_block: int):
        self.cfg, self.kv_block = cfg, kv_block
        self.chans = list(cfg.block_out_channels)
        self.temb = self.chans[0] * 4

    def resnet(self, cin: int, cout: int) -> ResnetBlock2D:
        return ResnetBlock2D(cin, cout, eps=self.cfg.norm_eps, temb_channels=self.temb)

    def attn(self, level: int, site: str) -> Transformer2DModel:
        """The attention site ``site`` of ``level``, with its span's name."""
        cfg = self.cfg
        return _named(Transformer2DModel(
            self.chans[level], cfg.num_heads[level], cfg.head_dim(level),
            cfg.cross_attention_dim, cfg.use_linear_projection, self.kv_block,
            n_blocks=cfg.depth(level), site=site,
        ), "transformer", site)

    def stem(self) -> tuple[nn.Conv2d, TimestepEmbedding]:
        """conv_in and time_embedding."""
        c0 = self.chans[0]
        return nn.Conv2d(self.cfg.in_channels, c0, 3, padding=1), TimestepEmbedding(c0, self.temb)

    def down_blocks(self) -> tuple[nn.ModuleList, list[int]]:
        """The down blocks and the channels of the skips they leave (conv_in's
        output first)."""
        cfg, chans = self.cfg, self.chans
        cin, skips = chans[0], [chans[0]]
        down = []
        for i, ch in enumerate(chans):
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(_named(self.resnet(cin, ch), "resnet", f"down_{i}_res_{j}"))
                cin = ch
                if cfg.attn_down[i]:
                    attns.append(self.attn(i, f"down_{i}_{j}"))
                skips.append(ch)
            ds = Downsample2D(ch) if i < len(chans) - 1 else None
            if ds is not None:
                skips.append(ch)
            down.append(_Block(resnets, attns, downsample=ds))
        return nn.ModuleList(down), skips

    def mid_block(self) -> _Block:
        c = self.chans[-1]
        resnets = [_named(self.resnet(c, c), "resnet", f"mid_res_{j}") for j in range(2)]
        return _Block(resnets, [self.attn(len(self.chans) - 1, "mid")])


def embed_timesteps(cfg: UNet2DConfig, time_embedding: TimestepEmbedding, timesteps,
                    b: int, device) -> torch.Tensor:
    """Sinusoidal embedding of an int, 0-dim or (B,) timestep through the
    time MLP -> (B, 4 C0)."""
    t = torch.as_tensor(timesteps, device=device)
    if t.dim() == 0:
        t = t.expand(b)
    return time_embedding(
        timestep_embedding(
            t, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
        )
    )


def down_pass(blocks: nn.ModuleList, h, temb, context, edit: Optional[editctx.UNetEdit],
              cache: dict) -> tuple[torch.Tensor, list]:
    """The down blocks on conv_in's output h (NCHW) -> (h, skips), filling
    ``cache`` with the PIVOTAL entries of their edit sites; ``edit`` None
    runs plain self-attention (the ControlNet's encoder)."""
    skips = [h]
    for i, block in enumerate(blocks):
        for j, res in enumerate(block.resnets):
            with span(res.span_name):
                h = res(h, temb)
            if len(block.attentions):
                attn = block.attentions[j]
                with span(attn.span_name):
                    h, c = attn(h, context, edit)
                cache.update(c)
            skips.append(h)
        if hasattr(block, "downsamplers"):
            h = block.downsamplers[0](h)
            skips.append(h)
    return h, skips


def mid_pass(mid: _Block, h, temb, context, edit: Optional[editctx.UNetEdit], cache: dict):
    res0, res1, attn = mid.resnets[0], mid.resnets[1], mid.attentions[0]
    with span(res0.span_name):
        h = res0(h, temb)
    with span(attn.span_name):
        h, c = attn(h, context, edit)
    cache.update(c)
    with span(res1.span_name):
        return res1(h, temb)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNet2DConfig, kv_block: int = 1024):
        super().__init__()
        cfg = self.config = config
        parts = UNetParts(cfg, kv_block)
        chans = parts.chans
        n = len(chans)

        self.conv_in, self.time_embedding = parts.stem()
        if cfg.addition_time_embed_dim:
            self.add_time_proj = Timesteps(cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
                                           cfg.freq_shift)
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   parts.temb)
        self.down_blocks, skips = parts.down_blocks()
        self.mid_block = parts.mid_block()

        cin = chans[-1]
        rev = chans[::-1]
        up = []
        for i in range(n):
            level = n - 1 - i
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(_named(parts.resnet(cin + skips.pop(), rev[i]), "resnet",
                                      f"up_{i}_res_{j}"))
                cin = rev[i]
                if cfg.attn_up[i]:
                    attns.append(parts.attn(level, f"up_{i}_{j}"))
            us = Upsample2D(rev[i]) if i < n - 1 else None
            up.append(_Block(resnets, attns, upsample=us))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = FusedGroupNorm(32, chans[0], eps=cfg.norm_eps, act="silu")
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def add_embed(self, added_cond: Optional[dict], b: int) -> Optional[torch.Tensor]:
        """SD-XL's added conditioning (``text_embeds`` (B, P), ``time_ids``
        (B, 6)) -> (B, 4 C0): ``add_embedding`` of the pooled text and each
        id's sinusoids, concatenated (diffusers' "text_time"); None for a
        UNet without it. Either side missing what the other has raises."""
        if not self.config.addition_time_embed_dim:
            if added_cond is not None:
                raise ValueError("added_cond given to a UNet without added conditioning")
            return None
        if added_cond is None:
            raise ValueError("this UNet (SD-XL) needs added_cond: text_embeds and time_ids")
        with span("tf.add_embed"):
            text, ids = added_cond["text_embeds"], added_cond["time_ids"]
            if text.shape[0] != b or ids.shape[0] != b:
                raise ValueError(f"added_cond rows {text.shape[0]}, {ids.shape[0]} "
                                 f"for a batch of {b}")
            t_ids = self.add_time_proj(ids.flatten()).reshape(b, -1)
            return self.add_embedding(torch.cat([text.to(t_ids.dtype), t_ids], dim=-1))

    def forward(
        self,
        sample: torch.Tensor,  # (B, H, W, C_in) NHWC
        timesteps,  # int, 0-dim or (B,) tensor
        encoder_hidden_states: torch.Tensor,  # (B, 77, cross_dim)
        edit: Optional[editctx.UNetEdit] = None,
        down_block_residuals: Optional[Sequence[torch.Tensor]] = None,  # NHWC
        mid_block_residual: Optional[torch.Tensor] = None,  # NHWC
        added_cond: Optional[dict] = None,  # SD-XL: text_embeds (B, P), time_ids (B, 6)
    ):
        """Returns (eps (B, H, W, C_out) NHWC, cache {site: entry})."""
        with span("tf.unet"):
            edit = edit or editctx.UNetEdit()
            if edit.pnp and not self.config.pnp_defined:
                raise ValueError(
                    "PnP is not defined on this UNet: its injection sites are SD's "
                    "four-level up path with one transformer block a site "
                    "(tokenflow_utils.py:102, 208-214); edit SD-XL with SDEdit")
            dtype = self.dtype
            context = encoder_hidden_states.to(dtype)
            cache: dict = {}
            b = sample.shape[0]
            temb = embed_timesteps(self.config, self.time_embedding, timesteps, b, sample.device)
            added = self.add_embed(added_cond, b)
            if added is not None:
                temb = temb + added

            h = self.conv_in(nchw_body(sample.to(dtype)))
            h, skips = down_pass(self.down_blocks, h, temb, context, edit, cache)
            if down_block_residuals is not None:
                skips = [s + _nchw(r, dtype) for s, r in zip(skips, down_block_residuals)]
            h = mid_pass(self.mid_block, h, temb, context, edit, cache)
            if mid_block_residual is not None:
                h = h + _nchw(mid_block_residual, dtype)

            for i, block in enumerate(self.up_blocks):
                for j, res in enumerate(block.resnets):
                    conv_site = f"up_{i}_res_{j}"
                    conv_edit = edit.for_conv(conv_site)
                    with span(res.span_name):
                        h = torch.cat([h, skips.pop()], dim=1)
                        if conv_edit is None:
                            h = res(h, temb)
                        else:
                            h, c = res(h, temb, conv_edit)
                            if c is not None:
                                cache[conv_site] = c
                    if len(block.attentions):
                        attn = block.attentions[j]
                        with span(attn.span_name):
                            h, c = attn(h, context, edit)
                        cache.update(c)
                if hasattr(block, "upsamplers"):
                    h = block.upsamplers[0](h)

            eps = self.conv_out(self.conv_norm_out(h))
            if edit.mode == editctx.EditMode.PIVOTAL:
                editctx.count_cache(cache)
            return eps.permute(0, 2, 3, 1), cache
