"""SD AutoencoderKL (PyTorch), the counterpart of
``tokenflow_tpu/models/vae.py``. NHWC in and out; module names follow the
diffusers state-dict keys. Encoding returns the posterior mean (the
reference's deterministic choice); the 0.18215 scaling is applied by the
runtime, as in JAX. The mid-block attention is plain attention, as the JAX
VAE leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from tokenflow_torch.models.layers import (
    Downsample2D,
    FusedGroupNorm,
    ResnetBlock2D,
    Upsample2D,
    nchw_body,
)
from tokenflow_torch.ops.attention import sdp_attention


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215

    @staticmethod
    def sd() -> "AutoencoderKLConfig":
        return AutoencoderKLConfig()

    @staticmethod
    def tiny() -> "AutoencoderKLConfig":
        return AutoencoderKLConfig(
            block_out_channels=(16, 32), layers_per_block=1, norm_groups=8
        )


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, groups: int, eps: float):
        super().__init__()
        self.group_norm = FusedGroupNorm(groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = (p(h)[:, :, None, :] for p in (self.to_q, self.to_k, self.to_v))
        o = self.to_out[0](sdp_attention(q, k, v)[:, :, 0, :])
        return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def _mid_block(ch: int, cfg: AutoencoderKLConfig) -> nn.Module:
    block = nn.Module()
    block.resnets = nn.ModuleList(
        [ResnetBlock2D(ch, ch, cfg.norm_eps, cfg.norm_groups) for _ in range(2)]
    )
    block.attentions = nn.ModuleList(
        [VAEAttention(ch, cfg.norm_groups, cfg.norm_eps)]
    )
    return block


def _run_mid(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    h = block.resnets[0](h)
    h = block.attentions[0](h)
    return block.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        chans = list(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        cin, blocks = chans[0], []
        for i, ch in enumerate(chans):
            block = nn.Module()
            block.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                block.resnets.append(
                    ResnetBlock2D(cin, ch, cfg.norm_eps, cfg.norm_groups)
                )
                cin = ch
            if i < len(chans) - 1:
                block.downsamplers = nn.ModuleList(
                    [Downsample2D(ch, asymmetric_pad=True)]
                )
            blocks.append(block)
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(chans[-1], cfg)
        self.conv_norm_out = FusedGroupNorm(
            cfg.norm_groups, chans[-1], eps=cfg.norm_eps, act="silu"
        )
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        rev = list(cfg.block_out_channels)[::-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], cfg)
        cin, blocks = rev[0], []
        for i, ch in enumerate(rev):
            block = nn.Module()
            block.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                block.resnets.append(
                    ResnetBlock2D(cin, ch, cfg.norm_eps, cfg.norm_groups)
                )
                cin = ch
            if i < len(rev) - 1:
                block.upsamplers = nn.ModuleList([Upsample2D(ch)])
            blocks.append(block)
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = FusedGroupNorm(
            cfg.norm_groups, rev[-1], eps=cfg.norm_eps, act="silu"
        )
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lc = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) image in [-1, 1] -> posterior mean (B, h, w, 4)."""
        moments = self.quant_conv(self.encoder(nchw_body(x.to(self.dtype))))
        mean = moments[:, : self.config.latent_channels]
        return mean.permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 4) latent -> (B, H, W, 3) image."""
        h = self.post_quant_conv(nchw_body(z.to(self.dtype)))
        return self.decoder(h).permute(0, 2, 3, 1)
