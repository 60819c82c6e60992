"""ControlNet (PyTorch), the counterpart of
``tokenflow_tpu/models/controlnet.py``: the base UNet's encoder half (same
modules under diffusers' ``ControlNetModel`` state-dict keys), a
conditioning-image embedder added after ``conv_in``, and zero-initialised
1x1 projection convs that turn every skip and the mid block's output into
the residuals the UNet adds (``UNet2DConditionModel(...,
down_block_residuals=, mid_block_residual=)``). Public layout is NHWC in and
out, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tokenflow_torch.models import unet2d
from tokenflow_torch.models.layers import nchw_body
from tokenflow_torch.models.unet2d import UNet2DConfig
from tokenflow_torch.profiling import span

# channels of diffusers' ControlNetConditioningEmbedding (three stride-2
# convs: the x8 latent factor of the SD VAE)
COND_CHANNELS = (16, 32, 96, 256)


class ControlNetCondEmbedding(nn.Module):
    """Conditioning image (B, 3, H, W) -> (B, C0, H / 2^n, W / 2^n): conv_in,
    then per stage a 3x3 conv and a stride-2 3x3 conv (``blocks``), SiLU
    after each, and conv_out. ``num_downsamples`` n < 3 keeps the last n + 1
    channel stops, as the JAX module does for the tiny stack's x2 VAE."""

    def __init__(self, out_channels: int, num_downsamples: int = 3):
        super().__init__()
        if not 0 <= num_downsamples <= len(COND_CHANNELS) - 1:
            raise ValueError(f"num_downsamples {num_downsamples} not in 0..3")
        ch = COND_CHANNELS[len(COND_CHANNELS) - 1 - num_downsamples:]
        self.num_downsamples = num_downsamples
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks.append(nn.Conv2d(ch[i], ch[i], 3, padding=1))
            blocks.append(nn.Conv2d(ch[i], ch[i + 1], 3, padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNetModel(nn.Module):
    """UNet encoder + cond embedder + zero convs -> (down residuals, mid
    residual). ``cond_downsamples`` is the log2 of the cond image's size over
    the latent's (3 for the SD VAE's x8): the JAX module infers it from the
    inputs at trace time, a module here needs it to make its weights, and
    ``forward`` raises on inputs of another ratio."""

    def __init__(self, config: UNet2DConfig, cond_downsamples: int = 3, kv_block: int = 1024):
        super().__init__()
        if not config.pnp_defined:
            raise ValueError("the port has no ControlNet for this UNet: its ControlNet is "
                             "SD-1.5's canny model (SD's layout, no added conditioning)")
        self.config = config
        parts = unet2d.UNetParts(config, kv_block)
        self.conv_in, self.time_embedding = parts.stem()
        self.controlnet_cond_embedding = ControlNetCondEmbedding(parts.chans[0], cond_downsamples)
        self.down_blocks, skips = parts.down_blocks()
        self.mid_block = parts.mid_block()
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skips])
        c = parts.chans[-1]
        self.controlnet_mid_block = nn.Conv2d(c, c, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(
        self,
        sample: torch.Tensor,  # (B, h, w, C_in) NHWC latents
        timesteps,  # int, 0-dim or (B,) tensor
        encoder_hidden_states: torch.Tensor,  # (B, 77, cross_dim)
        controlnet_cond: torch.Tensor,  # (B, H, W, 3) NHWC conditioning image
        conditioning_scale: float = 1.0,
    ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
        """Returns (down residuals, one per skip, and the mid residual), NHWC
        in the model's dtype, each scaled by ``conditioning_scale``; a
        ``tf.controlnet`` span, its blocks' spans named as the UNet's."""
        n = self.controlnet_cond_embedding.num_downsamples
        if controlnet_cond.shape[1:3] != tuple(x << n for x in sample.shape[1:3]):
            raise ValueError(
                f"cond image {tuple(controlnet_cond.shape[1:3])} is not 2^{n} times the "
                f"latent {tuple(sample.shape[1:3])}"
            )
        with span("tf.controlnet"):
            dtype = self.dtype
            context = encoder_hidden_states.to(dtype)
            temb = unet2d.embed_timesteps(
                self.config, self.time_embedding, timesteps, sample.shape[0], sample.device
            )
            h = self.conv_in(nchw_body(sample.to(dtype)))
            h = h + self.controlnet_cond_embedding(controlnet_cond.to(dtype).permute(0, 3, 1, 2))
            # no edit directive: the blocks run plain self-attention
            h, skips = unet2d.down_pass(self.down_blocks, h, temb, context, None, {})
            h = unet2d.mid_pass(self.mid_block, h, temb, context, None, {})

            def project(conv, x):
                r = conv(x)
                if conditioning_scale != 1.0:
                    r = r * conditioning_scale
                return r.permute(0, 2, 3, 1)

            down = tuple(project(conv, s) for conv, s in zip(self.controlnet_down_blocks, skips))
            return down, project(self.controlnet_mid_block, h)
