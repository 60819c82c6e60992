"""DPT (dense prediction transformer) depth estimator, MiDaS 3.0 DPT-Large
(PyTorch), the counterpart of ``tokenflow_tpu/models/dpt.py``.

Public layout is NHWC in, (B, H, W) out, as in JAX; the body runs NCHW.
Module names follow ``transformers.DPTForDepthEstimation`` state-dict keys,
so an ``Intel/dpt-large`` checkpoint loads by key name
(``tokenflow_torch.io.depth.load_dpt_model``), apart from three groups HF
has and the model never reads (``UNREAD_KEYS``).

  ViT backbone   patch conv (p x p, stride p) -> [CLS] + tokens + position
                 table (its grid resized bilinearly, align_corners=False,
                 when the input grid differs from the native one); pre-LN
                 blocks (LN -> MHSA -> +res; LN -> MLP(exact GELU) -> +res).
                 The neck reads the raw block outputs at
                 ``backbone_out_indices``, before the final LayerNorm.
  Reassemble     per tapped stage: readout 'project' (CLS concatenated to
                 every token, Linear + GELU) -> (h/p, w/p) map -> 1x1 conv
                 to the stage width -> resize by {4, 2, 1, 0.5} (a k = f,
                 stride f transposed conv, identity, a 3x3 stride-2 conv).
  Fusion         3x3 no-bias conv to the fusion width, then top-down:
                 + pre-activation residual units, x2 bilinear upsample
                 (align_corners=True), 1x1 projection.
  Head           3x3 conv (C -> C/2) -> x2 bilinear (align_corners=True)
                 -> 3x3 conv (-> 32) -> ReLU -> 1x1 conv (-> 1) -> ReLU.

Attention is plain torch (fp32 logits and softmax): no kernel runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tokenflow_torch.ops.attention import merge_heads, split_heads

# keys of an HF DPTForDepthEstimation state dict that the model never reads:
# the final LayerNorm and pooler (the neck reads the raw block outputs) and
# the residual unit of the first fusion layer (the deepest feature has no
# residual; HF builds the unit and never calls it)
UNREAD_KEYS = ("dpt.layernorm.", "dpt.pooler.", "neck.fusion_stage.layers.0.residual_layer1.")


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 384  # the position table's native grid
    backbone_out_indices: Sequence[int] = (5, 11, 17, 23)
    neck_hidden_sizes: Sequence[int] = (256, 512, 1024, 1024)
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12

    @staticmethod
    def dpt_large() -> "DPTConfig":
        """Intel/dpt-large (torch.hub intel-isl/MiDaS DPT_Large)."""
        return DPTConfig()

    @staticmethod
    def tiny() -> "DPTConfig":
        """Small config for tests (a tiny HF DPTConfig)."""
        return DPTConfig(
            hidden_size=32,
            num_layers=4,
            num_heads=2,
            intermediate_size=64,
            patch_size=16,
            image_size=64,
            backbone_out_indices=(0, 1, 2, 3),
            neck_hidden_sizes=(8, 12, 16, 16),
            fusion_hidden_size=16,
        )


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = _SelfAttention(dim)
        self.output = _Dense(dim, dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        a = self.attention
        q, k, v = (split_heads(p(h), self.heads) for p in (a.query, a.key, a.value))
        d = q.shape[-1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
        probs = torch.softmax(logits, dim=-1).to(h.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.output.dense(merge_heads(o))


class _Dense(nn.Module):
    """A Linear under HF's ``<name>.dense`` key."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)


class ViTBlock(nn.Module):
    """Pre-LN transformer block (HF ``DPTViTLayer``)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        dim = cfg.hidden_size
        self.layernorm_before = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attention = _Attention(dim, cfg.num_heads)
        self.layernorm_after = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.intermediate = _Dense(dim, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        p = cfg.patch_size
        self.projection = nn.Conv2d(3, cfg.hidden_size, p, stride=p)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.native = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, self.native**2 + 1, cfg.hidden_size)
        )
        self.patch_embeddings = _PatchEmbeddings(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 1 + gh * gw, D)."""
        h = self.patch_embeddings.projection(pixels)
        b, dim, gh, gw = h.shape
        h = h.flatten(2).transpose(1, 2)
        pos = self.position_embeddings
        pos_cls, pos_grid = pos[:, :1], pos[:, 1:]
        if (gh, gw) != (self.native, self.native):
            grid = pos_grid.reshape(1, self.native, self.native, dim).permute(0, 3, 1, 2)
            grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
            pos_grid = grid.flatten(2).transpose(1, 2)
        h = torch.cat([self.cls_token.expand(b, 1, dim), h], dim=1)
        return h + torch.cat([pos_cls, pos_grid], dim=1)


class _Encoder(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layer = nn.ModuleList([ViTBlock(cfg) for _ in range(cfg.num_layers)])


class _Backbone(nn.Module):
    """HF ``DPTModel`` without its final LayerNorm (``UNREAD_KEYS``)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)


class Reassemble(nn.Module):
    """One tapped stage's 1x1 projection and resize (HF
    ``DPTReassembleLayer``); the readout projection sits in the stage."""

    def __init__(self, dim: int, channels: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(dim, channels, 1)
        if factor > 1:
            f = int(factor)
            self.resize = nn.ConvTranspose2d(channels, channels, f, stride=f)
        elif factor < 1:
            self.resize = nn.Conv2d(channels, channels, 3, stride=int(round(1 / factor)),
                                    padding=1)
        else:
            self.resize = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(x))


class _ReassembleStage(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        dim = cfg.hidden_size
        self.readout_projects = nn.ModuleList(
            [nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU()) for _ in cfg.neck_hidden_sizes]
        )
        self.layers = nn.ModuleList([
            Reassemble(dim, ch, f)
            for ch, f in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors)
        ])

    def forward(self, stage: int, tokens: torch.Tensor, grid_hw) -> torch.Tensor:
        """(B, 1 + gh * gw, D) block output -> the stage's NCHW map."""
        cls, h = tokens[:, :1], tokens[:, 1:]
        h = self.readout_projects[stage](torch.cat([h, cls.expand_as(h)], dim=-1))
        b, _, dim = h.shape
        h = h.transpose(1, 2).reshape(b, dim, *grid_hw)
        return self.layers[stage](h)


class PreActResidual(nn.Module):
    """ReLU -> 3x3 conv -> ReLU -> 3x3 conv, added to the input (HF
    ``DPTPreActResidualLayer``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.convolution2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convolution1(F.relu(x))
        return x + self.convolution2(F.relu(h))


class FusionLayer(nn.Module):
    """HF ``DPTFeatureFusionLayer``; the first (deepest) one has no
    residual unit."""

    def __init__(self, channels: int, has_residual: bool):
        super().__init__()
        if has_residual:
            self.residual_layer1 = PreActResidual(channels)
        self.residual_layer2 = PreActResidual(channels)
        self.projection = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is not None:
            if residual.shape[2:] != x.shape[2:]:
                residual = F.interpolate(residual, size=x.shape[2:], mode="bilinear",
                                         align_corners=False)
            x = x + self.residual_layer1(residual)
        return self.projection(_upsample2(self.residual_layer2(x)))


class _FusionStage(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layers = nn.ModuleList([
            FusionLayer(cfg.fusion_hidden_size, has_residual=j > 0)
            for j in range(len(cfg.neck_hidden_sizes))
        ])


class _Neck(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.reassemble_stage = _ReassembleStage(cfg)
        self.convs = nn.ModuleList([
            nn.Conv2d(ch, cfg.fusion_hidden_size, 3, padding=1, bias=False)
            for ch in cfg.neck_hidden_sizes
        ])
        self.fusion_stage = _FusionStage(cfg)


class _Head(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.head = nn.Sequential(
            nn.Conv2d(channels, channels // 2, 3, padding=1),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(channels // 2, 32, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(32, 1, 1),
            nn.ReLU(),
        )


class DPTDepthModel(nn.Module):
    """(B, H, W, 3) normalized RGB -> (B, H, W) raw inverse-depth
    predictions (MiDaS's output convention)."""

    def __init__(self, config: DPTConfig):
        super().__init__()
        self.config = config
        self.dpt = _Backbone(config)
        self.neck = _Neck(config)
        self.head = _Head(config.fusion_hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = self.neck.convs[0].weight.dtype
        x = pixels.to(dtype).permute(0, 3, 1, 2)
        p = cfg.patch_size
        grid_hw = (x.shape[2] // p, x.shape[3] // p)

        h = self.dpt.embeddings(x)
        taps = {}
        for i, block in enumerate(self.dpt.encoder.layer):
            h = block(h)
            if i in cfg.backbone_out_indices:
                taps[i] = h

        neck = self.neck
        feats = [
            neck.convs[s](neck.reassemble_stage(s, taps[idx], grid_hw))
            for s, idx in enumerate(cfg.backbone_out_indices)
        ]
        fused = None
        for layer, f in zip(neck.fusion_stage.layers, reversed(feats)):
            fused = layer(f) if fused is None else layer(fused, f)
        return self.head.head(fused)[:, 0]
