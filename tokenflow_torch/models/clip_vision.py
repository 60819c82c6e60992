"""CLIP vision tower and CLIP scorer (PyTorch), the counterpart of
``tokenflow_tpu/models/clip_vision.py``: the edit-quality metrics (CLIP
score of frames against a prompt, cosine of consecutive frames).

- ``CLIPVisionModel``: the ViT of ``transformers.CLIPVisionModel`` (patch
  conv without bias, class embedding, learned position embeddings, pre-LN
  encoder of ``clip_text.CLIPEncoderLayer`` without a causal mask,
  post-layernormed CLS pooling). NCHW inside, images in as (B, H, W, 3).
- ``CLIPScorer``: both towers and the ``CLIPModel`` projection heads.

Module names are HF ``CLIPModel``'s state-dict keys (``vision_model.*``
with HF's ``pre_layrnorm`` spelling, ``text_model.*``,
``visual_projection``, ``text_projection``), so an HF checkpoint loads by
key name (``weights.normalize_state_dict(..., "clip")``). LayerNorms run in
fp32. The attention is plain softmax, as in the JAX towers: no kernel
serves this path. Run the towers in fp32 with TF32 off
(``utils.fp32_products``), as ``cli/compare_outputs.py`` does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tokenflow_torch.models.clip_text import (
    CLIPEncoderLayer,
    CLIPTextConfig,
    CLIPTextTransformer,
)
from tokenflow_torch.models.layers import LayerNorm32


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @staticmethod
    def vit_l_14() -> "CLIPVisionConfig":
        """openai/clip-vit-large-patch14 (the standard CLIP-score model)."""
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            image_size=32, patch_size=8, projection_dim=16,
        )

    def as_text_layer_config(self) -> CLIPTextConfig:
        """The encoder-layer hyperparameters as a CLIPTextConfig, so that
        ``clip_text.CLIPEncoderLayer`` serves both towers."""
        return CLIPTextConfig(
            hidden_size=self.hidden_size, num_layers=self.num_layers,
            num_heads=self.num_heads, intermediate_size=self.intermediate_size,
            hidden_act=self.hidden_act, layer_norm_eps=self.layer_norm_eps,
        )


class CLIPVisionTransformer(nn.Module):
    """HF ``CLIPVisionModel.vision_model``: pixels -> the pooled CLS state."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        p, w = cfg.patch_size, cfg.hidden_size
        self.embeddings = nn.Module()
        self.embeddings.patch_embedding = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.embeddings.class_embedding = nn.Parameter(torch.zeros(w))
        self.embeddings.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, w)
        self.pre_layrnorm = LayerNorm32(w, eps=cfg.layer_norm_eps)  # HF's spelling
        self.encoder = nn.Module()
        layer_cfg = cfg.as_text_layer_config()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(layer_cfg) for _ in range(cfg.num_layers)]
        )
        self.post_layernorm = LayerNorm32(w, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3), CLIP-normalized -> pooled (B, hidden)."""
        emb = self.embeddings
        dtype = emb.patch_embedding.weight.dtype
        h = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(dtype))
        h = h.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major grid
        cls = emb.class_embedding.to(dtype).expand(h.shape[0], 1, -1)
        h = torch.cat([cls, h], dim=1)
        h = h + emb.position_embedding.weight[None, : h.shape[1]].to(dtype)
        h = self.pre_layrnorm(h)
        for layer in self.encoder.layers:
            h = layer(h, 0.0)  # no causal mask
        return self.post_layernorm(h[:, 0])


class CLIPVisionModel(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3), CLIP-normalized -> pooled (B, hidden)
        (transformers ``CLIPVisionModel`` pooler_output)."""
        return self.vision_model(pixels)


# ImageNet-CLIP preprocessing constants (transformers CLIPImageProcessor)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_images(frames: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> CLIP-normalized (B, size, size, 3):
    bicubic resize of the shortest edge to ``image_size`` (the long edge to
    ``int(size * long / short)``), then a center crop, as
    transformers' CLIPImageProcessor and the JAX ``preprocess_images``.
    ``jax.image.resize``'s bicubic is the Keys cubic with a = -0.5, widened
    by the shrink factor (it antialiases): ``F.interpolate`` computes that
    filter with ``antialias=True`` (within 8.1e-7 of a float64 evaluation
    of JAX's weights, 512 -> 224, 480 x 640 -> 224 x 298 and 64 -> 224),
    and its default, without antialias, uses a = -0.75 and reads up to 0.7
    away at 512 -> 224."""
    b, h, w, _ = frames.shape
    if h == w:
        nh = nw = image_size
    elif h < w:
        nh, nw = image_size, int(image_size * w / h)
    else:
        nh, nw = int(image_size * h / w), image_size
    x = F.interpolate(frames.float().permute(0, 3, 1, 2), size=(nh, nw), mode="bicubic",
                      align_corners=False, antialias=True)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top : top + image_size, left : left + image_size].permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class CLIPScorer(nn.Module):
    """Vision and text towers with the ``CLIPModel`` projection heads.
    ``image_features`` and ``text_features`` return L2-normalized
    embeddings; ``forward`` is the CLIP score, 100 * max(cos, 0), of each
    image against the first prompt.

    ``eos_token_id``: the text tower pools at the first position holding
    it (HF ``CLIPTextModel``; 49407 is CLIP's end-of-text)."""

    def __init__(self, vision_config: CLIPVisionConfig, text_config: CLIPTextConfig,
                 eos_token_id: int = 49407):
        super().__init__()
        self.vision_config, self.text_config = vision_config, text_config
        self.eos_token_id = eos_token_id
        self.vision_model = CLIPVisionTransformer(vision_config)
        self.text_model = CLIPTextTransformer(text_config)
        proj = vision_config.projection_dim
        self.visual_projection = nn.Linear(vision_config.hidden_size, proj, bias=False)
        self.text_projection = nn.Linear(text_config.hidden_size, proj, bias=False)

    def image_features(self, pixels: torch.Tensor) -> torch.Tensor:
        emb = self.visual_projection(self.vision_model(pixels))
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def text_features(self, input_ids: torch.Tensor) -> torch.Tensor:
        hidden = self.text_model(input_ids)
        eos = torch.argmax((input_ids == self.eos_token_id).int(), dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eos]
        emb = self.text_projection(pooled)
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """CLIP score of each image against the first prompt: (B,) in [0, 100]."""
        cos = self.image_features(pixels) @ self.text_features(input_ids)[0]
        return cos.clamp(min=0.0) * 100.0
