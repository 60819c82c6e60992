"""CLIP text encoder (PyTorch), the counterpart of
``tokenflow_tpu/models/clip_text.py``: token + learned position embeddings,
pre-LN causal transformer, final LayerNorm; returns the last hidden state.
Module names follow ``transformers.CLIPTextModel`` state-dict keys.

SD-XL reads two towers differently (``runtime.SDStack.encode_prompts``):
CLIP-L's penultimate hidden state (the last layer and the final LayerNorm
left out), and OpenCLIP-bigG's penultimate hidden state beside its pooled
output, the final-normed state at the first end-of-text token through the
bias-free ``text_projection`` (``CLIPTextModelWithProjection``, the keys of
``transformers.CLIPTextModelWithProjection``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tokenflow_torch.models.layers import LayerNorm32
from tokenflow_torch.ops.attention import merge_heads, split_heads


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 0  # the pooled output's text_projection; 0: none

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        """CLIP ViT-L/14's text tower (SD-1.5): 768 wide, 12 layers."""
        return CLIPTextConfig(
            hidden_size=768,
            num_layers=12,
            num_heads=12,
            intermediate_size=3072,
            hidden_act="quick_gelu",
        )

    @staticmethod
    def sdxl_g() -> "CLIPTextConfig":
        """OpenCLIP ViT-bigG/14's text tower (SD-XL's ``text_encoder_2``):
        1280 wide, 32 layers, 20 heads, a 1280-wide text projection."""
        return CLIPTextConfig(
            hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
            projection_dim=1280,
        )

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64,
        )

    @staticmethod
    def tiny_xl() -> tuple["CLIPTextConfig", "CLIPTextConfig"]:
        """The tiny SD-XL stack's two towers: 16 + 16 wide hidden states
        (the tiny SD-XL UNet's 32-wide context), a 32-wide pooled output."""
        small = dict(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                     intermediate_size=32)
        return (CLIPTextConfig(**small, hidden_act="quick_gelu"),
                CLIPTextConfig(**small, projection_dim=32))


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        w = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)

    def forward(self, h, causal_bias):
        q, k, v = (split_heads(p(h), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        d = q.shape[-1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
        probs = torch.softmax(logits + causal_bias, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs.to(h.dtype).float(), v.float())
        return self.out_proj(merge_heads(o.to(h.dtype)))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, h):
        return self.fc2(_act(self.act, self.fc1(h)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, causal_bias):
        x = x + self.self_attn(self.layer_norm1(x), causal_bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextTransformer(nn.Module):
    """HF ``CLIPTextModel.text_model``: the whole tower, ids -> the last
    hidden state after the final LayerNorm."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.embeddings.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)]
        )
        self.final_layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def hidden_states(self, input_ids: torch.Tensor) -> list[torch.Tensor]:
        """The embeddings' output and each layer's, as transformers'
        ``output_hidden_states`` gives them (no final LayerNorm)."""
        s = input_ids.shape[1]
        x = self.embeddings.token_embedding(input_ids)
        x = x + self.embeddings.position_embedding.weight[None, :s]
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        causal_bias = torch.zeros((s, s), device=x.device).masked_fill(
            ~mask, float("-inf")
        )
        out = [x]
        for layer in self.encoder.layers:
            out.append(layer(out[-1], causal_bias))
        return out

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        # fp32 final norm, then the stack dtype (the JAX model's astype)
        return self.final_layer_norm(self.hidden_states(input_ids)[-1])


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, S) integer -> last hidden state (B, S, hidden)."""
        return self.text_model(input_ids)

    def penultimate(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S, hidden): the state after all but the last layer, without
        the final LayerNorm (``hidden_states[-2]``, SD-XL's context)."""
        return self.text_model.hidden_states(input_ids)[-2]


class CLIPTextModelWithProjection(CLIPTextModel):
    """A text tower with its pooled output's ``text_projection`` (SD-XL's
    OpenCLIP-bigG ``text_encoder_2``)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__(config)
        self.text_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def penultimate_and_pooled(self, input_ids: torch.Tensor, eos_token_id: int):
        """-> (the penultimate hidden state (B, S, hidden), the pooled output
        (B, projection_dim)): the final-normed last state at the first
        ``eos_token_id`` of each row, through ``text_projection``."""
        states = self.text_model.hidden_states(input_ids)
        last = self.text_model.final_layer_norm(states[-1])
        eos = torch.argmax((input_ids == eos_token_id).int(), dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos]
        return states[-2], self.text_projection(pooled)
