"""Weights for the port: diffusers-directory loading, seeded random init
with the JAX stack's init scales, and the inverse of the JAX package's
checkpoint converters.

The port's module names ARE the diffusers / transformers state-dict keys,
so a local checkpoint loads with ``load_state_dict`` after two legacy
renames. ``state_dict_from_flax`` turns a JAX parameter tree (numpy leaves)
back into that state dict, the inverse of
``tokenflow_tpu/models/weights.py::convert_{unet,vae,clip_text,controlnet,dpt,clip_vision,clip_model}_state_dict``:
Dense (in, out) -> (out, in), Conv HWIO -> OIHW (the CLIP vision tower's
bias-free (p, p, 3, hidden) patch kernel too), norm ``scale`` ->
``weight``; the DPT's transposed-conv resize kernels (k, k, in, out) ->
(in, out, k, k).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any

import numpy as np
import torch
from torch import nn

from tokenflow_torch.models.dpt import UNREAD_KEYS as DPT_UNREAD_KEYS

# ---------------------------------------------------------------------------
# diffusers-directory loading
# ---------------------------------------------------------------------------


def load_file(path: str) -> dict[str, torch.Tensor]:
    """One .safetensors or torch .bin file as CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file as load_safetensors

        return load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_component_state_dict(component_dir: str) -> dict[str, torch.Tensor]:
    """The (possibly sharded) weights of one diffusers component dir,
    preferring safetensors when both formats are present."""
    files = sorted(
        f for f in os.listdir(component_dir)
        if f.endswith((".safetensors", ".bin")) and "index" not in f
    )
    if any(f.endswith(".safetensors") for f in files):
        files = [f for f in files if f.endswith(".safetensors")]
    sd: dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(os.path.join(component_dir, f)))
    if not sd:
        raise FileNotFoundError(f"no weight files in {component_dir}")
    return sd


# legacy VAE attention names (pre-diffusers-0.19 checkpoints)
_VAE_LEGACY = [
    (r"(attentions\.0\.)query\.", r"\1to_q."),
    (r"(attentions\.0\.)key\.", r"\1to_k."),
    (r"(attentions\.0\.)value\.", r"\1to_v."),
    (r"(attentions\.0\.)proj_attn\.", r"\1to_out.0."),
]


def normalize_state_dict(sd: dict[str, torch.Tensor], kind: str) -> dict:
    """Drop buffers the port does not keep (position_ids, the CLIP text
    projection) and rename legacy VAE attention keys; 1x1-conv legacy
    attention weights become linear weights. ``kind`` is ``unet``, ``vae``,
    ``clip_text``, ``clip_text_projection`` (a text tower that keeps its
    ``text_projection``: SD-XL's ``text_encoder_2``), ``controlnet`` (a diffusers ``ControlNetModel``, whose
    keys are the port's as they are), ``dpt`` (an HF
    ``DPTForDepthEstimation``: the keys the model never reads,
    ``models.dpt.UNREAD_KEYS``, are dropped, and only those) or ``clip`` (an
    HF ``CLIPModel`` for ``models.clip_vision.CLIPScorer``: the two
    ``position_ids`` buffers and ``logit_scale`` are dropped, and only
    those)."""
    out = {}
    for key, w in sd.items():
        if kind == "dpt":
            if not key.startswith(DPT_UNREAD_KEYS):
                out[key] = w
            continue
        if kind == "clip":
            if not key.endswith("position_ids") and key != "logit_scale":
                out[key] = w
            continue
        if key.endswith("position_ids") or (key.startswith("text_projection")
                                            and kind != "clip_text_projection"):
            continue
        if kind == "vae":
            for pat, rep in _VAE_LEGACY:
                key = re.sub(pat, rep, key)
            if ".attentions.0." in key and w.dim() == 4:
                w = w[:, :, 0, 0]
        out[key] = w
    return out


def load_into(module: nn.Module, component_dir: str, kind: str) -> None:
    sd = normalize_state_dict(load_component_state_dict(component_dir), kind)
    module.load_state_dict(sd, strict=True)


# ---------------------------------------------------------------------------
# random init with the JAX (Flax default) scales
# ---------------------------------------------------------------------------

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
# ControlNet's projections, zero-initialised as in Flax (kernel_init zeros)
# and diffusers, so that a fresh ControlNet leaves the UNet's result as it is
ZERO_INIT = re.compile(r"^(controlnet_cond_embedding\.conv_out|controlnet_down_blocks\.\d+"
                       r"|controlnet_mid_block)$")


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax default initializers, drawn from ``generator``: lecun-normal
    (truncated normal, variance 1/fan_in) for Linear, Conv and transposed
    Conv weights (the DPT's resize kernels, fan_in in x k x k as Flax
    counts their (k, k, in, out) kernels), zero biases, unit/zero norms,
    embeddings normal with std 1/sqrt(width) and the CLIP position table
    normal(0.01) (tokenflow_tpu/models/*.py); zero weights for the
    ControlNet projections (``ZERO_INIT``). Bare parameters (the DPT's CLS
    token and position table, zeros in Flax) are left as they are."""
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d) and ZERO_INIT.match(name):
            m.weight.zero_()
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            else:
                fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(
                m.weight, std=std, a=-2 * std, b=2 * std, generator=generator
            )
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            std = 0.01 if name.endswith("position_embedding") else (
                1.0 / math.sqrt(m.weight.shape[1])
            )
            m.weight.normal_(0.0, std, generator=generator)


# ---------------------------------------------------------------------------
# JAX parameter tree -> port state dict
# ---------------------------------------------------------------------------

_UNET_INV = [
    (r"^down_(\d+)_res_(\d+)\.", r"down_blocks.\1.resnets.\2."),
    (r"^down_(\d+)_attn_(\d+)\.", r"down_blocks.\1.attentions.\2."),
    (r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0."),
    (r"^up_(\d+)_res_(\d+)\.", r"up_blocks.\1.resnets.\2."),
    (r"^up_(\d+)_attn_(\d+)\.", r"up_blocks.\1.attentions.\2."),
    (r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0."),
    (r"^mid_res_(\d+)\.", r"mid_block.resnets.\1."),
    (r"^mid_attn\.", r"mid_block.attentions.0."),
    (r"\.block\.", r".transformer_blocks.0."),
    (r"\.to_out\.", r".to_out.0."),
    (r"\.ff\.proj_in\.", r".ff.net.0.proj."),
    (r"\.ff\.proj_out\.", r".ff.net.2."),
]

_VAE_INV = [
    (r"^(encoder|decoder)\.down_(\d+)_res_(\d+)\.", r"\1.down_blocks.\2.resnets.\3."),
    (r"^(encoder|decoder)\.down_(\d+)_downsample\.", r"\1.down_blocks.\2.downsamplers.0."),
    (r"^(encoder|decoder)\.up_(\d+)_res_(\d+)\.", r"\1.up_blocks.\2.resnets.\3."),
    (r"^(encoder|decoder)\.up_(\d+)_upsample\.", r"\1.up_blocks.\2.upsamplers.0."),
    (r"^(encoder|decoder)\.mid_res_(\d+)\.", r"\1.mid_block.resnets.\2."),
    (r"^(encoder|decoder)\.mid_attn\.", r"\1.mid_block.attentions.0."),
    (r"\.to_out\.", r".to_out.0."),
]

_CLIP_INV = [
    (r"^token_embedding\.embedding$", r"embeddings.token_embedding.weight"),
    (r"^position_embedding$", r"embeddings.position_embedding.weight"),
    (r"^layer_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.", r"encoder.layers.\1.self_attn.\2."),
    (r"^layer_(\d+)\.(fc1|fc2)\.", r"encoder.layers.\1.mlp.\2."),
    (r"^layer_(\d+)\.", r"encoder.layers.\1."),
    (r"^", r"text_model."),
]

_CLIP_VISION_INV = [
    (r"^patch_embed\.", r"embeddings.patch_embedding."),
    (r"^class_embedding$", r"embeddings.class_embedding"),
    (r"^position_embedding$", r"embeddings.position_embedding.weight"),
    (r"^pre_layernorm\.", r"pre_layrnorm."),  # HF's spelling
    (r"^layer_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.", r"encoder.layers.\1.self_attn.\2."),
    (r"^layer_(\d+)\.(fc1|fc2)\.", r"encoder.layers.\1.mlp.\2."),
    (r"^layer_(\d+)\.", r"encoder.layers.\1."),
    (r"^", r"vision_model."),
]

_CONTROLNET_INV = _UNET_INV + [
    (r"^cond_embedding\.conv_in\.", r"controlnet_cond_embedding.conv_in."),
    (r"^cond_embedding\.block_(\d+)\.", r"controlnet_cond_embedding.blocks.\1."),
    (r"^cond_embedding\.conv_out\.", r"controlnet_cond_embedding.conv_out."),
    (r"^controlnet_down_(\d+)\.", r"controlnet_down_blocks.\1."),
    (r"^controlnet_mid\.", r"controlnet_mid_block."),
]

_DPT_INV = [
    (r"^cls_token$", r"dpt.embeddings.cls_token"),
    (r"^pos_embed$", r"dpt.embeddings.position_embeddings"),
    (r"^patch_embed\.", r"dpt.embeddings.patch_embeddings.projection."),
    (r"^block_(\d+)\.norm1\.", r"dpt.encoder.layer.\1.layernorm_before."),
    (r"^block_(\d+)\.norm2\.", r"dpt.encoder.layer.\1.layernorm_after."),
    (r"^block_(\d+)\.q\.", r"dpt.encoder.layer.\1.attention.attention.query."),
    (r"^block_(\d+)\.k\.", r"dpt.encoder.layer.\1.attention.attention.key."),
    (r"^block_(\d+)\.v\.", r"dpt.encoder.layer.\1.attention.attention.value."),
    (r"^block_(\d+)\.proj\.", r"dpt.encoder.layer.\1.attention.output.dense."),
    (r"^block_(\d+)\.fc1\.", r"dpt.encoder.layer.\1.intermediate.dense."),
    (r"^block_(\d+)\.fc2\.", r"dpt.encoder.layer.\1.output.dense."),
    (r"^reassemble_(\d+)\.readout\.", r"neck.reassemble_stage.readout_projects.\1.0."),
    (r"^reassemble_(\d+)\.proj\.", r"neck.reassemble_stage.layers.\1.projection."),
    (r"^reassemble_(\d+)\.resize\.", r"neck.reassemble_stage.layers.\1.resize."),
    (r"^reassemble_(\d+)\.resize_bias$", r"neck.reassemble_stage.layers.\1.resize.bias"),
    (r"^neck_conv_(\d+)\.", r"neck.convs.\1."),
    (r"^fusion_(\d+)\.proj\.", r"neck.fusion_stage.layers.\1.projection."),
    (r"^fusion_(\d+)\.res(\d)\.conv(\d)\.",
     r"neck.fusion_stage.layers.\1.residual_layer\2.convolution\3."),
    (r"^head_conv1\.", r"head.head.0."),
    (r"^head_conv2\.", r"head.head.2."),
    (r"^head_conv3\.", r"head.head.4."),
]

_RULES = {"unet": _UNET_INV, "vae": _VAE_INV, "clip_text": _CLIP_INV,
          "controlnet": _CONTROLNET_INV, "dpt": _DPT_INV, "clip_vision": _CLIP_VISION_INV}
# the JAX CLIPScorer tree: each tower's subtree and its rules, and the
# bias-free projection heads
_CLIP_PARTS = {"vision": "clip_vision", "text": "clip_text"}
KINDS = sorted([*_RULES, "clip"])


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _torch_leaf(path: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    head, _, leaf = path.rpartition(".")
    w = np.asarray(w)
    if leaf == "kernel":
        if w.ndim == 4:  # conv HWIO -> OIHW
            return f"{head}.weight", w.transpose(3, 2, 0, 1)
        return f"{head}.weight", w.T  # dense (in, out) -> (out, in)
    if leaf == "scale":
        return f"{head}.weight", w
    if leaf == "resize_kernel":  # DPT transposed conv (k, k, in, out) -> (in, out, k, k)
        return f"{head}.resize.weight", w.transpose(2, 3, 0, 1)
    return path, w  # bias, embeddings, position table


def state_dict_from_flax(params: dict, kind: str) -> dict[str, torch.Tensor]:
    """JAX parameter tree (``{"params": ...}`` or its inner dict, numpy
    leaves) of kind ``unet``, ``vae``, ``clip_text``, ``controlnet``,
    ``dpt``, ``clip_vision`` (a ``CLIPVisionModel``) or ``clip`` (a
    ``CLIPScorer``: both towers and the projection heads) -> the port's
    state dict (contiguous CPU tensors, the leaves' dtype)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    tree = params.get("params", params)
    if kind == "clip":
        out = {}
        for part, sub in _CLIP_PARTS.items():
            out.update(state_dict_from_flax(tree[part], sub))
        for head in ("visual_projection", "text_projection"):
            key, val = _torch_leaf(f"{head}.kernel", tree[head]["kernel"])
            out[key] = torch.tensor(val)
        return out
    out = {}
    for path, w in _flatten(tree).items():
        key, val = _torch_leaf(path, w)
        for pat, rep in _RULES[kind]:
            key = re.sub(pat, rep, key)
        out[key] = torch.tensor(val)  # a copy: JAX leaves are read-only
    return out
