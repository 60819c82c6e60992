"""Model-stack assembly for the port: configs, weights, tokenizer, prompt
encoding and VAE helpers (the ``SDStack`` subset of
``tokenflow_tpu/runtime.py`` that the main path uses).

A stack comes from a local diffusers-layout directory (``model_dir``, or
``$TOKENFLOW_MODELS/<repo id>``, or the HF cache layout under ``$HF_HOME``)
or, with ``init="random"``, from seeded random weights at the JAX stack's
init scales. Nothing is downloaded.

``sd_version: xl`` (``stabilityai/stable-diffusion-xl-base-1.0``, and its
tiny test stack ``tiny-xl``) adds the second text tower: the context is
CLIP-L's and OpenCLIP-bigG's penultimate hidden states concatenated, and
the UNet's added conditioning (:meth:`SDStack.added_cond`) is bigG's pooled
output with the size and crop ids of an uncropped image at the run's
resolution; an empty negative prompt encodes to zeros (diffusers'
``force_zeros_for_empty_prompt``), and the VAE's ``scaling_factor`` is its
checkpoint config's (0.13025). The JAX package has no SD-XL.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from tokenflow_torch.models import weights as weights_lib
from tokenflow_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTextModelWithProjection,
)
from tokenflow_torch.models.layers import FusedGroupNorm
from tokenflow_torch.models.unet2d import UNet2DConditionModel, UNet2DConfig
from tokenflow_torch.models.vae import AutoencoderKL, AutoencoderKLConfig
from tokenflow_torch.io.tokenizer import CLIPTokenizer, HashTokenizer
from tokenflow_torch.sharding import mesh

MODEL_KEYS = {
    "2.1": "stabilityai/stable-diffusion-2-1-base",
    "2.0": "stabilityai/stable-diffusion-2-base",
    "1.5": "runwayml/stable-diffusion-v1-5",
    "ControlNet": "runwayml/stable-diffusion-v1-5",
    "depth": "stabilityai/stable-diffusion-2-depth",
    "xl": "stabilityai/stable-diffusion-xl-base-1.0",
}
SD_VERSIONS = ("1.5", "2.0", "2.1", "ControlNet", "depth", "tiny", "tiny-controlnet",
               "tiny-depth", "xl", "tiny-xl")
SDXL_VAE_SCALING = 0.13025  # stable-diffusion-xl-base-1.0 vae/config.json


def is_depth(sd_version: str) -> bool:
    """Depth-conditioned variants: the 5-channel SD-2-depth UNet (4 latent
    channels and the frame's depth map), and its tiny test stack."""
    return sd_version in ("depth", "tiny-depth")


def is_controlnet(sd_version: str) -> bool:
    """Variants that run the ControlNet residual branch on every UNet call
    (SD-1.5 with the canny ControlNet, and its tiny test stack)."""
    return sd_version in ("ControlNet", "tiny-controlnet")


def is_xl(sd_version: str) -> bool:
    """SD-XL and its tiny test stack: two text towers, the added
    conditioning; edited with SDEdit only."""
    return sd_version in ("xl", "tiny-xl")


def text_encoder_2_config(sd_version: str) -> Optional[CLIPTextConfig]:
    """SD-XL's second text tower (OpenCLIP-bigG with its projection); None
    for a one-tower stack."""
    if sd_version == "xl":
        return CLIPTextConfig.sdxl_g()
    if sd_version == "tiny-xl":
        return CLIPTextConfig.tiny_xl()[1]
    return None


def configs_for(sd_version: str):
    if sd_version == "xl":
        return (UNet2DConfig.sdxl_base(),
                AutoencoderKLConfig(scaling_factor=SDXL_VAE_SCALING), CLIPTextConfig.sd15())
    if sd_version == "tiny-xl":
        return (UNet2DConfig.tiny_xl(),
                dataclasses.replace(AutoencoderKLConfig.tiny(), scaling_factor=SDXL_VAE_SCALING),
                CLIPTextConfig.tiny_xl()[0])
    if sd_version in ("tiny", "tiny-controlnet", "tiny-depth"):
        unet_cfg = UNet2DConfig.tiny()
        if is_depth(sd_version):
            unet_cfg = dataclasses.replace(unet_cfg, in_channels=5)
        return unet_cfg, AutoencoderKLConfig.tiny(), CLIPTextConfig.tiny()
    if sd_version in ("2.1", "2.0"):
        return UNet2DConfig.sd21_base(), AutoencoderKLConfig.sd(), CLIPTextConfig.sd21()
    if sd_version == "depth":
        return UNet2DConfig.sd21_depth(), AutoencoderKLConfig.sd(), CLIPTextConfig.sd21()
    if sd_version in ("1.5", "ControlNet"):
        return UNet2DConfig.sd15(), AutoencoderKLConfig.sd(), CLIPTextConfig.sd15()
    raise ValueError(
        f"sd_version {sd_version!r} is not supported by the port "
        f"(supported: {', '.join(SD_VERSIONS)})"
    )


def resolve_model_dir(sd_version: str, model_dir: Optional[str] = None) -> Optional[str]:
    if model_dir:
        return model_dir if os.path.isdir(model_dir) else None
    key = MODEL_KEYS.get(sd_version)
    if key is None:
        return None
    root = os.environ.get("TOKENFLOW_MODELS")
    if root:
        for cand in (os.path.join(root, key), os.path.join(root, key.split("/")[-1])):
            if os.path.isdir(cand):
                return cand
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    snaps = os.path.join(hf_home, "hub", "models--" + key.replace("/", "--"), "snapshots")
    if os.path.isdir(snaps) and os.listdir(snaps):
        return os.path.join(snaps, sorted(os.listdir(snaps))[-1])
    return None


def _config_mismatches(ckpt_cfg: dict, expected: dict) -> list[str]:
    """Compare a checkpoint config.json against preset expectations.

    Keys absent from the checkpoint config are not mismatches (older
    checkpoints omit some); present keys must agree."""
    out = []
    for key, want in expected.items():
        if key not in ckpt_cfg:
            continue
        got = ckpt_cfg[key]
        if isinstance(want, (list, tuple)):
            ok = list(got) == list(want)
        elif isinstance(want, float):
            ok = abs(float(got) - want) < 1e-9
        else:
            ok = got == want
        if not ok:
            out.append(f"{key}: checkpoint={got!r} != preset={want!r}")
    return out


def validate_checkpoint_configs(
    sd_version: str, configs: dict, unet_cfg, vae_cfg, clip_cfg, clip2_cfg=None
) -> None:
    """Raise, with every mismatch listed, when a checkpoint's own
    config.json disagrees with the preset chosen for ``sd_version``
    (``tokenflow_tpu/runtime.py::validate_checkpoint_configs``: the same
    keys and message). ``configs`` maps ``unet``, ``vae`` and
    ``text_encoder`` (and SD-XL's ``text_encoder_2``, checked against
    ``clip2_cfg``) to their parsed config.json; a missing one is skipped.
    Strict loading catches shapes but not the keys no weight shape carries
    (``hidden_act``, the head count, ``scaling_factor``)."""
    mismatches: list[str] = []

    unet_ck = dict(configs.get("unet") or {})
    heads = list(unet_cfg.num_heads)
    # diffusers' misnamed ``attention_head_dim`` is the per-level head
    # count of SD UNets; an int means the same count at every level
    ahd = unet_ck.pop("attention_head_dim", None)
    if ahd is not None:
        ahd_list = [ahd] * len(heads) if isinstance(ahd, int) else list(ahd)
        if ahd_list != heads:
            mismatches.append(
                f"unet: attention_head_dim: checkpoint={ahd!r} "
                f"!= preset={heads!r}"
            )
    mismatches += [
        f"unet: {m}"
        for m in _config_mismatches(unet_ck, {
            "in_channels": unet_cfg.in_channels,
            "out_channels": unet_cfg.out_channels,
            "cross_attention_dim": unet_cfg.cross_attention_dim,
            "block_out_channels": list(unet_cfg.block_out_channels),
            "layers_per_block": unet_cfg.layers_per_block,
            "use_linear_projection": unet_cfg.use_linear_projection,
            **({} if unet_cfg.transformer_layers is None else {
                "transformer_layers_per_block": list(unet_cfg.transformer_layers)}),
            **({} if not unet_cfg.addition_time_embed_dim else {
                "addition_embed_type": "text_time",
                "addition_time_embed_dim": unet_cfg.addition_time_embed_dim,
                "projection_class_embeddings_input_dim":
                    unet_cfg.projection_class_embeddings_input_dim}),
        })
    ]
    mismatches += [
        f"vae: {m}"
        for m in _config_mismatches(dict(configs.get("vae") or {}), {
            "in_channels": vae_cfg.in_channels,
            "out_channels": vae_cfg.out_channels,
            "latent_channels": vae_cfg.latent_channels,
            "block_out_channels": list(vae_cfg.block_out_channels),
            "layers_per_block": vae_cfg.layers_per_block,
            "scaling_factor": vae_cfg.scaling_factor,
        })
    ]
    mismatches += [
        f"text_encoder: {m}"
        for m in _config_mismatches(dict(configs.get("text_encoder") or {}), {
            "vocab_size": clip_cfg.vocab_size,
            "hidden_size": clip_cfg.hidden_size,
            "num_hidden_layers": clip_cfg.num_layers,
            "num_attention_heads": clip_cfg.num_heads,
            "intermediate_size": clip_cfg.intermediate_size,
            "max_position_embeddings": clip_cfg.max_position_embeddings,
            "hidden_act": clip_cfg.hidden_act,
        })
    ]
    if clip2_cfg is not None:
        mismatches += [
            f"text_encoder_2: {m}"
            for m in _config_mismatches(dict(configs.get("text_encoder_2") or {}), {
                "vocab_size": clip2_cfg.vocab_size,
                "hidden_size": clip2_cfg.hidden_size,
                "num_hidden_layers": clip2_cfg.num_layers,
                "num_attention_heads": clip2_cfg.num_heads,
                "intermediate_size": clip2_cfg.intermediate_size,
                "max_position_embeddings": clip2_cfg.max_position_embeddings,
                "hidden_act": clip2_cfg.hidden_act,
                "projection_dim": clip2_cfg.projection_dim,
            })
        ]
    if mismatches:
        raise ValueError(
            f"checkpoint does not match the sd_version={sd_version!r} "
            "preset:\n  " + "\n  ".join(mismatches)
            + "\n(pass the matching sd_version, or a matching checkpoint)"
        )


def read_component_configs(found: str) -> dict:
    """{component: parsed config.json} of a diffusers directory's unet, vae,
    text_encoder and text_encoder_2; a component without one is left
    out."""
    configs = {}
    for name in ("unet", "vae", "text_encoder", "text_encoder_2"):
        path = os.path.join(found, name, "config.json")
        if os.path.exists(path):
            with open(path) as f:
                configs[name] = json.load(f)
    return configs


@dataclasses.dataclass
class SDStack:
    sd_version: str
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    dtype: torch.dtype
    device: torch.device
    model_dir: Optional[str] = None  # the checkpoint read, None for random weights
    # SD-XL's OpenCLIP-bigG tower and its tokenizer; None for SD
    text_encoder_2: Optional[CLIPTextModelWithProjection] = None
    tokenizer_2: Any = None

    # ---- text ---------------------------------------------------------

    @torch.inference_mode()
    def encode_tokens(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return self.text_encoder(ids)

    def encode_prompt(self, prompt: str, negative_prompt: str) -> torch.Tensor:
        """-> (2, 77, D) [uncond, cond] (reference get_text_embeds order)."""
        return self.encode_prompts(prompt, negative_prompt)[0]

    @torch.inference_mode()
    def encode_prompts(self, prompt: str, negative_prompt: str):
        """-> ((2, 77, D) [uncond, cond], SD-XL's pooled (2, P) or None).
        SD-XL: CLIP-L's and bigG's penultimate hidden states concatenated,
        bigG's pooled output; an empty negative prompt gives zeros for
        both (diffusers' ``force_zeros_for_empty_prompt``)."""
        if self.text_encoder_2 is None:
            ids = np.stack([self.tokenizer(negative_prompt), self.tokenizer(prompt)])
            return self.encode_tokens(ids), None

        def ids(tok):
            return torch.as_tensor(np.stack([tok(negative_prompt), tok(prompt)]),
                                   dtype=torch.long, device=self.device)

        first = self.text_encoder.penultimate(ids(self.tokenizer))
        second, pooled = self.text_encoder_2.penultimate_and_pooled(
            ids(self.tokenizer_2), self.tokenizer_2.eos_token_id)
        embeds = torch.cat([first, second.to(first.dtype)], dim=-1)
        if negative_prompt == "":
            embeds[0], pooled[0] = 0, 0
        return embeds, pooled

    def added_cond(self, pooled: Optional[torch.Tensor], height: int, width: int):
        """The UNet's ``added_cond`` for prompts with the pooled outputs
        ``pooled`` (rows), an uncropped image of ``height`` x ``width``
        pixels: time ids (H, W, 0, 0, H, W); None for SD."""
        if pooled is None:
            return None
        ids = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                           device=pooled.device)
        return {"text_embeds": pooled, "time_ids": ids.expand(len(pooled), -1).contiguous()}

    # ---- VAE ----------------------------------------------------------

    @torch.inference_mode()
    def encode_frames(self, frames, *, batch: int = 10, group=None) -> torch.Tensor:
        """float (F, H, W, 3) in [0, 1] -> scaled latents (F, h, w, 4) fp32
        (posterior mean, as every reference call site), in batches of
        ``batch`` frames. Over a frames ``group`` (``sharding/mesh.py``) the
        rank encodes its block of the frames and returns its latents."""
        frames = np.asarray(frames)
        if group is not None:
            frames = group.local(frames)
        x = torch.as_tensor(frames, device=self.device) * 2.0 - 1.0
        out = torch.cat([
            self.vae.encode(x[i : i + batch]).float() for i in range(0, len(x), batch)
        ])
        return out * self.vae.config.scaling_factor

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor, *, batch: int = 10,
                       group=None) -> Optional[torch.Tensor]:
        """scaled latents -> fp32 images (F, H, W, 3) in [0, 1], in batches of
        ``batch`` frames. Over a frames ``group`` ``latents`` are the rank's
        block of the frames: each rank decodes its own, and rank 0 receives
        all the images in frame order (the other ranks None)."""
        z = latents.to(self.device).float() / self.vae.config.scaling_factor
        img = torch.cat([
            self.vae.decode(z[i : i + batch]).float() for i in range(0, len(z), batch)
        ])
        return mesh.gather_to_rank0(group, (img / 2.0 + 0.5).clamp(0.0, 1.0))

    # ---- UNet ---------------------------------------------------------

    def unet_apply(self, sample, t, context, edit=None, **kw):
        """-> (eps, cache); see UNet2DConditionModel.forward (``kw``: its
        ControlNet ``down_block_residuals`` / ``mid_block_residual``, SD-XL's
        ``added_cond``)."""
        return self.unet(sample, t, context, edit, **kw)


@functools.lru_cache(maxsize=1)
def _build_stack(sd_version, found, dtype, init, seed, device) -> SDStack:
    """``found`` is the resolved checkpoint directory or None. The cache
    holds the most recent stack only."""
    unet_cfg, vae_cfg, clip_cfg = configs_for(sd_version)
    clip2_cfg = text_encoder_2_config(sd_version)
    pretrained = found is not None and init != "random"
    if pretrained:  # before any weight is read
        configs = read_component_configs(found)
        if clip2_cfg is not None and "scaling_factor" in configs.get("vae", {}):
            # SD-XL's VAE scale is its checkpoint's
            vae_cfg = dataclasses.replace(vae_cfg,
                                          scaling_factor=configs["vae"]["scaling_factor"])
        validate_checkpoint_configs(sd_version, configs, unet_cfg, vae_cfg, clip_cfg, clip2_cfg)
    # build in fp32 on the target device, fill, then cast
    with torch.device(device):
        unet = UNet2DConditionModel(unet_cfg)
        vae = AutoencoderKL(vae_cfg)
        text = CLIPTextModel(clip_cfg)
        text_2 = None if clip2_cfg is None else CLIPTextModelWithProjection(clip2_cfg)
    models = [m for m in (unet, vae, text, text_2) if m is not None]
    tokenizer_2 = None
    if pretrained:
        weights_lib.load_into(unet, os.path.join(found, "unet"), "unet")
        weights_lib.load_into(vae, os.path.join(found, "vae"), "vae")
        weights_lib.load_into(text, os.path.join(found, "text_encoder"), "clip_text")
        tokenizer = CLIPTokenizer.from_pretrained(os.path.join(found, "tokenizer"))
        if text_2 is not None:
            weights_lib.load_into(text_2, os.path.join(found, "text_encoder_2"),
                                  "clip_text_projection")
            tokenizer_2 = CLIPTokenizer.from_pretrained(os.path.join(found, "tokenizer_2"),
                                                        config_pad=True)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in models:
            weights_lib.init_random_(m, gen)
        tokenizer = HashTokenizer(vocab_size=clip_cfg.vocab_size)
        if text_2 is not None:
            tokenizer_2 = HashTokenizer(vocab_size=clip2_cfg.vocab_size)
    for m in models:
        m.to(dtype).eval().requires_grad_(False)
    return SDStack(sd_version, unet, vae, text, tokenizer, dtype, device,
                   os.path.abspath(found) if pretrained else None, text_2, tokenizer_2)


def load_stack(
    sd_version: str,
    *,
    device: torch.device | str,
    model_dir: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    init: str = "auto",  # "auto" | "pretrained" | "random"
    seed: int = 0,
    group_norm_kernel: Optional[bool] = None,
) -> SDStack:
    """Build the SD model stack on ``device``. The most recent stack is
    held, so chained stages in one process (preprocess, then the editor)
    share one set of weights; a different request replaces it.
    ``group_norm_kernel`` sets ``use_kernel`` on every GroupNorm of the UNet
    and the VAE (the sites the JAX switch ``TOKENFLOW_PALLAS_GN=1``
    reaches; ``models/layers.py::group_norm_path``): None (unset) lets the
    device decide (K4 on CUDA, ``F.group_norm`` on the CPU), False forces
    ``F.group_norm``, True runs K4 on CUDA and its plain version on the
    CPU. It is applied on every call, so it never sticks to the held
    stack.

    An fp32 stack turns TF32 off for PyTorch's own matmuls and cuDNN
    convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``; PyTorch's default lets cuDNN take
    10-bit-mantissa products), so ``dtype: f32`` runs full fp32 products on
    the card as the JAX reference does. The port's fp32 kernels (K1-f32,
    the fp32 match core) do not read these flags: they run 3xTF32 splits,
    fp32-class error (on the H100, relative L2 at most 1.1e-6 for K1-f32
    and at most 1.8e-5 of the matches flipped, at near ties). A bf16 stack leaves both flags as they are: they touch
    only fp32 products."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    found = None if init == "random" else resolve_model_dir(sd_version, model_dir)
    if init == "pretrained" and found is None:
        raise FileNotFoundError(
            f"no checkpoint for sd_version={sd_version} (model_dir={model_dir!r}, "
            "$TOKENFLOW_MODELS, HF cache); pass init='random' for weightless runs"
        )
    stack = _build_stack(sd_version, found, dtype, init, seed, torch.device(device))
    for model in (stack.unet, stack.vae):
        for m in model.modules():
            if isinstance(m, FusedGroupNorm):
                m.use_kernel = group_norm_kernel
    return stack
