"""The system under test: the PyTorch and CUDA port's UNet and ControlNet
built for a configuration and handed the benchmark's state dict by key
name, as the port loads a diffusers checkpoint, and its kernel library.
Only this module and the stage drivers import the program."""

from __future__ import annotations

import torch

from reference.model import UNetSpec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_kernels() -> bool:
    """Build (a checkout's first run) or load the program's kernel library,
    which it keeps under ``build/tokenflow_torch/`` in the checkout; True
    where this call built it."""
    from tokenflow_torch.kernels import _build

    built = not _build.library_path().exists()
    _build.load_library()
    return built


def _port_config(spec: UNetSpec):
    from tokenflow_torch.models.unet2d import UNet2DConfig

    if spec.norm_num_groups != 32:
        raise ValueError("the port's norms have 32 groups")
    return UNet2DConfig(
        in_channels=spec.in_channels, out_channels=spec.out_channels,
        block_out_channels=spec.block_out_channels, layers_per_block=spec.layers_per_block,
        cross_attention_dim=spec.cross_attention_dim, num_heads=spec.heads,
        use_linear_projection=spec.use_linear_projection, norm_eps=spec.norm_eps,
        flip_sin_to_cos=spec.flip_sin_to_cos, freq_shift=spec.freq_shift,
        attn_down=spec.attn_down, attn_up=spec.attn_up,
    )


def _load(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def unet(spec: UNetSpec, state_dict: dict):
    from tokenflow_torch.models.unet2d import UNet2DConditionModel

    with torch.device("meta"):
        model = UNet2DConditionModel(_port_config(spec))
    return _load(model, state_dict)


def controlnet(spec: UNetSpec, state_dict: dict):
    from tokenflow_torch.models.controlnet import COND_CHANNELS, ControlNetModel

    if spec.cond_channels != COND_CHANNELS:
        raise ValueError(f"the port's conditioning embedding has {COND_CHANNELS}")
    with torch.device("meta"):
        model = ControlNetModel(_port_config(spec), len(spec.cond_channels) - 1)
    return _load(model, state_dict)
