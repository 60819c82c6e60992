"""ControlNet conditioning helpers for the port's CLIs, the counterpart of
``tokenflow_tpu/cli/controlnet_utils.py``.

Canny-edge conditioning as the reference computes it (thresholds 100/200 on
``(f * 255).astype(uint8)``, the one channel replicated x3, /255). The
ControlNet weights come from a local diffusers-layout directory of
``lllyasviel/sd-controlnet-canny`` (``controlnet_dir``, or under
``$TOKENFLOW_MODELS``) or, with ``init="random"`` or none found, from seeded
random weights whose projections are zero (a fresh ControlNet changes
nothing). Nothing is downloaded.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import cv2
import numpy as np
import torch

from tokenflow_torch import runtime
from tokenflow_torch.models import weights as weights_lib
from tokenflow_torch.models.controlnet import ControlNetModel
from tokenflow_torch.models.unet2d import UNet2DConfig

CONTROLNET_KEY = "lllyasviel/sd-controlnet-canny"
CONTROLNET_SEED = 1  # random init (the stack's models draw from seed 0)


def canny_cond(frames: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """float (F, H, W, 3) in [0, 1] -> canny cond (F, H, W, 3) in {0, 1}."""
    out = []
    for f in frames:
        edges = cv2.Canny((f * 255).astype(np.uint8), low, high)
        out.append(np.repeat(edges[..., None], 3, axis=-1).astype(np.float32) / 255.0)
    return np.stack(out)


def resolve_controlnet_dir(model_dir: Optional[str] = None) -> Optional[str]:
    """``model_dir`` if it is a directory, else ``$TOKENFLOW_MODELS/<key>``
    (or its last part), else None."""
    if model_dir and os.path.isdir(model_dir):
        return model_dir
    root = os.environ.get("TOKENFLOW_MODELS")
    if root:
        for cand in (os.path.join(root, CONTROLNET_KEY),
                     os.path.join(root, CONTROLNET_KEY.split("/")[-1])):
            if os.path.isdir(cand):
                return cand
    return None


@functools.lru_cache(maxsize=1)
def _build(config: UNet2DConfig, cond_downsamples: int, found, dtype, device) -> ControlNetModel:
    """The most recent ControlNet is held, as the stack is, so chained
    stages in one process (preprocess, then the editor) share its weights."""
    with torch.device(device):
        model = ControlNetModel(config, cond_downsamples)
    if found is not None:
        weights_lib.load_into(model, found, "controlnet")
    else:
        weights_lib.init_random_(
            model, torch.Generator(device=device).manual_seed(CONTROLNET_SEED)
        )
    return model.to(dtype).eval().requires_grad_(False)


def load_controlnet(
    stack: runtime.SDStack, model_dir: Optional[str] = None, init: str = "auto"
) -> ControlNetModel:
    """The ControlNet for ``stack``: its encoder mirrors the stack's UNet
    config (SD-1.5 for the canny checkpoint), its cond embedder downsamples
    by the stack's VAE factor (x8 for SD, x2 for the tiny stack)."""
    found = None if init == "random" else resolve_controlnet_dir(model_dir)
    if found is None and init == "pretrained":
        raise FileNotFoundError(
            f"no ControlNet checkpoint ({CONTROLNET_KEY}); set $TOKENFLOW_MODELS "
            "or pass controlnet_dir"
        )
    vae_factor = 2 ** (len(stack.vae.config.block_out_channels) - 1)
    return _build(stack.unet.config, int(math.log2(vae_factor)), found, stack.dtype,
                  stack.device)


def build_controlnet(
    stack: runtime.SDStack,
    frames: np.ndarray,
    controlnet_dir: Optional[str] = None,
    init: str = "auto",
) -> tuple[ControlNetModel, torch.Tensor]:
    """-> (model, canny cond (F, H, W, 3) on the stack's device, its dtype)."""
    model = load_controlnet(stack, controlnet_dir, init)
    canny = torch.as_tensor(canny_cond(np.asarray(frames)), device=stack.device)
    return model, canny.to(stack.dtype)
