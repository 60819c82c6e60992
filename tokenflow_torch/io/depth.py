"""Per-frame depth conditioning for the depth-conditioned models
(``sd_version`` ``depth``), the counterpart of ``tokenflow_tpu/io/depth.py``.

Sources, in order:

  1. precomputed maps ``{data_path}/depth/%05d.npy`` (raw predictions, any
     H x W), as :func:`compute_dpt_depth` and :func:`compute_midas_depth`
     cache them;
  2. the port's DPT (``models/dpt.py``) on a checkpoint given explicitly
     (``model_dir``: an HF ``Intel/dpt-large`` snapshot directory or one
     ``.safetensors``/``.bin`` file, the weights torch.hub serves as
     MiDaS DPT_Large);
  3. MiDaS through torch.hub, where its cache is present;
  4. otherwise a clear error.

Maps are bicubic-resized to the latent size and min-max normalized per
frame to [-1, 1], as the reference does (preprocess.py:100-108).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tokenflow_torch.io.video import frame_paths
from tokenflow_torch.utils import fp32_products


def _normalize_resize(pred: np.ndarray, latent_hw) -> np.ndarray:
    """(H, W) raw depth -> (h, w, 1) in [-1, 1] (bicubic, per-frame
    min-max; reference preprocess.py:100-108)."""
    import cv2

    h, w = latent_hw
    d = cv2.resize(pred.astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    dmin, dmax = d.min(), d.max()
    d = 2.0 * (d - dmin) / max(dmax - dmin, 1e-8) - 1.0
    return d[..., None]


def depth_paths(data_path: str, n_frames: int) -> list[str]:
    return [os.path.join(data_path, "depth", f"{i:05d}.npy") for i in range(n_frames)]


def load_or_compute_depth(
    data_path: str, n_frames: int, latent_hw, *, model_dir: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """-> (F, h, w, 1) float32 in [-1, 1], from the first source that has
    them (module docstring); the DPT and MiDaS run on ``device``."""
    pre = depth_paths(data_path, n_frames)
    if os.path.exists(pre[0]):
        return np.stack([_normalize_resize(np.load(p), latent_hw) for p in pre])
    if model_dir:
        return compute_dpt_depth(data_path, n_frames, latent_hw, model_dir, device=device)
    try:
        return compute_midas_depth(data_path, n_frames, latent_hw, device=device)
    except Exception as e:  # no hub cache, no network
        depth_dir = os.path.dirname(pre[0])
        raise RuntimeError(
            f"depth maps unavailable: no precomputed {depth_dir}/%05d.npy and MiDaS "
            f"could not run ({e}). Pass depth_model_dir (preprocess: "
            f"--depth_model_dir) an Intel/dpt-large checkpoint for the port's DPT, "
            f"precompute depth with tokenflow_torch.io.depth.compute_midas_depth on "
            f"a machine with the MiDaS torch.hub cache, or drop .npy files into "
            f"{depth_dir}/."
        ) from e


def load_dpt_model(ckpt: str, config=None, device: torch.device | str = "cpu"):
    """An HF ``Intel/dpt-large`` checkpoint (snapshot directory or one
    .safetensors/.bin file) in the port's ``DPTDepthModel``, fp32, on
    ``device``. Keys load by name; only ``models.dpt.UNREAD_KEYS`` are
    dropped, any other missing or unexpected key raises."""
    from tokenflow_torch.models import weights as weights_lib
    from tokenflow_torch.models.dpt import DPTConfig, DPTDepthModel

    if os.path.isdir(ckpt):
        sd = weights_lib.load_component_state_dict(ckpt)
    else:
        sd = weights_lib.load_file(ckpt)
    sd = {k: v.float() for k, v in weights_lib.normalize_state_dict(sd, "dpt").items()}
    with torch.device("meta"):
        model = DPTDepthModel(config or DPTConfig.dpt_large())
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).eval().requires_grad_(False)


def dpt_inputs(data_path: str, n_frames: int, input_size: int = 384) -> np.ndarray:
    """Frames as the HF DPTImageProcessor of Intel/dpt-large prepares them:
    bilinear resize to input_size^2, 1/255, mean = std = 0.5 (the
    square-input equivalent of the reference's hub transform) ->
    (F, S, S, 3) float32."""
    import cv2

    imgs = []
    for p in frame_paths(data_path, n_frames):
        img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (input_size, input_size), interpolation=cv2.INTER_LINEAR)
        imgs.append((img.astype(np.float32) / 255.0 - 0.5) / 0.5)
    return np.stack(imgs)


@torch.inference_mode()
def predict_depth(model, pixels: np.ndarray, batch: int = 8) -> np.ndarray:
    """The DPT's raw predictions (F, S, S) for (F, S, S, 3) inputs, in
    batches of ``batch`` frames on the model's device, fp32 products."""
    device = next(model.parameters()).device
    preds = []
    with fp32_products():
        for i in range(0, len(pixels), batch):
            x = torch.as_tensor(pixels[i : i + batch], device=device)
            preds.append(model(x).float().cpu().numpy())
    return np.concatenate(preds)


def _cache_and_normalize(data_path: str, preds, latent_hw) -> np.ndarray:
    """Writes each raw prediction to depth/%05d.npy -> the normalized maps."""
    paths = depth_paths(data_path, len(preds))
    os.makedirs(os.path.dirname(paths[0]), exist_ok=True)
    out = []
    for p, pred in zip(paths, preds):
        np.save(p, pred)
        out.append(_normalize_resize(pred, latent_hw))
    return np.stack(out)


def compute_dpt_depth(
    data_path: str,
    n_frames: int,
    latent_hw,
    ckpt: str,
    batch: int = 8,
    input_size: int = 384,
    config=None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """MiDaS DPT-Large through the port's DPT on ``device``: raw predictions
    cached to depth/%05d.npy as the hub path caches them -> (F, h, w, 1)."""
    model = load_dpt_model(ckpt, config, device)
    preds = predict_depth(model, dpt_inputs(data_path, n_frames, input_size), batch)
    return _cache_and_normalize(data_path, preds, latent_hw)


def compute_midas_depth(
    data_path: str, n_frames: int, latent_hw, model_type: str = "DPT_Large",
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """MiDaS through torch.hub (needs the hub cache or the network), with
    the reference's settings (preprocess.py:77-97), on ``device``."""
    import cv2

    midas = torch.hub.load("intel-isl/MiDaS", model_type)
    midas.to(device).eval()
    transforms = torch.hub.load("intel-isl/MiDaS", "transforms")
    transform = (
        transforms.dpt_transform
        if model_type in ("DPT_Large", "DPT_Hybrid")
        else transforms.small_transform
    )
    preds = []
    with torch.inference_mode(), fp32_products():
        for p in frame_paths(data_path, n_frames):
            img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            preds.append(midas(transform(img).to(device)).squeeze(0).float().cpu().numpy())
    return _cache_and_normalize(data_path, preds, latent_hw)
