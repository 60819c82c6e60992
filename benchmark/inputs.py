"""A cell's inputs, made from the run's seed: a smooth synthetic video that
pans by a few pixels a frame, its latents, canny conditioning images, the
prompt embeddings, the source trajectory an edit starts from, and the
pivot frames of every edit step. The traffic fixes every size; the seed
moves only values, so every seed gives the same work."""

from __future__ import annotations

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from reference import schedule
from weights import sub_seed

SALT_VIDEO, SALT_LATENT, SALT_NOISE, SALT_TEXT, SALT_PIVOTS = range(10, 15)
LATENT_FACTOR = 8  # the SD VAE's downsampling


def _gen(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, salt))


def video(traffic: dict, seed: int, device) -> torch.Tensor:
    """(F, H, H, 3) fp32 in [0, 1]: frame f is a window into one wide random
    field, moved ``motion_px`` pixels to the right per frame."""
    f, h, step = traffic["frames"], traffic["resolution"], traffic["motion_px"]
    width = h + step * (f - 1)
    gen = _gen(seed, SALT_VIDEO, device)
    coarse = torch.rand((1, 3, h // 32 + 2, width // 32 + 2), generator=gen, device=device)
    fine = torch.rand((1, 3, h // 8 + 2, width // 8 + 2), generator=gen, device=device)
    field = (F.interpolate(coarse, size=(h, width), mode="bicubic", align_corners=False)
             + 0.3 * (F.interpolate(fine, size=(h, width), mode="bilinear",
                                    align_corners=False) - 0.5)).clamp(0, 1)
    return torch.stack([field[0, :, :, i * step : i * step + h] for i in range(f)]).permute(
        0, 2, 3, 1).contiguous()


def latents(frames: torch.Tensor, seed: int) -> torch.Tensor:
    """(F, h, h, 4) fp32 clean latents with unit spread: the frames pooled
    to the latent grid and mixed into four channels by a seeded matrix."""
    gen = _gen(seed, SALT_LATENT, frames.device)
    pooled = F.avg_pool2d(frames.permute(0, 3, 1, 2), LATENT_FACTOR) - 0.5
    mix = torch.randn((4, 3), generator=gen, device=frames.device)
    lat = torch.einsum("ck,fkhw->fhwc", mix, pooled)
    lat = lat + 0.1 * torch.randn(lat.shape, generator=gen, device=frames.device)
    return lat / lat.std()


def canny(frames: torch.Tensor, low: int = 100, high: int = 200) -> torch.Tensor:
    """(F, H, W, 3) canny edge images in {0, 1} (the one edge channel three
    times), on the frames' device."""
    imgs = (frames.cpu().numpy() * 255).astype(np.uint8)
    edges = np.stack([cv2.Canny(np.ascontiguousarray(im), low, high) for im in imgs])
    return torch.as_tensor(np.repeat(edges[..., None], 3, axis=-1) / 255.0,
                           dtype=torch.float32, device=frames.device)


def embeddings(n: int, width: int, seed: int, device) -> torch.Tensor:
    """(n, 77, width) prompt embeddings, unit normal (a text encoder's
    output after its final layer norm)."""
    return torch.randn((n, 77, width), generator=_gen(seed, SALT_TEXT, device), device=device)


def noise(shape, seed: int, device) -> torch.Tensor:
    return torch.randn(shape, generator=_gen(seed, SALT_NOISE, device), device=device)


def start_latents(x0: torch.Tensor, eps: torch.Tensor, tables: dict) -> torch.Tensor:
    """The latents an edit starts from: the clean latents noised to the
    first edit step's level, DDIM's forward formula at its alpha_t, or
    rectified flow's (1 - sigma) x0 + sigma eps at its sigma."""
    if tables["prediction_type"] == "flow":
        s0 = float(tables["sigma"][0])
        return (1 - s0) * x0 + s0 * eps
    ac0 = float(tables["alpha_t"][0])
    return ac0**0.5 * x0 + (1 - ac0) ** 0.5 * eps


def source_trajectory(x0: torch.Tensor, eps: torch.Tensor, sched: dict, save_steps: int):
    """(save_steps, F, h, w, 4) fp32: the clean latents noised to each save
    timestep with one noise per frame, DDIM's forward formula, or rectified
    flow's at each sigma of the ascending save grid."""
    if schedule.is_flow(sched):
        s = torch.as_tensor(schedule.flow_sigmas(sched, save_steps)[::-1].copy(),
                            device=x0.device)[:, None, None, None, None]
        return (1 - s) * x0[None] + s * eps[None]
    ac = schedule.alphas_cumprod(sched)
    a = torch.as_tensor(ac[schedule.save_grid(sched, save_steps)], device=x0.device)
    a = a[:, None, None, None, None]
    return torch.sqrt(a) * x0[None] + torch.sqrt(1 - a) * eps[None]


def pivots(n_steps: int, frames: int, window: int, seed: int) -> np.ndarray:
    """(n_steps, frames // window) pivot frames, one drawn in each window."""
    gen = torch.Generator().manual_seed(sub_seed(seed, SALT_PIVOTS))
    k = frames // window
    draw = torch.randint(0, window, (n_steps, k), generator=gen).numpy()
    return (draw + np.arange(k) * window).astype(np.int64)
