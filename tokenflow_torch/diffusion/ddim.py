"""DDIM scheduler (eta = 0), the counterpart of
``tokenflow_tpu/diffusion/ddim.py``.

The schedule tables stay host-side numpy, exactly as in JAX (same
``DDIMSchedule``, ``make_schedule``, ``truncate_schedule``,
``get_timesteps`` and ``save_grid`` semantics); the update rules work on
tensors. The rules compute in at least fp32: the JAX loops feed float32
alpha arrays, which promote bf16 latents to fp32, and callers cast the
result back to the carry dtype.

Math parity targets (Stable Diffusion scheduler config): scaled-linear
betas 0.00085..0.012 over 1000 steps, "leading" spacing with
steps_offset=1, final_alpha_cumprod = alphas_cumprod[0], epsilon
prediction, no clipping.

The update rules take the model's output as eps (``prediction_type``
"epsilon", the default, the SD models') or as v ("v_prediction",
HunyuanDiT's): v is turned into eps and x0 in fp32 at the level the sample
sits at, x0 = sqrt(a) x - sqrt(1 - a) v and eps = sqrt(a) v + sqrt(1 - a) x
(Salimans & Ho, 2022; diffusers' DDIMScheduler), and the eps path is the
same operations as before. Guidance is affine in the output, so the loops
guide the raw output and convert after.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Static schedule tables; ``timesteps`` is the descending grid."""

    num_train_timesteps: int
    num_inference_steps: int
    alphas_cumprod: np.ndarray  # (num_train_timesteps,) float32
    final_alpha_cumprod: float
    timesteps: np.ndarray  # (num_inference_steps,) int32, descending

    def step_alphas(self) -> tuple[np.ndarray, np.ndarray]:
        """(alpha_t, alpha_prev) per sampling step via t_prev = t - N/steps
        (diffusers DDIMScheduler.step)."""
        step = self.num_train_timesteps // self.num_inference_steps
        t = self.timesteps
        t_prev = t - step
        alpha_t = self.alphas_cumprod[t]
        alpha_prev = np.where(
            t_prev >= 0,
            self.alphas_cumprod[np.clip(t_prev, 0, None)],
            self.final_alpha_cumprod,
        )
        return alpha_t.astype(np.float32), alpha_prev.astype(np.float32)

    def inversion_alphas(self) -> tuple[np.ndarray, np.ndarray]:
        """(alpha_t, alpha_prev) per inversion step, ascending t
        (reference preprocess.py:211-215)."""
        t_asc = self.timesteps[::-1]
        alpha_t = self.alphas_cumprod[t_asc]
        alpha_prev = np.concatenate(
            [
                np.asarray([self.final_alpha_cumprod], dtype=np.float32),
                self.alphas_cumprod[t_asc[:-1]],
            ]
        )
        return alpha_t.astype(np.float32), alpha_prev.astype(np.float32)

    def recon_alphas(self) -> tuple[np.ndarray, np.ndarray]:
        """(alpha_t, alpha_prev) per reconstruction step, descending
        (reference preprocess.py:245-250)."""
        t = self.timesteps
        alpha_t = self.alphas_cumprod[t]
        alpha_prev = np.concatenate(
            [
                self.alphas_cumprod[t[1:]],
                np.asarray([self.final_alpha_cumprod], dtype=np.float32),
            ]
        )
        return alpha_t.astype(np.float32), alpha_prev.astype(np.float32)


def make_schedule(
    num_inference_steps: int,
    *,
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    steps_offset: int = 1,
    set_alpha_to_one: bool = False,
) -> DDIMSchedule:
    """The static schedule (diffusers "leading" spacing)."""
    betas = (
        np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
        ** 2
    )
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    final_alpha = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (
        (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        + steps_offset
    )
    return DDIMSchedule(
        num_train_timesteps=num_train_timesteps,
        num_inference_steps=num_inference_steps,
        alphas_cumprod=alphas_cumprod,
        final_alpha_cumprod=final_alpha,
        timesteps=timesteps.astype(np.int32),
    )


def truncate_schedule(sched: DDIMSchedule, start: float) -> DDIMSchedule:
    """SDEdit truncation with the reference's operator precedence:
    ``timesteps[int(1 - start * len(timesteps)):]``
    (run_tokenflow_sdedit.py:57)."""
    ts = sched.timesteps
    return dataclasses.replace(sched, timesteps=ts[int(1 - start * len(ts)) :])


def get_timesteps(sched: DDIMSchedule, strength: float) -> tuple[np.ndarray, int]:
    """Keep the last ``int(steps * strength)`` timesteps
    (reference preprocess.py:17-24)."""
    n = sched.num_inference_steps
    init_timestep = min(int(n * strength), n)
    t_start = max(n - init_timestep, 0)
    return sched.timesteps[t_start:], n - t_start


def save_grid(
    inversion_steps: int, save_steps: int, num_train_timesteps: int = 1000,
    steps_offset: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(save_timesteps ascending, per-inversion-step save mask, per-step
    slot) of the trajectory save grid (reference preprocess.py:227-229,
    297-301), both grids at the scheduler's ``steps_offset`` (SD's 1 by
    default), so an edit's timesteps lie on it at any offset."""
    toy = make_schedule(save_steps, num_train_timesteps=num_train_timesteps,
                        steps_offset=steps_offset).timesteps[::-1]
    inv = make_schedule(
        inversion_steps, num_train_timesteps=num_train_timesteps, steps_offset=steps_offset
    ).timesteps[::-1]
    save_set = {int(t): i for i, t in enumerate(toy)}
    mask = np.asarray([int(t) in save_set for t in inv])
    slot = np.asarray([save_set.get(int(t), 0) for t in inv], dtype=np.int32)
    return toy.astype(np.int32), mask, slot


# ---------------------------------------------------------------------------
# update rules; alphas are python/numpy scalars or 0-dim tensors
# ---------------------------------------------------------------------------


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _alpha(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


PREDICTION_TYPES = ("epsilon", "v_prediction")


def check_prediction_type(prediction_type: str) -> None:
    if prediction_type not in PREDICTION_TYPES:
        raise ValueError(f"prediction_type {prediction_type!r} is not one of {PREDICTION_TYPES}")


def v_to_x0_eps(x_t, v, alpha):
    """(x0, eps) of a v-prediction ``v`` for the sample ``x_t`` at level
    ``alpha``, in fp32: x0 = sqrt(a) x - sqrt(1-a) v, eps = sqrt(a) v +
    sqrt(1-a) x."""
    x_t, v = _f32(x_t), _f32(v)
    a = _alpha(alpha, x_t)
    sa, s1 = torch.sqrt(a), torch.sqrt(1.0 - a)
    return sa * x_t - s1 * v, sa * v + s1 * x_t


def pred_x0_from_eps(x_t, eps, alpha_t):
    """x0 estimate: (x_t - sqrt(1-a_t) eps) / sqrt(a_t)."""
    x_t, eps = _f32(x_t), _f32(eps)
    a = _alpha(alpha_t, x_t)
    return (x_t - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)


def ddim_step(x_t, eps, alpha_t, alpha_prev, prediction_type: str = "epsilon"):
    """One deterministic DDIM denoising step (diffusers DDIMScheduler.step,
    reference run_tokenflow_pnp.py:217); ``eps`` is the model's (guided)
    output of kind ``prediction_type``, read at ``alpha_t``."""
    check_prediction_type(prediction_type)
    if prediction_type == "v_prediction":
        x0, eps = v_to_x0_eps(x_t, eps, alpha_t)
    else:
        x0 = pred_x0_from_eps(x_t, eps, alpha_t)
    a_prev = _alpha(alpha_prev, x0)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * _f32(eps)


def ddim_invert_step(x_t, eps, alpha_t, alpha_prev, prediction_type: str = "epsilon"):
    """One closed-form DDIM inversion step, ascending t (reference
    preprocess.py:217-225); ``eps`` is the model's output of kind
    ``prediction_type`` for ``x_t``, which sits at ``alpha_prev``."""
    check_prediction_type(prediction_type)
    if prediction_type == "v_prediction":
        x0, eps = v_to_x0_eps(x_t, eps, alpha_prev)
        a = _alpha(alpha_t, x0)
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    x_t, eps = _f32(x_t), _f32(eps)
    a, a_prev = _alpha(alpha_t, x_t), _alpha(alpha_prev, x_t)
    x0 = (x_t - torch.sqrt(1.0 - a_prev) * eps) / torch.sqrt(a_prev)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps


def add_noise(x0, eps, alpha_t):
    """sqrt(a_t) x0 + sqrt(1-a_t) eps (diffusers add_noise)."""
    x0, eps = _f32(x0), _f32(eps)
    a = _alpha(alpha_t, x0)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps


def recover_eps(x_t, x0, alpha_t):
    """Implied noise of a noisy/clean pair (reference
    run_tokenflow_pnp.py:186-193)."""
    x_t, x0 = _f32(x_t), _f32(x0)
    a = _alpha(alpha_t, x_t)
    return (x_t - torch.sqrt(a) * x0) / torch.sqrt(1.0 - a)


def classifier_free_guidance(eps_uncond, eps_cond, scale):
    """eps_uncond + scale * (eps_cond - eps_uncond) (reference
    run_tokenflow_pnp.py:214)."""
    return eps_uncond + scale * (eps_cond - eps_uncond)
