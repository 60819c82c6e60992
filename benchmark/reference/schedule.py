"""DDIM's tables, worked out from a diffusers ``scheduler_config.json`` and
the traffic's step counts (Song et al., 2021; diffusers' DDIMScheduler
with eta 0, "leading" spacing; TokenFlow's inversion save grid and PnP
gates; SDEdit's truncation as TokenFlow's script writes it).

What the reference follows of a scheduler, and so what both sides of the
check run (:func:`check`; ``program.py`` builds the program's schedule
from the same numbers, :func:`ddim_parameters`):

- ``beta_schedule`` "scaled_linear", with any ``beta_start``, ``beta_end``
  and ``num_train_timesteps``; ``trained_betas`` null or absent;
- ``steps_offset`` (absent: 0) and ``set_alpha_to_one`` (absent: false);
- ``prediction_type`` "epsilon" (also when absent) or "v_prediction";
- ``timestep_spacing`` "leading" (also when absent, as in SD-1.5's and
  SD-2.1's configs);
- ``clip_sample``, ``thresholding`` and ``rescale_betas_zero_snr`` false
  or absent.

Any other value of these keys is refused by name. Every other key is a
sampler's own (PNDM's ``skip_prk_steps``, Euler's ``use_karras_sigmas``)
and does not touch DDIM."""

from __future__ import annotations

import numpy as np

# key -> (value when absent, the values followed)
FOLLOWED = {
    "beta_schedule": (None, ("scaled_linear",)),
    "prediction_type": ("epsilon", ("epsilon", "v_prediction")),
    "timestep_spacing": ("leading", ("leading",)),
    "trained_betas": (None, (None,)),
    "clip_sample": (False, (False,)),
    "thresholding": (False, (False,)),
    "rescale_betas_zero_snr": (False, (False,)),
}


def check(sched: dict) -> None:
    """Refuse, by key and value, a scheduler the reference does not follow."""
    for key, (absent, followed) in FOLLOWED.items():
        value = sched.get(key, absent)
        if value not in followed:
            raise ValueError(
                f"scheduler {key}={value!r}: the benchmark's DDIM follows "
                f"{key} in {list(followed)} only (benchmark/reference/schedule.py)")


def prediction_type(sched: dict) -> str:
    """What the denoiser's output is: "epsilon" or "v_prediction"."""
    check(sched)
    return sched.get("prediction_type", "epsilon")


def ddim_parameters(sched: dict) -> dict:
    """The numbers DDIM's tables are made of, under the names of the
    program's ``ddim.make_schedule``."""
    check(sched)
    return {"num_train_timesteps": sched["num_train_timesteps"],
            "beta_start": sched["beta_start"], "beta_end": sched["beta_end"],
            "steps_offset": sched.get("steps_offset", 0),
            "set_alpha_to_one": sched.get("set_alpha_to_one", False)}


def alphas_cumprod(sched: dict) -> np.ndarray:
    p = ddim_parameters(sched)
    betas = np.linspace(p["beta_start"] ** 0.5, p["beta_end"] ** 0.5,
                        p["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def final_alpha(sched: dict, ac: np.ndarray) -> float:
    return 1.0 if ddim_parameters(sched)["set_alpha_to_one"] else float(ac[0])


def timesteps(sched: dict, steps: int) -> np.ndarray:
    """The descending grid of ``steps`` inference steps."""
    p = ddim_parameters(sched)
    ratio = p["num_train_timesteps"] // steps
    return (np.arange(steps) * ratio)[::-1].astype(np.int64) + p["steps_offset"]


def save_grid(sched: dict, save_steps: int) -> np.ndarray:
    """The trajectory's save timesteps, ascending (one slot each)."""
    return timesteps(sched, save_steps)[::-1].copy()


def edit_tables(sched: dict, traffic: dict) -> dict:
    """Per edit step: t, alpha_t, alpha_prev, the trajectory slot of t, and
    the PnP q/k and conv gates; and the denoiser's ``prediction_type``.
    ``traffic["start"]`` truncates as SDEdit does:
    ``timesteps[int(1 - start * n):]``."""
    n = traffic["timesteps"]
    ac = alphas_cumprod(sched)
    ts = timesteps(sched, n)
    if traffic.get("start") is not None:
        ts = ts[int(1 - traffic["start"] * len(ts)):]
    t_prev = ts - sched["num_train_timesteps"] // n
    alpha_prev = np.where(t_prev >= 0, ac[np.clip(t_prev, 0, None)], final_alpha(sched, ac))
    slot = {int(t): i for i, t in enumerate(save_grid(sched, traffic["save_steps"]))}
    idx = np.arange(len(ts))
    return {
        "t": ts.astype(np.int64),
        "alpha_t": ac[ts].astype(np.float32),
        "alpha_prev": alpha_prev.astype(np.float32),
        "slot": np.asarray([slot[int(t)] for t in ts]),
        "qk_gate": idx < int(n * traffic.get("pnp_attn_t", 0.0)),
        "conv_gate": idx < int(n * traffic.get("pnp_f_t", 0.0)),
        "prediction_type": prediction_type(sched),
    }


def inversion_tables(sched: dict, traffic: dict) -> dict:
    """Per inversion step (ascending t): t, alpha_t, alpha_prev, and the
    trajectory slot it writes (-1: none); and the denoiser's
    ``prediction_type``."""
    ac = alphas_cumprod(sched)
    t_asc = timesteps(sched, traffic["timesteps"])[::-1].copy()
    alpha_prev = np.concatenate([[final_alpha(sched, ac)], ac[t_asc[:-1]]])
    slot = {int(t): i for i, t in enumerate(save_grid(sched, traffic["save_steps"]))}
    return {
        "t": t_asc.astype(np.int64),
        "alpha_t": ac[t_asc].astype(np.float32),
        "alpha_prev": alpha_prev.astype(np.float32),
        "slot": np.asarray([slot.get(int(t), -1) for t in t_asc]),
        "prediction_type": prediction_type(sched),
    }


def propagation_indices(n_frames: int, window: int):
    """Per frame: own-window pivot pa, previous window's pb (window 0: its
    own), and pa's blend weight, the sigmoid of the distance share with
    each pivot taken at its window's centre."""
    f = np.arange(n_frames)
    pa = f // window
    pb = np.maximum(pa - 1, 0)
    d1 = np.abs(f - (pa * window + window // 2)).astype(np.float64)
    d2 = np.abs(f - (pb * window + window // 2)).astype(np.float64)
    w1 = 1.0 / (1.0 + np.exp(-(d2 / (d1 + d2 + 1e-8))))
    return pa, pb, w1.astype(np.float32)
