"""DDIM's tables, worked out from a diffusers ``scheduler_config.json`` and
the traffic's step counts (Song et al., 2021; diffusers' DDIMScheduler
with eta 0, "leading" spacing; TokenFlow's inversion save grid and PnP
gates; SDEdit's truncation as TokenFlow's script writes it)."""

from __future__ import annotations

import numpy as np


def alphas_cumprod(sched: dict) -> np.ndarray:
    if sched.get("beta_schedule") != "scaled_linear" or sched.get("prediction_type",
                                                                    "epsilon") != "epsilon":
        raise ValueError("the reference follows scaled-linear betas and eps prediction")
    n = sched["num_train_timesteps"]
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def final_alpha(sched: dict, ac: np.ndarray) -> float:
    return 1.0 if sched.get("set_alpha_to_one", False) else float(ac[0])


def timesteps(sched: dict, steps: int) -> np.ndarray:
    """The descending grid of ``steps`` inference steps."""
    ratio = sched["num_train_timesteps"] // steps
    return (np.arange(steps) * ratio)[::-1].astype(np.int64) + sched.get("steps_offset", 0)


def save_grid(sched: dict, save_steps: int) -> np.ndarray:
    """The trajectory's save timesteps, ascending (one slot each)."""
    return timesteps(sched, save_steps)[::-1].copy()


def edit_tables(sched: dict, traffic: dict) -> dict:
    """Per edit step: t, alpha_t, alpha_prev, the trajectory slot of t, and
    the PnP q/k and conv gates. ``traffic["start"]`` truncates as SDEdit
    does: ``timesteps[int(1 - start * n):]``."""
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
    }


def inversion_tables(sched: dict, traffic: dict) -> dict:
    """Per inversion step (ascending t): t, alpha_t, alpha_prev, and the
    trajectory slot it writes (-1: none)."""
    ac = alphas_cumprod(sched)
    t_asc = timesteps(sched, traffic["timesteps"])[::-1].copy()
    alpha_prev = np.concatenate([[final_alpha(sched, ac)], ac[t_asc[:-1]]])
    slot = {int(t): i for i, t in enumerate(save_grid(sched, traffic["save_steps"]))}
    return {
        "t": t_asc.astype(np.int64),
        "alpha_t": ac[t_asc].astype(np.float32),
        "alpha_prev": alpha_prev.astype(np.float32),
        "slot": np.asarray([slot.get(int(t), -1) for t in t_asc]),
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
