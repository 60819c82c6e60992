"""The samplers' tables, worked out from a diffusers ``scheduler_config.json``
and the traffic's step counts. Two families, chosen by the scheduler's
``_class_name``:

- rectified flow, for ``FlowMatchEulerDiscreteScheduler`` (Esser et al.,
  2024; diffusers' scheduler with a static shift): the state moves by
  (sigma_next - sigma) times the model's velocity;
- DDIM, for every other class (Song et al., 2021; diffusers' DDIMScheduler
  with eta 0, "leading" spacing; TokenFlow's inversion save grid and PnP
  gates).

Both truncate SDEdit as TokenFlow's script writes it, by index:
``steps[int(1 - start * n):]``.

What the reference follows of a DDIM scheduler, and so what both sides of
the check run (:func:`check`; ``program.py`` builds the program's schedule
from the same numbers, :func:`ddim_parameters`):

- ``beta_schedule`` "scaled_linear", with any ``beta_start``, ``beta_end``
  and ``num_train_timesteps``; ``trained_betas`` null or absent;
- ``steps_offset`` (absent: 0) and ``set_alpha_to_one`` (absent: false);
- ``prediction_type`` "epsilon" (also when absent) or "v_prediction";
- ``timestep_spacing`` "leading" (also when absent, as in SD-1.5's and
  SD-2.1's configs);
- ``clip_sample``, ``thresholding`` and ``rescale_betas_zero_snr`` false
  or absent.

What it follows of a flow scheduler (:func:`flow_parameters`):

- ``num_train_timesteps`` N and ``shift`` (absent: 1.0), any value > 0;
- ``use_dynamic_shifting``, ``invert_sigmas``, ``use_karras_sigmas``,
  ``use_exponential_sigmas``, ``use_beta_sigmas`` and
  ``stochastic_sampling`` false or absent; ``shift_terminal`` null or
  absent.

``base_shift``, ``max_shift``, ``base_image_seq_len``,
``max_image_seq_len`` and ``time_shift_type`` act only under dynamic
shifting, so they are accepted and ignored. The flow grid has no
inversion (TokenFlow defines none), and a flow traffic edits on the grid
it saves (``timesteps`` = ``save_steps``), since two float grids do not
nest.

Any other value of the keys followed is refused by name. Every other key is
a sampler's own (PNDM's ``skip_prk_steps``, Euler's ``use_karras_sigmas``)
and does not touch DDIM."""

from __future__ import annotations

import numpy as np

FLOW_CLASS = "FlowMatchEulerDiscreteScheduler"
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
FLOW_FOLLOWED = {
    "use_dynamic_shifting": (False, (False,)),
    "invert_sigmas": (False, (False,)),
    "use_karras_sigmas": (False, (False,)),
    "use_exponential_sigmas": (False, (False,)),
    "use_beta_sigmas": (False, (False,)),
    "stochastic_sampling": (False, (False,)),
    "shift_terminal": (None, (None,)),
}


def is_flow(sched: dict) -> bool:
    """Whether the scheduler is of the rectified-flow family."""
    return sched.get("_class_name") == FLOW_CLASS


def check(sched: dict) -> None:
    """Refuse, by key and value, a scheduler the reference does not follow."""
    flow = is_flow(sched)
    family = "flow Euler" if flow else "DDIM"
    for key, (absent, followed) in (FLOW_FOLLOWED if flow else FOLLOWED).items():
        value = sched.get(key, absent)
        if value not in followed:
            raise ValueError(
                f"scheduler {key}={value!r}: the benchmark's {family} follows "
                f"{key} in {list(followed)} only (benchmark/reference/schedule.py)")
    shift = sched.get("shift", 1.0)
    if flow and not (type(shift) in (int, float) and shift > 0):
        raise ValueError(f"scheduler shift={shift!r}: the benchmark's flow Euler follows "
                         "a shift > 0 only (benchmark/reference/schedule.py)")


def prediction_type(sched: dict) -> str:
    """What the denoiser's output is: "epsilon" or "v_prediction" under
    DDIM, "flow" (the velocity) under rectified flow."""
    check(sched)
    return "flow" if is_flow(sched) else sched.get("prediction_type", "epsilon")


def _refuse_family(sched: dict, wanted: str) -> None:
    raise ValueError(f"scheduler _class_name={sched.get('_class_name')!r}: not of the "
                     f"{wanted} family (benchmark/reference/schedule.py)")


def ddim_parameters(sched: dict) -> dict:
    """The numbers DDIM's tables are made of, under the names of the
    program's ``ddim.make_schedule``."""
    check(sched)
    if is_flow(sched):
        _refuse_family(sched, "DDIM")
    return {"num_train_timesteps": sched["num_train_timesteps"],
            "beta_start": sched["beta_start"], "beta_end": sched["beta_end"],
            "steps_offset": sched.get("steps_offset", 0),
            "set_alpha_to_one": sched.get("set_alpha_to_one", False)}


def flow_parameters(sched: dict) -> dict:
    """The numbers the flow grid is made of, under the names of the
    program's ``flow.make_schedule`` and ``flow.save_grid``."""
    check(sched)
    if not is_flow(sched):
        _refuse_family(sched, "flow")
    return {"num_train_timesteps": sched["num_train_timesteps"],
            "shift": float(sched.get("shift", 1.0))}


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


def flow_train_sigmas(sched: dict) -> np.ndarray:
    """The descending training sigmas, float32: i / N (i = N..1), shifted
    as shift s / (1 + (shift - 1) s) (diffusers'
    ``FlowMatchEulerDiscreteScheduler.__init__`` with a static shift)."""
    p = flow_parameters(sched)
    n_train, shift = p["num_train_timesteps"], p["shift"]
    s = np.linspace(1, n_train, n_train, dtype=np.float32)[::-1] / np.float32(n_train)
    return (np.float32(shift) * s / (1 + np.float32(shift - 1) * s)).astype(np.float32)


def flow_sigmas(sched: dict, steps: int) -> np.ndarray:
    """The descending sigmas of ``steps`` inference steps, float32, as
    diffusers' ``set_timesteps`` makes them with a static shift: the
    training sigmas' first and last, sigma_max and sigma_min, span
    linspace(sigma_max N, sigma_min N, steps) / N, shifted once more in
    float64 and kept in float32. The timesteps are sigma N, as floats."""
    p = flow_parameters(sched)
    n_train, shift = p["num_train_timesteps"], p["shift"]
    train = flow_train_sigmas(sched)
    sigma_max, sigma_min = float(train[0]), float(train[-1])
    grid = np.linspace(sigma_max * n_train, sigma_min * n_train, steps) / n_train
    return (shift * grid / (1 + (shift - 1) * grid)).astype(np.float32)


def _flow_edit_tables(sched: dict, traffic: dict) -> dict:
    n = traffic["timesteps"]
    if n != traffic["save_steps"]:
        raise ValueError(
            f"flow traffic timesteps={n} save_steps={traffic['save_steps']}: the flow grids "
            "of two step counts do not nest, so a flow edit runs on the grid it saves "
            "(benchmark/reference/schedule.py)")
    sigma = flow_sigmas(sched, n)
    sigma_next = np.append(sigma[1:], np.float32(0))
    if traffic.get("start") is not None:
        cut = int(1 - traffic["start"] * len(sigma))
        sigma, sigma_next = sigma[cut:], sigma_next[cut:]
    slot = {float(s): i for i, s in enumerate(flow_sigmas(sched, traffic["save_steps"])[::-1])}
    idx = np.arange(len(sigma))
    return {
        "t": sigma * np.float32(sched["num_train_timesteps"]),
        "sigma": sigma,
        "sigma_next": sigma_next,
        "slot": np.asarray([slot[float(s)] for s in sigma]),
        "qk_gate": idx < int(n * traffic.get("pnp_attn_t", 0.0)),
        "conv_gate": idx < int(n * traffic.get("pnp_f_t", 0.0)),
        "prediction_type": "flow",
    }


def edit_tables(sched: dict, traffic: dict) -> dict:
    """Per edit step: t, the trajectory slot of t, and the PnP q/k and conv
    gates; alpha_t and alpha_prev under DDIM, sigma and sigma_next (0 after
    the grid's last step) under flow; and the denoiser's
    ``prediction_type``. ``traffic["start"]`` truncates as SDEdit does:
    ``timesteps[int(1 - start * n):]``. A flow step's t is sigma N, a
    float; a flow slot is the step's index into the ascending save grid."""
    if is_flow(sched):
        return _flow_edit_tables(sched, traffic)
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
    ``prediction_type``. DDIM only: a flow scheduler is refused."""
    if is_flow(sched):
        raise ValueError(
            f"scheduler _class_name={FLOW_CLASS!r}: the benchmark has no flow inversion "
            "(TokenFlow defines none; benchmark/reference/schedule.py)")
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
