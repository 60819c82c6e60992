"""DDIM inversion and reconstruction with an in-memory latent trajectory,
the counterpart of ``tokenflow_tpu/diffusion/inversion.py`` written as
Python loops. The UNet enters as ``eps_fn(x, t) -> eps``. Each step is a
``tf.step`` span, its update a ``tf.ddim`` span (``profiling.span``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tokenflow_torch.diffusion import ddim
from tokenflow_torch.profiling import span

EpsFn = Callable[[torch.Tensor, int], torch.Tensor]


def inversion_xs(
    sched: ddim.DDIMSchedule, save_steps: int
) -> tuple[tuple[np.ndarray, ...], np.ndarray]:
    """Per-step tables ((alpha_t, alpha_prev, t_asc, save_mask, save_slot),
    save_ts), as tokenflow_tpu/diffusion/inversion.py:47-57."""
    # the grid's smallest timestep is the schedule's offset
    save_ts, save_mask, save_slot = ddim.save_grid(
        sched.num_inference_steps, save_steps, sched.num_train_timesteps,
        steps_offset=int(sched.timesteps[-1]),
    )
    alpha_t, alpha_prev = sched.inversion_alphas()
    t_asc = np.ascontiguousarray(sched.timesteps[::-1]).astype(np.int32)
    return (alpha_t, alpha_prev, t_asc, save_mask, save_slot), save_ts


@torch.inference_mode()
def ddim_inversion(
    eps_fn: EpsFn,
    latents: torch.Tensor,  # (F, h, w, 4)
    sched: ddim.DDIMSchedule,
    save_steps: int,
    *,
    steps: Optional[slice] = None,
    carry: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    prediction_type: str = "epsilon",
) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Invert clean latents to noise, recording the save-grid trajectory
    (reference preprocess.py:198-230, conditional-only embedding).

    ``steps`` (a slice of the inversion's step indices, default all) and
    ``carry`` ((x, trajectory) after the steps before it, default the clean
    latents and a zero trajectory) run one segment of the inversion:
    segments run in order, each on the previous one's carry, compute what
    one call computes. A save slot that is not on the inversion grid keeps
    its zero row.

    ``prediction_type``: what ``eps_fn`` returns, "epsilon" or
    "v_prediction" (converted at the level the step's sample sits at,
    ``alpha_prev``: ``ddim.ddim_invert_step``).

    Returns (x_T, trajectory (n_save, F, h, w, 4) ascending, save_ts)."""
    ddim.check_prediction_type(prediction_type)
    (alpha_t, alpha_prev, t_asc, mask, slot), save_ts = inversion_xs(sched, save_steps)
    if carry is None:
        x = latents
        traj = torch.zeros((save_steps, *latents.shape), dtype=latents.dtype,
                           device=latents.device)
    else:
        x, traj = carry
    for i in range(len(t_asc))[steps or slice(None)]:
        with span("tf.step"):
            eps = eps_fn(x, int(t_asc[i]))
            with span("tf.ddim"):
                x = ddim.ddim_invert_step(x, eps, alpha_t[i], alpha_prev[i],
                                          prediction_type).to(x.dtype)
            if mask[i]:
                traj[int(slot[i])] = x
    return x, traj, save_ts


def segmented_inversion(eps_fn: EpsFn, latents: torch.Tensor, sched: ddim.DDIMSchedule,
                        save_steps: int, *, segments=None, checkpoint=None):
    """:func:`ddim_inversion` in ``segments`` (slices of the step indices,
    default one), the counterpart of
    ``tokenflow_tpu/sharding/mesh.py::sharded_inversion``. The segments run
    in order on one carry, which ``checkpoint`` (a
    ``cli.common.SegmentCheckpointer``, or None) resumes and saves at their
    boundaries. Inversion is frame-parallel: over a frames group each rank
    passes its own block of the frames as ``latents`` and needs no
    communication. Returns x_T, the trajectory and the save grid;
    ``sharding.mesh.gather_to_rank0`` collects a rank's for saving (x_T
    along axis 0, the trajectory along axis 1)."""
    segments = segments or [slice(None)]
    traj = torch.zeros((save_steps, *latents.shape), dtype=latents.dtype,
                       device=latents.device)
    start, (x, traj) = (0, (latents, traj)) if checkpoint is None else \
        checkpoint.resume((latents, traj), len(segments))
    save_ts = inversion_xs(sched, save_steps)[1]
    for i, steps in enumerate(segments):
        if i < start:
            continue
        x, traj, save_ts = ddim_inversion(
            eps_fn, latents, sched, save_steps, steps=steps, carry=(x, traj))
        if checkpoint is not None:
            checkpoint.save(i, len(segments), (x, traj))
    if checkpoint is not None:
        checkpoint.done()
    return x, traj, save_ts


@torch.inference_mode()
def ddim_reconstruction(
    eps_fn: EpsFn, x_T: torch.Tensor, sched: ddim.DDIMSchedule
) -> torch.Tensor:
    """Sample back from the inverted noise (reference preprocess.py:232-261,
    the inverted.mp4 sanity check)."""
    alpha_t, alpha_prev = sched.recon_alphas()
    x = x_T
    for i, t in enumerate(sched.timesteps):
        with span("tf.step"):
            eps = eps_fn(x, int(t))
            with span("tf.ddim"):
                x = ddim.ddim_step(x, eps, alpha_t[i], alpha_prev[i]).to(x.dtype)
    return x
