"""The system under test: the PyTorch and CUDA port's kernel library, its
dtypes, its schedule on a configuration's scheduler (DDIM, or rectified
flow for a ``FlowMatchEulerDiscreteScheduler``), and the loading
of the benchmark's state dict into a model of the port by key name, as the
port loads a diffusers checkpoint. The models themselves are built by the
architecture's module (``architectures/<name>.py::program_model``). Only
this module, the architectures' program side and the stage drivers import
the program."""

from __future__ import annotations

import torch

from reference import schedule as ref_schedule

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_kernels() -> bool:
    """Build (a checkout's first run) or load the program's kernel library,
    which it keeps under ``build/tokenflow_torch/`` in the checkout; True
    where this call built it."""
    from tokenflow_torch.kernels import _build

    built = not _build.library_path().exists()
    _build.load_library()
    return built


def load(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """``model`` (built on the meta device) holding ``state_dict``, for
    inference."""
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def ddim_schedule(sched: dict, steps: int):
    """The program's ``ddim.make_schedule`` of ``steps`` inference steps on
    a configuration's ``scheduler``: its betas, training timesteps,
    ``steps_offset`` and ``set_alpha_to_one``, the numbers the reference's
    tables are made of (``reference/schedule.py::ddim_parameters``, which
    refuses by key and value a scheduler the reference does not follow)."""
    from tokenflow_torch.diffusion import ddim

    return ddim.make_schedule(steps, **ref_schedule.ddim_parameters(sched))


def flow_schedule(sched: dict, traffic: dict) -> tuple:
    """(the program's flow schedule of the traffic's ``timesteps``, cut at
    its ``start`` where it has one; the save grid's timesteps, ascending),
    through the port's ``tokenflow_torch.diffusion.flow``:

    - ``flow.make_schedule(steps, num_train_timesteps=N, shift=s)``;
    - ``flow.truncate_schedule(schedule, start)``, SDEdit's cut by index;
    - ``flow.save_grid(save_steps, num_train_timesteps=N, shift=s)``;

    each called with the reference's ``flow_parameters`` as keywords, the
    numbers the reference's tables are made of
    (``reference/schedule.py``). A port without these entries fails here
    with its own error: that is the program's contract."""
    p = ref_schedule.flow_parameters(sched)
    import tokenflow_torch.diffusion.flow as flow

    schedule = flow.make_schedule(traffic["timesteps"], **p)
    if traffic.get("start") is not None:
        schedule = flow.truncate_schedule(schedule, traffic["start"])
    return schedule, flow.save_grid(traffic["save_steps"], **p)


def prediction_kw(sched: dict) -> dict:
    """The keyword arguments that tell the program's entries what the
    denoiser outputs: none for eps, so an eps configuration calls the
    program as its editors do; ``prediction_type`` otherwise ("v_prediction",
    or "flow" for the velocity of rectified flow)."""
    kind = ref_schedule.prediction_type(sched)
    return {} if kind == "epsilon" else {"prediction_type": kind}
