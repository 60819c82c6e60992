"""The system under test: the PyTorch and CUDA port's kernel library, its
dtypes, its DDIM schedule on a configuration's scheduler, and the loading
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


def prediction_kw(sched: dict) -> dict:
    """The keyword arguments that tell the program's entries what the
    denoiser outputs: none for eps, so an eps configuration calls the
    program as its editors do; ``prediction_type`` otherwise."""
    kind = ref_schedule.prediction_type(sched)
    return {} if kind == "epsilon" else {"prediction_type": kind}
