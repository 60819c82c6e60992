"""The system under test: the PyTorch and CUDA port's kernel library, its
dtypes, and the loading of the benchmark's state dict into a model of the
port by key name, as the port loads a diffusers checkpoint. The models
themselves are built by the architecture's module
(``architectures/<name>.py::program_model``). Only this module, the
architectures' program side and the stage drivers import the program."""

from __future__ import annotations

import torch

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
