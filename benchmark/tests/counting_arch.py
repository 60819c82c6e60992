"""A test-only architecture: SD's UNet family through the SD module, with
every hook counted in ``CALLS``, and one further model input, ``probe`` (the
prompt's index), handed to the program's calls and to the reference's. The
reference's modules check that each call gets the probe batched as the
prompt embeddings are, and drop it before SD's forward; the tests drop the
program's. Copied into a benchmark's ``architectures/`` as a new file."""

from __future__ import annotations

import collections
import functools
from pathlib import Path

import torch

import manifest

SD = manifest.architecture("sd", Path(__file__).resolve().parents[1])
CALLS: collections.Counter = collections.Counter()


def _counted(fn):
    @functools.wraps(fn)
    def hook(*args, **kw):
        CALLS[fn.__name__] += 1
        return fn(*args, **kw)

    return hook


def _probe_checked(module, args, kwargs):
    """Forward pre-hook: ``probe`` is the prompt index of each row of the
    batch, frame-major, as the embeddings are repeated."""
    probe = kwargs.pop("probe")
    batch, prompts = args[1].shape[0], int(probe.max()) + 1
    want = torch.arange(prompts, dtype=probe.dtype, device=probe.device).repeat(batch // prompts)
    if batch % prompts or not torch.equal(probe, want):
        raise AssertionError(f"probe {probe.tolist()} for a batch of {batch}")
    CALLS["reference_probe"] += 1
    return args, kwargs


@_counted
def specs(config: dict) -> tuple:
    return SD.specs(config)


@_counted
def reference_model(kind: str, config: dict, state_dict=None):
    model = SD.reference_model(kind, config, state_dict)
    model.register_forward_pre_hook(_probe_checked, with_kwargs=True)
    return model


@_counted
def step_ops(stage: str, unet, controlnet, traffic: dict) -> list:
    return SD.step_ops(stage, unet, controlnet, traffic)


@_counted
def program_model(kind: str, spec, state_dict: dict):
    return SD.program_model(kind, spec, state_dict)


@_counted
def model_inputs(spec, prompts: int, seed: int, device, dtype) -> tuple:
    probe = torch.arange(prompts, dtype=torch.float32, device=device)
    return {"probe": probe}, {"probe": probe}


@_counted
def inject_sites(spec) -> tuple:
    return SD.inject_sites(spec)
