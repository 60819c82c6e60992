"""A test-only architecture whose configuration keeps the denoiser's
config.json under "transformer", as a diffusion transformer's published
layout does (``DENOISER_GROUP``), and SD's UNet family through the SD module
otherwise. Its configuration's "unet" group is null, so a harness that read
that group would fail. Copied into a benchmark's ``architectures/`` as a new
file."""

from __future__ import annotations

from pathlib import Path

import manifest

SD = manifest.architecture("sd", Path(__file__).resolve().parents[1])
DENOISER_GROUP = "transformer"


def specs(config: dict) -> tuple:
    return SD.specs({"unet": config[DENOISER_GROUP]})


reference_model = SD.reference_model
step_ops = SD.step_ops
program_model = SD.program_model
model_inputs = SD.model_inputs
inject_sites = SD.inject_sites
