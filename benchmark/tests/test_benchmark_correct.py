"""How ``correct`` is decided, driven through whole runs of tiny cells on
the CPU (the harness's look for a card skipped): sound runs pass, the
control (the reference in fp8 in the program's place) fails, and so does
each fault a cell can have, planted in the timed path. The cells run on
one chip and exchange nothing between chips, so the fault of a skipped
exchange has no place here.

The tiny cells' limits are their own, set as the cells' are (PERF.md)
from readings at this size: over seeds 1-6 sound runs read at most 0.092
(state) and 0.137 (worst frame) in the edit cells and 0.0051 and 0.0058 in
the inversion, their fp8 controls at least 0.289, 0.297, 0.038 and 0.041."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

import harness  # noqa: E402
import manifest  # noqa: E402
import tiny  # noqa: E402
from tokenflow_torch.diffusion import inversion  # noqa: E402
from tokenflow_torch.editing import pipeline  # noqa: E402

EDIT_LIMITS = {"state_rel_l2": 0.17, "frame_rel_l2": 0.22}
INVERT_LIMITS = {"state_rel_l2": 0.015, "frame_rel_l2": 0.018, "slot_gap": 0.0,
                 "slots_wrong": 0.0}
SEED = 3000000021


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy_with_tiny_cells(
        tmp_path_factory.mktemp("bench"),
        lambda cell: INVERT_LIMITS if "invert" in cell else EDIT_LIMITS)


def _run(root, cell, capsys, seed=SEED) -> dict:
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", "0"], time.monotonic(), root=root, device=torch.device("cpu"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_sound_runs_are_correct(root, cell, capsys):
    result = _run(root, cell, capsys)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(manifest.cell(cell, root).limits)


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_the_fp8_control_is_not_correct(root, cell, monkeypatch):
    """The inversion's control reads under its limit on the first step and
    over it on later ones: the window holds six steps however slow the
    machine, so a later step is compared."""
    monkeypatch.setattr(harness, "window", tiny.fixed_window(6))
    c = manifest.cell(cell, root)
    args = harness.parse(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5"])
    out = harness.run_cell(c, args, time.monotonic(), root, torch.device("cpu"), control="fp8")
    assert harness.decide(c, out["compared"])[0] is True
    correct, failed, checked = harness.decide(c, out["control"])
    assert correct is False and failed >= 1
    assert checked["state_rel_l2"][0] > checked["state_rel_l2"][1]


def _broken_edit(fault):
    real = pipeline.tokenflow_sample_loop

    def loop(unet_apply, x_init, *args, **kw):
        if fault == "unchanged":
            return x_init
        x = real(unet_apply, x_init, *args, **kw).clone()
        half = len(x) // 2
        if fault == "half_batch":  # the second half left out: the mean of the first
            x[half:] = x[:half].mean(dim=0, keepdim=True)
        elif fault == "answer_altered":  # one frame's latents, where they are made
            x[0] = x[0] * 1.5
        return x

    return loop


def _broken_inversion(fault):
    real = inversion.ddim_inversion

    def invert(eps_fn, latents, sched, save_steps, *, steps=None, carry=None):
        if fault == "unchanged":
            x, traj = carry if carry is not None else (latents, torch.zeros(
                (save_steps, *latents.shape), dtype=latents.dtype))
            return x, traj, None
        x, traj, ts = real(eps_fn, latents, sched, save_steps, steps=steps, carry=carry)
        x = x.clone()
        half = len(x) // 2
        if fault == "half_batch":
            x[half:] = x[:half].mean(dim=0, keepdim=True)
        elif fault == "answer_altered":
            x[0] = x[0] * 1.5
        elif fault == "slot_unwritten":  # the step's trajectory row not written
            with torch.inference_mode():
                traj.zero_()
        return x, traj, ts

    return invert


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["tiny_pnp_edit", "tiny_cn_edit", "tiny_sdedit_edit"])
def test_a_broken_edit_step_is_not_correct(root, cell, fault, monkeypatch, capsys):
    monkeypatch.setattr(pipeline, "tokenflow_sample_loop", _broken_edit(fault))
    result = _run(root, cell, capsys)
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered",
                                   "slot_unwritten"])
def test_a_broken_inversion_step_is_not_correct(root, fault, monkeypatch, capsys):
    monkeypatch.setattr(inversion, "ddim_inversion", _broken_inversion(fault))
    result = _run(root, "tiny_invert", capsys)
    assert result["correct"] is False and result["failed"] >= 1
