"""A configuration brings its model family as a module it names
(``"architecture"``, ``architectures/<name>.py``; SD's UNet where it names
none): the harness and the drivers take the specs, the reference, the
operation count, the program's models, the further model inputs and the PnP
sites from it. The SD module reads what the harness read before it (the
tiny cells' compared numbers bit for bit; the cells' operation counts are
pinned in ``test_benchmark_yardstick.py``), and a new architecture is a new
file."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
TESTS = BENCH / "tests"
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(TESTS)]

import harness  # noqa: E402
import manifest  # noqa: E402
import tiny  # noqa: E402
from tokenflow_torch.editing import pipeline  # noqa: E402

READINGS = json.loads((TESTS / "tiny_readings.json").read_text())
LIMITS = {"state_rel_l2": 1.0, "frame_rel_l2": 1.0, "slot_gap": 0.0, "slots_wrong": 0.0}
HOOKS = ("specs", "reference_model", "step_ops", "program_model", "model_inputs",
         "inject_sites")
COUNTING_CELL = "tiny_counting_edit"
SEED = 3000000021


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells, and one whose configuration names the test-only
    architecture, added to a copy as new files."""
    r = tiny.copy_with_tiny_cells(
        tmp_path_factory.mktemp("bench"), lambda cell: LIMITS,
        cells={**tiny.TINY_CELLS, COUNTING_CELL: ("tiny_counting", "tiny_pnp")},
        configs={"tiny_counting": {"unet": tiny.TINY_UNET, "architecture": "counting"}})
    shutil.copy(TESTS / "counting_arch.py", r / "architectures" / "counting.py")
    return r


@pytest.fixture
def one_thread():
    """The readings were taken on one thread: the CPU's sums depend on how
    many share them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_the_sd_module_compares_what_the_harness_compared_before_it(root, cell, one_thread,
                                                                    monkeypatch):
    """Sound and fp8-control numbers of a fixed count of steps, equal bit
    for bit to the readings of the harness before the architecture modules."""
    c = manifest.cell(cell, root)
    assert c.arch.__file__ == str(root / "architectures" / "sd.py")
    monkeypatch.setattr(harness, "window", tiny.fixed_window(READINGS["steps"][c.stage]))
    args = harness.parse(["--workload", cell, "--seed", str(READINGS["seed"]), "--seconds", "1"])
    out = harness.run_cell(c, args, time.monotonic(), root, torch.device("cpu"), control="fp8")
    assert out["compared"] == READINGS["cells"][cell]["compared"]
    assert out["control"] == READINGS["cells"][cell]["control"]


def test_a_configuration_brings_its_architecture_as_a_new_file(root, monkeypatch, capsys):
    """A tiny PnP cell on the test-only architecture runs through
    ``harness.main`` to ``correct``, every hook serves it, and both sides get
    its further input; no file of the benchmark changed for it."""
    original = {p: d for p, d in _digests(BENCH).items() if p.parts[0] != "tests"}
    copied = _digests(root)
    assert not [p for p, d in original.items() if copied.get(p) != d]

    cells, program_probes = [], []
    load, loop = manifest.cell, pipeline.tokenflow_sample_loop

    def cell(name, r=manifest.HERE):
        cells.append(load(name, r))
        return cells[-1]

    def sample_loop(*args, probe, **kw):
        program_probes.append(probe.tolist())
        return loop(*args, **kw)

    monkeypatch.setattr(manifest, "cell", cell)
    monkeypatch.setattr(pipeline, "tokenflow_sample_loop", sample_loop)
    rc = harness.main(["--workload", COUNTING_CELL, "--seed", str(SEED), "--seconds", "0.5",
                       "--trace", "0"], time.monotonic(), root=root, device=torch.device("cpu"))
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    calls = cells[0].arch.CALLS
    assert Path(cells[0].arch.__file__) == root / "architectures" / "counting.py"
    assert {h: calls[h] > 0 for h in HOOKS} == {h: True for h in HOOKS}
    # the weights' shapes and the check's copy of each model
    assert calls["reference_model"] == 2 and calls["program_model"] == 1
    assert calls["reference_probe"] > 0
    assert program_probes and all(p == [0.0, 1.0, 2.0] for p in program_probes)


def test_an_unknown_architecture_names_the_file_it_looked_for(tmp_path):
    root = tiny.copy_with_tiny_cells(
        tmp_path, lambda cell: LIMITS, cells={"tiny_unknown_edit": ("tiny_unknown", "tiny_pnp")},
        configs={"tiny_unknown": {"unet": tiny.TINY_UNET, "architecture": "no_such_unet"}})
    path = root / "architectures" / "no_such_unet.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        manifest.cell("tiny_unknown_edit", root)


def test_the_sd_module_refuses_added_conditioning():
    """SD-XL's ``addition_embed_type`` is another family's: the SD module
    refuses it and points at the ``architecture`` key."""
    sd = manifest.architecture(manifest.DEFAULT_ARCHITECTURE)
    config = {"unet": dict(tiny.TINY_UNET, addition_embed_type="text_time")}
    with pytest.raises(ValueError, match=r"addition_embed_type='text_time'.*\"architecture\""):
        sd.specs(config)
    assert sd.specs({"unet": tiny.TINY_UNET})[1] is None
