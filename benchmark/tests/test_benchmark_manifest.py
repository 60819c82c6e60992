"""BENCHMARK.json against the benchmark's contract, and the harness finding
what a later change adds as new files alone."""

from __future__ import annotations

import hashlib
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

import manifest  # noqa: E402
import tiny  # noqa: E402

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (BENCH.parent / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert (BENCH.parent / SPEC["command"][1]).resolve().is_relative_to(BENCH)
    assert len(json.dumps(SPEC)) <= 64 << 10


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs_name_their_files_and_cut_nothing():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert Path(c["file"]) == Path("benchmark/configs") / f"{c['name']}.json"
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"], "each configuration lists what was assumed"
        arch = cfg.get("architecture", manifest.DEFAULT_ARCHITECTURE)
        assert (BENCH / "architectures" / f"{arch}.py").exists()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_cells_use_one_chip_and_their_files_exist():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.cell(w["name"])
        assert (BENCH / "drivers" / f"{cell.stage}.py").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()


def test_metrics_units_bounds_and_readers():
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert hasattr(manifest.reader(m["name"]), "read")


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        cell = manifest.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_every_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert manifest.reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in SPEC["per_layer"]:  # one layer, one spelling
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_stage_and_metric_are_found_as_new_files(tmp_path):
    """A copy gains configurations, mixes, cells, a stage driver and a
    metric reader as new files (and entries in BENCHMARK.json, which lies
    outside the benchmark's folder); no file the benchmark has changes, and
    the harness finds each new one by its name."""
    root = tiny.copy_with_tiny_cells(tmp_path, lambda cell: {"state_rel_l2": 1.0})
    (root / "drivers" / "noop.py").write_text("class Stage:\n    pass\n")
    (root / "traffic" / "tiny_noop.json").write_text(json.dumps({"stage": "noop"}))
    (root / "metrics" / "noop.count.py").write_text("def read(m):\n    return 1.0\n")
    original = {p: d for p, d in _digests(BENCH).items() if p.parts[0] != "tests"}
    copied = _digests(root)
    assert not [p for p, d in original.items() if copied.get(p) != d]
    assert len(copied) > len(original)
    for name, (cfg, traffic) in tiny.TINY_CELLS.items():
        cell = manifest.cell(name, root)
        assert cell.config["name"] == cfg and cell.traffic == tiny.TINY_TRAFFIC[traffic]
        assert cell.limits == {"state_rel_l2": 1.0}
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
    assert hasattr(manifest.driver("noop", root), "Stage")
    assert manifest.reader("noop.count", root).read(None) == 1.0
