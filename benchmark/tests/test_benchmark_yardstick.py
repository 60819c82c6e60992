"""The yardstick's counts (the SD architecture's operations of a step): its
analytic FLOPs against PyTorch's FLOP counter on the plain reference, its
least times against the smoke test's rows, its kernel calls against the
program's launch counts, and each cell's count against the one it read
before the architecture became the configuration's."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

import manifest  # noqa: E402
import tiny  # noqa: E402
import weights  # noqa: E402
import yardstick as Y  # noqa: E402
from reference import schedule  # noqa: E402
from reference.precision import Precision  # noqa: E402
from reference.steps import edit_step, inversion_step  # noqa: E402

CONFIGS = {p.stem: json.loads(p.read_text()) for p in (BENCH / "configs").glob("*.json")}
SD = manifest.architecture("sd")


def _models(cfg: dict, seed: int = 7):
    out = []
    for kind in ("unet", "controlnet"):
        if kind in cfg:
            shapes = SD.reference_model(kind, cfg[kind])
            sd = weights.random_state_dict(shapes, seed, "cpu", torch.float32)
            out.append(SD.reference_model(kind, cfg[kind], sd))
        else:
            out.append(None)
    return out


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@pytest.mark.parametrize("controlnet", [False, True])
@pytest.mark.parametrize("stage", ["edit", "invert"])
def test_step_flops_match_the_flop_counter_on_the_reference(stage, controlnet):
    """A tiny step of each stage through the reference, counted by
    FlopCounterMode, against the yardstick's count of the same step."""
    cfg = {"unet": tiny.TINY_UNET, "scheduler": CONFIGS["sd21"]["scheduler"]}
    if controlnet:
        cfg["controlnet"] = tiny.TINY_CONTROLNET
    traffic = copy.deepcopy(tiny.TINY_TRAFFIC["tiny_pnp" if stage == "edit" else "tiny_invert"])
    spec, cn_spec = SD.specs(cfg)
    unet, cn = _models(cfg)
    f, hw = traffic["frames"], traffic["resolution"] // 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((f, hw, hw, 4), generator=gen)
    cond = torch.rand((f, 8 * hw, 8 * hw, 3), generator=gen) if controlnet else None
    P = Precision("fp32")
    if stage == "edit":
        tables = schedule.edit_tables(cfg["scheduler"], traffic)
        pa, pb, w1 = (torch.as_tensor(a) for a in
                      schedule.propagation_indices(f, traffic["window"]))
        embeds = torch.randn((3, 77, 32), generator=gen)
        pivots = [1, 2]
        inject = SD.inject_sites(spec)
        counted = _counted(lambda: edit_step(P, unet, cn, x, x, embeds, tables, 0, pivots,
                                             traffic, inject, cond=cond, pa=pa, pb=pb, w1=w1))
    else:
        tables = schedule.inversion_tables(cfg["scheduler"], traffic)
        counted = _counted(lambda: inversion_step(P, unet, cn, x, torch.randn((1, 77, 32)),
                                                  tables, 0, cond=cond))
    assert Y.flops(SD.step_ops(stage, spec, cn_spec, traffic)) == counted


def test_least_times_match_the_smoke_rows():
    """chip_smoke.py's bound for K1 at 2 x 20480^2, 5 heads of 64, and for
    K2 at F = 40, 4096 x 320 (PERF.md: 1.086 ms and 0.869 ms), both bound
    by their operations."""
    k1 = Y.Attn(2, 5, 20480, 20480, 64, "extended")
    assert k1.k1 and k1.least_ms() == pytest.approx(1.086, abs=5e-4)
    assert Y.bound(2 * 2 * 5 * 64 * (2 * 20480 + 2 * 20480), k1.flops)[1] == "operations"
    match = Y.Match(40, 4096, 320, 5, 3)
    assert match.least_ms() == pytest.approx(0.869, abs=5e-4)


@pytest.mark.parametrize("config,traffic,k1,matches", [
    ("sd21", "pnp512_edit", 20, 16),
    ("sd21", "invert512", 5, 0),
    ("sd15_controlnet", "controlnet512_edit", 24, 16),
    ("sd21", "sdedit768_edit", 25, 16),
])
def test_kernel_calls_per_step_match_the_programs_launch_counts(config, traffic, k1, matches):
    """Per step the calls the yardstick routes to K1 and to the match core
    equal the launches the program's counters read on the card (PERF.md
    §6: PnP 512^2 edit 20, inversion 5, K2 16 a step; ControlNet 512^2
    14 / 5 / 5 at D = 40 / 80 / 160; SDEdit 768p 25)."""
    cfg = CONFIGS[config]
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    ops = SD.step_ops(tr["stage"], *SD.specs(cfg), tr)
    assert sum(isinstance(o, Y.Attn) and o.k1 for o in ops) == k1
    assert sum(isinstance(o, Y.Match) for o in ops) == matches
    if config == "sd15_controlnet":
        dims = [o.d for o in ops if isinstance(o, Y.Attn) and o.k1]
        assert (dims.count(40), dims.count(80), dims.count(160)) == (14, 5, 5)


@pytest.mark.parametrize("cell,n_ops,step_flops,k1", [
    ("sd21_pnp512_edit", 516, 97534510694400.0, 20),
    ("sd15cn_pnp512_edit", 788, 135646084300800.0, 24),
    ("sd21_pnp512_invert", 266, 32170298572800.0, 5),
    ("sd21_sdedit768_edit", 516, 251508072038400.0, 25),
])
def test_each_cell_counts_what_it_counted_before_the_architecture_plug(cell, n_ops, step_flops,
                                                                      k1):
    """Each cell's operations through its configuration's architecture
    module: as many, and exactly the FLOPs, that ``yardstick.step_ops`` read
    on the same configurations and traffic before the count moved there;
    every ``*.mfu`` and ``k1_roofline.*`` reads these."""
    c = manifest.cell(cell)
    ops = c.arch.step_ops(c.stage, *c.arch.specs(c.config), c.traffic)
    assert len(ops) == n_ops
    assert Y.flops(ops) == step_flops
    assert sum(isinstance(o, Y.Attn) and o.k1 for o in ops) == k1
