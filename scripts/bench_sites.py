"""A benchmark cell's time by program site, with the program's spans on.

    python scripts/bench_sites.py --workload <cell> --seed <n> --seconds <s>

The cell's set-up as ``benchmark/run.py`` makes it (weights, models, inputs,
warm-up), then three windows of ``--seconds`` each: the measured window
with the spans off (as every benchmark window runs), (a) the same steps
with the program's spans on (``profiling.spans``), unprofiled: the span
record gives the host ms a step and the spans' cost against the measured
window; (b) with the spans on under ``torch.profiler``: ``benchmark/
sites.py`` charges every kernel, copy and set to the span that launched it
and counts the blocking calls. Standard error gets the ``[bench] sites:``
table; the last line of standard output is a JSON object with the
windows' steps and step seconds, the spans' cost and the readings of
``sites.readings``. On a machine without a card window (b) is left out and
the device numbers are null. The line also gives the norm kernels'
launches in window (a) beside the model calls (``tf.unet``, ``tf.dit``,
``tf.controlnet`` spans) they ran in: on the card K4 (GroupNorm) launches
once per GroupNorm site a call runs, K5 (LayerNorm) once per LayerNorm
site; and the program's edit counters in the same window
(``ops/editctx.py``): the edit sites the denoiser's calls visited (one per
transformer block a call runs: 16 on SD, 70 on SD-XL, 40 on HunyuanDiT)
and the bytes of the pivotal caches they returned; and K6's (short-key attention) launches in
the same window by plan and by head dim, beside the CUDA short-key calls
that took the plain version instead (``ops/attention.py::plain_on_cuda``,
0 on every cell); and K7's (the GEGLU's projection and activation)
launches in the same window by plan, with the CUDA GEGLU calls that took
the plain version (``models/layers.py::GEGLU.plain_on_cuda``, 0 on every
cell): one launch per transformer block a model call runs; and K5's
rotary entry's launches (HunyuanDiT's rotated q and k: 4 a block a step,
160 on the DiT, 0 on the UNets; K5's plain launches in ``norm_launches``
leave them out) with the CUDA q/k transforms that took the plain norm and
rotation (``models/hunyuan_dit.py::plain_rope_on_cuda``, 0). The weights
(of the configuration's denoiser group, ``Cell.denoiser_group``: "unet",
or a DiT's "transformer"), the specs and the models come from the
configuration's architecture module, as a benchmark run takes them, and
the stage driver builds the program's schedule from the configuration's
scheduler (``program.ddim_schedule``). No reference runs: ``benchmark/run.py`` decides ``correct``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

T0 = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
sys.path[:0] = [str(BENCH), str(ROOT)]

import guard  # noqa: E402
import harness  # noqa: E402
import manifest  # noqa: E402
import program  # noqa: E402
import sites  # noqa: E402
import tracing  # noqa: E402
import weights  # noqa: E402


def stage_for(cell: manifest.Cell, seed: int, root: Path, device):
    """The cell's stage driver, set up and warmed as a benchmark run's
    (``harness.run_cell``): specs, weights and models from the
    configuration's architecture module."""
    cfg, arch = cell.config, cell.arch
    dtype = program.DTYPES[cfg["dtype"]]
    unet_spec, cn_spec = arch.specs(cfg)
    if device.type == "cuda":
        program.build_kernels()
    state = {"unet": weights.random_state_dict(
        arch.reference_model("unet", cfg[cell.denoiser_group]), weights.sub_seed(seed, 1),
        device, dtype)}
    state["controlnet"] = None if cn_spec is None else weights.random_state_dict(
        arch.reference_model("controlnet", cfg["controlnet"]), weights.sub_seed(seed, 2),
        device, dtype)
    run = harness.Run(cell, seed, device, dtype, unet_spec, cn_spec, state,
                      lambda name: contextlib.nullcontext())
    stage = manifest.driver(cell.stage, root).Stage(run)
    stage.warm()
    return stage


# the spans of one denoiser call: a UNet's, a DiT's
MODEL_SPANS = ("tf.unet", "tf.dit")


def norm_launches(record, launched: dict, steps: int) -> dict:
    """K4's and K5's launches (``launched``) and the model calls of the
    span ``record``, in all and per step."""
    calls = {name: sum(1 for s in record.spans if s is not None and s.name == f"tf.{name}")
             for name in ("unet", "dit", "controlnet")}
    counts = {**{f"{k}_calls": v for k, v in calls.items()}, **launched}
    return {**counts, "per_step": {k: v / steps for k, v in counts.items()}}


def edit_counters(record, counted: dict, steps: int) -> dict:
    """The edit counters' growth over a window (``counted``: sites visited,
    pivotal cache bytes), in all, per step and per denoiser call (``tf.unet``
    or ``tf.dit`` span) of the span ``record``."""
    calls = sum(1 for s in record.spans if s is not None and s.name in MODEL_SPANS)
    return {**counted, "unet_calls": calls,
            "per_step": {k: v / steps for k, v in counted.items()},
            "per_unet_call": {k: v / calls for k, v in counted.items()} if calls else None}


def k6_counts() -> dict:
    """K6's launches so far, in all, by plan and by head dim, and the CUDA
    short-key calls that took the plain version."""
    from tokenflow_torch.kernels import short_attention
    from tokenflow_torch.ops import attention

    return {"launches": short_attention.launches,
            **{f"plan.{k}": v for k, v in short_attention.launches_by_plan.items()},
            **{f"head_dim.{k}": v for k, v in short_attention.launches_by_head_dim.items()},
            "plain_on_cuda": attention.plain_on_cuda}


def k7_counts() -> dict:
    """K7's launches so far, in all and by plan, and the CUDA GEGLU calls
    that took the plain version."""
    from tokenflow_torch.kernels import geglu
    from tokenflow_torch.models.layers import GEGLU

    return {"launches": geglu.launches,
            **{f"plan.{k}": v for k, v in geglu.launches_by_plan.items()},
            "plain_on_cuda": GEGLU.plain_on_cuda}


def k5_rope_counts() -> dict:
    """K5's rotary entry's launches so far, and the CUDA q/k transforms that
    took the plain norm and rotation."""
    from tokenflow_torch.kernels import layer_norm
    from tokenflow_torch.models import hunyuan_dit

    return {"launches": layer_norm.rope_launches,
            "plain_on_cuda": hunyuan_dit.plain_rope_on_cuda}


def growth(before: dict, after: dict, steps: int) -> dict:
    """The growth of counts (``k6_counts``, ``k7_counts``,
    ``k5_rope_counts``) over a window, in all and per step."""
    grown = {k: v - before.get(k, 0) for k, v in after.items()}
    return {**grown, "per_step": {k: v / steps for k, v in grown.items()}}


def measure(cell: manifest.Cell, seed: int, seconds: float, root: Path, device) -> dict:
    from tokenflow_torch import profiling
    from tokenflow_torch.kernels import group_norm, layer_norm
    from tokenflow_torch.ops import editctx

    cuda = device.type == "cuda"
    stage = stage_for(cell, seed, root, device)
    setup_s = time.monotonic() - T0
    steps, window_s = harness.window(stage, seconds, False, cuda)
    before = {"group_norm": group_norm.launches, "layer_norm": layer_norm.launches}
    sites0, cache0 = editctx.sites_visited, editctx.pivotal_cache_bytes
    k6_before, k7_before, rope_before = k6_counts(), k7_counts(), k5_rope_counts()
    with profiling.spans() as record:
        steps_a, window_a = harness.window(stage, seconds, False, cuda)
    launched = {"group_norm": group_norm.launches - before["group_norm"],
                "layer_norm": layer_norm.launches - before["layer_norm"]}
    k6 = growth(k6_before, k6_counts(), steps_a)
    k7 = growth(k7_before, k7_counts(), steps_a)
    rope = growth(rope_before, k5_rope_counts(), steps_a)
    counted = {"sites_visited": editctx.sites_visited - sites0,
               "pivotal_cache_bytes": editctx.pivotal_cache_bytes - cache0}
    reduced, steps_b = None, 0
    if cuda:
        with profiling.spans(), tracing.profiled(True) as prof:
            steps_b, _ = harness.window(stage, seconds, True, cuda)
        reduced = sites.reduce(sites.from_kineto(prof))
        print(reduced.table(), file=sys.stderr, flush=True)
    off, on = window_s / steps, window_a / steps_a
    out = {
        "workload": cell.name, "seed": seed, "setup_s": setup_s,
        "steps": {"off": steps, "spans_on": steps_a, "profiled": steps_b},
        "step_s": {"off": off, "spans_on": on},
        "spans_on_cost_pct": 100.0 * (on / off - 1.0),
        "readings": sites.readings(cell.stage, record, reduced),
        "norm_launches": norm_launches(record, launched, steps_a),
        "edit_counters": edit_counters(record, counted, steps_a),
        "k6_launches": k6,
        "k7_launches": k7,
        "k5_rope_launches": rope,
    }
    if reduced is not None:
        out.update(coverage_pct=reduced.coverage, linked_pct=reduced.linked_share,
                   device_ms_per_step={k: dict(v) for k, v in reduced.by_kind().items()})
    return out


def main(argv, root: Path = BENCH, device=None) -> int:
    args = harness.parse(argv)
    guard.check("at start")
    cell = manifest.cell(args.workload, root)
    harness.cache_dirs(root.parent)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print(f"[bench] {cell.name} needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    out = measure(cell, args.seed, args.seconds, root, device)
    out["card"] = harness.card_line() if device.type == "cuda" else "cpu"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
