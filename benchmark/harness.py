"""One run of one cell: set-up, the measured window, the traced reading,
and the comparison with the plain reference that decides ``correct``.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``: process start to the first timed step) builds or
loads the program's kernel library, makes the weights on the device from
the seed, builds the program's models on them, makes the cell's inputs and
runs the stage's warm-up steps. What depends on the model family (specs,
the reference's and the program's models, the operation count, further
model inputs, PnP sites) comes from the configuration's architecture module
(``manifest.architecture``). The window then runs the stage's steps for
``--seconds`` and ends on a step: every end-to-end rate is the window's
seconds over the steps it completed, with at most one step enqueued ahead
of the device. ``--trace 1`` reports the per-layer metrics instead: it
runs the window with CUDA events at the program's pass edges (the rates
and pass times it reads come from this window, as the end-to-end ones do),
then the same steps again under ``torch.profiler`` (what it reads from the
device trace). After the windows the program's models are dropped and the
reference (fp32, TF32 off) repeats the compared steps from the states the
program held. The last line of standard output is the result; the last
lines of standard error are the compared numbers beside their limits.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Optional

import guard
import manifest


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(checkout: Path) -> None:
    """The CUDA driver's kernel cache at a fixed path inside the checkout
    (the program's own library lives under ``build/tokenflow_torch/``)."""
    os.environ["CUDA_CACHE_PATH"] = str(checkout / "build" / "bench_cache" / "cuda")


@dataclasses.dataclass
class Run:
    """What a stage driver is handed."""

    cell: manifest.Cell
    seed: int
    device: Any
    dtype: Any
    unet_spec: Any
    controlnet_spec: Any
    state: dict  # {"unet": state dict, "controlnet": state dict or None}
    phase: Any  # the loop's pass hook: name -> context manager

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def arch(self):
        """The configuration's architecture module (``manifest.architecture``)."""
        return self.cell.arch

    @property
    def sched_config(self) -> dict:
        return self.cell.config["scheduler"]


@dataclasses.dataclass
class Measures:
    """What a metric reader reads."""

    cell: manifest.Cell
    steps: int
    window_s: float
    setup_s: float
    peak_bytes: int
    step_ops: list  # the yardstick's operations of one step
    phase_s: dict  # the program's passes: name -> device seconds in the window
    trace: Optional[Any]  # tracing.Trace of a traced run's profiled window
    trace_steps: int  # the steps of the profiled window
    dtype: str

    @property
    def stage(self) -> str:
        return self.cell.stage


class PassClock:
    """The loop's pass hook in a traced run: CUDA events at each pass's
    edges and a profiler span of its name."""

    def __init__(self):
        self.events: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.profiler.record_function(name):
            start.record()
            yield
            end.record()
        self.events.append((name, start, end))

    def seconds(self) -> dict:
        out: dict = {}
        for name, start, end in self.events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end) / 1e3
        return out


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def window(stage, seconds: float, traced: bool, cuda: bool):
    """Run steps until ``seconds`` have passed; returns (steps, seconds).
    Each step's end is an event; the host waits on the previous step's
    before the next, so it stays at most one step ahead of the device.
    ``traced``: the profiled window, with spans for the trace; its steps
    repeat the measured window's and are not offered to the check."""
    import torch

    span = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.monotonic()
    k, prev = 0, None
    with span("bench.window"):
        while True:
            with span("bench.step"):
                stage.step(k, check=not traced)
            done = torch.cuda.Event() if cuda else None
            if cuda:
                done.record()
            if prev is not None:
                prev.synchronize()
            prev, k = done, k + 1
            if time.monotonic() - t0 >= seconds:
                break
        sync()
    return k, time.monotonic() - t0


def run_cell(cell: manifest.Cell, args, t0: float, root: Path, device,
             control: Optional[str] = None) -> dict:
    """One run; with ``control`` (a reference precision) the compared steps
    are also read with that precision's reference in the program's place."""
    import torch

    import program
    import tracing
    import weights
    from reference.precision import Precision

    traced = bool(args.trace)
    marks = [("imports", time.monotonic())]
    cfg, arch = cell.config, cell.arch
    dtype_name = cfg["dtype"]
    dtype = program.DTYPES[dtype_name]
    unet_spec, cn_spec = arch.specs(cfg)
    if device.type == "cuda":
        torch.cuda.init()
        marks.append(("cuda", time.monotonic()))
        built = program.build_kernels()
        print(f"[bench] kernel library {'built' if built else 'loaded'} in "
              f"{time.monotonic() - marks[-1][1]:.3f} s", flush=True)
    marks.append(("kernels", time.monotonic()))
    denoiser = cfg[cell.denoiser_group]
    state = {"unet": weights.random_state_dict(arch.reference_model("unet", denoiser),
                                               weights.sub_seed(args.seed, 1), device, dtype)}
    state["controlnet"] = None if cn_spec is None else weights.random_state_dict(
        arch.reference_model("controlnet", cfg["controlnet"]), weights.sub_seed(args.seed, 2),
        device, dtype)
    clock = PassClock() if traced else None
    run = Run(cell, args.seed, device, dtype, unet_spec, cn_spec, state,
              clock if traced else (lambda name: contextlib.nullcontext()))
    marks.append(("weights", time.monotonic()))
    stage = manifest.driver(cell.stage, root).Stage(run)
    marks.append(("models and inputs", time.monotonic()))
    stage.warm()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", time.monotonic()))
    setup_s = time.monotonic() - t0
    print("[bench] set-up s: " + ", ".join(
        f"{name} {t1 - t0_:.3f}" for (_, t0_), (name, t1) in zip([("start", t0)] + marks, marks)),
        flush=True)
    if clock is not None:
        clock.events.clear()  # the warm-up's passes are set-up

    steps, window_s = window(stage, args.seconds, False, cuda)
    trace, trace_steps = None, 0
    if traced:
        phase_s = clock.seconds()
        with tracing.profiled(True) as prof:
            trace_steps, _ = window(stage, args.seconds, True, cuda)
        trace = tracing.Trace(prof)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    guard.check("after the window")
    measures = Measures(
        cell=cell, steps=steps, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        step_ops=arch.step_ops(cell.stage, unet_spec, cn_spec, cell.traffic),
        phase_s=phase_s if traced else {}, trace=trace, trace_steps=trace_steps,
        dtype=dtype_name)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = manifest.reader(m["name"], root).read(measures)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"[bench] {cell.name}: {steps} steps in {window_s} s, setup {setup_s} s, "
          f"window peak {peak} B" + (f", {trace_steps} steps profiled" if traced else ""),
          flush=True)

    # the reference, once the program's state is dropped
    stage.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref_unet = arch.reference_model("unet", denoiser, state["unet"])
    ref_cn = None if cn_spec is None else arch.reference_model("controlnet", cfg["controlnet"],
                                                               state["controlnet"])
    t_ref = time.monotonic()
    compared = stage.compare(Precision("fp32"), ref_unet, ref_cn)
    reference_s = time.monotonic() - t_ref
    result = {
        "metrics": metrics, "steps": steps, "window_s": window_s,
        "memory_peak_bytes": max(setup_peak, peak) if cuda else 0,
        "compared": compared, "reference_s": reference_s,
    }
    if control is not None:
        result["control"] = stage.compare(Precision("fp32"), ref_unet, ref_cn,
                                          control=Precision(control))
    if trace is not None:
        result["busy_s"], result["traced_window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = trace.breakdown()
    return result


def decide(cell: manifest.Cell, compared: list) -> tuple[bool, int, dict]:
    """(correct, steps failed, {number: (worst reading, limit)})."""
    import checks

    worst, failed = checks.judge([c["numbers"] for c in compared], cell.limits)
    missing = sorted(set(worst) - set(cell.limits))
    if missing:
        raise KeyError(f"limits/{cell.name}.json has no limit for {missing}")
    correct = failed == 0 and all(math.isfinite(v) for v in worst.values())
    return correct, failed, {n: (v, cell.limits[n]) for n, v in worst.items()}


def main(argv, t0: float, root: Path = manifest.HERE, device=None) -> int:
    """Run a cell; ``device`` None requires the cell's CUDA devices (the
    tests pass the CPU)."""
    args = parse(argv)
    guard.check("at start")
    cell = manifest.cell(args.workload, root)
    cache_dirs(root.parent)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"[bench] {cell.name} needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    out = run_cell(cell, args, t0, root, device)
    correct, failed, checked = decide(cell, out["compared"])
    for c in out["compared"]:
        print(f"[bench] compared step {c['step']} (schedule position {c['position']}): "
              f"{json.dumps(c['numbers'])}", flush=True)
    cuda = device.type == "cuda"
    print(f"[bench] card: {card_line() if cuda else 'cpu'}; reference {out['reference_s']} s",
          flush=True)
    guard.check("before the result")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["steps"], "failed": failed,
              "metrics": out["metrics"], "device": dev}
    if args.trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["traced_window_s"]
        result["breakdown"] = out["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checked.items()}
    for n, (v, lim) in checked.items():
        print(f"check {n}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
