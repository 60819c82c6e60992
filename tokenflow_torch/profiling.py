"""Phase metrics and device traces.

``PhaseMetrics``: wall-clock seconds per named phase, collected into the
report dict that the CLIs print and dump as ``metrics.json`` (the port's
copy of ``PhaseMetrics`` from ``tokenflow_tpu/profiling.py``, same report
format). :func:`trace`: a ``torch.profiler`` trace of a block, the
counterpart of that module's ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class PhaseMetrics:
    """Accumulates {phase: seconds} plus free-form scalar metrics."""

    phases: dict = field(default_factory=dict)
    scalars: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (
                self.phases.get(name, 0.0) + time.perf_counter() - t0
            )

    def add(self, name: str, value: float):
        self.scalars[name] = value

    def report(self) -> dict:
        return {"phases_seconds": dict(self.phases), **self.scalars}

    def dump(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """``torch.profiler`` trace of the block into ``trace_dir``, in
    TensorBoard's profile-plugin layout (``tensorboard_trace_handler``:
    ``<host>_<pid>.<time>.pt.trace.json``), as the JAX package's
    ``jax.profiler`` trace is (tokenflow_tpu/profiling.py:56-76). CPU
    activity always, CUDA activity when a card is present. A no-op when
    ``trace_dir`` is falsy. Unlike the JAX trace, a profiler failure is
    not swallowed: a trace that was asked for and not written raises."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set(glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX)))
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
    written = set(glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX))) - before
    if not written:
        raise RuntimeError(f"the profiler wrote no trace to {trace_dir}")
