"""Phase metrics: wall-clock seconds per named phase, collected into the
report dict that the CLIs print and dump as ``metrics.json``.

The port's copy of ``PhaseMetrics`` from ``tokenflow_tpu/profiling.py``
(same report format). Device traces come from ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
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
