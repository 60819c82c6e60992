"""Phase metrics, program spans and device traces.

``PhaseMetrics``: wall-clock seconds per named phase, collected into the
report dict that the CLIs print and dump as ``metrics.json`` (the port's
copy of ``PhaseMetrics`` from ``tokenflow_tpu/profiling.py``, same report
format). :func:`span`: a named program site (``tf.step``, ``tf.unet``,
``tf.transformer:down_0_0``, ``tf.norm``, ...), recorded while
:func:`spans` is on and put on a running profiler's timeline, where a
device trace can charge each kernel to the site that launched it.
:func:`trace`: a ``torch.profiler`` trace of a block with the spans on,
the counterpart of that module's ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch


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


STEP = "tf.step"  # one denoising step: the index every span inside it carries


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the record, -1 at the top
    step: int  # ordinal of the enclosing ``tf.step`` in the record, -1 outside one
    t0_ns: int  # time.perf_counter_ns() on entry
    t1_ns: int  # and on exit


class SpanRecord:
    """The spans of one :func:`spans` block in the order they opened; an
    open span's entry is None until it closes. Spans are opened from one
    thread at a time."""

    def __init__(self):
        self.spans: list[Optional[Span]] = []
        self.steps = 0  # the ``tf.step`` spans opened so far
        self._open: list[_Recording] = []

    def seconds(self, name: str) -> float:
        """Host seconds inside the closed spans named ``name``."""
        return sum(s.t1_ns - s.t0_ns for s in self.spans
                   if s is not None and s.name == name) / 1e9


class _Recording:
    """An open span: an entry of the record and, while a profiler runs, a
    ``record_function`` of the same name."""

    __slots__ = ("record", "name", "index", "parent", "step", "t0", "fn")

    def __init__(self, record: SpanRecord, name: str):
        self.record, self.name = record, name

    def __enter__(self):
        rec = self.record
        if rec._open:
            top = rec._open[-1]
            self.parent, self.step = top.index, top.step
        else:
            self.parent, self.step = -1, -1
        if self.name == STEP:
            self.step, rec.steps = rec.steps, rec.steps + 1
        self.fn = None
        if torch.autograd._profiler_enabled():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.index = len(rec.spans)
        rec.spans.append(None)
        rec._open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.record
        rec._open.pop()
        rec.spans[self.index] = Span(self.name, self.parent, self.step, self.t0, t1)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


_record: Optional[SpanRecord] = None  # the record of the open spans() block
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking a program site. Off (outside
    :func:`spans`) it is one shared no-op; callers build ``name`` once per
    model or call, never per span."""
    if _record is None:
        return _OFF
    return _Recording(_record, name)


@contextlib.contextmanager
def spans():
    """Turns :func:`span` on for the block and yields its
    :class:`SpanRecord`; a nested block shares the enclosing record."""
    global _record
    if _record is not None:
        yield _record
        return
    _record = SpanRecord()
    try:
        yield _record
    finally:
        _record = None


TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """``torch.profiler`` trace of the block into ``trace_dir``, in
    TensorBoard's profile-plugin layout (``tensorboard_trace_handler``:
    ``<host>_<pid>.<time>.pt.trace.json``), as the JAX package's
    ``jax.profiler`` trace is (tokenflow_tpu/profiling.py:56-76). CPU
    activity always, CUDA activity when a card is present; the program's
    spans are on, so the trace names the site of every operator. A no-op
    when ``trace_dir`` is falsy. Unlike the JAX trace, a profiler failure
    is not swallowed: a trace that was asked for and not written raises."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set(glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX)))
    with spans(), profile(activities=activities,
                          on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
    written = set(glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX))) - before
    if not written:
        raise RuntimeError(f"the profiler wrote no trace to {trace_dir}")
