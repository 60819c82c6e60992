"""Device time by program site: a profiled window run with the program's
spans on (``tokenflow_torch/profiling.py``: ``tf.step``, ``tf.unet``,
``tf.transformer:down_0_0``, ``tf.norm``, ...), reduced in memory.

Every kernel, copy and set on the device is linked to the CUDA runtime call
that launched it by their shared correlation id, and its device time is
charged to the innermost ``tf.*`` span open on the host at that call. The
blocking runtime calls inside ``tf.step`` spans are counted: stream, device
and event synchronizations, synchronous copies, and device-to-host
``cudaMemcpyAsync`` (a ``.item()`` reads as the copy and its stream
synchronization). :func:`readings` gives the per-step numbers the spans
make readable, from the program's span record of an unprofiled window
(host) and this reduction (device).

The harness's windows run with the spans off; ``scripts/bench_sites.py``
runs a cell's set-up, its measured window, and then an unprofiled and a
profiled window with the spans on, and prints the table and the readings.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Optional

import torch

import tracing
from yardstick import kernel_class

PREFIX = "tf."
STEP = "tf.step"
WINDOW = tracing.WINDOW
CUDA = torch.autograd.DeviceType.CUDA
RUNTIME = re.compile(r"cu(da)?[A-Z]")  # runtime and driver entry points
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"})


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event: ``kind`` "span" (a ``tf.*`` span on the host),
    "runtime" (a CUDA runtime or driver call), "device" (a kernel, copy or
    set) or "window" (the profiled window); times in ns on the profiler's
    clock; ``corr`` links a runtime call to the device work it launched."""

    kind: str
    name: str
    t0: int
    t1: int
    corr: int = 0


def from_kineto(prof) -> list[Event]:
    """The events of a ``torch.profiler`` run that :func:`reduce` reads: on
    the device every kernel, copy and set but the spans' device-side
    copies; on the host the spans, the window and the CUDA runtime and
    driver calls (``cudaLaunchKernel``, ``cuLaunchKernel``, ...)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == CUDA:
            if name.startswith(PREFIX) or name in tracing.SPANS:
                continue
            kind = "device"
        elif name.startswith(PREFIX):
            kind = "span"
        elif name == WINDOW:
            kind = "window"
        elif RUNTIME.match(name):
            kind = "runtime"
        else:
            continue
        t0 = e.start_ns()
        out.append(Event(kind, name, t0, t0 + e.duration_ns(), e.correlation_id()))
    return out


def span_kind(name: str) -> str:
    """``tf.transformer:down_0_0`` -> ``tf.transformer``."""
    return name.split(":", 1)[0]


@dataclasses.dataclass
class Sites:
    """One profiled window's reduction. ``ns`` is keyed by (site, span
    kind, kernel class): the site is the innermost block span
    (``tf.resnet:*``, ``tf.transformer:*``) around the charged span, or
    its kind outside one; "-" where no span was open at the launch."""

    steps: int
    ns: dict
    inclusive_ns: dict  # span kind -> device ns under any span of that kind
    device_ns: int
    device_events: int
    linked: int  # device events whose launching runtime call is in the trace
    syncs: int  # blocking runtime calls inside tf.step spans
    runtime: dict  # runtime call name -> [calls, host ns] inside tf.step spans

    @property
    def covered_ns(self) -> int:
        return sum(v for (site, _, _), v in self.ns.items() if site != "-")

    @property
    def coverage(self) -> float:
        """The share (%) of the window's device time charged to a span."""
        return 100.0 * self.covered_ns / self.device_ns if self.device_ns else 0.0

    @property
    def linked_share(self) -> float:
        """The share (%) of device events linked to their launch."""
        return 100.0 * self.linked / self.device_events if self.device_events else 0.0

    def ms(self, kind: str) -> Optional[float]:
        """Device ms a step charged to spans of ``kind`` and to the spans
        inside them."""
        if not self.steps or not self.device_ns:
            return None
        return self.inclusive_ns.get(kind, 0) / 1e6 / self.steps

    def by_kind(self) -> dict:
        """{span kind: {kernel class: device ms a step}}, innermost spans."""
        out: dict = collections.defaultdict(lambda: collections.Counter())
        for (_, kind, cls), v in self.ns.items():
            out[kind][cls] += v / 1e6 / max(self.steps, 1)
        return out

    def table(self, top_sites: int = 12) -> str:
        """The ``[bench] sites:`` lines: device ms a step by span kind and
        kernel class, the sites that hold the copies and casts, the
        blocking and runtime calls a step, and the two shares."""
        kinds = self.by_kind()
        totals = collections.Counter()
        for row in kinds.values():
            totals.update(row)
        classes = [c for c, _ in totals.most_common()]
        width = max([len(k) for k in kinds] + [4])
        lines = [f"[bench] sites: {self.steps} steps; device ms a step by innermost span "
                 "(rows) and kernel class (columns)",
                 " " * width + " | total | " + " | ".join(classes)]
        for kind, row in sorted(kinds.items(), key=lambda kv: -sum(kv[1].values())):
            lines.append(f"{kind:<{width}} | {sum(row.values()):.3f} | "
                         + " | ".join(f"{row.get(c, 0.0):.3f}" for c in classes))
        copies = collections.Counter()
        for (site, kind, cls), v in self.ns.items():
            if cls == "copies and casts":
                copies[f"{site} > {kind}" if site != kind else site] += v / 1e6 / self.steps
        lines.append("[bench] sites: copies and casts, ms a step: " + "; ".join(
            f"{name} {ms:.3f}" for name, ms in copies.most_common(top_sites)))
        inclusive = sorted(self.inclusive_ns.items(), key=lambda kv: -kv[1])
        lines.append("[bench] sites: inclusive ms a step: " + "; ".join(
            f"{k} {v / 1e6 / self.steps:.3f}" for k, v in inclusive))
        calls = sorted(self.runtime.items(), key=lambda kv: -kv[1][1])
        lines.append(f"[bench] sites: {self.syncs / self.steps:.2f} blocking calls a step; "
                     "runtime calls a step (calls, host ms): " + "; ".join(
                         f"{n} {c / self.steps:.1f} {ns / 1e6 / self.steps:.3f}"
                         for n, (c, ns) in calls[:8]))
        lines.append(f"[bench] sites: {self.coverage:.3f}% of {self.device_ns / 1e9:.4f} "
                     f"device s charged to a tf.* span; {self.linked_share:.3f}% of "
                     f"{self.device_events} device events linked to their launch")
        return "\n".join(lines)


def _tree(spans: list[Event]):
    """(starts, owners, parents) for spans that nest: from ``starts[i]``
    until the next start the innermost open span is ``owners[i]`` (-1:
    none); ``parents[j]`` encloses span j."""
    bounds = []
    for j, s in enumerate(spans):
        bounds.append((s.t0, 1, -s.t1, j))  # outer spans open first
        bounds.append((s.t1, 0, -s.t0, j))  # inner spans close first
    bounds.sort()
    starts, owners, stack = [], [], []
    parents = [-1] * len(spans)
    for t, opens, _, j in bounds:
        if opens:
            parents[j] = stack[-1] if stack else -1
            stack.append(j)
        else:
            stack.remove(j)
        starts.append(t)
        owners.append(stack[-1] if stack else -1)
    return starts, owners, parents


def reduce(events: list[Event]) -> Sites:
    """Charge each device event in the window (the ``bench.window`` span,
    or the whole trace) to the innermost span open at its launch."""
    windows = [e for e in events if e.kind == "window"]
    w0, w1 = ((windows[0].t0, windows[0].t1) if windows else
              (min(e.t0 for e in events), max(e.t1 for e in events)))
    spans = sorted((e for e in events if e.kind == "span"), key=lambda e: (e.t0, -e.t1))
    starts, owners, parents = _tree(spans)
    site, kinds, in_step = [], [], []
    for j, s in enumerate(spans):
        p = parents[j]
        kind = span_kind(s.name)
        block = s.name if ":" in s.name else (site[p] if p >= 0 else "")
        site.append(block if ":" in block else kind)
        kinds.append((kinds[p] if p >= 0 else frozenset()) | {kind})
        in_step.append(s.name == STEP or (p >= 0 and in_step[p]))

    def owner(t: int) -> int:
        i = bisect.bisect_right(starts, t) - 1
        return owners[i] if i >= 0 else -1

    runtime = {e.corr: e for e in events if e.kind == "runtime" and e.corr}
    device = [e for e in events if e.kind == "device" and e.t1 > w0 and e.t0 < w1]
    to_host = {e.corr for e in device if "DtoH" in e.name}
    ns: dict = collections.Counter()
    inclusive: dict = collections.Counter()
    linked = 0
    for e in device:
        dur = min(e.t1, w1) - max(e.t0, w0)
        call = runtime.get(e.corr)
        j = -1
        if call is not None:
            linked += 1
            j = owner(call.t0)
        cls = kernel_class(e.name)
        if j < 0:
            ns[("-", "-", cls)] += dur
            continue
        kind = span_kind(spans[j].name)
        ns[(site[j], kind, cls)] += dur
        for k in kinds[j]:
            inclusive[k] += dur
    syncs, calls = 0, collections.defaultdict(lambda: [0, 0])
    for e in runtime.values():
        if not w0 <= e.t0 < w1:
            continue
        j = owner(e.t0)
        if j < 0 or not in_step[j]:
            continue
        calls[e.name][0] += 1
        calls[e.name][1] += e.t1 - e.t0
        memcpy_sync = e.name.startswith("cudaMemcpy") and "Async" not in e.name
        if e.name in SYNCS or memcpy_sync or (e.name.startswith("cudaMemcpyAsync")
                                              and e.corr in to_host):
            syncs += 1
    steps = sum(1 for s in spans if s.name == STEP and w0 <= s.t0 < w1)
    return Sites(steps=steps, ns=dict(ns), inclusive_ns=dict(inclusive),
                 device_ns=sum(min(e.t1, w1) - max(e.t0, w0) for e in device),
                 device_events=len(device), linked=linked, syncs=syncs, runtime=dict(calls))


def host_ms(record, name: str) -> Optional[float]:
    """Host ms a step inside the spans ``name`` of a span record (the
    program's ``profiling.SpanRecord``)."""
    if record is None or not record.steps:
        return None
    return 1e3 * record.seconds(name) / record.steps


def readings(stage: str, record, sites: Optional[Sites]) -> dict:
    """The per-step numbers of a cell's stage: host ms from the unprofiled
    window's span ``record``, device ms and blocking calls from the
    profiled window's ``sites`` (None on a run without a card)."""
    def device(kind):
        return None if sites is None else sites.ms(kind)

    syncs = None if sites is None or not sites.steps else sites.syncs / sites.steps
    if stage == "edit":
        return {"edit.host_ms": host_ms(record, STEP),
                "edit.pivotal_host_ms": host_ms(record, "tf.pivotal"),
                "edit.syncs": syncs, "edit.norm_ms": device("tf.norm"),
                "edit.sdp_ms": device("tf.sdp"), "edit.match_ms": device("tf.propagation")}
    return {"invert.host_ms": host_ms(record, STEP), "invert.syncs": syncs,
            "invert.norm_ms": device("tf.norm"), "invert.sdp_ms": device("tf.sdp")}
