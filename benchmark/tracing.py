"""The traced run: ``torch.profiler`` over the measured window, reduced in
memory (no trace file) to what the per-layer metrics and the breakdown
read: the window's length, the union of the device's kernel, copy and set
intervals, device time and launch counts by kernel name, and the device's
idle gaps by what the host was doing during them."""

from __future__ import annotations

import bisect
import collections
import contextlib

import torch

from yardstick import kernel_class

WINDOW = "bench.window"
# the spans the harness opens: the window, each step, and the loop's passes
SPANS = frozenset({WINDOW, "bench.step", "pivotal", "propagate", "fused"})


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profiler over the block (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def _union(intervals):
    """Sorted, merged (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Trace:
    """One profiled window's reduction. Times in seconds."""

    def __init__(self, prof):
        win = None
        device, host, spans = [], [], []
        self.kernel_ns: dict[str, int] = collections.Counter()
        self.kernel_count: dict[str, int] = collections.Counter()
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == cuda:
                if name not in SPANS:  # a kernel, copy or set, not a span's device side
                    device.append((s, end, name))
            elif name == WINDOW:
                win = (s, end)
            elif name in SPANS:
                spans.append((s, end, name))
            else:
                host.append((s, end, name))
        if win is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        w0, w1 = win
        self.window_s = (w1 - w0) / 1e9
        device = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
        for s, e, n in device:
            self.kernel_ns[n] += e - s
            self.kernel_count[n] += 1
        busy = _union([(s, e) for s, e, _ in device])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.class_s: dict[str, float] = collections.Counter()
        for n, ns in self.kernel_ns.items():
            self.class_s[kernel_class(n)] += ns / 1e9
        self.idle_s = self._idle_by_host(busy, w0, w1, host, spans)

    def kernels(self, key: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds ``key``."""
        ns = sum(v for n, v in self.kernel_ns.items() if key in n)
        return ns / 1e9, sum(v for n, v in self.kernel_count.items() if key in n)

    @staticmethod
    def _outermost(events):
        """The events of ``events`` that no other one encloses, by start."""
        out = []
        for s, e, n in sorted(events):
            if out and e <= out[-1][1]:
                continue
            out.append((s, e, n))
        return out

    def _idle_by_host(self, busy, w0, w1, host, spans) -> dict:
        """Idle seconds of the window by the host's work at each gap's middle:
        the innermost benchmark or program span there and the outermost
        operator (or "python" between operators)."""
        gaps, t = [], w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        ops = self._outermost(host)
        op_starts = [s for s, _, _ in ops]
        spans = sorted(spans)
        span_starts = [s for s, _, _ in spans]
        idle: dict[str, float] = collections.Counter()
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(op_starts, mid) - 1
            op = ops[i][2] if i >= 0 and ops[i][1] >= mid else "python"
            span = "window"
            for j in range(bisect.bisect_right(span_starts, mid) - 1, -1, -1):
                s, e, n = spans[j]
                if e >= mid:
                    span = n
                    break
                if mid - s > 10**10:  # spans last seconds at most
                    break
            idle[f"{span}: {op}"] += (g1 - g0) / 1e9
        return idle

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.class_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
