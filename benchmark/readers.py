"""The arithmetic the metric readers (``metrics/<name>.py``) share. A
reader returns None where its cell gives it nothing to read."""

from __future__ import annotations

import sys

from yardstick import PEAKS, Attn, Match, flops

GIB = 1 << 30


def step_s(m, stage: str):
    """The window's seconds over the steps it completed."""
    return m.window_s / m.steps if m.stage == stage and m.steps else None


def mfu(m, stage: str):
    """The model's operations in the window's steps over the window's time,
    as a share (%) of the chip's dense peak in the served dtype."""
    if m.stage != stage or not m.steps:
        return None
    return 100.0 * flops(m.step_ops) * m.steps / m.window_s / PEAKS[m.dtype][0]


def roofline(m, stage: str, kernel: str):
    """A hand-written kernel's share (%) of its roofline: the least time of
    the calls it is due to run in the profiled window (the yardstick's
    operations) over the device time of the kernels named ``kernel`` in the trace. None
    where the trace's launch count is not the one the yardstick expects."""
    if m.trace is None or m.stage != stage:
        return None
    kind = {"flash_fwd": lambda o: isinstance(o, Attn) and o.k1,
            "match_core": lambda o: isinstance(o, Match)}[kernel]
    calls = [o for o in m.step_ops if kind(o)]
    seconds, launches = m.trace.kernels(kernel)
    if not calls or not seconds:
        return None
    if launches != len(calls) * m.trace_steps:
        print(f"[bench] {kernel}: {launches} launches traced, {len(calls)} x {m.trace_steps} "
              "due; its roofline is left out", file=sys.stderr)
        return None
    least_s = m.trace_steps * sum(o.least_ms(m.dtype) for o in calls) / 1e3
    return 100.0 * least_s / seconds


def pass_ms(m, name: str):
    """Device ms a step of the program's pass ``name`` (CUDA events at its
    edges in the traced window)."""
    if name not in m.phase_s or not m.steps:
        return None
    return 1e3 * m.phase_s[name] / m.steps


def idle(m, stage: str):
    """The share (%) of the traced window in which no kernel, copy or set
    ran on the device."""
    if m.trace is None or m.stage != stage:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
