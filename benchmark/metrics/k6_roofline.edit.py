"""K6 (short_attn_fwd) in the edit cells: the least time of the attention calls at
or under the UNet's kv_block (the yardstick's attention calls K1 does not
take) over K6's traced device time; None where the trace's launch count is
not the one the yardstick expects (a program without K6 traces none)."""

import sys

from yardstick import Attn

KERNEL = "short_attn_fwd"


def read(m):
    if m.trace is None or m.stage != "edit":
        return None
    calls = [o for o in m.step_ops if isinstance(o, Attn) and not o.k1]
    seconds, launches = m.trace.kernels(KERNEL)
    if not calls or not seconds:
        return None
    if launches != len(calls) * m.trace_steps:
        print(f"[bench] {KERNEL}: {launches} launches traced, {len(calls)} x {m.trace_steps} "
              "due; its roofline is left out", file=sys.stderr)
        return None
    least_s = m.trace_steps * sum(o.least_ms(m.dtype) for o in calls) / 1e3
    return 100.0 * least_s / seconds
