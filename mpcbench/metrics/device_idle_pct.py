"""Share of the traced window in which no kernel, copy or fill ran on the
device: 1 - (union of their intervals) / window."""

from mpcbench.harness import device_intervals


def read(ctx, arg):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    lo, hi = ctx.trace.window
    busy = sum(e - s for s, e in device_intervals(ctx.trace))
    return 100.0 * (1.0 - busy / (hi - lo))
