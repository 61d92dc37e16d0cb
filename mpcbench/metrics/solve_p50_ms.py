"""Median host ms per call over every call of the window."""

from mpcbench.harness import percentile


def read(ctx, arg):
    return percentile(ctx.host_ms, 50) if ctx.host_ms else None
