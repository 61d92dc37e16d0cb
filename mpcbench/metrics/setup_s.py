"""Seconds from the process's start to the first timed call: imports, the
card, the traffic, the kernels' build or load, the warm-up calls and every
graph capture."""


def read(ctx, arg):
    return ctx.setup_s
