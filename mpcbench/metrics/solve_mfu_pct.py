"""The whole solve's share of the f32 peak: problems per call x the
family's solve operations (``mpcbench/counts/solve_<family>.py``) over the
median device seconds per call, timed by CUDA events around each call."""

import importlib

import numpy as np

from mpcbench.metrics import F32_FLOPS


def read(ctx, arg):
    if not ctx.device_ms:
        return None
    try:
        count = importlib.import_module(
            f"mpcbench.counts.solve_{ctx.config['family']}")
    except ModuleNotFoundError:
        return None
    seconds = float(np.median(ctx.device_ms)) * 1e-3
    return 100.0 * ctx.batch * count.flops(ctx.config) / seconds / F32_FLOPS
