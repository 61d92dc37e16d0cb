"""Median over the window's calls of host ms minus the device span of the
same call, timed by CUDA events around the call (traced run)."""

import numpy as np


def read(ctx, arg):
    if not ctx.device_ms:
        return None
    return float(np.median(np.asarray(ctx.host_ms)
                           - np.asarray(ctx.device_ms)))
