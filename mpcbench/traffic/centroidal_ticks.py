"""The centroidal MPC as a real-time controller: one problem per call.

A stream of ticks of one gait (the workload's ``gait``) whose contact table
advances one node per tick; every tick has its own commanded speed, height
and feet, drawn from the seed as ``make_example_inputs`` draws them. Tick 0
is cold; every later tick is warm-started from the previous tick's solution
shifted one node. The stream holds ``stream_ticks`` ticks and starts over
at its end (the warm start carries on).
"""

from __future__ import annotations

import numpy as np

from mpcbench.traffic import Inputs, Traffic, shift
from mpcbench.traffic._frozen.centroidal_inputs import gait_table, packed_inputs


def make(config: dict, params: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed)
    L, N = params["stream_ticks"], config["horizon"]
    period = 2 * max(N // 2, 1)
    tables = np.stack([gait_table(params["gait"], N, k % period)
                       for k in range(period)])
    packed = packed_inputs(config, params, rng,
                           tables[np.arange(L) % period])

    def inputs(k: int, prev) -> Inputs:
        args = tuple(a[k % L] for a in packed)
        warm = None if prev is None else shift(prev["x_traj"],
                                               prev["u_traj"])
        return Inputs(args, warm)

    return Traffic(batch=None, reads=("contact_force", "u_traj", "x_traj"),
                   warmup=params["warmup"], inputs=inputs)
