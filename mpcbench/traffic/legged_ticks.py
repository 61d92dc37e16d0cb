"""The legged planner as a real-time controller: one problem per call.

The contact table is the gait.info trot (``cycle`` s, diagonal pairs),
sampled at the N nodes and advanced ``tick_s`` seconds per tick from a
phase drawn from the seed; the swing-height references come from the
swing planner at its default settings. Every tick has its own standing
state (base height and joints jittered) and forward-velocity command,
drawn from the seed. Tick 0 is cold; every later tick is warm-started from
the previous tick's solution shifted one node.
"""

from __future__ import annotations

import numpy as np

from mpcbench.traffic import Inputs, Traffic, shift
from mpcbench.traffic._frozen.legged_inputs import TrotSampler, states


def make(config: dict, params: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed)
    L, cycle, tick = params["stream_ticks"], params["cycle"], params["tick_s"]
    period = int(round(cycle / tick))
    phase0 = rng.uniform(0.0, cycle)
    sampler = TrotSampler(config, cycle)
    grids = [sampler.sample((phase0 + tick * k) % cycle)
             for k in range(period)]
    x0, x_ref = states(config, params, rng, L)

    def inputs(k: int, prev) -> Inputs:
        i = k % L
        enable, z_pos, z_vel = grids[k % period]
        warm = None if prev is None else shift(prev["x_traj"],
                                               prev["u_traj"])
        return Inputs((x0[i], x_ref[i], enable, z_pos, z_vel), warm)

    return Traffic(batch=None, reads=("forces", "u_traj", "x_traj"),
                   warmup=params["warmup"], inputs=inputs)
