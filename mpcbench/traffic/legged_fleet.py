"""The legged planner for a fleet user: ``batch`` cold-started problems per
call.

Each problem has its own phase of the gait.info trot (drawn from the seed
on a grid of ``phase_step`` s), so its contact masks and swing references
differ, and its own standing state and forward-velocity command. Set-up
makes ``pool`` such batches; the calls cycle through them.
"""

from __future__ import annotations

import numpy as np

from mpcbench.traffic import Inputs, Traffic
from mpcbench.traffic._frozen.legged_inputs import TrotSampler, states


def make(config: dict, params: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed)
    B, cycle = params["batch"], params["cycle"]
    n_phase = int(round(cycle / params["phase_step"]))
    sampler = TrotSampler(config, cycle)
    grids = [np.stack(g) for g in zip(*(
        sampler.sample(i * params["phase_step"]) for i in range(n_phase)))]
    pool = []
    for _ in range(params["pool"]):
        ph = rng.integers(n_phase, size=B)
        x0, x_ref = states(config, params, rng, B)
        pool.append((x0, x_ref) + tuple(g[ph] for g in grids))

    def inputs(k: int, prev) -> Inputs:
        return Inputs(pool[k % len(pool)], None)

    return Traffic(batch=B, reads=("forces", "u_traj"),
                   warmup=params["warmup"], inputs=inputs)
