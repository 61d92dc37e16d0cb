"""The convex SRB MPC for a sweep user: ``batch`` cold scenarios per call
over a grid of commands, slopes and trot phases.

The grid is the product of ``grid``'s axes: forward speed, lateral speed,
yaw rate (each evenly spaced over its range), the ground's inclination
along the heading and the trot's phase (``phases`` evenly spaced phases of
a ``cycle_nodes``-node cycle); ``batch`` is its size, and each call holds
every grid point once, in an order drawn from the seed. Each scenario has
its own heading, tilt, height and CoM offset (``_frozen/convex_inputs.py``)
and starts at its command; on a slope its feet stand on the plane and its
reference pitch follows it. Set-up makes ``pool`` such batches; the calls
cycle through them.
"""

from __future__ import annotations

import itertools

import numpy as np

from mpcbench.traffic import Inputs, Traffic
from mpcbench.traffic._frozen.convex_inputs import scenarios, trot_table


def grid(params: dict) -> np.ndarray:
    """(points, 5) rows (vx, vy, yaw rate, slope, phase in cycles)."""
    g = params["grid"]
    axes = [np.linspace(*params[k], g[k]) for k in ("vx", "vy", "yaw_rate")]
    axes += [np.asarray(params["slopes"], np.float64),
             np.arange(g["phases"]) / g["phases"]]
    return np.array(list(itertools.product(*axes)))


def make(config: dict, params: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed)
    B, N = params["batch"], config["horizon"]
    points = grid(params)
    if len(points) != B:
        raise ValueError(f"the grid has {len(points)} points, the batch "
                         f"{B}: each call holds every point once")
    pool = []
    for _ in range(params["pool"]):
        p = points[rng.permutation(B)]
        cmd, slope = p[:, :3], p[:, 3]
        yaw = rng.uniform(-np.pi, np.pi, B)
        table = trot_table(N, params["cycle_nodes"], p[:, 4])
        pool.append(scenarios(params, config, rng, cmd, yaw,
                              np.zeros((B, 2)), slope, table, cmd))

    def inputs(k: int, prev) -> Inputs:
        return Inputs(pool[k % len(pool)], None)

    return Traffic(batch=B, reads=("forces", "dx"),
                   warmup=params["warmup"], inputs=inputs)
