"""The convex SRB MPC as the onboard controller: one problem per call.

A trot (``cycle_nodes`` nodes per cycle) whose contact table advances one
node per tick, from a start node drawn from the seed, one tick per node
(``dt``). A velocity command (vx, vy, yaw rate), drawn from the seed, is
held for segments of ``segment_s`` seconds; the robot's nominal heading and
position integrate the commands tick by tick, and each tick's state follows
the previous tick's command, so a segment's first tick asks for a step in
velocity. Every tick has its own tilt, height and CoM offset
(``_frozen/convex_inputs.py``); the ground is flat. Every tick is solved
cold: the convex MPC takes no warm start. The stream holds
``stream_ticks`` ticks and starts over at its end.
"""

from __future__ import annotations

import numpy as np

from mpcbench.traffic import Inputs, Traffic
from mpcbench.traffic._frozen.convex_inputs import (scenarios, trot_table,
                                                    uniform_commands)


def make(config: dict, params: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed)
    L, N, dt = params["stream_ticks"], config["horizon"], config["dt"]
    per_segment = max(int(round(params["segment_s"] / dt)), 1)
    segments = uniform_commands(params, rng, -(-L // per_segment))
    cmd = np.repeat(segments, per_segment, axis=0)[:L]
    v_now = np.concatenate([cmd[:1], cmd[:-1]])
    yaw = rng.uniform(-np.pi, np.pi) + np.concatenate(
        [[0.0], np.cumsum(v_now[1:, 2] * dt)])
    c, s = np.cos(yaw), np.sin(yaw)
    step = np.stack([c * v_now[:, 0] - s * v_now[:, 1],
                     s * v_now[:, 0] + c * v_now[:, 1]], -1) * dt
    pos = np.concatenate([np.zeros((1, 2)), np.cumsum(step[1:], axis=0)])
    cycle = params["cycle_nodes"]
    start = rng.integers(cycle)
    table = trot_table(N, cycle, (start + np.arange(L)) / cycle)
    x0, x_ref, feet, enable = scenarios(params, config, rng, cmd, yaw, pos,
                                        np.zeros(L), table, v_now)

    def inputs(k: int, prev) -> Inputs:
        i = k % L
        return Inputs((x0[i], x_ref[i], feet[i], enable[i]), None)

    return Traffic(batch=None, reads=("forces", "dx"),
                   warmup=params["warmup"], inputs=inputs)
