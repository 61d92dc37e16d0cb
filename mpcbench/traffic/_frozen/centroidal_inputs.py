"""Packed inputs of the centroidal MPC: a frozen copy of the port's
``examples.make_example_inputs`` and ``gait_table``, with a contact-table
phase and a gait per scenario.

Leg order LF, RF, RH, LH. ``state`` is [com_pos, com_vel, L, feet];
``des_state`` the CoM position, velocity and angular momentum over N+1
nodes; ``des_inputs`` per leg [contact_enable(N), des_foot_pos(3 (N+1))].
"""

from __future__ import annotations

import numpy as np

NOMINAL_FEET = np.array([[0.35, 0.052, 0.0], [0.35, -0.054, 0.0],
                         [-0.37, -0.053, 0.0], [-0.36, 0.054, 0.0]])
GAITS = ("trot", "bound", "pace", "gallop", "stance")
_PAIRS = {"trot": ((0, 2), (1, 3)), "bound": ((0, 1), (2, 3)),
          "pace": ((0, 3), (1, 2))}


def gait_table(kind: str, horizon: int, phase: int = 0,
               num_legs: int = 4) -> np.ndarray:
    """(horizon, num_legs) contact table of the named gait, ``phase`` nodes
    on. Pair gaits alternate their two pairs every ``horizon // 2`` nodes;
    ``gallop`` is the rotary footfall LH, RH, RF, LF at a constant 50 %
    duty; ``stance`` keeps every foot down."""
    table = np.zeros((horizon, num_legs))
    if kind == "stance":
        table[:] = 1.0
    elif kind in _PAIRS:
        half = max(horizon // 2, 1)
        for k in range(horizon):
            for leg in _PAIRS[kind][((k + phase) // half) % 2]:
                table[k, leg] = 1.0
    elif kind == "gallop":
        offsets = {3: 0.0, 2: 0.25, 1: 0.5, 0: 0.75}
        for k in range(horizon):
            ph = ((k + phase) / max(horizon, 1)) % 1.0
            for leg, off in offsets.items():
                if (ph - off) % 1.0 < 0.5:
                    table[k, leg] = 1.0
    else:
        raise ValueError(f"unknown gait kind: {kind!r}")
    return table


def packed_inputs(config: dict, params: dict, rng: np.random.Generator,
                  tables: np.ndarray):
    """``(state, des_state, des_inputs)`` of ``len(tables)`` scenarios, each
    with its own contact table ``tables[i]`` (N, legs) and commanded speed,
    height and feet drawn from ``rng`` as ``make_example_inputs`` draws
    them."""
    N, nl, dt = config["horizon"], config["num_legs"], config["dt"]
    b = len(tables)
    vx = params["vx_mean"] + params["vx_std"] * rng.standard_normal(b)
    z0 = params["z_mean"] + params["z_std"] * rng.standard_normal(b)

    state = np.zeros((b, 3 * (nl + 3)))
    state[:, 2] = z0
    state[:, 3] = vx
    state[:, 8] = 0.1
    feet = (NOMINAL_FEET[None, :nl, :]
            + params["feet_std"] * rng.standard_normal((b, nl, 3)))
    feet[:, :, 2] = 0.0
    state[:, 9:] = feet.reshape(b, -1)

    ts = np.arange(N + 1) * dt
    des_com_pos = np.zeros((b, N + 1, 3))
    des_com_pos[:, :, 0] = vx[:, None] * (ts[None, :] + 0.01)
    des_com_pos[:, :, 2] = z0[:, None] + 0.05 * ts[None, :] / max(ts[-1], 1e-9)
    des_com_vel = np.zeros((b, N + 1, 3))
    des_com_vel[:, :, 0] = vx[:, None] * np.linspace(1.0, 0.0, N + 1)[None, :]
    des_am = np.zeros((b, N + 1, 3))
    des_am[:, :, 2] = 0.1 + 0.02 * ts[None, :] / dt / max(N, 1)
    des_state = np.concatenate([des_com_pos.reshape(b, -1),
                                des_com_vel.reshape(b, -1),
                                des_am.reshape(b, -1)], axis=1)

    des_inputs = np.zeros((b, nl * (4 * N + 3)))
    for i in range(nl):
        off = i * (4 * N + 3)
        des_inputs[:, off:off + N] = tables[:, :, i]
        # Desired feet: held in stance, advanced in swing.
        fp = np.repeat(feet[:, i:i + 1, :], N + 1, axis=1)
        advance = np.cumsum(1.0 - np.concatenate(
            [np.ones((b, 1)), tables[:, :, i]], axis=1), axis=1)
        fp[:, :, 0] += vx[:, None] * dt * advance * 2.0
        des_inputs[:, off + N:off + N + 3 * (N + 1)] = fp.reshape(b, -1)
    return state, des_state, des_inputs
