"""Scenario generators for smoke runs, tests and demos (numpy only).

Counterpart of ``cheeta_mpc_tpu/examples.py``, copied so that the port
imports nothing of the JAX package: the same seeds give the same packed
inputs in both packages. Produces the packed vectors
:func:`cheeta_mpc_tpu_torch.mpc.centroidal_mpc._unpack_reference_inputs`
decodes, for any horizon (trot table, forward-walking CoM references,
stepping feet).
"""

from __future__ import annotations

import numpy as np


TEST_WEIGHTS = (1, 1, 100, 0.5, 0.5, 0,
                2, 2, 8) + (0.2, 0.2, 0.2, 0.3, 0.3, 0.3, 0.1, 0.1, 0.1) * 4

# Nominal stance: LF, RF, RH, LH
NOMINAL_FEET = np.array([[0.35, 0.052, 0.0], [0.35, -0.054, 0.0],
                         [-0.37, -0.053, 0.0], [-0.36, 0.054, 0.0]])


def trot_table(horizon: int, num_legs: int = 4, phase: int = 0) -> np.ndarray:
    """(horizon, num_legs) contact table: diagonal pairs alternating every
    horizon//2 steps."""
    half = max(horizon // 2, 1)
    table = np.zeros((horizon, num_legs))
    for k in range(horizon):
        pair = ((k + phase) // half) % 2
        if pair == 0:
            table[k, 0] = table[k, 2] = 1.0  # LF + RH
        else:
            table[k, 1] = table[k, 3] = 1.0  # RF + LH
    return table


def gait_table(kind: str, horizon: int, num_legs: int = 4,
               phase: int = 0) -> np.ndarray:
    """(horizon, num_legs) contact-enable table for the named quadruped gait.

    Leg order is LF, RF, RH, LH. Pair gaits alternate their two leg pairs
    every ``horizon // 2`` steps like :func:`trot_table`; ``gallop`` is a
    stylized rotary four-beat footfall — hind pair then front pair with the
    front pair's lateral order reversed (LH, RH, RF, LF), lift-offs
    staggered by a quarter cycle at a constant 50% duty factor (a real
    gallop has shorter stances; the constant duty keeps the contact count
    per node fixed for the sweep); ``stance`` keeps all feet down.
    """
    pairs = {
        "trot": ((0, 2), (1, 3)),    # diagonal: LF+RH / RF+LH
        "bound": ((0, 1), (2, 3)),   # front / hind
        "pace": ((0, 3), (1, 2)),    # lateral: LF+LH / RF+RH
    }
    table = np.zeros((horizon, num_legs))
    if kind == "stance":
        table[:] = 1.0
        return table
    if kind in pairs:
        half = max(horizon // 2, 1)
        for k in range(horizon):
            for leg in pairs[kind][((k + phase) // half) % 2]:
                table[k, leg] = 1.0
        return table
    if kind == "gallop":
        # Rotary gallop footfall sequence LH, RH, RF, LF (front pair
        # reverses the hind pair's lateral order): leg i is in stance for
        # the half-cycle starting at its phase offset.
        offsets = {3: 0.0, 2: 0.25, 1: 0.5, 0: 0.75}  # leg -> cycle phase
        for k in range(horizon):
            ph = ((k + phase) / max(horizon, 1)) % 1.0
            for leg, off in offsets.items():
                if (ph - off) % 1.0 < 0.5:
                    table[k, leg] = 1.0
        return table
    raise ValueError(f"unknown gait kind: {kind!r}")


def make_example_inputs(cfg, batch: int | None = None,
                        seed: int = 0, gait: str = "trot"):
    """Returns (state, des_state, des_inputs) packed vectors for a config
    with ``horizon``, ``num_legs`` and ``dt`` fields; with ``batch`` set, a
    leading batch axis with per-element perturbations of speed, height and
    foot placement. ``gait`` selects the contact table
    (:func:`gait_table`)."""
    N, nl = cfg.horizon, cfg.num_legs
    rng = np.random.default_rng(seed)
    b = 1 if batch is None else batch

    vx = 0.1 + 0.05 * rng.standard_normal(b)  # commanded forward speed
    z0 = 0.15 + 0.01 * rng.standard_normal(b)

    state = np.zeros((b, 3 * (nl + 3)))
    state[:, 2] = z0
    state[:, 3] = vx
    state[:, 8] = 0.1
    feet = NOMINAL_FEET[None, :, :] + 0.01 * rng.standard_normal((b, nl, 3))
    feet[:, :, 2] = 0.0
    state[:, 9:] = feet.reshape(b, -1)

    ts = np.arange(N + 1) * cfg.dt
    des_state = np.zeros((b, 9 * (N + 1)))
    des_com_pos = np.zeros((b, N + 1, 3))
    des_com_pos[:, :, 0] = vx[:, None] * (ts[None, :] + 0.01)
    des_com_pos[:, :, 2] = z0[:, None] + 0.05 * ts[None, :] / max(ts[-1], 1e-9)
    des_com_vel = np.zeros((b, N + 1, 3))
    des_com_vel[:, :, 0] = vx[:, None] * np.linspace(1.0, 0.0, N + 1)[None, :]
    des_am = np.zeros((b, N + 1, 3))
    des_am[:, :, 2] = 0.1 + 0.02 * ts[None, :] / cfg.dt / max(N, 1)
    des_state[:, 0:3 * (N + 1)] = des_com_pos.reshape(b, -1)
    des_state[:, 3 * (N + 1):6 * (N + 1)] = des_com_vel.reshape(b, -1)
    des_state[:, 6 * (N + 1):] = des_am.reshape(b, -1)

    table = trot_table(N, nl) if gait == "trot" else gait_table(gait, N, nl)
    des_inputs = np.zeros((b, nl * (4 * N + 3)))
    for i in range(nl):
        off = i * (4 * N + 3)
        des_inputs[:, off:off + N] = table[None, :, i]
        # Desired foot positions: hold during stance, advance during swing.
        fp = np.repeat(feet[:, i:i + 1, :], N + 1, axis=1)  # (b, N+1, 3)
        advance = np.cumsum(1.0 - np.concatenate(
            [np.ones((1,)), table[:, i]]), axis=0)  # (N+1,)
        fp[:, :, 0] += vx[:, None] * cfg.dt * advance[None, :] * 2.0
        des_inputs[:, off + N:off + N + 3 * (N + 1)] = fp.reshape(b, -1)

    if batch is None:
        return state[0], des_state[0], des_inputs[0]
    return state, des_state, des_inputs
