"""Inputs of the convex SRB MPC (``build_convex_mpc``'s ``x0, x_ref_traj,
foot_pos, enable_table``) for a quadruped that trots under velocity
commands, on flat ground or on a plane inclined along its heading.

State layout (13): rpy (ZYX Euler: roll, pitch, yaw), CoM position, world
angular velocity, world linear velocity, and the gravity constant 1.0. Leg
order LF, RF, RH, LH; the trot's diagonal pairs are LF + RH and RF + LH.
The nominal stance is a frozen copy of the port's ``examples.NOMINAL_FEET``
(feet relative to the CoM in the body's yaw frame, on the ground).
"""

from __future__ import annotations

import numpy as np

NOMINAL_FEET = np.array([[0.35, 0.052, 0.0], [0.35, -0.054, 0.0],
                         [-0.37, -0.053, 0.0], [-0.36, 0.054, 0.0]])
PAIRS = ((0, 2), (1, 3))


def trot_table(horizon: int, cycle_nodes: int, phase) -> np.ndarray:
    """(..., horizon, 4) contact flags of a trot whose cycle lasts
    ``cycle_nodes`` nodes, ``phase`` (cycles, any shape) into it: pair LF +
    RH stands over the first half of each cycle, pair RF + LH over the
    second, read at each node's midpoint. At ``phase = j / cycle_nodes``
    with ``cycle_nodes = horizon`` this is the port's ``trot_table(horizon,
    phase=j)``."""
    phase = np.asarray(phase, np.float64)[..., None]
    s = np.mod((np.arange(horizon) + 0.5) / cycle_nodes + phase, 1.0)
    first = (s < 0.5).astype(np.float64)
    table = np.zeros(phase.shape[:-1] + (horizon, 4))
    for leg in PAIRS[0]:
        table[..., leg] = first
    for leg in PAIRS[1]:
        table[..., leg] = 1.0 - first
    return table


def _rotz(yaw):
    """(..., 2, 2) planar rotations."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


def scenarios(params: dict, config: dict, rng: np.random.Generator,
              cmd: np.ndarray, yaw: np.ndarray, pos: np.ndarray,
              slope: np.ndarray, table: np.ndarray, v_now: np.ndarray):
    """``(x0, x_ref_traj, foot_pos, enable_table)`` of ``n = len(cmd)``
    scenarios, each a trot planned from its own state.

    ``cmd`` (n, 3) is the commanded (vx, vy, yaw rate) in the body's yaw
    frame, ``v_now`` (n, 3) the same quantities of the state (the command
    the robot followed until now), ``yaw`` and ``pos`` (n, 2) the nominal
    heading and ground-plane position, ``slope`` (n,) the ground's
    inclination along that heading (rad; the plane passes through ``pos``),
    ``table`` (n, N, 4) the contact flags. Drawn from ``rng`` per scenario:
    roll and pitch about the ground's attitude (std ``tilt_std``), the
    CoM's height above the ground (uniform in ``height``), its offset from
    the nominal position (its length uniform in [0, ``com_offset``], its
    direction uniform). The reference starts at the CoM's position, holds
    the nominal height above the ground and the ground's attitude, and
    integrates the command, yaw included; the feet stand at the nominal
    stance around the nominal position, shifted by the command's Raibert
    offset (half a stance of the commanded velocity), on the ground."""
    N, dt, n = config["horizon"], config["dt"], len(cmd)
    heading = np.stack([np.cos(yaw), np.sin(yaw)], -1)
    grade = np.tan(slope)

    def ground(xy):  # height of the plane under each point (n, ..., 2)
        d = xy - pos.reshape((n,) + (1,) * (xy.ndim - 2) + (2,))
        return grade.reshape((n,) + (1,) * (xy.ndim - 2)) * np.einsum(
            "n...i,ni->n...", d, heading)

    lo, hi = params["height"]
    radius = params["com_offset"] * rng.uniform(0.0, 1.0, n)
    angle = rng.uniform(0.0, 2.0 * np.pi, n)
    off = radius[:, None] * np.stack([np.cos(angle), np.sin(angle)], -1)
    com = pos + off
    x0 = np.zeros((n, 13))
    x0[:, 0] = params["tilt_std"] * rng.standard_normal(n)
    x0[:, 1] = -slope + params["tilt_std"] * rng.standard_normal(n)
    x0[:, 2] = yaw
    x0[:, 3:5] = com
    x0[:, 5] = ground(com[:, None, :])[:, 0] + rng.uniform(lo, hi, n)
    v_world = np.einsum("nij,nj->ni", _rotz(yaw), v_now[:, :2])
    x0[:, 8] = v_now[:, 2]
    x0[:, 9:11] = v_world
    x0[:, 11] = grade * np.einsum("ni,ni->n", v_world, heading)
    x0[:, 12] = 1.0

    ks = np.arange(N + 1)
    yaw_ref = yaw[:, None] + cmd[:, None, 2] * dt * ks  # (n, N+1)
    v_ref = np.einsum("nkij,nj->nki", _rotz(yaw_ref), cmd[:, :2])
    xy_ref = com[:, None, :] + np.concatenate(
        [np.zeros((n, 1, 2)), np.cumsum(v_ref[:, :-1] * dt, axis=1)], 1)
    x_ref = np.zeros((n, N + 1, 13))
    x_ref[..., 1] = -slope[:, None]
    x_ref[..., 2] = yaw_ref
    x_ref[..., 3:5] = xy_ref
    x_ref[..., 5] = ground(xy_ref) + params["nominal_height"]
    x_ref[..., 8] = cmd[:, None, 2]
    x_ref[..., 9:11] = v_ref
    x_ref[..., 11] = grade[:, None] * np.einsum("nki,ni->nk", v_ref, heading)
    x_ref[..., 12] = 1.0

    stance_s = 0.5 * params["cycle_nodes"] * dt
    raibert = 0.5 * stance_s * np.einsum("nij,nj->ni", _rotz(yaw),
                                         cmd[:, :2])
    feet = np.zeros((n, 4, 3))
    feet[..., :2] = (pos[:, None, :] + raibert[:, None, :]
                     + np.einsum("nij,lj->nli", _rotz(yaw),
                                 NOMINAL_FEET[:, :2]))
    feet[..., 2] = ground(feet[..., :2])
    return x0, x_ref, feet, np.ascontiguousarray(table, np.float64)


def uniform_commands(params: dict, rng: np.random.Generator, n: int):
    """(n, 3) commands (vx, vy, yaw rate), each uniform in its range."""
    return np.stack([rng.uniform(*params[k], n)
                     for k in ("vx", "vy", "yaw_rate")], -1)
