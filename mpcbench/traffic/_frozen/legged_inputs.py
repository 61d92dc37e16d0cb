"""Inputs of the legged solver on the gait.info trot: a frozen copy of the
port's ``examples.default_stance_state`` and of the trot scenario of
``examples.make_legged_example_inputs``, sampled at any phase of the cycle.

State layout (24): normalised momentum (6), base position (3), ZYX Euler
angles (3), joints [LF, LH, RF, RH] x (HAA, HFE, KFE) (12).
"""

from __future__ import annotations

import numpy as np

from mpcbench.traffic._frozen.motion_phase import contact_flags_of_mode
from mpcbench.traffic._frozen.schedule import GaitSchedule, trot_template
from mpcbench.traffic._frozen.swing import SwingTrajectoryPlanner

DEFAULT_JOINTS = (0.0, 0.4, -0.8, 0.0, -0.4, 0.8) * 2
TROT_START = 0.1  # stance until then, the trot after (no stance buffer)


def default_stance_state(model: dict) -> np.ndarray:
    """(24,) standing state: the base height is minus the mean foot height of
    the forward kinematics at zero base pose (every HAA angle is 0)."""
    q = np.asarray(DEFAULT_JOINTS).reshape(4, 3)
    foot_z = -(model["thigh_length"] * np.cos(q[:, 1])
               + model["shank_length"] * np.cos(q[:, 1] + q[:, 2]))
    x0 = np.zeros(24)
    x0[8] = -foot_z.mean()
    x0[12:] = DEFAULT_JOINTS
    return x0


class TrotSampler:
    """Contact flags and swing-height references of the trot on the shooting
    grid of a window that starts ``phase`` seconds into a cycle."""

    def __init__(self, config: dict, cycle: float):
        self.N, self.dt = config["horizon"], config["model"]["dt"]
        gait = GaitSchedule.stance(trot_template(cycle))
        gait.phase_transition_stance_time = 0.0
        gait.insert_template(trot_template(cycle), TROT_START)
        self.schedule = gait.get_mode_schedule(
            0.0, TROT_START + 2 * cycle + self.N * self.dt)
        self.planner = SwingTrajectoryPlanner()
        self.planner.update(self.schedule)

    def sample(self, phase: float):
        """``(enable, z_pos, z_vel)``, each (N, 4)."""
        times = TROT_START + phase + np.arange(self.N + 1) * self.dt
        mids = 0.5 * (times[:-1] + times[1:])
        enable = contact_flags_of_mode(
            np.array([self.schedule.mode_at(float(t)) for t in mids]))
        z_pos, z_vel = self.planner.sample_times(mids)
        return enable, z_pos.T, z_vel.T


def states(config: dict, params: dict, rng: np.random.Generator, n: int):
    """``(x0, x_ref)`` of ``n`` problems: the standing state with its base
    height and joints jittered, and a forward-velocity command ``vx`` that
    the reference's base position follows."""
    N, dt = config["horizon"], config["model"]["dt"]
    vx = params["vx_std"] * rng.standard_normal(n)
    x0 = np.tile(default_stance_state(config["model"]), (n, 1))
    x0[:, 0] += vx
    x0[:, 8] += params["height_std"] * rng.standard_normal(n)
    x0[:, 12:] += params["joint_std"] * rng.standard_normal((n, 12))
    x_ref = np.repeat(x0[:, None, :], N + 1, axis=1)
    x_ref[:, :, 6] += vx[:, None] * (np.arange(N + 1) * dt)[None, :]
    return x0, x_ref
