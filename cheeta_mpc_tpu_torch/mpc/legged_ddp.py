"""Legged-robot DDP/SLQ MPC: the reference's alternative solver node, torch.

Counterpart of ``cheeta_mpc_tpu/mpc/legged_ddp.py`` — the capability
equivalent of ``LeggedRobotDdpMpcNode`` (``LeggedRobotDdpMpcNode.cpp:42-78``:
``GaussNewtonDDP_MPC`` with ``ddp.algorithm SLQ``, task.info:50-99)
assembled on the same SRBD kinodynamic task as the SQP path
(mpc/legged_mpc.py), driven by the generic Gauss-Newton DDP engine
(solvers/ddp.py).

Constraint treatment in DDP mode (all through the cost, as SLQ does):
- friction cone: relaxed-barrier penalty on the smoothed SOC — the exact
  configuration of the reference's DDP task (``LeggedRobotInterface.cpp:
  313-325`` + task.info:215-222);
- stance zero-velocity and swing normal-velocity equalities: quadratic
  penalties (the reference SLQ projects state-input equalities; a stiff
  quadratic penalty is the standard unconstrained-DDP equivalent and keeps
  the backward pass a plain Riccati recursion);
- swing zero-force: structural, forces multiplied by the contact flag inside
  the dynamics, so swing forces cannot act (and a small regularizer pins
  them to zero).

The stage cost's Hessian is taken by forward-over-reverse differentiation
through the closed-form kinematics (models/quadruped_kinematics.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cheeta_mpc_tpu_torch.core.types import resolve_device
from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
    foot_positions_world
from cheeta_mpc_tpu_torch.models.srbd_legged import (
    foot_velocity_constraint_values, srbd_step, unpack_srbd_state,
    weight_compensating_input)
from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import _as_tensor
from cheeta_mpc_tpu_torch.mpc.friction_cone import (FrictionConeConfig,
                                                    RelaxedBarrierConfig,
                                                    cone_value,
                                                    relaxed_barrier)
from cheeta_mpc_tpu_torch.mpc.legged_mpc import NL, LeggedMpcConfig
from cheeta_mpc_tpu_torch.solvers.ddp import DdpSettings, solve_ddp


class LeggedDdpSolution(NamedTuple):
    x_traj: torch.Tensor  # (N+1, 24)
    u_traj: torch.Tensor  # (N, 24)
    forces: torch.Tensor  # (N, 4, 3) effective contact forces
    joint_vel: torch.Tensor  # (N, 12)
    gains_K: torch.Tensor  # (N, 24, 24) feedback of the last backward pass
    gains_P: torch.Tensor  # (N+1, 24, 24) value-function Hessians (the DDP
    #                        cost-to-go surface, matching the SQP path)
    gains_p: torch.Tensor  # (N+1, 24) value-function gradients
    cost: torch.Tensor
    converged: torch.Tensor  # bool (ddp.minRelCost classification)


def build_legged_ddp_solver(cfg: LeggedMpcConfig,
                            ddp: DdpSettings = DdpSettings(iterations=5),
                            eq_penalty: float = 1e2,
                            force_reg: float = 1e-4, device="cuda"):
    """Returns ``solve(x0, x_ref_traj, enable_table, z_pos_ref, z_vel_ref,
    dts=None) -> LeggedDdpSolution`` on ``device`` (the card by default;
    with no card present this raises — pass ``device="cpu"``). The
    arguments are those of the SQP builder's solve
    (:func:`~cheeta_mpc_tpu_torch.mpc.legged_mpc.build_legged_solver`), less
    ``warm``, for one problem (no batch dimension), so the two solvers are
    interchangeable behind the planning node — the relationship of the
    reference's two MPC nodes."""
    dev = resolve_device(device)
    p = cfg.params
    N = cfg.horizon
    dt_ = cfg.dtype
    kw = dict(dtype=dt_, device=dev)
    Qd = torch.tensor(cfg.q_diag, **kw)
    Rd = torch.tensor(cfg.r_diag, **kw)
    gain = cfg.position_error_gain
    cone_cfg = FrictionConeConfig(friction_coefficient=cfg.friction_mu)
    bar_cfg = RelaxedBarrierConfig(mu=cfg.barrier_mu, delta=cfg.barrier_delta)

    def solve(x0, x_ref_traj, enable_table, z_pos_ref, z_vel_ref,
              dts=None) -> LeggedDdpSolution:
        x0 = _as_tensor(x0, dt_, dev)
        x_ref = _as_tensor(x_ref_traj, dt_, dev)
        enable = _as_tensor(enable_table, dt_, dev)
        z_pos = _as_tensor(z_pos_ref, dt_, dev)
        z_vel = _as_tensor(z_vel_ref, dt_, dev)
        if x0.dim() != 1:
            raise ValueError(f"the legged DDP solver takes one problem; got "
                             f"x0 of shape {tuple(x0.shape)}")
        dts_v = (torch.full((N,), p.dt, **kw) if dts is None
                 else _as_tensor(dts, dt_, dev))
        u_ref = weight_compensating_input(p, enable)

        def step(k, x, u):
            return srbd_step(p, x, u, enable[k], dts_v[k])

        def stage_cost(k, x, u):
            e = enable[k]
            dx = x - x_ref[k]
            du = u - u_ref[k]
            c = 0.5 * torch.sum(dx * Qd * dx) + 0.5 * torch.sum(du * Rd * du)
            # Relaxed-barrier friction cone on stance legs.
            F = u[:3 * NL].reshape(NL, 3)
            h = cone_value(cone_cfg, F)
            c = c + torch.sum(e * relaxed_barrier(bar_cfg, h))
            # Swing forces: structural in the dynamics; regularize to zero.
            c = c + force_reg * torch.sum(((1.0 - e)[:, None] * F) ** 2)
            # Equality families as quadratic penalties: stance foot velocity
            # (12 rows) + swing normal velocity with swing-spline reference.
            v = foot_velocity_constraint_values(p, x, u)  # (4, 3)
            _, _, p_base, eul, q = unpack_srbd_state(x)
            feet = foot_positions_world(p.desc, p_base, eul, q)
            swing = (v[:, 2] + gain * (feet[:, 2] - z_pos[k]) - z_vel[k])
            c = c + eq_penalty * (torch.sum(e[:, None] * v ** 2)
                                  + torch.sum((1.0 - e) * swing ** 2))
            return c

        def terminal_cost(x):
            dx = x - x_ref[-1]
            return 0.5 * torch.sum(dx * Qd * dx)

        res = solve_ddp(step, stage_cost, terminal_cost, x0, u_init=u_ref,
                        settings=ddp)
        forces = res.u[:, :3 * NL].reshape(N, NL, 3) * enable[:, :, None]
        return LeggedDdpSolution(x_traj=res.x, u_traj=res.u, forces=forces,
                                 joint_vel=res.u[:, 3 * NL:], gains_K=res.K,
                                 gains_P=res.P, gains_p=res.p,
                                 cost=res.cost, converged=res.converged)

    return solve
