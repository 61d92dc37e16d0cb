"""Convex SRB MPC, plain torch: a frozen copy of the port's
``mpc/convex_mpc.py`` QP assembly, solved by this folder's plain
interior-point executor.

The QP comes straight from the SRB model (``srb.py``): diagonal state
tracking of a commanded reference trajectory plus a small force
regularization, and a friction pyramid with fz bounds on each stance leg,
masked by the gait's contact table, in deviation coordinates around the
reference (dx = x - x_ref, forces absolute). Swing-leg forces are exactly
zero. Any dtype and device; every input may lead with one scenario-batch
dimension, and the pyramid matrices C/D are built without one. No CUDA
graph, no kernel, and float32 products at full precision (TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcbench.reference.ocpqp import IpmSettings, solve_ocp_qp
from mpcbench.reference.riccati import bmv
from mpcbench.reference.scp import matmul_precision
from mpcbench.reference.srb import (GRAVITY, SrbParams,
                                    friction_pyramid_rows,
                                    srb_discrete_dynamics)
from mpcbench.reference.types import (CostApprox, DynamicsLin, OcpQpData,
                                      StageConstraint)


class ConvexMpcConfig(NamedTuple):
    """The port's ``ConvexMpcConfig``."""

    params: SrbParams
    horizon: int = 10
    dt: float = 0.03
    # Diagonal state weights [rpy(3), p(3), omega(3), v(3)]:
    q_diag: tuple = (25.0, 25.0, 10.0, 2.0, 2.0, 50.0,
                     0.0, 0.0, 0.3, 0.2, 0.2, 0.2)
    r_force: float = 1e-6
    dtype: torch.dtype = torch.float32


def build_convex_mpc(cfg: ConvexMpcConfig,
                     ipm: IpmSettings = IpmSettings(iters=12),
                     device="cpu"):
    """Returns ``solve(x0, x_ref_traj, foot_pos, enable_table) -> (forces,
    qp_solution)`` on ``device``, with the port's arguments: x0 (13,),
    x_ref_traj (N+1, 13), foot_pos (num_legs, 3), enable_table (N,
    num_legs), each optionally with one leading scenario dimension.
    ``forces`` is (..., N, num_legs, 3). The result's ``initial_qp`` takes
    the same arguments and returns the OCP-QP that ``solve`` solves."""
    dev = torch.device(device)
    p = cfg.params
    N, nl = cfg.horizon, p.num_legs
    nx, nu, ng = p.nx, p.nu, 5 * p.num_legs
    dt_ = cfg.dtype
    kw = dict(dtype=dt_, device=dev)

    qd = torch.tensor(tuple(cfg.q_diag) + (0.0,), **kw)
    Q = torch.diag_embed(qd).repeat(N + 1, 1, 1)
    q = torch.zeros((N + 1, nx), **kw)
    S = torch.zeros((N, nu, nx), **kw)
    # Friction pyramids (5 rows per leg) on stance steps.
    pyr = friction_pyramid_rows(p.mu, dt_, dev)
    D = torch.zeros((N + 1, ng, nu), **kw)
    for i in range(nl):
        D[:N, 5 * i:5 * (i + 1), 3 * i:3 * (i + 1)] = pyr
    C = torch.zeros((N + 1, ng, nx), **kw)
    lg = torch.zeros((N + 1, ng), **kw)
    lg[:N, 4::5] = p.fz_min
    big = 2.0 * p.mu * p.fz_max + 1.0
    ug = torch.zeros((N + 1, ng), **kw)
    ug[:N] = torch.tensor([big, big, big, big, p.fz_max] * nl, **kw)
    fz_col = torch.zeros(3, **kw)
    fz_col[2] = 1.0
    mask_terminal = torch.zeros((1, ng), **kw)

    def inputs(x0, x_ref_traj, foot_pos, enable_table):
        x0, x_ref, feet, enable = (
            torch.as_tensor(a, **kw)
            for a in (x0, x_ref_traj, foot_pos, enable_table))
        lead = torch.broadcast_shapes(x0.shape[:-1], x_ref.shape[:-2],
                                      feet.shape[:-2], enable.shape[:-2])
        if len(lead) > 1:
            raise ValueError(
                f"the inputs carry batch dimensions {tuple(lead)}; the "
                "solver takes at most one batch dimension")
        return x0, x_ref, feet, enable, lead

    def initial_qp(x0, x_ref_traj, foot_pos, enable_table) -> OcpQpData:
        x0, x_ref, feet, enable, lead = inputs(x0, x_ref_traj, foot_pos,
                                               enable_table)
        A, B = srb_discrete_dynamics(p, x_ref[..., :N, 2],
                                     x0[..., None, 3:6], feet[..., None, :, :],
                                     enable, cfg.dt, dt_)
        # The residual b_k = A x_ref_k - x_ref_{k+1} makes the QP exact for
        # the linear model in deviation coordinates.
        b = bmv(A, x_ref[..., :-1, :]) - x_ref[..., 1:, :]
        # Swing-leg force regularization dominates; stance regularization
        # is r_force (keeps the QP strictly convex).
        reg = cfg.r_force + (1.0 - torch.repeat_interleave(enable, 3, dim=-1))
        R = torch.diag_embed(2.0 * reg)
        # Gravity feedforward: r = -2*reg*f_ff with f_ff the equal share of
        # the weight over the stance legs.
        stance_count = torch.clamp(torch.sum(enable, dim=-1), min=1.0)
        fz_ff = p.mass * GRAVITY / stance_count  # (..., N)
        f_ff = (enable * fz_ff[..., None])[..., None] * fz_col
        r = -2.0 * reg * f_ff.reshape(f_ff.shape[:-2] + (nu,))
        mask = torch.cat([
            torch.repeat_interleave(enable, 5, dim=-1),
            mask_terminal.expand(enable.shape[:-2] + (1, ng))], dim=-2)
        dx0 = (x0 - x_ref[..., 0, :]).expand(lead + (nx,))
        return OcpQpData(dyn=DynamicsLin(A=A, B=B, b=b),
                         cost=CostApprox(Q=Q, q=q, R=R, r=r, S=S),
                         con=StageConstraint(C=C, D=D, lg=lg, ug=ug,
                                             mask=mask),
                         dx0=dx0)

    def solve(x0, x_ref_traj, foot_pos, enable_table):
        with matmul_precision("highest"):
            data = initial_qp(x0, x_ref_traj, foot_pos, enable_table)
            sol = solve_ocp_qp(data, ipm)
        enable = torch.as_tensor(enable_table, **kw)
        forces = (sol.du.reshape(sol.du.shape[:-1] + (nl, 3))
                  * enable[..., None])  # swing legs exactly zero
        return forces, sol

    solve.initial_qp = initial_qp
    return solve
