"""State-input equality-constraint projection (null-space elimination),
batched torch.

Counterpart of ``cheeta_mpc_tpu/ops/projection.py``: the reference's
``ConstraintProjection`` (``ocs2_sqp/ocs2_sqp/src/ConstraintProjection.cpp:
34-65``) and change-of-input-variables step
(``MultipleShootingTranscription.cpp:67-82``). Given stage equalities
``C dx + D du + e = 0`` with full-row-rank ``D``, substitute
``du = Pu @ du_tilde + Px @ dx + Pe`` so that the reduced problem in
``du_tilde`` has no equalities.

QR variant (reference :34-53):   D' = [Q1 Q2] [R1; 0]
    Pu = Q2,  Px = -Q1 R1^{-T} C,  Pe = -Q1 R1^{-T} e
LU variant (reference :55-65):   pseudo-inverse based
    Pu = ker(D),  Px = -D^+ C,  Pe = -D^+ e

Every function takes any leading dimensions (stages, then scenarios) where
the JAX package maps a per-stage function with ``jax.vmap``. The rank is
the static shape ``nc``, so every row must be active. The pseudo-inverse
uses ``torch.linalg.cholesky_ex`` (no check of the factorization on the
host: a rank-deficient ``D`` gives NaN, not an exception).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains)
from cheeta_mpc_tpu_torch.ops.cuda_ipm_batch import make_fleet_qp_solver
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.ops.riccati import bmv


class Projection(NamedTuple):
    Pu: torch.Tensor  # (..., nu, nu - nc) null-space basis
    Px: torch.Tensor  # (..., nu, nx) particular-solution state map
    Pe: torch.Tensor  # (..., nu) particular-solution offset


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def qr_projection(C: torch.Tensor, D: torch.Tensor,
                  e: torch.Tensor) -> Projection:
    """QR-based projection. D: (..., nc, nu) with nc <= nu, full row
    rank."""
    nc = D.shape[-2]
    Qfull, Rfull = torch.linalg.qr(_t(D), mode="complete")
    Q1, Q2 = Qfull[..., :nc], Qfull[..., nc:]
    R1t = _t(Rfull[..., :nc, :])
    # Q1 R1^{-T} applied to C and e:  solve R1' Y = C  =>  Y = R1^{-T} C.
    Yc = torch.linalg.solve_triangular(R1t, C, upper=False)
    Ye = torch.linalg.solve_triangular(R1t, e[..., None], upper=False)
    return Projection(Pu=Q2, Px=-Q1 @ Yc, Pe=-(Q1 @ Ye)[..., 0])


def lu_projection(C: torch.Tensor, D: torch.Tensor,
                  e: torch.Tensor) -> Projection:
    """Pseudo-inverse-based projection (reference LU variant, :55-65). For
    full-row-rank D the pseudo-inverse is D' (D D')^{-1}, computed through a
    Cholesky factorization."""
    nc = D.shape[-2]
    L, _ = torch.linalg.cholesky_ex(D @ _t(D))
    Dpinv = _t(torch.cholesky_solve(D, L))  # (..., nu, nc)
    Qfull, _ = torch.linalg.qr(_t(D), mode="complete")
    return Projection(Pu=Qfull[..., nc:], Px=-Dpinv @ C,
                      Pe=-(Dpinv @ e[..., None])[..., 0])


def change_of_input_variables(H_uu, H_ux, h_u, proj: Projection):
    """Map input-space quadratic data through du = Pu du~ + Px dx + Pe.

    Returns the reduced (H_uu~, H_ux~, h_u~) in du~ coordinates plus the
    cross/constant corrections to the state blocks:
        dH_xx = Px' H_uu Px + Px' H_ux + H_ux' Px
        dh_x  = Px'(H_uu Pe + h_u) + H_ux' Pe
    (reference: ocs2_core changeOfInputVariables used at
    MultipleShootingTranscription.cpp:72-80).
    """
    Pu, Px, Pe = proj
    HuuPu = H_uu @ Pu
    HuuPx = H_uu @ Px
    HuuPe = bmv(H_uu, Pe)
    H_uu_t = _t(Pu) @ HuuPu
    H_ux_t = _t(Pu) @ (HuuPx + H_ux)
    h_u_t = bmv(_t(Pu), HuuPe + h_u)
    dH_xx = _t(Px) @ HuuPx + _t(Px) @ H_ux + _t(H_ux) @ Px
    dh_x = bmv(_t(Px), HuuPe + h_u) + bmv(_t(H_ux), Pe)
    return H_uu_t, H_ux_t, h_u_t, dH_xx, dh_x


def _cat_stages(parts, nd: int) -> torch.Tensor:
    """Concatenate stage stacks with ``nd`` trailing dims (stage first) on
    the stage axis, after broadcasting their leading (batch) dims."""
    lead = torch.broadcast_shapes(*(t.shape[:-nd] for t in parts))
    return torch.cat([t.expand(lead + t.shape[-nd:]) for t in parts],
                     dim=-nd)


def _default_inner(data: OcpQpData, settings: IpmSettings) -> OcpQpSolution:
    return make_fleet_qp_solver(settings)(data)


def solve_ocp_qp_projected(data: OcpQpData,
                           settings: Optional[IpmSettings] = None,
                           method: str = "qr",
                           inner: Optional[Callable] = None
                           ) -> OcpQpSolution:
    """Solve an OCP-QP with stage equalities by PROJECTION instead of the
    masked eq-Riccati elimination: the reference's
    ``projectStateInputEqualityConstraints=true`` solver mode
    (MultipleShootingTranscription.cpp:67-82 + ConstraintProjection.cpp:34-65
    + the input remap ``du = Pu du~ + Px dx + Pe`` and the null-space gain
    projection of MultipleShootingSolver.cpp:268-311,350-356).

    Per stage the equalities are eliminated by the substitution
    (``qr_projection`` / ``lu_projection``), which carries dynamics, cost
    and inequality rows into the reduced input ``du~`` of static width
    ``nu - nc``. The reduced problem (no equalities) goes to
    ``inner(data, settings)``; by default the port's kernel dispatch
    (``ops.cuda_ipm_batch.make_fleet_qp_solver``: the interior-point
    kernels with inequality rows, the equality-Riccati kernels without; on
    the CPU their plain versions). The solution, trajectory and Riccati
    gains, is mapped back to the full input space.

    Scope: every equality row active, ``D`` of full row rank (the rank is a
    shape, so it cannot follow a runtime mask). Mode-dependent equality
    sets use the eq-Riccati path (``eq_mode='riccati'``).
    """
    if settings is None:
        settings = IpmSettings()
    if inner is None:
        inner = _default_inner
    eq = data.eq
    if eq is None or eq.nc == 0:
        raise ValueError("projected mode needs stage equalities")
    project = qr_projection if method == "qr" else lu_projection
    Pu, Px, Pe = project(eq.C, eq.D, eq.e)  # (..., N, nu, nu-nc) etc.

    dyn, cost = data.dyn, data.cost
    # Dynamics through the substitution.
    dyn_t = dyn.replace(A=dyn.A + dyn.B @ Px, B=dyn.B @ Pu,
                        b=dyn.b + bmv(dyn.B, Pe))
    # Cost through the substitution (stage blocks; terminal unchanged).
    H_uu_t, H_ux_t, h_u_t, dH_xx, dh_x = change_of_input_variables(
        cost.R, cost.S, cost.r, Projection(Pu, Px, Pe))
    Q_t = _cat_stages([cost.Q[..., :-1, :, :] + dH_xx,
                       cost.Q[..., -1:, :, :]], 3)
    q_t = _cat_stages([cost.q[..., :-1, :] + dh_x, cost.q[..., -1:, :]], 2)
    cost_t = cost.replace(Q=Q_t, q=q_t, R=H_uu_t, S=H_ux_t, r=h_u_t)
    # Inequality rows through the substitution (the terminal row has no du).
    con_t = None
    if data.con is not None:
        con = data.con
        Ds = con.D[..., :-1, :, :]
        DPe = bmv(Ds, Pe)
        shift = torch.cat([DPe, torch.zeros_like(DPe[..., :1, :])], dim=-2)
        C_t = _cat_stages([con.C[..., :-1, :, :] + Ds @ Px,
                           con.C[..., -1:, :, :]], 3)
        DPu = Ds @ Pu
        D_t = torch.cat([DPu, torch.zeros_like(DPu[..., :1, :, :])], dim=-3)
        con_t = con.replace(C=C_t, D=D_t, lg=con.lg - shift,
                            ug=con.ug - shift)
    red = data.replace(dyn=dyn_t, cost=cost_t, con=con_t, eq=None)

    sol = inner(red, settings)
    # Remap to full input space: trajectories, then gains through the
    # null-space (reference MultipleShootingSolver.cpp:350-356).
    du = bmv(Pu, sol.du) + bmv(Px, sol.dx[..., :-1, :]) + Pe
    K = Pu @ sol.gains.K + Px
    k = bmv(Pu, sol.gains.k) + Pe
    eq_res = torch.amax(torch.abs(eq.mask * (bmv(eq.C, sol.dx[..., :-1, :])
                                             + bmv(eq.D, du) + eq.e)),
                        dim=(-2, -1))
    return sol.replace(du=du,
                       gains=RiccatiGains(K=K, k=k, P=sol.gains.P,
                                          p=sol.gains.p),
                       eq_res=torch.maximum(sol.eq_res, eq_res))
