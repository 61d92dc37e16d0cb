"""Riccati recursions for OCP-structured QPs, plain torch.

Counterpart of ``cheeta_mpc_tpu/ops/riccati.py``. Each recursion is a Python
loop over stages; every tensor may carry leading batch dimensions (``...``),
which take the place of ``jax.vmap``. The factorization (matrix) pass and
the vector pass are split so the interior-point method factors once per
iteration and runs two vector solves against the same factors.

Convention (k = 0..N-1, terminal N):
    min  sum_k 1/2 [dx;du]' [Q S'; S R] [dx;du] + [q;r]'[dx;du]  + terminal
    s.t. dx_{k+1} = A dx_k + B du_k + b_k,   dx_0 given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cheeta_mpc_tpu_torch.core.types import (CostApprox, DynamicsLin,
                                             OcpQpData, OcpQpSolution,
                                             RiccatiGains, symmetrize)
from cheeta_mpc_tpu_torch.ops.linalg_small import spd_inverse


def bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched mat-vec: (..., m, n) x (..., n) -> (..., m)."""
    return torch.sum(M * v[..., None, :], dim=-1)


def bmv_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., m, n)' x (..., m) -> (..., n) without forming M'."""
    return torch.sum(M * v[..., :, None], dim=-2)


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _stack_rev(items):
    """Stack per-stage results collected in backward order onto axis -3
    (matrices) in forward order."""
    return torch.stack(items[::-1], dim=-3)


def _stack_rev_vec(items):
    return torch.stack(items[::-1], dim=-2)


class RiccatiFactors(NamedTuple):
    """Per-stage factorization products needed for vector solves; ``Ginv``
    is the explicit inverse of G_k = R_k + B'P_{k+1}B."""

    K: torch.Tensor  # (..., N, nu, nx)
    Ginv: torch.Tensor  # (..., N, nu, nu)
    P: torch.Tensor  # (..., N+1, nx, nx)


def riccati_factorize(dyn: DynamicsLin, Q, R, S,
                      reg: float = 0.0) -> RiccatiFactors:
    """Backward matrix pass. Q: (..., N+1, nx, nx), R: (..., N, nu, nu),
    S: (..., N, nu, nx)."""
    N = R.shape[-3]
    nu = R.shape[-1]
    eye_u = torch.eye(nu, dtype=R.dtype, device=R.device)
    P_next = symmetrize(Q[..., N, :, :])
    Ks, Gis, Ps = [], [], [P_next]
    for k in range(N - 1, -1, -1):
        A, B = dyn.A[..., k, :, :], dyn.B[..., k, :, :]
        PA = P_next @ A
        PB = P_next @ B
        G = R[..., k, :, :] + _t(B) @ PB + reg * eye_u
        H = S[..., k, :, :] + _t(B) @ PA
        Ginv = spd_inverse(symmetrize(G))
        K = -Ginv @ H
        P_next = symmetrize(Q[..., k, :, :] + _t(A) @ PA + _t(H) @ K)
        Ks.append(K)
        Gis.append(Ginv)
        Ps.append(P_next)
    return RiccatiFactors(K=_stack_rev(Ks), Ginv=_stack_rev(Gis),
                          P=_stack_rev(Ps))


def riccati_vector(dyn: DynamicsLin, q, r, factors: RiccatiFactors):
    """Backward vector pass against stored factors. q: (..., N+1, nx),
    r: (..., N, nu). Returns (k: (..., N, nu), p: (..., N+1, nx))."""
    N = r.shape[-2]
    p_next = q[..., N, :]
    ks, ps = [], [p_next]
    for k in range(N - 1, -1, -1):
        A, B = dyn.A[..., k, :, :], dyn.B[..., k, :, :]
        m = p_next + bmv(factors.P[..., k + 1, :, :], dyn.b[..., k, :])
        rhs = r[..., k, :] + bmv_t(B, m)
        kk = -bmv(factors.Ginv[..., k, :, :], rhs)
        p_next = (q[..., k, :] + bmv_t(A, m)
                  + bmv_t(factors.K[..., k, :, :], rhs))
        ks.append(kk)
        ps.append(p_next)
    return _stack_rev_vec(ks), _stack_rev_vec(ps)


def lqr_forward(dyn: DynamicsLin, K, k, dx0):
    """Forward rollout of the affine policy.
    Returns (dx: (..., N+1, nx), du: (..., N, nu))."""
    N = K.shape[-3]
    dx = dx0 + torch.zeros_like(dyn.b[..., 0, :])  # broadcast batch dims
    dxs, dus = [dx], []
    for i in range(N):
        du = bmv(K[..., i, :, :], dx) + k[..., i, :]
        dx = (bmv(dyn.A[..., i, :, :], dx) + bmv(dyn.B[..., i, :, :], du)
              + dyn.b[..., i, :])
        dus.append(du)
        dxs.append(dx)
    return torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2)


class EqRiccatiFactors(NamedTuple):
    """Factors for the equality-constrained stage elimination.

    Per-stage equalities ``Ceq dx + Deq du = h`` with an activity mask
    (inactive rows get an eps dual regularization, so the row count is
    static while the effective rank follows the contact mode).

    Stage saddle system over (du, nu_eq):
        [G  D'] [du ]   [-(H dx + g)]
        [D  -E ] [nu ] = [h - C dx  ]      E = eps * diag(1 - mask)
    eliminated via two SPD inverses:
        Y  = G^{-1} D',   Lam = D Y + E,   Li = Lam^{-1}
        W  = G^{-1} - Y Li Y'             (reduced inverse)
        du = -(W H + Y Li C) dx - (W g - Y Li h)
    Value recursion:
        P <- (Q + A'PA) + H'K + C' Li (C - Y' H)
        p <- q_x + A'm + H'k + C' nu0,  nu0 = -Li (h + Y' g)
    """

    K: torch.Tensor  # (..., N, nu, nx)
    W: torch.Tensor  # (..., N, nu, nu) reduced inverses
    YLi: torch.Tensor  # (..., N, nu, nc)
    Li: torch.Tensor  # (..., N, nc, nc)
    H: torch.Tensor  # (..., N, nu, nx)
    P: torch.Tensor  # (..., N+1, nx, nx)


def riccati_factorize_eq(dyn: DynamicsLin, Q, R, S, Ceq, Deq, eq_mask,
                         reg: float = 0.0, eps: float = 1.0,
                         inverse=spd_inverse) -> EqRiccatiFactors:
    """Backward matrix pass with masked stage equalities.

    Ceq: (..., N, nc, nx), Deq: (..., N, nc, nu), eq_mask: (..., N, nc).
    Inactive rows must be zero in Ceq/Deq and get dual regularization
    ``eps`` so Lam stays SPD. ``inverse`` is the SPD inverse used for G and
    Lam (the kernels' plain versions pass their Gauss-Jordan here)."""
    N = R.shape[-3]
    nu = R.shape[-1]
    eye_u = torch.eye(nu, dtype=R.dtype, device=R.device)
    P_next = symmetrize(Q[..., N, :, :])
    Ks, Ws, YLis, Lis, Hs, Ps = [], [], [], [], [], [P_next]
    for k in range(N - 1, -1, -1):
        A, B = dyn.A[..., k, :, :], dyn.B[..., k, :, :]
        Ck, Dk = Ceq[..., k, :, :], Deq[..., k, :, :]
        PA = P_next @ A
        PB = P_next @ B
        G = R[..., k, :, :] + _t(B) @ PB + reg * eye_u
        H = S[..., k, :, :] + _t(B) @ PA
        Ginv = inverse(symmetrize(G))
        Y = Ginv @ _t(Dk)  # (nu, nc)
        E = eps * (1.0 - eq_mask[..., k, :])
        Lam = Dk @ Y + torch.diag_embed(E)
        Li = inverse(symmetrize(Lam))
        YLi = Y @ Li
        W = Ginv - YLi @ _t(Y)
        K = -(W @ H + YLi @ Ck)
        P_next = symmetrize(Q[..., k, :, :] + _t(A) @ PA + _t(H) @ K
                            + _t(Ck) @ (Li @ (Ck - _t(Y) @ H)))
        for lst, val in ((Ks, K), (Ws, W), (YLis, YLi), (Lis, Li), (Hs, H),
                         (Ps, P_next)):
            lst.append(val)
    return EqRiccatiFactors(K=_stack_rev(Ks), W=_stack_rev(Ws),
                            YLi=_stack_rev(YLis), Li=_stack_rev(Lis),
                            H=_stack_rev(Hs), P=_stack_rev(Ps))


def riccati_vector_eq(dyn: DynamicsLin, q, r, h, Ceq,
                      factors: EqRiccatiFactors):
    """Backward vector pass with equality right-hand sides h: (..., N, nc).

    Uses Li Y' g = (YLi)' g (Li symmetric), so the stored factors suffice:
    nu0 = -(Li h + (YLi)' g)."""
    N = r.shape[-2]
    p_next = q[..., N, :]
    ks, ps = [], [p_next]
    for k in range(N - 1, -1, -1):
        A, B = dyn.A[..., k, :, :], dyn.B[..., k, :, :]
        YLi = factors.YLi[..., k, :, :]
        hk = h[..., k, :]
        m = p_next + bmv(factors.P[..., k + 1, :, :], dyn.b[..., k, :])
        g = r[..., k, :] + bmv_t(B, m)
        kk = -(bmv(factors.W[..., k, :, :], g) - bmv(YLi, hk))
        nu0 = -(bmv(factors.Li[..., k, :, :], hk) + bmv_t(YLi, g))
        p_next = (q[..., k, :] + bmv_t(A, m)
                  + bmv_t(factors.H[..., k, :, :], kk)
                  + bmv_t(Ceq[..., k, :, :], nu0))
        ks.append(kk)
        ps.append(p_next)
    return _stack_rev_vec(ks), _stack_rev_vec(ps)


def _no_inequality_solution(data: OcpQpData, dx, du,
                            gains: RiccatiGains) -> OcpQpSolution:
    """Solution record of an exact (inequality-free) solve."""
    batch = dx.shape[:-2]
    N1 = dx.shape[-2]
    ng = 0 if data.con is None else data.con.ng
    kw = dict(dtype=dx.dtype, device=dx.device)
    zero = torch.zeros(batch, **kw)
    return OcpQpSolution(
        dx=dx, du=du, gains=gains,
        lam_l=torch.zeros(batch + (N1, ng), **kw),
        lam_u=torch.zeros(batch + (N1, ng), **kw),
        s_l=torch.ones(batch + (N1, ng), **kw),
        s_u=torch.ones(batch + (N1, ng), **kw),
        iterations=torch.zeros(batch, dtype=torch.int32, device=dx.device),
        mu=zero, stat_res=zero, ineq_res=zero, eq_res=zero)


def solve_eq_lqr(data: OcpQpData, reg: float = 0.0) -> OcpQpSolution:
    """Solve an OCP-QP with stage equalities but no inequalities, exactly."""
    cost, eq = data.cost, data.eq
    f = riccati_factorize_eq(data.dyn, cost.Q, cost.R, cost.S, eq.C, eq.D,
                             eq.mask, reg=reg)
    k, p = riccati_vector_eq(data.dyn, cost.q, cost.r, -(eq.mask * eq.e),
                             eq.C, f)
    dx, du = lqr_forward(data.dyn, f.K, k, dx0=data.dx0)
    return _no_inequality_solution(
        data, dx, du, RiccatiGains(K=f.K, k=k, P=f.P, p=p))


def solve_lqr(data: OcpQpData, reg: float = 0.0) -> OcpQpSolution:
    """Solve an inequality-free OCP-QP exactly: the oracle path for tests
    and the inner engine of the IPM."""
    cost = data.cost
    f = riccati_factorize(data.dyn, cost.Q, cost.R, cost.S, reg=reg)
    k, p = riccati_vector(data.dyn, cost.q, cost.r, f)
    dx, du = lqr_forward(data.dyn, f.K, k, dx0=data.dx0)
    return _no_inequality_solution(
        data, dx, du, RiccatiGains(K=f.K, k=k, P=f.P, p=p))


def cost_of(cost: CostApprox, dx: torch.Tensor,
            du: torch.Tensor) -> torch.Tensor:
    """Evaluate the quadratic objective at (dx, du)."""
    dxs, dxN = dx[..., :-1, :], dx[..., -1, :]
    Qs = cost.Q[..., :-1, :, :]
    stage = (0.5 * torch.sum(dxs * bmv(Qs, dxs), dim=(-2, -1))
             + 0.5 * torch.sum(du * bmv(cost.R, du), dim=(-2, -1))
             + torch.sum(du * bmv(cost.S, dxs), dim=(-2, -1))
             + torch.sum(cost.q[..., :-1, :] * dxs, dim=(-2, -1))
             + torch.sum(cost.r * du, dim=(-2, -1)))
    term = (0.5 * torch.sum(dxN * bmv(cost.Q[..., -1, :, :], dxN), dim=-1)
            + torch.sum(cost.q[..., -1, :] * dxN, dim=-1))
    return stage + term
