"""Structured primal-dual interior-point solver for OCP-QPs, plain torch.

Counterpart of ``cheeta_mpc_tpu/ops/ocpqp.py`` and the port's
``qp_backend='riccati'`` executor: any dtype, any device, any number of
leading batch dimensions. The design is the JAX package's:

- **Fixed iteration count** instead of data-dependent exits; converged
  elements freeze (zero step) once ``mu < mu_tol``.
- **Activity masks** instead of per-stage row counts.
- **Factor once, solve twice**: the Mehrotra corrector reuses the
  predictor's Riccati factorization.
- ``dx0`` is data, not a decision variable.

Every data-dependent choice (the freeze, the stationarity guard, the step
lengths) is made per batch element with ``torch.where`` — what ``jax.vmap``
does to the JAX package's scalar code.

Algorithm per iteration (Mehrotra predictor-corrector):
    W      = mask * (lam_l/s_l + lam_u/s_u)            barrier weights
    Qbar   = Q + C' diag(W) C   (and Rbar, Sbar with D)
    factor = riccati_factorize_eq(A, B, Qbar, Rbar, Sbar, eq)
    predictor: sigma = 0        -> affine direction, alpha_aff, mu_aff
    sigma  = (mu_aff/mu)^3
    corrector: r_c += ds_aff*dlam_aff - sigma*mu  -> final direction
    fraction-to-boundary (tau=0.995), one step length for all variables.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains, StageConstraint,
                                             StageEquality)
from cheeta_mpc_tpu_torch.ops.linalg_small import spd_inverse
from cheeta_mpc_tpu_torch.ops.riccati import (EqRiccatiFactors, bmv, bmv_t,
                                              lqr_forward,
                                              riccati_factorize_eq,
                                              riccati_vector_eq, solve_eq_lqr,
                                              solve_lqr)


class IpmSettings(NamedTuple):
    """The knobs of the fixed-iteration formulation (the JAX package's
    ``IpmSettings``; ``eq_backend`` is kept so settings convert one to one,
    only ``'scan'`` exists in the port so far)."""

    iters: int = 18
    tau: float = 0.995  # fraction-to-boundary
    mu0: float = 1e1  # initial complementarity target
    s0_min: float = 1.0  # slack clipping at init
    reg: float = 1e-9  # Riccati G regularization
    w_max: float = 1e10  # barrier weight clip (f32 safety; inert in f64)
    # Convergence freeze: once mu < mu_tol the element takes zero steps.
    mu_tol: float = 0.0  # 0.0 => auto by dtype (1e-9 f64, 1e-4 f32)
    eq_backend: str = 'scan'


class _IpmState(NamedTuple):
    dx: torch.Tensor
    du: torch.Tensor
    s_l: torch.Tensor
    s_u: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor


def dtype_clamps(settings: IpmSettings, dtype) -> IpmSettings:
    """The dtype-dependent clamps: barrier conditioning caps achievable
    complementarity at roughly sqrt(machine eps) x problem scale, so the
    freeze sits there; f32 also clips the barrier weights at 1e6."""
    f64 = dtype == torch.float64
    mu_tol = settings.mu_tol if settings.mu_tol > 0 else (
        1e-9 if f64 else 1e-4)
    w_max = settings.w_max if f64 else min(settings.w_max, 1e6)
    return settings._replace(mu_tol=mu_tol, w_max=w_max)


def _bc(a: torch.Tensor) -> torch.Tensor:
    """Per-element scalar (...) -> (..., 1, 1) to scale a trajectory."""
    return a[..., None, None]


def _constraint_values(con: StageConstraint, dx, du):
    """g_n = C_n dx_n + D_n du_n with du padded at the terminal node."""
    du_pad = torch.cat([du, torch.zeros_like(du[..., :1, :])], dim=-2)
    return bmv(con.C, dx) + bmv(con.D, du_pad)


def _grad_at(cost, dx, du):
    """Gradient of the quadratic objective at the current iterate."""
    gq = cost.q + bmv(cost.Q, dx)
    gq = torch.cat([gq[..., :-1, :] + bmv_t(cost.S, du), gq[..., -1:, :]],
                   dim=-2)
    gr = cost.r + bmv(cost.R, du) + bmv(cost.S, dx[..., :-1, :])
    return gq, gr


def _dyn_residual(dyn, dx, du):
    return (bmv(dyn.A, dx[..., :-1, :]) + bmv(dyn.B, du) + dyn.b
            - dx[..., 1:, :])


def _solve_newton(data: OcpQpData, state: _IpmState,
                  factors: EqRiccatiFactors, r_dyn, r_x0, r_eq,
                  r_l, r_u, r_cl, r_cu):
    """One Newton direction for given complementarity residuals."""
    con = data.con
    m = con.mask
    w_l = state.lam_l / state.s_l
    w_u = state.lam_u / state.s_u
    beta = m * (w_l * r_l + w_u * r_u + r_cl / state.s_l - r_cu / state.s_u)
    lam_net = m * (state.lam_u - state.lam_l + beta)

    gq, gr = _grad_at(data.cost, state.dx, state.du)
    qbar = gq + bmv_t(con.C, lam_net)
    rbar = gr + bmv_t(con.D[..., :-1, :, :], lam_net[..., :-1, :])

    dyn_res = data.dyn.replace(b=r_dyn)
    kvec, p = riccati_vector_eq(dyn_res, qbar, rbar, -r_eq, data.eq.C,
                                factors)
    ddx, ddu = lqr_forward(dyn_res, factors.K, kvec, dx0=r_x0)

    dg = _constraint_values(con, ddx, ddu)
    ds_l = m * (dg + r_l)
    ds_u = m * (-dg - r_u)
    dlam_l = -m * (r_cl + state.lam_l * ds_l) / state.s_l
    dlam_u = -m * (r_cu + state.lam_u * ds_u) / state.s_u
    return ddx, ddu, ds_l, ds_u, dlam_l, dlam_u, kvec, p


def _stationarity_norm(data: OcpQpData, state: _IpmState,
                       LiD) -> torch.Tensor:
    """Inf-norm of the input-space KKT stationarity at the iterate, per
    batch element. Costates come from the adjoint recursion; per-stage
    equality duals are the least-squares fit
    ``nu_k = -LiD_k (gr_k + B' mu_{k+1})`` with
    ``LiD = (Deq Deq' + E)^{-1} Deq``."""
    con, eq = data.con, data.eq
    lam_net = con.mask * (state.lam_u - state.lam_l)
    gq, gr = _grad_at(data.cost, state.dx, state.du)
    qbar = gq + bmv_t(con.C, lam_net)
    gru = gr + bmv_t(con.D[..., :-1, :, :], lam_net[..., :-1, :])
    N = data.dyn.horizon
    mu_next = qbar[..., N, :]
    stat = None
    for k in range(N - 1, -1, -1):
        t_u = gru[..., k, :] + bmv_t(data.dyn.B[..., k, :, :], mu_next)
        nu = -bmv(LiD[..., k, :, :], t_u)
        stat_k = t_u + bmv_t(eq.D[..., k, :, :], nu)
        mu_next = (qbar[..., k, :] + bmv_t(data.dyn.A[..., k, :, :], mu_next)
                   + bmv_t(eq.C[..., k, :, :], nu))
        sk = torch.amax(torch.abs(stat_k), dim=-1)
        stat = sk if stat is None else torch.maximum(stat, sk)
    return stat


def _max_step(v, dv, mask, tau):
    """Largest alpha <= 1 with v + alpha*dv >= (1-tau)*v on active rows,
    per batch element."""
    ratio = torch.where((dv < 0) & (mask > 0),
                        -tau * v / torch.clamp(dv, max=-1e-30),
                        torch.full_like(v, float("inf")))
    return torch.clamp(torch.amin(ratio, dim=(-2, -1)), max=1.0)


def _step_length(state, ds_l, ds_u, dl_l, dl_u, m, tau):
    return torch.minimum(
        torch.minimum(_max_step(state.s_l, ds_l, m, tau),
                      _max_step(state.s_u, ds_u, m, tau)),
        torch.minimum(_max_step(state.lam_l, dl_l, m, tau),
                      _max_step(state.lam_u, dl_u, m, tau)))


def _batch_shape(data: OcpQpData):
    con = data.con
    return torch.broadcast_shapes(
        data.dyn.A.shape[:-3], data.dyn.B.shape[:-3], data.dyn.b.shape[:-2],
        data.cost.Q.shape[:-3], data.cost.q.shape[:-2],
        data.cost.R.shape[:-3], data.cost.r.shape[:-2],
        data.cost.S.shape[:-3], con.C.shape[:-3], con.D.shape[:-3],
        con.lg.shape[:-2], con.ug.shape[:-2], con.mask.shape[:-2],
        data.dx0.shape[:-1])


def solve_ocp_qp(data: OcpQpData,
                 settings: IpmSettings = IpmSettings(),
                 warm: Optional[_IpmState] = None,
                 inverse=spd_inverse) -> OcpQpSolution:
    """Solve the constrained OCP-QP. Returns primal/dual solution + gains.

    With ``data.con is None`` this reduces to a single exact Riccati solve.
    ``inverse`` is the SPD inverse of the factorization; the plain versions
    of the CUDA kernels pass the kernels' equilibrated Gauss-Jordan here and
    otherwise run this same function.
    """
    if data.con is None and data.eq is None:
        return solve_lqr(data, reg=settings.reg)
    if data.con is None:
        return solve_eq_lqr(data, reg=settings.reg)
    dt, dev = data.dx0.dtype, data.dx0.device
    kw = dict(dtype=dt, device=dev)
    Nh, nx, nu = data.dyn.horizon, data.dyn.nx, data.dyn.nu
    if data.eq is None:
        data = data.replace(eq=StageEquality(
            C=torch.zeros((Nh, 0, nx), **kw), D=torch.zeros((Nh, 0, nu), **kw),
            e=torch.zeros((Nh, 0), **kw), mask=torch.zeros((Nh, 0), **kw)))
    eq = data.eq
    # Least-squares equality-dual operator for the stationarity metric
    # (constraint matrices are constant across IPM iterations).
    DDt = eq.D @ eq.D.transpose(-1, -2) + torch.diag_embed(1.0 - eq.mask)
    LiD = inverse(DDt) @ eq.D  # (..., N, nc, nu)

    con = data.con
    m = con.mask.to(dt)
    con = con.replace(mask=m)
    data = data.replace(con=con)
    batch = _batch_shape(data)
    n_active = torch.clamp(torch.sum(m, dim=(-2, -1)), min=1.0)
    settings = dtype_clamps(settings, dt)
    mu_tol, tau = settings.mu_tol, settings.tau

    one, zero = torch.ones((), **kw), torch.zeros((), **kw)
    if warm is None:
        dx = torch.zeros(batch + (Nh + 1, nx), **kw)
        du = torch.zeros(batch + (Nh, nu), **kw)
        g = _constraint_values(con, dx, du)
        s_l = torch.where(m > 0, torch.clamp(g - con.lg, min=settings.s0_min),
                          one)
        s_u = torch.where(m > 0, torch.clamp(con.ug - g, min=settings.s0_min),
                          one)
        lam_l = torch.where(m > 0, settings.mu0 / s_l, zero)
        lam_u = torch.where(m > 0, settings.mu0 / s_u, zero)
        state = _IpmState(dx, du, s_l, s_u, lam_l, lam_u)
    else:
        state = warm

    Cn, Dn = con.C, con.D[..., :-1, :, :]
    gains = RiccatiGains(
        K=torch.zeros(batch + (Nh, nu, nx), **kw),
        k=torch.zeros(batch + (Nh, nu), **kw),
        P=torch.zeros(batch + (Nh + 1, nx, nx), **kw),
        p=torch.zeros(batch + (Nh + 1, nx), **kw))
    mu = torch.full(batch, float("inf"), **kw)
    stat_old = _stationarity_norm(data, state, LiD) + torch.zeros(batch, **kw)

    for _ in range(settings.iters):
        g = _constraint_values(con, state.dx, state.du)
        r_l = g - state.s_l - con.lg
        r_u = g + state.s_u - con.ug
        r_dyn = _dyn_residual(data.dyn, state.dx, state.du)
        r_x0 = data.dx0 - state.dx[..., 0, :]
        r_eq = eq.mask * (bmv(eq.C, state.dx[..., :-1, :])
                          + bmv(eq.D, state.du) + eq.e)
        mu = (torch.sum(m * (state.s_l * state.lam_l
                             + state.s_u * state.lam_u), dim=(-2, -1))
              / (2.0 * n_active))

        # Barrier-augmented Hessian blocks; factor once per iteration.
        w = m * torch.clamp(state.lam_l / state.s_l
                            + state.lam_u / state.s_u, max=settings.w_max)
        wC = w[..., None] * Cn
        wD = w[..., :-1, :, None] * Dn
        Qb = data.cost.Q + Cn.transpose(-1, -2) @ wC
        Rb = data.cost.R + Dn.transpose(-1, -2) @ wD
        Sb = data.cost.S + Dn.transpose(-1, -2) @ wC[..., :-1, :, :]
        factors = riccati_factorize_eq(data.dyn, Qb, Rb, Sb, eq.C, eq.D,
                                       eq.mask, reg=settings.reg,
                                       inverse=inverse)

        # Predictor (affine direction, sigma = 0).
        r_cl = m * (state.s_l * state.lam_l)
        r_cu = m * (state.s_u * state.lam_u)
        aff = _solve_newton(data, state, factors, r_dyn, r_x0, r_eq,
                            r_l, r_u, r_cl, r_cu)
        _, _, ds_l_a, ds_u_a, dl_l_a, dl_u_a, _, _ = aff
        a_aff = _bc(_step_length(state, ds_l_a, ds_u_a, dl_l_a, dl_u_a, m,
                                 tau))
        mu_aff = (torch.sum(m * ((state.s_l + a_aff * ds_l_a)
                                 * (state.lam_l + a_aff * dl_l_a)
                                 + (state.s_u + a_aff * ds_u_a)
                                 * (state.lam_u + a_aff * dl_u_a)),
                            dim=(-2, -1)) / (2.0 * n_active))
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                            0.0, 1.0)

        # Corrector (reuses the factorization; only the vector pass reruns).
        sm = _bc(sigma * mu)
        r_cl_c = m * (state.s_l * state.lam_l + ds_l_a * dl_l_a - sm)
        r_cu_c = m * (state.s_u * state.lam_u + ds_u_a * dl_u_a - sm)
        cor = _solve_newton(data, state, factors, r_dyn, r_x0, r_eq,
                            r_l, r_u, r_cl_c, r_cu_c)
        ddx, ddu, ds_l, ds_u, dl_l, dl_u, kvec, p = cor
        a = _step_length(state, ds_l, ds_u, dl_l, dl_u, m, tau)
        # Freeze converged elements: prevents post-convergence blow-up and
        # makes divergent convergence across a batch harmless. An element
        # keeps iterating while stationarity is unresolved even at tiny mu —
        # the step guard below keeps that regime safe.
        a = _bc(a * ((mu > mu_tol) | (stat_old > 1e3 * mu_tol)).to(dt))

        new = _IpmState(
            dx=state.dx + a * ddx,
            du=state.du + a * ddu,
            s_l=torch.where(m > 0, state.s_l + a * ds_l, one),
            s_u=torch.where(m > 0, state.s_u + a * ds_u, one),
            lam_l=torch.where(m > 0, state.lam_l + a * dl_l, zero),
            lam_u=torch.where(m > 0, state.lam_u + a * dl_u, zero))
        # Stationarity guard: near convergence the barrier Hessian reaches
        # condition ~1/mu and a full step can corrupt the duals (or NaN in
        # f32). Reject, per element, steps that grow the KKT stationarity by
        # more than 10x; a NaN compares false, so NaN steps are rejected.
        stat_new = _stationarity_norm(data, new, LiD)
        ok = stat_new <= 10.0 * (stat_old + mu)
        state = _IpmState(*(torch.where(_bc(ok), n, o)
                            for n, o in zip(new, state)))
        stat_old = torch.where(ok, stat_new, stat_old)
        gains = RiccatiGains(K=factors.K, k=kvec, P=factors.P, p=p)

    return _finish(data, state, gains, mu, settings.iters)


def _finish(data: OcpQpData, state: _IpmState, gains: RiccatiGains, mu,
            iters: int) -> OcpQpSolution:
    """Final diagnostics of an IPM solve (shared with the kernels' wrappers,
    which run it in plain torch on the kernels' outputs)."""
    con = data.con
    m = con.mask
    g = _constraint_values(con, state.dx, state.du)
    viol = torch.maximum(con.lg - g, g - con.ug)
    if con.ng > 0:
        ineq_res = torch.amax(torch.where(m > 0, viol, torch.zeros_like(viol)),
                              dim=(-2, -1))
    else:
        ineq_res = torch.zeros_like(mu)
    r_dyn = _dyn_residual(data.dyn, state.dx, state.du)
    _, gr = _grad_at(data.cost, state.dx, state.du)
    lam_net = m * (state.lam_u - state.lam_l)
    stat_u = gr + bmv_t(con.D[..., :-1, :, :], lam_net[..., :-1, :])
    # State stationarity involves equality duals we do not store; report the
    # input-space stationarity (sufficient for convergence monitoring).
    stat_res = torch.amax(torch.abs(
        stat_u + _costate_correction(data, state, lam_net)), dim=(-2, -1))
    return OcpQpSolution(
        dx=state.dx, du=state.du, gains=gains,
        lam_l=state.lam_l, lam_u=state.lam_u, s_l=state.s_l, s_u=state.s_u,
        iterations=torch.full(mu.shape, iters, dtype=torch.int32,
                              device=mu.device),
        mu=mu, stat_res=stat_res, ineq_res=ineq_res,
        eq_res=torch.amax(torch.abs(r_dyn), dim=(-2, -1)))


def _costates(dyn, qbar):
    """lam_{k+1}, k = 0..N-1, of the state-stationarity recursion."""
    N = dyn.horizon
    lam = qbar[..., N, :]
    seq = []
    for k in range(N - 1, -1, -1):
        seq.append(lam)
        lam = qbar[..., k, :] + bmv_t(dyn.A[..., k, :, :], lam)
    return torch.stack(seq[::-1], dim=-2)


def _costate_correction(data: OcpQpData, state: _IpmState, lam_net):
    """B' * costate contribution to input stationarity."""
    gq, _ = _grad_at(data.cost, state.dx, state.du)
    qbar = gq + bmv_t(data.con.C, lam_net)
    return bmv_t(data.dyn.B, _costates(data.dyn, qbar))


def kkt_residuals(data: OcpQpData, sol: OcpQpSolution):
    """Certify a solution: KKT residual inf-norms of the convex OCP-QP, per
    batch element: {stationarity, dynamics, initial, ineq_primal,
    slack_consistency, complementarity, dual_sign}. For a convex QP, all ~0
    proves global optimality."""
    dx, du = sol.dx, sol.du
    gq, gr = _grad_at(data.cost, dx, du)
    if data.con is not None:
        m = data.con.mask
        lam_net = m * (sol.lam_u - sol.lam_l)
        g = _constraint_values(data.con, dx, du)
        qbar = gq + bmv_t(data.con.C, lam_net)
        stat_u = gr + bmv_t(data.con.D[..., :-1, :, :], lam_net[..., :-1, :])
    else:
        qbar, stat_u = gq, gr

    def amax(x):
        return torch.amax(x, dim=(-2, -1))

    stat = amax(torch.abs(stat_u + bmv_t(data.dyn.B,
                                         _costates(data.dyn, qbar))))
    out = {
        'stationarity': stat,
        'dynamics': amax(torch.abs(_dyn_residual(data.dyn, dx, du))),
        'initial': torch.amax(torch.abs(dx[..., 0, :] - data.dx0), dim=-1),
    }
    if data.con is not None:
        z = torch.zeros_like(g)
        on = m > 0
        viol = torch.maximum(data.con.lg - g, g - data.con.ug)
        out['ineq_primal'] = amax(torch.where(on, viol, z))
        out['slack_consistency'] = amax(torch.where(
            on, torch.maximum(torch.abs(g - sol.s_l - data.con.lg),
                              torch.abs(g + sol.s_u - data.con.ug)), z))
        out['complementarity'] = amax(torch.where(
            on, torch.maximum(sol.s_l * sol.lam_l, sol.s_u * sol.lam_u), z))
        out['dual_sign'] = torch.maximum(
            amax(torch.where(on, -sol.lam_l, z)),
            amax(torch.where(on, -sol.lam_u, z)))
    return out
