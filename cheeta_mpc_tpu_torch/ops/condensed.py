"""Condensed (dense) interior-point solver for OCP-QPs, batched torch.

Counterpart of ``cheeta_mpc_tpu/ops/condensed.py``: HPIPM's condensing mode
(the reference drives HPIPM from
``ocs2_sqp/hpipm_catkin/src/HpipmInterface.cpp:281-301``) beside its
Riccati mode. The states are eliminated and a dense QP in the stacked
inputs is solved by the same Mehrotra predictor-corrector as
:func:`cheeta_mpc_tpu_torch.ops.ocpqp.solve_ocp_qp` (fixed iteration count,
activity masks, factor once and solve twice, convergence freeze,
stationarity step guard), so the two backends are interchangeable. Riccati
gains (K, k, P, p) are recovered by one backward pass on the final
barrier-augmented cost, outside the iteration loop.

The JAX package computes this outside any Pallas kernel (dense XLA
products and a Cholesky factorization); the port does the same in plain
torch: batched ``torch.matmul``/``einsum``, ``torch.linalg.cholesky_ex``
and ``torch.linalg.solve_triangular``. Every function takes leading batch
dimensions, where the JAX package uses ``jax.vmap``. The f32 clamps are the
JAX package's (``ops.ocpqp.dtype_clamps``: the freeze at mu < 1e-4, barrier
weights at most 1e6).

Elimination (per scenario):
    dX = Phi dU + phi          Phi: ((N+1)*nx, N*nu) block lower triangular
    H  = Rbar + Phi' Qbar Phi + sym(Sblk Phi)        dense (N*nu, N*nu)
    Ghat = Cblk Phi + Dblk                           dense (rows, N*nu)
with ``phi`` carrying both the initial state and the affine defects ``b``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains, symmetrize)
from cheeta_mpc_tpu_torch.ops.ocpqp import (IpmSettings, _grad_at, _max_step,
                                            dtype_clamps)
from cheeta_mpc_tpu_torch.ops.riccati import (bmv, riccati_factorize,
                                              riccati_vector, solve_lqr)


class CondensedQp(NamedTuple):
    """The dense QP ``min 1/2 z'Hz + g0'z  s.t. lg <= Ghat z + ghat <= ug``
    plus the state-recovery operators (leading batch dimensions ``...``)."""

    H: torch.Tensor  # (..., M, M), M = N*nu
    g0: torch.Tensor  # (..., M)
    Ghat: torch.Tensor  # (..., Rows, M), Rows = (N+1)*ng
    ghat: torch.Tensor  # (..., Rows)
    lg: torch.Tensor  # (..., Rows)
    ug: torch.Tensor  # (..., Rows)
    mask: torch.Tensor  # (..., Rows)
    Phi: torch.Tensor  # (..., N+1, nx, M)
    phi: torch.Tensor  # (..., N+1, nx)


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(..., N, n, m) -> (..., N*n, N*m) block-diagonal."""
    N, n, m = blocks.shape[-3:]
    eye = torch.eye(N, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("...kij,kl->...kilj", blocks, eye).reshape(
        blocks.shape[:-3] + (N * n, N * m))


def condense(data: OcpQpData) -> CondensedQp:
    """Eliminate the states from an OCP-QP without stage equalities.

    The state trajectory is affine in the stacked inputs:
    ``dx = Phi z + phi`` with ``phi_0 = dx0``, ``phi_{k+1} = A phi_k + b_k``.
    """
    if data.eq is not None and data.eq.nc > 0:
        raise ValueError("condensed backend does not support stage "
                         "equalities; use the Riccati backend")
    dyn, cost, con = data.dyn, data.cost, data.con
    N, nx, nu = dyn.horizon, dyn.nx, dyn.nu
    M = N * nu
    kw = dict(dtype=data.dx0.dtype, device=data.dx0.device)

    row = torch.zeros(M, **kw).expand(nx, M)  # the rows of Phi at stage 0
    ph = data.dx0
    rows, phis = [row], [ph]
    for k in range(N):
        A = dyn.A[..., k, :, :]
        row = A @ row
        row = torch.cat([row[..., :k * nu],
                         dyn.B[..., k, :, :].expand(row.shape[:-1] + (nu,)),
                         row[..., (k + 1) * nu:]], dim=-1)
        ph = bmv(A, ph) + dyn.b[..., k, :]
        rows.append(row)
        phis.append(ph)
    lead = torch.broadcast_shapes(*(r.shape[:-2] for r in rows))
    Phi = torch.stack([r.expand(lead + r.shape[-2:]) for r in rows],
                      dim=-3)  # (..., N+1, nx, M)
    lead_p = torch.broadcast_shapes(*(p.shape[:-1] for p in phis))
    phi = torch.stack([p.expand(lead_p + p.shape[-1:]) for p in phis],
                      dim=-2)

    # H = Rbar + Phi' Qbar Phi + sym(Sblk Phi); contraction over (N+1)*nx.
    QPhi = cost.Q @ Phi
    H = torch.einsum("...kim,...kin->...mn", Phi, QPhi) + _block_diag(cost.R)
    SPhi = (cost.S @ Phi[..., :-1, :, :]).flatten(-3, -2)
    H = symmetrize(H + SPhi + SPhi.transpose(-1, -2))

    # g0 = rbar + Sblk phi + Phi'(Qbar phi + qbar).
    y = bmv(cost.Q, phi) + cost.q
    g0 = (cost.r + bmv(cost.S, phi[..., :-1, :])).flatten(-2)
    g0 = g0 + torch.einsum("...kim,...ki->...m", Phi, y)

    if con is None:
        z = torch.zeros(0, **kw)
        return CondensedQp(H=H, g0=g0, Ghat=torch.zeros((0, M), **kw),
                           ghat=z, lg=z, ug=z, mask=z, Phi=Phi, phi=phi)

    ng = con.ng
    U = con.C @ Phi  # (..., N+1, ng, M)
    Dblk = torch.cat([_block_diag(con.D[..., :-1, :, :]),
                      torch.zeros(con.D.shape[:-3] + (ng, M), **kw)], dim=-2)
    Ghat = U.flatten(-3, -2) + Dblk
    ghat = bmv(con.C, phi).flatten(-2)
    return CondensedQp(H=H, g0=g0, Ghat=Ghat, ghat=ghat,
                       lg=con.lg.flatten(-2), ug=con.ug.flatten(-2),
                       mask=con.mask.to(data.dx0.dtype).flatten(-2),
                       Phi=Phi, phi=phi)


class _DenseState(NamedTuple):
    z: torch.Tensor
    s_l: torch.Tensor
    s_u: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _factorize(Hb: torch.Tensor, method: str):
    """Factor the barrier-augmented Hessian once per iteration.

    'cholesky' (default): Cholesky after Jacobi equilibration (the barrier
    term puts large spikes on the diagonal; normalizing them reduces the
    condition number the factorization sees). ``cholesky_ex`` checks
    nothing on the host; a failed factorization leaves NaN in the step,
    which the stationarity guard rejects. 'spd_inverse': the explicit
    inverse of the equilibrated matrix (``ops.linalg_small.spd_inverse``,
    a Cholesky inverse here), applied with one refinement step in
    :func:`_factor_solve`; the JAX package keeps it for small f64 oracles.
    """
    d = torch.rsqrt(torch.clamp(torch.diagonal(Hb, dim1=-2, dim2=-1),
                                min=1e-30))
    Hs = d[..., :, None] * Hb * d[..., None, :]
    if method == "spd_inverse":
        from cheeta_mpc_tpu_torch.ops.linalg_small import spd_inverse
        return d[..., :, None] * spd_inverse(Hs) * d[..., None, :], d
    if method == "cholesky":
        return torch.linalg.cholesky_ex(Hs)[0], d
    raise ValueError(f"unknown dense factorization {method!r}")


def _factor_solve(F, Hb: torch.Tensor, rhs: torch.Tensor, method: str):
    Fmat, d = F
    if method == "spd_inverse":
        # Explicit inverse + one iterative-refinement step: the refinement
        # squares the inverse's relative error (two extra mat-vecs).
        x = _mv(Fmat, rhs)
        return x + _mv(Fmat, rhs - _mv(Hb, x))
    y = torch.linalg.solve_triangular(Fmat, (d * rhs)[..., None], upper=False)
    x = torch.linalg.solve_triangular(Fmat.transpose(-1, -2), y, upper=True)
    return d * x[..., 0]


def _dense_step(v, dv, m, tau):
    """``ops.ocpqp._max_step`` over the flat rows of the dense QP."""
    return _max_step(v[..., None], dv[..., None], m[..., None], tau)


def solve_ocp_qp_condensed(data: OcpQpData,
                           settings: IpmSettings = IpmSettings(),
                           factor: str = "cholesky") -> OcpQpSolution:
    """Solve a constrained OCP-QP by condensing + dense Mehrotra IPM.

    Drop-in for :func:`cheeta_mpc_tpu_torch.ops.ocpqp.solve_ocp_qp` on
    problems without stage equalities; any leading batch dimensions.
    ``factor`` selects the dense factorization ('cholesky', or
    'spd_inverse', see :func:`_factorize`). Role (HPIPM's condensing mode
    beside its Riccati mode): the dense cross-check and oracle backend.
    """
    qp = condense(data)
    dt = data.dx0.dtype
    M = data.dyn.horizon * data.dyn.nu
    ng = 0 if data.con is None else data.con.ng
    if ng == 0:
        # Unconstrained: the exact Riccati solve gives the gains too.
        return solve_lqr(data, reg=settings.reg)
    m = qp.mask
    n_active = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    s = dtype_clamps(settings, dt)
    mu_tol, w_max, tau = s.mu_tol, s.w_max, s.tau
    eyeM = torch.eye(M, dtype=dt, device=data.dx0.device)
    one = torch.ones((), dtype=dt, device=m.device)
    zero = torch.zeros((), dtype=dt, device=m.device)
    lead = torch.broadcast_shapes(qp.H.shape[:-2], qp.Ghat.shape[:-2],
                                  qp.ghat.shape[:-1], m.shape[:-1],
                                  qp.lg.shape[:-1], qp.ug.shape[:-1])

    # Initialization (the Riccati-backend IPM's rule), at z = 0.
    g = qp.ghat.expand(lead + qp.ghat.shape[-1:])
    s_l = torch.where(m > 0, torch.clamp(g - qp.lg, min=s.s0_min), one)
    s_u = torch.where(m > 0, torch.clamp(qp.ug - g, min=s.s0_min), one)
    lam_l = torch.where(m > 0, s.mu0 / s_l, zero)
    lam_u = torch.where(m > 0, s.mu0 / s_u, zero)
    state = _DenseState(torch.zeros(lead + (M,), dtype=dt,
                                    device=m.device), s_l, s_u, lam_l, lam_u)

    def stat_norm(st: _DenseState) -> torch.Tensor:
        lam_net = m * (st.lam_u - st.lam_l)
        return torch.amax(torch.abs(_mv(qp.H, st.z) + qp.g0
                                    + _mtv(qp.Ghat, lam_net)), dim=-1)

    def newton(st, F, Hb, r_l, r_u, r_cl, r_cu):
        w_l = st.lam_l / st.s_l
        w_u = st.lam_u / st.s_u
        beta = m * (w_l * r_l + w_u * r_u + r_cl / st.s_l - r_cu / st.s_u)
        lam_net = m * (st.lam_u - st.lam_l + beta)
        grad = _mv(qp.H, st.z) + qp.g0
        dz = _factor_solve(F, Hb, -(grad + _mtv(qp.Ghat, lam_net)), factor)
        dg = _mv(qp.Ghat, dz)
        ds_l = m * (dg + r_l)
        ds_u = m * (-dg - r_u)
        dlam_l = -m * (r_cl + st.lam_l * ds_l) / st.s_l
        dlam_u = -m * (r_cu + st.lam_u * ds_u) / st.s_u
        return dz, ds_l, ds_u, dlam_l, dlam_u

    def step_length(st, ds_l, ds_u, dl_l, dl_u):
        return torch.minimum(
            torch.minimum(_dense_step(st.s_l, ds_l, m, tau),
                          _dense_step(st.s_u, ds_u, m, tau)),
            torch.minimum(_dense_step(st.lam_l, dl_l, m, tau),
                          _dense_step(st.lam_u, dl_u, m, tau)))

    stat_old = stat_norm(state)
    mu = torch.full(lead, float("inf"), dtype=dt, device=m.device)
    for _ in range(s.iters):
        g = _mv(qp.Ghat, state.z) + qp.ghat
        r_l = g - state.s_l - qp.lg
        r_u = g + state.s_u - qp.ug
        mu = (torch.sum(m * (state.s_l * state.lam_l
                             + state.s_u * state.lam_u), dim=-1)
              / (2.0 * n_active))

        w = m * torch.clamp(state.lam_l / state.s_l
                            + state.lam_u / state.s_u, max=w_max)
        Hb = symmetrize(qp.H + qp.Ghat.transpose(-1, -2)
                        @ (w[..., :, None] * qp.Ghat) + s.reg * eyeM)
        F = _factorize(Hb, factor)

        r_cl = m * (state.s_l * state.lam_l)
        r_cu = m * (state.s_u * state.lam_u)
        dz_a, ds_l_a, ds_u_a, dl_l_a, dl_u_a = newton(
            state, F, Hb, r_l, r_u, r_cl, r_cu)
        a_aff = step_length(state, ds_l_a, ds_u_a, dl_l_a, dl_u_a)[..., None]
        mu_aff = (torch.sum(m * ((state.s_l + a_aff * ds_l_a)
                                 * (state.lam_l + a_aff * dl_l_a)
                                 + (state.s_u + a_aff * ds_u_a)
                                 * (state.lam_u + a_aff * dl_u_a)), dim=-1)
                  / (2.0 * n_active))
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                            0.0, 1.0)

        sm = (sigma * mu)[..., None]
        r_cl_c = r_cl + m * (ds_l_a * dl_l_a - sm)
        r_cu_c = r_cu + m * (ds_u_a * dl_u_a - sm)
        dz, ds_l, ds_u, dl_l, dl_u = newton(state, F, Hb, r_l, r_u, r_cl_c,
                                            r_cu_c)
        a = step_length(state, ds_l, ds_u, dl_l, dl_u)
        a = (a * ((mu > mu_tol) | (stat_old > 1e3 * mu_tol)).to(dt))[..., None]

        new = _DenseState(
            z=state.z + a * dz,
            s_l=torch.where(m > 0, state.s_l + a * ds_l, one),
            s_u=torch.where(m > 0, state.s_u + a * ds_u, one),
            lam_l=torch.where(m > 0, state.lam_l + a * dl_l, zero),
            lam_u=torch.where(m > 0, state.lam_u + a * dl_u, zero))
        # Step guard (the Riccati backend's): reject steps that grow the KKT
        # stationarity by more than 10x; NaN compares false, so NaN steps
        # are rejected.
        stat_new = stat_norm(new)
        ok = stat_new <= 10.0 * (stat_old + mu)
        state = _DenseState(*(torch.where(ok[..., None], n, o)
                              for n, o in zip(new, state)))
        stat_old = torch.where(ok, stat_new, stat_old)
    return _expand_solution(data, qp, state, mu, s)


def _expand_solution(data: OcpQpData, qp: CondensedQp, state: _DenseState,
                     mu, settings: IpmSettings) -> OcpQpSolution:
    """Expand a dense-IPM iterate back to the OCP trajectory + Riccati gains
    (``settings`` with the dtype clamps applied)."""
    N, nu = data.dyn.horizon, data.dyn.nu
    con = data.con
    ng = con.ng
    m = qp.mask
    lead = state.z.shape[:-1]

    def stages(v):  # (..., Rows) -> (..., N+1, ng)
        return v.reshape(v.shape[:-1] + (N + 1, ng))

    du = state.z.reshape(lead + (N, nu))
    dx = torch.einsum("...kim,...m->...ki", qp.Phi, state.z) + qp.phi

    # Riccati gains on the final barrier-augmented cost: one backward pass,
    # matching what the reference extracts from HPIPM's last factorization
    # (HpipmInterface.cpp:330-455).
    w = stages(m * torch.clamp(state.lam_l / state.s_l
                               + state.lam_u / state.s_u,
                               max=settings.w_max))
    wC = w[..., None] * con.C
    wD = w[..., None] * con.D
    Ct = con.C.transpose(-1, -2)
    Dt = con.D[..., :-1, :, :].transpose(-1, -2)
    Qb = data.cost.Q + Ct @ wC
    Rb = data.cost.R + Dt @ wD[..., :-1, :, :]
    Sb = data.cost.S + Dt @ wC[..., :-1, :, :]
    factors = riccati_factorize(data.dyn, Qb, Rb, Sb, reg=settings.reg)
    lam_net = stages(m * (state.lam_u - state.lam_l))
    gq, gr = _grad_at(data.cost, dx, du)  # gradient at the iterate
    gq = gq + bmv(Ct, lam_net)
    gr = gr + bmv(Dt, lam_net[..., :-1, :])
    # Newton direction around the (dynamics-feasible) iterate: the dynamics
    # residual is zero by construction, so the vector pass runs with b = 0.
    kvec, p = riccati_vector(
        data.dyn.replace(b=torch.zeros_like(data.dyn.b)), gq, gr, factors)
    gains = RiccatiGains(K=factors.K, k=kvec, P=factors.P, p=p)

    # Diagnostics.
    gfin = _mv(qp.Ghat, state.z) + qp.ghat
    viol = torch.maximum(qp.lg - gfin, gfin - qp.ug)
    lam_flat = m * (state.lam_u - state.lam_l)
    stat_res = torch.amax(torch.abs(_mv(qp.H, state.z) + qp.g0
                                    + _mtv(qp.Ghat, lam_flat)), dim=-1)
    dyn = data.dyn
    return OcpQpSolution(
        dx=dx, du=du, gains=gains,
        lam_l=stages(state.lam_l), lam_u=stages(state.lam_u),
        s_l=stages(state.s_l), s_u=stages(state.s_u),
        iterations=torch.full(lead, settings.iters, dtype=torch.int32,
                              device=dx.device),
        mu=mu, stat_res=stat_res,
        ineq_res=torch.amax(torch.where(m > 0, viol, torch.zeros_like(viol)),
                            dim=-1),
        eq_res=torch.amax(torch.abs(bmv(dyn.A, dx[..., :-1, :])
                                    + bmv(dyn.B, du) + dyn.b
                                    - dx[..., 1:, :]), dim=(-2, -1)))
