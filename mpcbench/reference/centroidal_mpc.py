"""Centroidal MPC — the north-star workload, batched torch.

Counterpart of ``cheeta_mpc_tpu/mpc/centroidal_mpc.py``: the same NLP
(centroidal dynamics, friction pyramids, footstep boxes, all 45 cost weights
including the exponential CoM-z trust decay), the same packed input layout
and the same outputs (per-leg foot-position and contact-force trajectories),
solved by SQP over the Riccati-structured interior-point QP solver.

Formulation notes (shared with the JAX package):
- Forces enter as ``F = enable * u_F`` so swing-leg forces are identically
  zero and the friction rows are simply masked off on swing nodes.
- The force-rate cost is made stage-separable by augmenting the state with
  the previous effective force (see models/centroidal.py).
- The CoM-z cost term is ``(w_k * (z_k - d_k))**2`` with
  ``w_k = (w2/2) e^{-k} + w2/2`` — the *squared* weight multiplies the
  squared error.
- Tiny regularizers (1e-6) on foot velocities and masked force variables pin
  coordinates the cost leaves free.

What differs from the JAX package is idiom, not math:
- every function takes any leading batch dimensions (a fleet of scenarios
  is a leading dimension of ``state``/``des_state``/``des_inputs``, not a
  ``vmap``);
- the stage cost is a diagonal-weighted quadratic in (x, u_F, foot_vel), so
  its gradient and Hessian blocks Q/R/S/q/r are written in closed form
  instead of coming from automatic differentiation;
- the constraint matrices C/D do not depend on the scenario and are kept
  without batch dimensions, which is what the fleet kernel's scope asks for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpcbench.reference.types import (CostApprox, DynamicsLin,
                                             OcpQpData, PerformanceIndex,
                                             StageConstraint, _Replace,
                                             resolve_device)
from mpcbench.reference.centroidal import (GRAVITY, CentroidalParams,
                                                    centroidal_step,
                                                    linearize_step,
                                                    pack_state, rollout,
                                                    unpack_input,
                                                    unpack_state)
from mpcbench.reference.riccati import bmv
from mpcbench.reference.scp import (ScpSettings, make_performance,
                                              solve_nonlinear_ocp)


class CentroidalMpcConfig(NamedTuple):
    """Static configuration (the JAX package's ``CentroidalMpcConfig``)."""

    mass: float = 8.0
    num_legs: int = 4
    horizon: int = 6
    dt: float = 0.01
    # 45 weights: com pos (3), com vel (3), angular momentum (3), then
    # foot pos (3*nl), force (3*nl), force rate (3*nl).
    weights: Tuple[float, ...] = ()
    mu: Tuple[float, ...] = (0.8, 0.8, 0.8, 0.8)
    foot_step_lb: Tuple[float, float, float] = (-0.2, -0.2, -0.1)
    foot_step_ub: Tuple[float, float, float] = (0.2, 0.2, 0.1)
    force_max: float = 5000.0  # friction-row upper bound
    reg_eps: float = 1e-6  # foot-vel / masked-force regularizer
    dtype: torch.dtype = torch.float32


@dataclass
class CentroidalSolution(_Replace):
    """Controller outputs plus diagnostics; ``...`` are the batch dimensions
    of the inputs."""

    foot_pos: torch.Tensor  # (..., num_legs, 3, N+1)
    contact_force: torch.Tensor  # (..., num_legs, 3, N)
    com_pos: torch.Tensor  # (..., 3, N+1)
    com_vel: torch.Tensor  # (..., 3, N+1)
    ang_mom: torch.Tensor  # (..., 3, N+1)
    x_traj: torch.Tensor  # (..., N+1, nx) augmented-state iterate
    u_traj: torch.Tensor  # (..., N, nu)
    merit: torch.Tensor
    qp_mu: torch.Tensor
    gains_K: torch.Tensor  # (..., N, nu, nx) Riccati feedback of the last QP
    gains_P: torch.Tensor  # (..., N+1, nx, nx) value-function Hessians
    gains_p: torch.Tensor  # (..., N+1, nx) value-function gradients
    performance: PerformanceIndex  # at the final iterate
    convergence: torch.Tensor  # int32 CONV_* code
    step_size: torch.Tensor  # (..., iters) accepted line-search steps
    step_type: torch.Tensor  # (..., iters) int32 STEP_* codes


class _Refs(NamedTuple):
    """Unpacked per-solve reference data (all arrays node-major)."""

    x0: torch.Tensor  # (..., nx) augmented initial state
    des_com_pos: torch.Tensor  # (..., N+1, 3)
    des_com_vel: torch.Tensor  # (..., N+1, 3)
    des_ang_mom: torch.Tensor  # (..., N+1, 3)
    des_foot_pos: torch.Tensor  # (..., num_legs, N+1, 3)
    des_force: torch.Tensor  # (..., num_legs, N, 3)
    enable: torch.Tensor  # (..., N, num_legs) contact table


def _as_tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _unpack_reference_inputs(cfg: CentroidalMpcConfig, state, des_state,
                             des_inputs, device="cpu") -> _Refs:
    """Decode the packed vectors.

    state:      [com_pos(3), com_vel(3), L(3), foot_pos(3*nl)]
    des_state:  [des_com_pos(3*(N+1)), des_com_vel(...), des_L(...)]
    des_inputs: per leg i at offset i*(4N+3):
                [contact_enable(N), des_foot_pos(3*(N+1))]
    Desired normal forces are derived from the contact table as
    m*g / (#stance legs) per step.
    """
    nl, N = cfg.num_legs, cfg.horizon
    state = _as_tensor(state, cfg.dtype, device)
    des_state = _as_tensor(des_state, cfg.dtype, device)
    des_inputs = _as_tensor(des_inputs, cfg.dtype, device)
    lead = state.shape[:-1]

    com_pos, com_vel, ang_mom = (state[..., 0:3], state[..., 3:6],
                                 state[..., 6:9])
    foot_pos0 = state[..., 9:9 + 3 * nl].reshape(*lead, nl, 3)

    per_node = 3 * (N + 1)
    des_com_pos = des_state[..., 0:per_node].reshape(*lead, N + 1, 3)
    des_com_vel = des_state[..., per_node:2 * per_node].reshape(
        *lead, N + 1, 3)
    des_ang_mom = des_state[..., 2 * per_node:3 * per_node].reshape(
        *lead, N + 1, 3)

    leg_stride = 4 * N + 3
    per_leg = des_inputs[..., :nl * leg_stride].reshape(*lead, nl, leg_stride)
    enable = per_leg[..., :N]  # (..., nl, N)
    des_foot_pos = per_leg[..., N:N + 3 * (N + 1)].reshape(
        *lead, nl, N + 1, 3)

    stance_count = torch.sum(enable, dim=-2)  # (..., N)
    fz_des = cfg.mass * GRAVITY / torch.clamp(stance_count, min=1.0)
    fz = enable * fz_des[..., None, :]  # (..., nl, N)
    des_force = torch.stack(
        [torch.zeros_like(fz), torch.zeros_like(fz), fz], dim=-1)

    # Initial F_prev: there is no rate cost on the first step, so F_prev_0
    # is irrelevant; the desired force keeps the augmented state well-scaled.
    x0 = pack_state(com_pos, com_vel, ang_mom, foot_pos0,
                    des_force[..., :, 0, :])
    return _Refs(x0=x0, des_com_pos=des_com_pos, des_com_vel=des_com_vel,
                 des_ang_mom=des_ang_mom, des_foot_pos=des_foot_pos,
                 des_force=des_force,
                 enable=enable.transpose(-1, -2).contiguous())


class _Weights(NamedTuple):
    """The 45 weights as per-node tensors of the cost's diagonal form
    ``sum w_x (x - x_des)^2 + ...`` (node-major, no batch dimensions)."""

    w_x: torch.Tensor  # (N+1, 9 + 3*nl) weights of the tracked states
    w_f: torch.Tensor  # (3*nl,) force tracking, leg-major
    w_r: torch.Tensor  # (N, 3*nl) force rate, zero at stage 0


def _weights(cfg: CentroidalMpcConfig, device) -> _Weights:
    nl, N = cfg.num_legs, cfg.horizon
    w = torch.as_tensor(np.asarray(cfg.weights, np.float64), dtype=cfg.dtype,
                        device=device)
    k = torch.arange(N + 1, dtype=cfg.dtype, device=device)
    # CoM-z: the node-dependent weight is squared together with the error.
    wz = (w[2] / 2) * torch.exp(-k) + w[2] / 2
    w_x = w[:9 + 3 * nl].expand(N + 1, -1).clone()
    w_x[:, 2] = wz * wz
    gate = (torch.arange(N, device=device) > 0).to(cfg.dtype)
    w_r = gate[:, None] * w[9 + 6 * nl:9 + 9 * nl]
    return _Weights(w_x=w_x, w_f=w[9 + 3 * nl:9 + 6 * nl], w_r=w_r)


def _tracked_reference(refs: _Refs) -> torch.Tensor:
    """Desired values of the tracked states, (..., N+1, 9 + 3*nl)."""
    des_fp = refs.des_foot_pos.transpose(-3, -2).flatten(-2)
    return torch.cat([refs.des_com_pos, refs.des_com_vel, refs.des_ang_mom,
                      des_fp], dim=-1)


def _leg_major(v: torch.Tensor) -> torch.Tensor:
    """(..., nl, N, 3) per-leg trajectories -> (..., N, 3*nl)."""
    return v.transpose(-3, -2).flatten(-2)


def _stage_cost(cfg: CentroidalMpcConfig, params: CentroidalParams, k, x, u,
                refs: _Refs, terminal: bool, weights: Optional[_Weights] = None):
    """Cost of the nodes ``k`` (an integer index tensor of shape (n,)), one
    value per node: x is (..., n, nx), u is (..., n, nu) and the result
    (..., n). For ``terminal=False`` the input terms are included; the
    terminal node is tracking only (``u`` is ignored)."""
    nl = cfg.num_legs
    wt = _weights(cfg, x.device) if weights is None else weights
    nt = 9 + 3 * nl
    err = x[..., :nt] - _tracked_reference(refs)[..., k, :]
    c = torch.sum(wt.w_x[k] * err * err, dim=-1)
    if not terminal:
        e = torch.repeat_interleave(refs.enable[..., k, :], 3, dim=-1)
        foot_vel, u_f = u[..., :3 * nl], u[..., 3 * nl:]
        f_prev = x[..., nt:]
        f_eff = e * u_f
        df = f_eff - _leg_major(refs.des_force)[..., k, :]
        rate = f_eff - f_prev
        c = c + torch.sum(wt.w_f * df * df, dim=-1)
        # Force-rate term: at stage k >= 1, (F_k - F_{k-1}) with F_{k-1}
        # stored in the augmented state (w_r is zero at stage 0).
        c = c + torch.sum(wt.w_r[k] * rate * rate, dim=-1)
        c = c + cfg.reg_eps * (torch.sum(foot_vel * foot_vel, dim=-1)
                               + torch.sum((1.0 - e) * u_f * u_f, dim=-1))
    return c


def _cost_quadratic(cfg: CentroidalMpcConfig, params: CentroidalParams,
                    x_traj, u_traj, refs: _Refs,
                    wt: _Weights) -> CostApprox:
    """Gradient and Hessian blocks of :func:`_stage_cost` at the iterate, in
    closed form. With e the (0/1, but not assumed so) contact flags and
    F = e u_F:

        d/dx_t   = 2 w_x (x_t - x_des)            Q_tt = 2 w_x
        d/dFprev = -2 w_r (F - Fprev)             Q_pp = 2 w_r
        d/du_F   = 2 e w_f (F - F_des) + 2 e w_r (F - Fprev)
                   + 2 eps (1 - e) u_F            R_FF = 2 e^2 (w_f + w_r)
                                                         + 2 eps (1 - e)
        d/dv     = 2 eps v                        R_vv = 2 eps
        S[u_F, Fprev] = -2 e w_r
    """
    nl, N = cfg.num_legs, cfg.horizon
    nx, nu = params.nx, params.nu
    nt, nf = 9 + 3 * nl, 3 * nl
    lead = x_traj.shape[:-2]
    kw = dict(dtype=x_traj.dtype, device=x_traj.device)
    eps = cfg.reg_eps

    err = x_traj[..., :nt] - _tracked_reference(refs)
    f_prev = x_traj[..., :-1, nt:]
    e = torch.repeat_interleave(refs.enable, 3, dim=-1)  # (..., N, 3nl)
    foot_vel, u_f = u_traj[..., :nf], u_traj[..., nf:]
    f_eff = e * u_f
    df = f_eff - _leg_major(refs.des_force)
    rate = f_eff - f_prev

    q_prev = torch.cat([-2.0 * wt.w_r * rate,
                        torch.zeros(lead + (1, nf), **kw)], dim=-2)
    q = torch.cat([2.0 * wt.w_x * err, q_prev], dim=-1)
    r = torch.cat([2.0 * eps * foot_vel,
                   2.0 * e * (wt.w_f * df + wt.w_r * rate)
                   + 2.0 * eps * (1.0 - e) * u_f], dim=-1)

    # Q does not depend on the scenario: no batch dimensions.
    q_diag = torch.cat([2.0 * wt.w_x, torch.cat(
        [2.0 * wt.w_r, torch.zeros((1, nf), **kw)], dim=0)], dim=-1)
    Q = torch.diag_embed(q_diag)
    r_diag = torch.cat([
        torch.full(lead + (N, nf), 2.0 * eps, **kw),
        2.0 * e * e * (wt.w_f + wt.w_r) + 2.0 * eps * (1.0 - e)], dim=-1)
    R = torch.diag_embed(r_diag)
    S = torch.zeros(e.shape[:-2] + (N, nu, nx), **kw)
    idx = torch.arange(nf, device=x_traj.device)
    S[..., nf + idx, nt + idx] = -2.0 * e * wt.w_r
    return CostApprox(Q=Q, q=q, R=R, r=r, S=S)


def _constraint_constants(cfg: CentroidalMpcConfig, params: CentroidalParams):
    """Static constraint matrices (numpy).

    Row layout per node (ng = 5*nl + 3*nl):
      [0, 5nl)       friction pyramid rows {(-1,0,mu),(1,0,mu),(0,-1,mu),
                     (0,1,mu),(0,0,1)}, leg-major (masked by enable; nodes
                     0..N-1 only)
      [5nl, 5nl+3nl) footstep box rows (foot positions at nodes 1..N)
    """
    nl, N = cfg.num_legs, cfg.horizon
    nx, nu = params.nx, params.nu
    ng = 8 * nl
    C = np.zeros((N + 1, ng, nx))
    D = np.zeros((N + 1, ng, nu))
    ug_fr = np.zeros((N + 1, 5 * nl))
    for i in range(nl):
        m = float(cfg.mu[i])
        pyr = np.array([[-1.0, 0.0, m], [1.0, 0.0, m], [0.0, -1.0, m],
                        [0.0, 1.0, m], [0.0, 0.0, 1.0]])
        D[:N, 5 * i:5 * (i + 1), 3 * nl + 3 * i:3 * nl + 3 * (i + 1)] = pyr
        C[:, 5 * nl + 3 * i:5 * nl + 3 * (i + 1),
          9 + 3 * i:9 + 3 * (i + 1)] = np.eye(3)
    force_ub = np.array([cfg.force_max] * 4 + [cfg.mass * GRAVITY * nl])
    ug_fr[:N] = np.tile(force_ub, nl)[None, :]
    box_mask = np.zeros((N + 1, 3 * nl))
    box_mask[1:] = 1.0  # nodes 1..N only
    return C, D, ug_fr, box_mask


class _ConstraintSet(NamedTuple):
    """The iterate-independent part of the stage constraints of one solve:
    batch-shared matrices and the absolute bounds and mask of each
    scenario."""

    C: torch.Tensor  # (N+1, ng, nx)
    D: torch.Tensor  # (N+1, ng, nu)
    lg: torch.Tensor  # (..., N+1, ng) bounds on g(x, u) itself
    ug: torch.Tensor
    mask: torch.Tensor


def _constraint_tensors(cfg: CentroidalMpcConfig, params: CentroidalParams,
                        dtype, device):
    """The constants of :func:`_constraint_constants` and the footstep box
    bounds (tiled per leg) as tensors on the device. Made once per solver:
    every host-to-device copy in a solve makes the host wait for the
    stream."""
    nl = cfg.num_legs
    arrays = _constraint_constants(cfg, params) + (
        np.tile(np.asarray(cfg.foot_step_lb), nl),
        np.tile(np.asarray(cfg.foot_step_ub), nl))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in arrays)


def _constraint_set(cfg: CentroidalMpcConfig, params: CentroidalParams,
                    refs: _Refs, consts=None) -> _ConstraintSet:
    """``consts`` are the tensors of :func:`_constraint_tensors` when the
    caller holds them on the device already."""
    nl, N = cfg.num_legs, cfg.horizon
    kw = dict(dtype=refs.x0.dtype, device=refs.x0.device)
    lead = refs.x0.shape[:-1]
    if consts is None:
        consts = _constraint_tensors(cfg, params, **kw)
    C, D, ug_fr, box_mask, step_lb, step_ub = consts
    des_box = refs.des_foot_pos.transpose(-3, -2).flatten(-2)
    # Bounds: friction rows [0, ug_fr]; box rows des +- step bounds.
    lg = torch.cat([torch.zeros(lead + (N + 1, 5 * nl), **kw),
                    des_box + step_lb], dim=-1)
    ug = torch.cat([ug_fr.expand(lead + ug_fr.shape), des_box + step_ub],
                   dim=-1)
    mask = torch.cat(
        [torch.cat([torch.repeat_interleave(refs.enable, 5, dim=-1),
                    torch.zeros(lead + (1, 5 * nl), **kw)], dim=-2),
         box_mask.expand(lead + box_mask.shape)], dim=-1)
    return _ConstraintSet(C=C, D=D, lg=lg, ug=ug, mask=mask)


def _build_constraints(cfg: CentroidalMpcConfig, params: CentroidalParams,
                       refs: _Refs, x_traj, u_traj,
                       cset: Optional[_ConstraintSet] = None
                       ) -> StageConstraint:
    """Stage constraints in deviation coordinates around the iterate:
    ``lg - g(iterate) <= J dz <= ug - g(iterate)``. ``cset`` carries the
    iterate-independent part when the caller has it already."""
    if cset is None:
        cset = _constraint_set(cfg, params, refs)
    du_pad = torch.cat([u_traj, torch.zeros_like(u_traj[..., :1, :])], dim=-2)
    g_iter = bmv(cset.C, x_traj) + bmv(cset.D, du_pad)
    return StageConstraint(C=cset.C, D=cset.D, lg=cset.lg - g_iter,
                           ug=cset.ug - g_iter, mask=cset.mask)


def build_centroidal_solver(cfg: CentroidalMpcConfig,
                            scp: ScpSettings = ScpSettings(),
                            device="cuda"):
    """Returns ``solve(state, des_state, des_inputs, warm=None) ->
    CentroidalSolution`` for the static config, running on ``device``.

    The default device is the card; with no card present this raises (pass
    ``device="cpu"`` to run the torch executors and the kernels' plain
    versions on the CPU). The packed inputs may be numpy arrays or tensors
    and may carry leading batch dimensions — a fleet of scenarios is solved
    in one call. ``warm=(x_traj, u_traj)`` warm-starts the SQP from a
    previous solution.
    """
    dev = resolve_device(device)
    params = CentroidalParams.create(cfg.mass, cfg.num_legs, cfg.dt, cfg.mu)
    N, nl = cfg.horizon, cfg.num_legs
    nx, nu = params.nx, params.nu
    wt = _weights(cfg, dev)
    ks = torch.arange(N + 1, device=dev)
    consts = _constraint_tensors(cfg, params, cfg.dtype, dev)

    def total_cost(x_traj, u_traj, refs):
        stage = _stage_cost(cfg, params, ks[:-1], x_traj[..., :-1, :],
                            u_traj, refs, False, wt)
        term = _stage_cost(cfg, params, ks[-1:], x_traj[..., -1:, :], None,
                           refs, True, wt)
        return torch.sum(stage, dim=-1) + term[..., 0]

    def make_perf(refs, cset):
        """PerformanceIndex callback (cost + exact-L1-penalty merit +
        violation components) for the filter line search."""

        def dyn_defects(x_traj, u_traj):
            xn = centroidal_step(params, x_traj[..., :-1, :], u_traj,
                                 refs.enable)
            return xn - x_traj[..., 1:, :]

        def ineq_violations(x_traj, u_traj):
            # In deviation coords around (x_traj, u_traj), dz = 0: violation
            # is how far 0 lies outside [lg, ug].
            con = _build_constraints(cfg, params, refs, x_traj, u_traj, cset)
            return con.mask * (torch.clamp(con.lg, min=0.0)
                               + torch.clamp(-con.ug, min=0.0))

        return make_performance(
            total_cost=lambda x, u: total_cost(x, u, refs),
            dyn_defects=dyn_defects, ineq_violations=ineq_violations)

    def linearize(x_traj, u_traj, refs, cset=None):
        A, B, f = linearize_step(params, x_traj[..., :-1, :], u_traj,
                                 refs.enable)
        dyn = DynamicsLin(A=A, B=B, b=f - x_traj[..., 1:, :])
        cost = _cost_quadratic(cfg, params, x_traj, u_traj, refs, wt)
        con = _build_constraints(cfg, params, refs, x_traj, u_traj, cset)
        return OcpQpData(dyn=dyn, cost=cost, con=con,
                         dx0=torch.zeros_like(x_traj[..., 0, :]))

    def start(state, des_state, des_inputs, warm=None):
        """References, constraint set and the SQP's starting trajectory."""
        refs = _unpack_reference_inputs(cfg, state, des_state, des_inputs,
                                        dev)
        cset = _constraint_set(cfg, params, refs, consts)
        if warm is None:
            foot_vel0 = torch.zeros_like(_leg_major(refs.des_force))
            u_init = torch.cat([foot_vel0, _leg_major(refs.des_force)],
                               dim=-1)
            x_init = rollout(params, refs.x0, u_init, refs.enable)
        else:
            x_init = _as_tensor(warm[0], cfg.dtype, dev)
            u_init = _as_tensor(warm[1], cfg.dtype, dev)
            x_init = torch.cat([refs.x0[..., None, :], x_init[..., 1:, :]],
                               dim=-2)
        return refs, cset, x_init, u_init

    def initial_qp(state, des_state, des_inputs, warm=None) -> OcpQpData:
        """The OCP-QP of the first SQP iteration (the linearization at the
        starting trajectory)."""
        refs, cset, x_init, u_init = start(state, des_state, des_inputs, warm)
        return linearize(x_init, u_init, refs, cset)

    def solve(state, des_state, des_inputs,
              warm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        refs, cset, x_init, u_init = start(state, des_state, des_inputs, warm)

        res = solve_nonlinear_ocp(
            linearize=lambda x, u: linearize(x, u, refs, cset),
            performance=make_perf(refs, cset),
            x_init=x_init, u_init=u_init, settings=scp)

        _, _, _, foot_pos, _ = unpack_state(params, res.x)  # (.., N+1, nl, 3)
        _, u_f = unpack_input(params, res.u)  # (..., N, nl, 3)
        f_eff = refs.enable[..., :, :, None] * u_f
        return CentroidalSolution(
            foot_pos=torch.movedim(foot_pos, -3, -1),
            contact_force=torch.movedim(f_eff, -3, -1),
            com_pos=res.x[..., 0:3].transpose(-1, -2),
            com_vel=res.x[..., 3:6].transpose(-1, -2),
            ang_mom=res.x[..., 6:9].transpose(-1, -2),
            x_traj=res.x, u_traj=res.u, merit=res.merit, qp_mu=res.qp_mu,
            gains_K=res.gains_K, gains_P=res.gains_P, gains_p=res.gains_p,
            performance=res.performance, convergence=res.convergence,
            step_size=res.step_info.step_size,
            step_type=res.step_info.step_type)

    solve.initial_qp = initial_qp
    solve.total_cost = total_cost
    return solve
