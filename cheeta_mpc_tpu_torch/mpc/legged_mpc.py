"""Legged-robot SQP MPC: the OCS2-style kinodynamic task, batched torch.

Counterpart of ``cheeta_mpc_tpu/mpc/legged_mpc.py``: assembles the
optimal-control problem — SRBD dynamics, base-tracking cost from the task's
Q/R diagonals, and the four per-foot constraint families — and solves it
with the SQP layer over the equality-aware QP solvers.

Constraint families (reference LeggedRobotInterface.cpp:177-183):
- zeroForce (swing):    structural, F_eff = enable * u_F.
- frictionCone (stance): ``cone_mode='soft'`` — the reference's smoothed
  second-order cone under a relaxed log barrier, a cost term, so no
  inequality row reaches the QP and the equality-Riccati kernels solve it
  exactly; ``cone_mode='pyramid'`` — 5 hard pyramid rows per leg on u_F,
  masked by the contact flags, enforced by the interior-point kernel.
- zeroVelocity (stance): v_foot(x, u) = 0 (3 rows/leg) — stage equalities.
- normalVelocity (swing): v_foot_z + gain (p_z - z_ref) = zdot_ref (1
  row/leg) with the swing-planner references.

Equality rows are 16 static rows per node whose activity follows the
contact mode (masked equality-Riccati elimination).

Every input of ``solve`` may carry one leading batch dimension (what
``jax.vmap`` of the JAX solver is); the enable table, the swing references
and ``dts`` are per scenario.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cheeta_mpc_tpu_torch.core.types import (CostApprox, DynamicsLin,
                                             OcpQpData, StageConstraint,
                                             StageEquality, resolve_device)
from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
    foot_positions_world
from cheeta_mpc_tpu_torch.models.srbd_legged import (
    GRAVITY, NU, NX, SrbdParams, foot_velocity_constraint_values,
    srbd_linearize, srbd_step, unpack_srbd_state, value_and_jacfwd,
    weight_compensating_input)
from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import _as_tensor
from cheeta_mpc_tpu_torch.mpc.friction_cone import (FrictionConeConfig,
                                                    RelaxedBarrierConfig,
                                                    barrier_cost_quadratic,
                                                    cone_value,
                                                    relaxed_barrier)
from cheeta_mpc_tpu_torch.ops.cuda_legged_linearize import legged_linearize
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.scp import (ScpSettings, make_performance,
                                              solve_nonlinear_ocp)

NL = 4
NC_EQ = 16  # 3 velocity rows/leg (stance) + 1 normal-velocity row/leg (swing)
NG = 20  # 5 friction-pyramid rows per leg


class LeggedMpcConfig(NamedTuple):
    params: SrbdParams = SrbdParams()
    horizon: int = 20  # nodes; reference: timeHorizon 1.0 s / dt 0.015 ~ 67
    q_diag: Tuple[float, ...] = ()  # (24,) diagonal of the task's Q
    r_diag: Tuple[float, ...] = ()  # (24,) diagonal of the task's R
    friction_mu: float = 0.5
    position_error_gain: float = 20.0
    force_max: float = 700.0
    # Friction treatment: 'soft' = the reference's configuration (smoothed
    # SOC under a relaxed log barrier — no inequality rows reach the QP, the
    # stage-equality Riccati solves exactly); 'pyramid' = hard 5-row pyramid
    # enforced by the interior-point QP (strict physics; slower).
    cone_mode: str = 'pyramid'
    barrier_mu: float = 0.1
    barrier_delta: float = 5.0
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_task_info(cls, task_info_path: str, horizon: Optional[int] = None,
                       cone_mode: str = 'soft',
                       dtype: torch.dtype = torch.float32
                       ) -> "LeggedMpcConfig":
        """The configuration of a task.info file (Q/R diagonals, shooting
        dt and integrator, horizon, friction-cone and model settings), as
        the JAX package reads it. Defaults to the soft cone, the task's own
        treatment."""
        from cheeta_mpc_tpu_torch.utils.info_config import (as_matrix,
                                                            load_info)
        tree = load_info(task_info_path)
        Q = as_matrix(tree["Q"])
        R = as_matrix(tree["R"])
        ms = tree["multiple_shooting"]
        dt = float(ms["dt"])
        T = float(tree["mpc"]["timeHorizon"])
        N = horizon if horizon is not None else int(round(T / dt))
        fc = tree["frictionConeSoftConstraint"]
        return cls(
            params=SrbdParams(dt=dt, integrator=str(
                ms.get("integratorType", "RK2")).lower()),
            horizon=N,
            q_diag=tuple(np.diag(Q).tolist()),
            r_diag=tuple(np.diag(R).tolist()),
            friction_mu=float(fc["frictionCoefficient"]),
            position_error_gain=float(
                tree["model_settings"]["positionErrorGain"]),
            cone_mode=cone_mode,
            barrier_mu=float(fc.get("mu", 0.1)),
            barrier_delta=float(fc.get("delta", 5.0)),
            dtype=dtype)


class LeggedSolution(NamedTuple):
    x_traj: torch.Tensor  # (..., N+1, 24)
    u_traj: torch.Tensor  # (..., N, 24)
    forces: torch.Tensor  # (..., N, 4, 3) effective contact forces
    joint_vel: torch.Tensor  # (..., N, 12)
    gains_K: torch.Tensor  # (..., N, 24, 24)
    merit: torch.Tensor
    qp_mu: torch.Tensor
    gains_P: torch.Tensor  # (..., N+1, 24, 24) value-function Hessians
    gains_p: torch.Tensor  # (..., N+1, 24) value-function gradients
    performance: object  # PerformanceIndex at the final iterate
    convergence: torch.Tensor  # int32 CONV_* code
    step_size: torch.Tensor  # (..., iterations) accepted line-search steps


def _pyramid(mu):
    return np.array([[-1.0, 0.0, mu], [1.0, 0.0, mu], [0.0, -1.0, mu],
                     [0.0, 1.0, mu], [0.0, 0.0, 1.0]])


def l1_model(cfg: LeggedMpcConfig, cone: FrictionConeConfig,
             barrier: RelaxedBarrierConfig) -> list:
    """The model and task constants in the order of L1's ``Model``
    (csrc/legged_linearize.cu)."""
    p, d = cfg.params, cfg.params.desc
    return [p.dt, GRAVITY, d.mass, *(1.0 / i for i in d.inertia),
            *d.com_offset, *(c for hip in d.hip_offsets for c in hip),
            d.hip_length, d.thigh_length, d.shank_length,
            cfg.position_error_gain, *cfg.q_diag, *cfg.r_diag,
            cone.friction_coefficient, cone.regularization,
            cone.gripper_force, cone.hessian_diagonal_shift, barrier.mu,
            barrier.delta]


def build_legged_solver(cfg: LeggedMpcConfig,
                        scp: ScpSettings = ScpSettings(
                            iterations=2, ipm=IpmSettings(iters=10)),
                        device="cuda"):
    """Returns ``solve(x0, x_ref_traj, enable_table, z_pos_ref, z_vel_ref,
    warm=None, dts=None) -> LeggedSolution`` running on ``device`` (the card
    by default; with no card present this raises — pass ``device="cpu"``).

    Args of the returned function (numpy arrays or tensors, each optionally
    with one leading batch dimension):
        x0: (24,) current state.
        x_ref_traj: (N+1, 24) tracking reference.
        enable_table: (N, 4) gait contact flags.
        z_pos_ref, z_vel_ref: (N, 4) swing-foot height/velocity references
            from the swing planner (SwingTrajectoryPlanner.sample_grid).
        warm: optional ``(x_traj, u_traj)`` of a previous solution.
        dts: optional (N,) per-interval durations from an event-aligned
            grid (solvers/discretization.discretize_fixed); None = uniform
            ``params.dt``.
    """
    dev = resolve_device(device)
    p = cfg.params
    N = cfg.horizon
    dt_ = cfg.dtype
    kw = dict(dtype=dt_, device=dev)
    gain = cfg.position_error_gain
    soft = cfg.cone_mode == 'soft'
    cone_cfg = FrictionConeConfig(friction_coefficient=cfg.friction_mu)
    bar_cfg = RelaxedBarrierConfig(mu=cfg.barrier_mu, delta=cfg.barrier_delta)

    # Constants of the solver, made once on the device: every tensor built
    # from host numbers inside a solve is a copy the host waits for.
    Qd = torch.tensor(cfg.q_diag, **kw)
    Rd = torch.tensor(cfg.r_diag, **kw)
    Qm = torch.diag_embed(Qd).repeat(N + 1, 1, 1)
    Rm = torch.diag_embed(Rd).repeat(N, 1, 1)
    Sm = torch.zeros((N, NU, NX), **kw)
    eye_l = torch.eye(NL, **kw).reshape(NL, 1, NL, 1)
    l1_params = l1_model(cfg, cone_cfg, bar_cfg)
    # Friction-pyramid constants (static per config).
    D_np = np.zeros((N + 1, NG, NU))
    for i in range(NL):
        D_np[:N, 5 * i:5 * (i + 1), 3 * i:3 * (i + 1)] = _pyramid(
            cfg.friction_mu)
    big = 2 * cfg.friction_mu * cfg.force_max + 1.0
    ub_leg = np.array([big, big, big, big, cfg.force_max])
    D_c = torch.tensor(D_np, **kw)
    C_c = torch.zeros((N + 1, NG, NX), **kw)
    ug_c = torch.tensor(np.tile(np.tile(ub_leg, NL)[None, :], (N + 1, 1)),
                        **kw)
    lg_c = torch.zeros((N + 1, NG), **kw)

    def eq_constraint(x, u, zp_ref, zv_ref):
        """(..., 16) equality values at nodes (mask applied by caller)."""
        v = foot_velocity_constraint_values(p, x, u)  # (..., 4, 3)
        _, _, p_base, eul, q = unpack_srbd_state(x)
        feet = foot_positions_world(p.desc, p_base, eul, q)
        stance_rows = v.reshape(v.shape[:-2] + (12,))
        swing_rows = v[..., 2] + gain * (feet[..., 2] - zp_ref) - zv_ref
        return torch.cat([stance_rows, swing_rows], dim=-1)

    def total_cost(x_traj, u_traj, refs):
        dx = x_traj - refs.x_ref
        du = u_traj - refs.u_ref
        c = (0.5 * torch.sum(dx * Qd * dx, dim=(-2, -1))
             + 0.5 * torch.sum(du * Rd * du, dim=(-2, -1)))
        if soft:
            # Relaxed-barrier soft cone on stance-leg forces.
            F = u_traj[..., :3 * NL].reshape(u_traj.shape[:-1] + (NL, 3))
            h = cone_value(cone_cfg, F)
            c = c + torch.sum(refs.enable * relaxed_barrier(bar_cfg, h),
                              dim=(-2, -1))
        return c

    def build_eq(x_traj, u_traj, refs):
        """The masked equality rows and their Jacobians. The function is
        masked BEFORE it is differentiated, so inactive rows of C and D are
        exactly zero — the Riccati elimination and the kernels rely on it."""
        val, (C, D) = value_and_jacfwd(
            lambda x, u, m, zp, zv: m * eq_constraint(x, u, zp, zv),
            (x_traj[..., :-1, :], u_traj),
            (refs.eq_mask, refs.z_pos, refs.z_vel))
        return StageEquality(C=C, D=D, e=val, mask=refs.eq_mask)

    def build_ineq(u_traj, refs):
        """Friction pyramid rows in deviation coordinates around u_traj."""
        du_pad = torch.cat([u_traj, torch.zeros_like(u_traj[..., :1, :])],
                           dim=-2)
        g_iter = torch.sum(D_c * du_pad[..., None, :], dim=-1)
        return StageConstraint(C=C_c, D=D_c, lg=lg_c - g_iter,
                               ug=ug_c - g_iter, mask=refs.ineq_mask)

    def linearize_plain(x_traj, u_traj, refs):
        """The OCP-QP at ``(x_traj, u_traj)`` by forward-mode autodiff in
        plain PyTorch, on any device and in any dtype: the CPU's path, and
        what L1 is held to on the card."""
        A, B, f = srbd_linearize(p, x_traj[..., :-1, :], u_traj, refs.enable,
                                 refs.dts)
        dyn = DynamicsLin(A=A, B=B, b=f - x_traj[..., 1:, :])
        dx = x_traj - refs.x_ref
        du = u_traj - refs.u_ref
        R, r_lin = Rm, Rd * du
        if soft:
            # Analytic quadratic of the relaxed-barrier cone cost on the
            # per-leg force blocks, placed block-diagonally into R.
            F = u_traj[..., :3 * NL].reshape(u_traj.shape[:-1] + (NL, 3))
            _, bgrad, bhess = barrier_cost_quadratic(cone_cfg, bar_cfg, F)
            bgrad = bgrad * refs.enable[..., None]
            bhess = bhess * refs.enable[..., None, None]
            blk = bhess[..., :, :, None, :] * eye_l  # (..., l, i, m, j)
            blk = blk.reshape(blk.shape[:-4] + (3 * NL, 3 * NL))
            pad_f = NU - 3 * NL
            R = Rm + torch.nn.functional.pad(blk, (0, pad_f, 0, pad_f))
            r_lin = r_lin + torch.nn.functional.pad(
                bgrad.reshape(bgrad.shape[:-2] + (3 * NL,)), (0, pad_f))
        cost = CostApprox(Q=Qm, q=Qd * dx, R=R, r=r_lin, S=Sm)
        eq = build_eq(x_traj, u_traj, refs)
        con = None if soft else build_ineq(u_traj, refs)
        return OcpQpData(dyn=dyn, cost=cost, con=con,
                         dx0=torch.zeros_like(x_traj[..., 0, :]), eq=eq)

    def linearize(x_traj, u_traj, refs):
        if x_traj.device.type == "cpu":
            return linearize_plain(x_traj, u_traj, refs)
        # One launch of L1 (ops/cuda_legged_linearize.py). The cold start's
        # state is a broadcast view, which the kernel takes only as a copy.
        lin = legged_linearize(
            x_traj.contiguous(), u_traj.contiguous(), refs.enable,
            refs.z_pos, refs.z_vel, refs.eq_mask, refs.x_ref, refs.u_ref,
            refs.dts, l1_params, soft=soft, rk2=p.integrator != "euler")
        cost = CostApprox(Q=Qm, q=lin.q, R=Rm if lin.R is None else lin.R,
                          r=lin.r, S=Sm)
        con = None if soft else build_ineq(u_traj, refs)
        return OcpQpData(
            dyn=DynamicsLin(A=lin.A, B=lin.B, b=lin.b), cost=cost, con=con,
            dx0=torch.zeros_like(x_traj[..., 0, :]),
            eq=StageEquality(C=lin.C, D=lin.D, e=lin.e, mask=refs.eq_mask))

    def make_perf(refs):
        def dyn_defects(x_traj, u_traj):
            xn = srbd_step(p, x_traj[..., :-1, :], u_traj, refs.enable,
                           refs.dts)
            return xn - x_traj[..., 1:, :]

        def eq_values(x_traj, u_traj):
            # The mask broadcasts over the line search's leading axis.
            return refs.eq_mask * eq_constraint(
                x_traj[..., :-1, :], u_traj, refs.z_pos, refs.z_vel)

        def ineq_violations(x_traj, u_traj):
            con = build_ineq(u_traj, refs)
            return con.mask * (torch.clamp(con.lg, min=0.0)
                               + torch.clamp(-con.ug, min=0.0))

        return make_performance(
            total_cost=lambda x, u: total_cost(x, u, refs),
            dyn_defects=dyn_defects, eq_values=eq_values,
            ineq_violations=None if soft else ineq_violations)

    def start(x0, x_ref_traj, enable_table, z_pos_ref, z_vel_ref, warm=None,
              dts=None):
        """References on the device, broadcast to the common batch shape,
        and the SQP's starting trajectory."""
        def dense(a):
            # L1 reads dense rows, and a numpy view (a transposed table)
            # keeps its strides on the device; a dense input stays as is.
            return _as_tensor(a, dt_, dev).contiguous()

        x0 = dense(x0)
        x_ref = dense(x_ref_traj)
        enable = dense(enable_table)
        z_pos = dense(z_pos_ref)
        z_vel = dense(z_vel_ref)
        dts_v = None if dts is None else dense(dts)
        lead = torch.broadcast_shapes(
            x0.shape[:-1], x_ref.shape[:-2], enable.shape[:-2],
            z_pos.shape[:-2], z_vel.shape[:-2],
            () if dts_v is None else dts_v.shape[:-1])
        if len(lead) > 1:
            raise ValueError(
                f"the legged solver takes at most one batch dimension, got "
                f"batch shape {tuple(lead)}")
        x0 = x0.expand(lead + (NX,))
        enable = enable.expand(lead + (N, NL))
        refs = _Refs(
            x_ref=x_ref.expand(lead + (N + 1, NX)), enable=enable,
            z_pos=z_pos.expand(lead + (N, NL)),
            z_vel=z_vel.expand(lead + (N, NL)),
            dts=None if dts_v is None else dts_v.expand(lead + (N,)),
            u_ref=weight_compensating_input(p, enable),
            eq_mask=torch.cat([torch.repeat_interleave(enable, 3, dim=-1),
                               1.0 - enable], dim=-1),
            ineq_mask=torch.cat(
                [torch.repeat_interleave(enable, 5, dim=-1),
                 torch.zeros(lead + (1, NG), **kw)], dim=-2))
        if warm is None:
            # Reference LeggedRobotInitializer: hold state, weight-comp input.
            u_init = refs.u_ref
            x_init = x0[..., None, :].expand(lead + (N + 1, NX))
        else:
            x_init = _as_tensor(warm[0], dt_, dev).expand(lead + (N + 1, NX))
            u_init = _as_tensor(warm[1], dt_, dev).expand(lead + (N, NU))
            x_init = torch.cat([x0[..., None, :], x_init[..., 1:, :]], dim=-2)
        return refs, x_init, u_init

    def initial_qp(*args, plain=False, **kwargs) -> OcpQpData:
        """The OCP-QP of the first SQP iteration (the linearization at the
        starting trajectory); same arguments as ``solve``. ``plain`` builds
        it by the plain version on any device."""
        refs, x_init, u_init = start(*args, **kwargs)
        return (linearize_plain if plain else linearize)(x_init, u_init,
                                                         refs)

    def solve(x0, x_ref_traj, enable_table, z_pos_ref, z_vel_ref,
              warm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              dts=None) -> LeggedSolution:
        refs, x_init, u_init = start(x0, x_ref_traj, enable_table, z_pos_ref,
                                     z_vel_ref, warm, dts)
        res = solve_nonlinear_ocp(
            linearize=lambda x, u: linearize(x, u, refs),
            performance=make_perf(refs), x_init=x_init, u_init=u_init,
            settings=scp)
        forces = (res.u[..., :3 * NL].reshape(res.u.shape[:-1] + (NL, 3))
                  * refs.enable[..., None])
        return LeggedSolution(x_traj=res.x, u_traj=res.u, forces=forces,
                              joint_vel=res.u[..., 3 * NL:],
                              gains_K=res.gains_K, merit=res.merit,
                              qp_mu=res.qp_mu, gains_P=res.gains_P,
                              gains_p=res.gains_p,
                              performance=res.performance,
                              convergence=res.convergence,
                              step_size=res.step_info.step_size)

    solve.initial_qp = initial_qp
    return solve


class _Refs(NamedTuple):
    """Per-solve references on the device, batch shape broadcast."""

    x_ref: torch.Tensor  # (..., N+1, 24)
    enable: torch.Tensor  # (..., N, 4)
    z_pos: torch.Tensor  # (..., N, 4)
    z_vel: torch.Tensor  # (..., N, 4)
    dts: Optional[torch.Tensor]  # (..., N) or None (uniform params.dt)
    u_ref: torch.Tensor  # (..., N, 24) weight-compensating input
    eq_mask: torch.Tensor  # (..., N, 16)
    ineq_mask: torch.Tensor  # (..., N+1, 20)


def make_standing_reference(cfg: LeggedMpcConfig, x0, com_height=None):
    """(N+1, 24) hold-position reference (current state held, zero
    momentum)."""
    x_ref = np.tile(np.asarray(x0, np.float64), (cfg.horizon + 1, 1))
    x_ref[:, 0:6] = 0.0  # zero momentum
    if com_height is not None:
        x_ref[:, 8] = com_height
    return x_ref


def make_velocity_command_reference(cfg: LeggedMpcConfig, x0, v_cmd,
                                    yaw_rate=0.0, com_height=None):
    """(N+1, 24) constant-velocity command reference."""
    x0 = np.asarray(x0, np.float64)
    N = cfg.horizon
    dt = cfg.params.dt
    x_ref = np.tile(x0, (N + 1, 1))
    ts = np.arange(N + 1) * dt
    x_ref[:, 0:3] = np.asarray(v_cmd)
    x_ref[:, 3:6] = 0.0
    x_ref[:, 6:9] = x0[None, 6:9] + ts[:, None] * np.asarray(v_cmd)
    if com_height is not None:
        x_ref[:, 8] = com_height
    x_ref[:, 9] = x0[9] + ts * yaw_rate
    x_ref[:, 10:12] = 0.0
    return x_ref
