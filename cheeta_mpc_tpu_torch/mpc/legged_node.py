"""Legged planner assembly: the planning node's main() as a reusable object.

Counterpart of ``cheeta_mpc_tpu/mpc/legged_node.py`` (the reference's
``LeggedRobotSqpMpcNode`` wiring): the legged solver as one CUDA graph per
call signature, a GaitSchedule and SwingTrajectoryPlanner regenerated per
solve (the SwitchedModelReferenceManager::modifyReferences role), a
GaitReceiver for asynchronous gait commands, a velocity-command target and
warm starting from the previous policy, behind one
``solve_fn(obs) -> PolicyData`` that :class:`~cheeta_mpc_tpu_torch.mpc.
runtime.MpcMrtInterface` drives.

The SQP solver is always called with ``warm=`` and ``dts=``, so one capture
serves every tick: the first tick hands it the solver's own initializer
(hold the state, weight-compensating input), as the JAX node does to keep
one jit signature. The DDP solver (``solver='ddp'``, the
``LeggedRobotDdpMpcNode`` role) takes no warm start, as in the JAX node,
and is captured the same way.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cheeta_mpc_tpu_torch.core.types import resolve_device
from cheeta_mpc_tpu_torch.examples import default_stance_state  # noqa: F401
from cheeta_mpc_tpu_torch.gait.receiver import GaitReceiver
from cheeta_mpc_tpu_torch.gait.schedule import (GaitSchedule,
                                                ModeSequenceTemplate)
from cheeta_mpc_tpu_torch.gait.swing import (SwingConfig,
                                             SwingTrajectoryPlanner)
from cheeta_mpc_tpu_torch.models.srbd_legged import weight_compensating_input
from cheeta_mpc_tpu_torch.mpc.legged_ddp import build_legged_ddp_solver
from cheeta_mpc_tpu_torch.mpc.legged_mpc import (
    LeggedMpcConfig, build_legged_solver, make_velocity_command_reference)
from cheeta_mpc_tpu_torch.mpc.runtime import (PolicyData, SystemObservation,
                                              shift_warm_start)
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.ddp import DdpSettings
from cheeta_mpc_tpu_torch.solvers.discretization import (
    discretize_fixed, interval_contact_flags)
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
from cheeta_mpc_tpu_torch.utils.cuda_graph import graphed
from cheeta_mpc_tpu_torch.utils.timing import Benchmarker


@dataclass
class PlannerSettings:
    """Knobs of the planning node (solver choice + loop config)."""

    solver: str = "sqp"  # 'sqp' (LeggedRobotSqpMpcNode) | 'ddp' (DdpMpcNode)
    sqp_iterations: int = 2
    ipm_iterations: int = 10
    ddp_iterations: int = 5
    # Full DDP settings object (e.g. DdpSettings.from_task_info on the
    # task.info ddp block); when set it wins over ddp_iterations.
    ddp: Optional[DdpSettings] = None
    com_height: Optional[float] = None  # default: from initial stance
    terrain_height: float = 0.0
    schedule_margin: float = 1.5  # seconds of schedule kept past the horizon


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class LeggedPlannerAssembly:
    """Solver + references + commands behind one ``solve_fn``, on
    ``device`` (the card by default; without one this raises, pass
    ``device="cpu"`` to run eagerly on the CPU).

    Thread-safety: ``set_velocity_command`` / ``on_gait_command`` may be
    called from any thread (they buffer under locks); ``solve_fn`` applies
    them between solves — the reference's solver-synchronized-module
    contract (GaitReceiver.cpp:49-57).
    """

    def __init__(self, cfg: LeggedMpcConfig, gait_schedule: GaitSchedule,
                 x0: np.ndarray, v_cmd: np.ndarray,
                 settings: PlannerSettings = PlannerSettings(),
                 swing_config: SwingConfig = None, device="cuda"):
        if settings.solver not in ("sqp", "ddp"):
            raise ValueError(f"unknown solver {settings.solver!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.settings = settings
        self._np_dtype = (np.float64 if cfg.dtype == torch.float64
                          else np.float32)
        self.N, self.DT = cfg.horizon, float(cfg.params.dt)
        self.horizon_s = self.N * self.DT
        self.gait_schedule = gait_schedule
        self.receiver = GaitReceiver(gait_schedule)
        self.planner = SwingTrajectoryPlanner(swing_config or SwingConfig(),
                                              num_feet=4)
        self.x0 = np.asarray(x0, np.float64)
        self.com_height = (settings.com_height if settings.com_height
                           is not None else float(self.x0[8]))
        self._v_lock = threading.Lock()
        self._v_cmd = np.asarray(v_cmd, np.float64)
        self.bench = Benchmarker()
        self._prev_policy: Optional[PolicyData] = None
        if settings.solver == "sqp":
            scp = ScpSettings(iterations=settings.sqp_iterations,
                              ipm=IpmSettings(iters=settings.ipm_iterations))
            solve = build_legged_solver(cfg, scp, device=dev)
        elif settings.ddp is not None:
            # Configured from the task.info ddp block. The file's
            # constraintPenaltyInitialValue (20.0) is meant as the START of
            # an AL growth schedule the reference runs; this DDP uses a
            # single fixed penalty, so floor it at 1e2 (the solver's
            # effective default) like cli/legged_demo.py does — otherwise
            # stance/swing equality enforcement weakens ~5x.
            ddp = settings.ddp
            solve = build_legged_ddp_solver(
                cfg, ddp, eq_penalty=max(ddp.constraint_penalty, 1e2),
                device=dev)
        else:
            solve = build_legged_ddp_solver(
                cfg, DdpSettings(iterations=settings.ddp_iterations),
                device=dev)
        self._solve = graphed(solve, dev)

    # -- command side (any thread) -------------------------------------
    def set_velocity_command(self, v_cmd: np.ndarray) -> None:
        """Target command entry: [vx, vy, yaw_rate] (the `_mpc_target`
        subscriber role). Accepts any vector; the first three entries are
        used."""
        v = np.zeros(3)
        arr = np.ravel(np.asarray(v_cmd, np.float64))
        v[:min(3, arr.size)] = arr[:3]
        with self._v_lock:
            self._v_cmd = v

    def on_gait_command(self, name: str,
                        template: ModeSequenceTemplate) -> None:
        """Gait command entry (the `_mpc_mode_schedule` subscriber role)."""
        self.receiver.on_command(name, template)

    # -- solve side (planner thread) ------------------------------------
    def solve_fn(self, obs: SystemObservation) -> PolicyData:
        t, x = obs.time, np.asarray(obs.state, np.float64)
        N = self.N
        s = self.settings
        # Solver-synchronized hooks: buffered gait command lands at
        # finalTime, then regenerate schedule + swing references
        # (SwitchedModelReferenceManager::modifyReferences over
        # [t0 - T, tf + T], SwitchedModelReferenceManager.cpp:54-61).
        self.receiver.pre_solver_run(t, t + self.horizon_s)
        ms = self.gait_schedule.get_mode_schedule(
            max(0.0, t - s.schedule_margin),
            t + self.horizon_s + s.schedule_margin)
        self.planner.update(ms, terrain_height=s.terrain_height)
        with self._v_lock:
            v_cmd = self._v_cmd.copy()

        x_ref = make_velocity_command_reference(self.cfg, x, v_cmd,
                                                com_height=self.com_height)
        # Event-aligned shooting grid (timeDiscretizationWithEvents role).
        times = discretize_fixed(t, t + self.horizon_s, N + 1,
                                 ms.event_times)
        enable = interval_contact_flags(times, ms)
        dts = np.diff(times)
        mids = 0.5 * (times[:-1] + times[1:])
        z_pos, z_vel = self.planner.sample_times(mids)
        z_pos, z_vel = z_pos.T, z_vel.T

        dt_np = self._np_dtype
        kw = {}
        if s.solver == "sqp":
            if self._prev_policy is not None:
                xw, uw = shift_warm_start(self._prev_policy, times)
            else:
                # First tick: the solver's own initializer (hold state +
                # weight-compensating input, LeggedRobotInitializer role), so
                # that `warm` is always given and one capture serves every
                # tick.
                xw = np.tile(x[None], (N + 1, 1))
                uw = weight_compensating_input(
                    self.cfg.params,
                    torch.as_tensor(enable.astype(dt_np))).numpy()
            kw["warm"] = (xw.astype(dt_np), uw.astype(dt_np))
        with self.bench.phase("mpc_solve"):
            sol = self._solve(x.astype(dt_np), x_ref.astype(dt_np),
                              enable.astype(dt_np), z_pos.astype(dt_np),
                              z_vel.astype(dt_np), dts=dts.astype(dt_np),
                              **kw)
            u_host = _host(sol.u_traj)
        solve_ms = self.bench.phase("mpc_solve").latest_ms
        self.bench.record_solve_ms(solve_ms)
        self.last_metrics = {"t": round(t, 6), "solve_ms": round(solve_ms, 3)}
        if s.solver == "sqp":
            perf = sol.performance
            self.last_metrics.update({
                "merit": float(sol.merit), "cost": float(perf.cost),
                "dyn_sse": float(perf.dyn_violation_sse),
                "eq_sse": float(perf.eq_constraint_sse),
                "ineq_sse": float(perf.ineq_constraint_sse),
                "convergence": int(sol.convergence)})
        else:
            self.last_metrics.update({"cost": float(sol.cost),
                                      "converged": bool(sol.converged)})
        # The DDP value-function surface fills the same policy fields.
        policy = PolicyData(times=times, x_traj=_host(sol.x_traj),
                            u_traj=u_host, K=_host(sol.gains_K),
                            P=_host(sol.gains_P), p=_host(sol.gains_p))
        self._prev_policy = policy
        return policy
