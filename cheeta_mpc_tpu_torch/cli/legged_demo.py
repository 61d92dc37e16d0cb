"""Legged-robot demo node: closed-loop walking with metrics + viz capture.

Counterpart of ``cheeta_mpc_tpu/cli/legged_demo.py`` — the application-node
equivalent of the reference's LeggedRobotSqpMpcNode / LeggedRobotDdpMpcNode
+ LeggedRobotDummyNode + LeggedRobotVisualizer + MultiplotRemap
(SURVEY.md §2.7): runs the MPC/MRT loop in deterministic lock-step with
plant == model, streams per-solve PerformanceIndex metrics as JSONL (the
reference republishes PerformanceIndex for rqt_multiplot), and saves the
trajectory + footholds + GRFs to an .npz for plotting.

The planner is the planning node (``mpc/legged_node.LeggedPlannerAssembly``:
event-aligned grid, swing references, warm start), whose solver runs as one
CUDA graph per call signature on the card; ``--device cpu`` runs it eagerly
on the CPU.

Usage:
    python -m cheeta_mpc_tpu_torch.cli.legged_demo --task-info TASK.info
        --gait-info GAIT.info [--seconds 1.2] [--vx 0.25]
        [--out PREFIX] [--gait trot] [--solver sqp|ddp]
        [--cone soft|pyramid] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# The reference's files, relative to the root of its checkout (the JAX
# package's defaults name the same two files).
DEFAULT_TASK_INFO = "ocs2_legged_robot/config/mpc/task.info"
DEFAULT_GAIT_INFO = "ocs2_legged_robot/config/command/gait.info"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--vx", type=float, default=0.25)
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--solver", choices=("sqp", "ddp"), default="sqp",
                    help="sqp = LeggedRobotSqpMpcNode role; "
                         "ddp = LeggedRobotDdpMpcNode role")
    ap.add_argument("--cone", choices=("soft", "pyramid"), default="soft",
                    help="friction treatment (soft = reference task.info)")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "legged_demo"))
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="render the run to a PNG (feet/CoM/CoP/support "
                         "polygon, per-leg forces, height, attitude — the "
                         "LeggedRobotVisualizer rviz role, headless)")
    ap.add_argument("--task-info", default=DEFAULT_TASK_INFO)
    ap.add_argument("--gait-info", default=DEFAULT_GAIT_INFO)
    ap.add_argument("--device", default="cuda",
                    help="where the solver runs: cuda (default, one CUDA "
                         "graph per solve) or cpu")
    args = ap.parse_args(argv)

    import torch

    from cheeta_mpc_tpu_torch.core.types import resolve_device
    from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule
    from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
        foot_positions_world
    from cheeta_mpc_tpu_torch.models.srbd_legged import srbd_step
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
    from cheeta_mpc_tpu_torch.mpc.legged_node import (LeggedPlannerAssembly,
                                                      PlannerSettings,
                                                      default_stance_state)
    from cheeta_mpc_tpu_torch.mpc.runtime import (MpcMrtInterface,
                                                  run_dummy_loop)
    from cheeta_mpc_tpu_torch.solvers.ddp import DdpSettings
    from cheeta_mpc_tpu_torch.utils.info_config import load_gait_library

    dev = resolve_device(args.device)
    cfg = LeggedMpcConfig.from_task_info(args.task_info,
                                         horizon=args.horizon,
                                         cone_mode=args.cone,
                                         dtype=torch.float32)
    DT = cfg.params.dt
    x0 = default_stance_state(cfg)

    library = load_gait_library(args.gait_info)
    template = library[args.gait]
    gs = GaitSchedule.stance(template, t0=0.0)
    gs.phase_transition_stance_time = 0.1
    gs.insert_template(template, insert_time=0.2)
    ms = gs.get_mode_schedule(0.0, args.seconds + 2.0)

    # The planning node: two SQP iterations of ten IPM iterations, or DDP
    # configured from the task.info ddp block (reference
    # LeggedRobotDdpMpcNode) with a deeper iteration budget than the file's
    # RTI setting for the from-scratch demo. Its schedule window starts at 0
    # for the whole run, as the schedule ``ms`` does.
    ddp = (DdpSettings.from_task_info(args.task_info, iterations=5)
           if args.solver == "ddp" else None)
    node = LeggedPlannerAssembly(
        cfg, gs, x0, v_cmd=np.array([args.vx, 0.0, 0.0]),
        settings=PlannerSettings(solver=args.solver, ddp=ddp,
                                 schedule_margin=args.seconds + 2.0),
        device=dev)
    bench = node.bench
    metrics_path = f"{args.out}_metrics.jsonl"
    metrics_f = open(metrics_path, "w")

    def solve_fn(obs):
        policy = node.solve_fn(obs)
        # PerformanceIndex stream (MultiplotRemap analogue).
        metrics_f.write(json.dumps(node.last_metrics) + "\n")
        return policy

    def plant_step(t, x, u):
        e = np.asarray(ms.contact_flags_at(t + 0.5 * DT))
        return srbd_step(
            cfg.params, torch.as_tensor(np.asarray(x, np.float32), device=dev),
            torch.as_tensor(np.asarray(u, np.float32), device=dev),
            torch.as_tensor(e.astype(np.float32), device=dev)
        ).cpu().numpy().astype(np.float64)

    n_steps = int(round(args.seconds / DT))
    t_wall = time.perf_counter()
    res = run_dummy_loop(MpcMrtInterface(solve_fn), plant_step, x0=x0,
                         mrt_dt=DT, mpc_update_ratio=2, n_steps=n_steps)
    wall = time.perf_counter() - t_wall
    metrics_f.close()

    xs = res.states
    xs_t = torch.as_tensor(xs)
    feet = foot_positions_world(cfg.params.desc, xs_t[:, 6:9],
                                xs_t[:, 9:12], xs_t[:, 12:]).numpy()
    forces = res.inputs[:, :12].reshape(-1, 4, 3)
    np.savez(f"{args.out}_traj.npz", times=res.times, states=xs, feet=feet,
             forces=forces)

    # Real-time delay guard (reference MPC_MRT_Interface.cpp:98-104).
    budget_ms = 1e3 * DT * 2  # planning period
    avg = bench.phase("mpc_solve").avg_ms
    rt_ok = avg < budget_ms
    print(f"simulated {n_steps * DT:.2f} s in {wall:.1f} s wall "
          f"({res.solves} solves, {args.solver} solver, {args.cone} cone, "
          f"{dev})")
    print(f"  forward progress: {xs[-1, 6] - x0[6]:+.3f} m at "
          f"cmd {args.vx} m/s; height drift "
          f"{np.abs(xs[:, 8] - x0[8]).max():.3f} m")
    print(f"  solve: {bench.report()}")
    print(f"  realtime budget {budget_ms:.0f} ms/solve: "
          f"{'OK' if rt_ok else 'EXCEEDED'} (avg {avg:.1f} ms)"
          + ("" if rt_ok else "  [reference delay-guard warning]"))
    print(f"  wrote {args.out}_traj.npz, {metrics_path}")
    if args.plot:
        from cheeta_mpc_tpu_torch.viz.render import render_run
        render_run(f"{args.out}_traj.npz", args.plot,
                   title=f"legged {args.solver} ({args.cone} cone), "
                         f"vx={args.vx} m/s")
        print(f"  wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
