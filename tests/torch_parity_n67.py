"""The deployed legged loop at the node's full horizon, the port against
the JAX package, on the CPU.

Runs the launcher's loop (``tests.torch_port_util.launch_loop``: planner and
plant in lock-step through each package's wire codec) on the stand-in
``.info`` files at N=67 for both packages, the JAX package's own two-process
launcher, a failing planner (the first policy held: ``replan=False``), one
DDP solve of each package from the stance and from a state off it, and the
launcher's loop with the DDP planner. Each
reading is printed as one JSON line: the height drift and forward progress
of each run, how far the port's trajectory lies from the JAX package's, and
the DDP costs.

    JAX_PLATFORMS=cpu python -m tests.torch_parity_n67 [--horizon 67]

It needs both packages, so it lives with the tests; it is no test (it takes
tens of minutes on the CPU).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from importlib import import_module

import numpy as np

from tests.torch_port_util import launch_loop, write_info_files

JAX, PORT = "cheeta_mpc_tpu", "cheeta_mpc_tpu_torch"


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _metrics(run):
    xs = run["states"]
    finite = np.isfinite(xs).all(axis=1)
    return {"height_drift_m": float(np.abs(xs[:, 8] - xs[0, 8]).max()),
            "forward_m": float(xs[-1, 6] - xs[0, 6]),
            "finite": bool(finite.all()),
            "first_nonfinite_step": (None if finite.all()
                                     else int(np.argmin(finite)))}


def _apart(a, b, tol=1e-6):
    """The first step at which two runs' states differ by more than
    ``tol`` (or one is not finite), or None."""
    d = np.abs(a["states"] - b["states"]).max(axis=1)
    apart = ~(d <= tol)
    return int(np.argmax(apart)) if apart.any() else None


def loops(task, gait, horizon):
    """The launcher's loop in both packages: soft 1.2 s (the length of the
    card's earlier runs), the two runs of ``chip_smoke.py`` phase
    ``launch`` (soft 1.8 s with the live switch at 0.6 s, the pyramid cone
    1.8 s), and the failing planner for 1.2 s and 1.8 s."""
    cases = (("soft_1.2s", dict(seconds=1.2)),
             ("soft_1.8s_switch", dict(seconds=1.8,
                                       switch=("standing_trot", 0.6))),
             ("pyramid_1.8s", dict(seconds=1.8, cone="pyramid")),
             ("soft_1.2s_first_policy_held", dict(seconds=1.2,
                                                  replan=False)),
             ("soft_1.8s_first_policy_held", dict(seconds=1.8,
                                                  replan=False)))
    _compare(task, gait, horizon, cases)


def ddp_loop(task, gait, horizon):
    """The launcher's loop with the DDP planner (``launch --solver ddp``),
    soft cone, 1.2 s, in both packages, in f32 and in f64."""
    import jax
    jax.config.update("jax_enable_x64", True)
    _compare(task, gait, horizon,
             (("ddp_soft_1.2s", dict(seconds=1.2, solver="ddp")),
              ("ddp_soft_1.2s_f64", dict(seconds=1.2, solver="ddp",
                                         f64=True))))


def node_loop(horizon):
    """``chip_smoke.py``'s planning-node loop in both packages: the
    configuration built in code with the stand-in Q/R, trot (cycle 0.7 s)
    at 0.25 m/s after 0.2 s of stance, the plant stepping every 5 ms and the
    node solving every fourth step, 240 steps; the SQP node (one iteration,
    as phase ``legged_node``) and the DDP node (as phase ``legged_ddp``).
    In f64 (the card's node solves in f32): the DDP node's loop is
    chaotic, and f32 rounding alone parts the two packages' runs once its
    costs have jumped."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from tests.torch_port_util import legged_configs
    jcfg, _, tcfg, _ = legged_configs(horizon, "soft", dtype="float64")
    for solver in ("sqp", "ddp"):
        runs = {}
        for pkg, cfg in ((JAX, jcfg), (PORT, tcfg)):
            node = import_module(f"{pkg}.mpc.legged_node")
            runtime = import_module(f"{pkg}.mpc.runtime")
            sched = import_module(f"{pkg}.gait.schedule")
            srbd_step = import_module(f"{pkg}.models.srbd_legged").srbd_step
            if pkg == JAX:
                import jax.numpy as jnp
                kw, arr = {}, (lambda a: jnp.asarray(a, jnp.float64))
            else:
                import torch
                kw = {"device": "cpu"}
                arr = (lambda a: torch.as_tensor(np.asarray(a),
                                                 dtype=torch.float64))
            gait = sched.GaitSchedule.stance(sched.trot_template(0.7), t0=0.0)
            gait.phase_transition_stance_time = 0.1
            gait.insert_template(sched.trot_template(0.7), insert_time=0.2)
            planner = node.LeggedPlannerAssembly(
                cfg, gait, node.default_stance_state(cfg),
                v_cmd=np.array([0.25, 0.0, 0.0]),
                settings=node.PlannerSettings(solver=solver,
                                              sqp_iterations=1), **kw)
            costs = []

            def solve_fn(obs, planner=planner, costs=costs):
                policy = planner.solve_fn(obs)
                costs.append(planner.last_metrics["cost"])
                return policy

            def plant(t, x, u, gait=gait, cfg=cfg, arr=arr,
                      srbd_step=srbd_step):
                e = gait.get_mode_schedule(max(0.0, t - 1.0), t + 1.0)\
                    .contact_flags_at(t + 0.5 * 0.005)
                return np.asarray(srbd_step(cfg.params, arr(x), arr(u),
                                            arr(np.asarray(e)), dt=0.005),
                                  np.float64)

            t0 = time.perf_counter()
            res = runtime.run_dummy_loop(
                runtime.MpcMrtInterface(solve_fn), plant,
                x0=node.default_stance_state(cfg), mrt_dt=0.005,
                mpc_update_ratio=4, n_steps=240)
            runs[pkg] = {"states": res.states, "costs": costs,
                         "wall_s": time.perf_counter() - t0}
        a, b = runs[PORT], runs[JAX]
        out = {"node_loop": solver, "horizon": horizon}
        for pkg, r in ((JAX, b), (PORT, a)):
            c = r["costs"]
            out[pkg] = dict(_metrics(r), wall_s=r["wall_s"],
                            first_cost=c[0], second_cost=c[1],
                            first_solve_over_10x_first_cost=next(
                                (i for i, v in enumerate(c)
                                 if not abs(v) <= 10.0 * abs(c[0])), None))
        out["port_vs_jax_states_max_abs"] = float(
            np.abs(a["states"] - b["states"]).max())
        out["port_vs_jax_first_step_apart_1e-6"] = _apart(a, b)
        _emit(out)


def _compare(task, gait, horizon, cases):
    for name, kw in cases:
        runs = {}
        for pkg in (JAX, PORT):
            t0 = time.perf_counter()
            runs[pkg] = launch_loop(pkg, task, gait, horizon=horizon, **kw)
            runs[pkg]["wall_s"] = time.perf_counter() - t0
        a, b = runs[PORT], runs[JAX]
        _emit({"loop": name, "horizon": horizon,
               "jax": dict(_metrics(b), wall_s=b["wall_s"]),
               "port": dict(_metrics(a), wall_s=a["wall_s"]),
               "port_vs_jax_states_max_abs": float(
                   np.abs(a["states"] - b["states"]).max()),
               "port_vs_jax_forces_max_abs_n": float(
                   np.abs(a["inputs"][:, :12] - b["inputs"][:, :12]).max()),
               "port_vs_jax_first_step_apart_1e-6": _apart(a, b),
               "switched_at": a["switched_at"],
               "gaits_applied": {"jax": b["gaits_applied"],
                                 "port": a["gaits_applied"]}})


def jax_launcher(task, gait, horizon, tmp):
    """The JAX package's own two-process launcher (its plant takes the
    first policy after each observation) at the card's soft run."""
    out = os.path.join(tmp, "jax_launch")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               JAX_COMPILATION_CACHE_DIR=os.path.join(tmp, "jax_cache"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cheeta_mpc_tpu.cli.launch", "--platform",
         "cpu", "--horizon", str(horizon), "--seconds", "1.2",
         "--task-info", task, "--gait-info", gait, "--out", out],
        env=env, cwd=root, capture_output=True, text=True, timeout=3600)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX launcher: exit code {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    with open(out + "_summary.json") as f:
        summary = json.load(f)
    _emit({"jax_launcher": "soft_1.2s", "horizon": horizon,
           "wall_s": time.perf_counter() - t0, "summary": summary})


def ddp_solves(task, gait, horizon):
    """One DDP node solve of each package (the node's settings) from the
    stance and from the state of the soft launcher loop at 0.6 s, in f32
    (as the node runs on the card) and in f64."""
    import jax
    import jax.numpy as jnp
    import torch
    jax.config.update("jax_enable_x64", True)

    sqp = launch_loop(PORT, task, gait, horizon=horizon, seconds=0.6)
    t_off, x_off = float(sqp["times"][-1]), sqp["states"][-1]
    for dtype in ("float32", "float64"):
        out = {"ddp": "node", "dtype": dtype, "horizon": horizon,
               "off_stance_t": t_off}
        for pkg, mod, kw in ((JAX, jnp, {}), (PORT, torch, {"device": "cpu"})):
            node = import_module(f"{pkg}.mpc.legged_node")
            obs_cls = import_module(f"{pkg}.mpc.runtime").SystemObservation
            cfg = import_module(f"{pkg}.mpc.legged_mpc").LeggedMpcConfig\
                .from_task_info(task, horizon=horizon,
                                dtype=getattr(mod, dtype))
            library = import_module(f"{pkg}.utils.info_config")\
                .load_gait_library(gait)
            gs = import_module(f"{pkg}.gait.schedule").GaitSchedule.stance(
                library["trot"], t0=0.0)
            gs.phase_transition_stance_time = 0.1
            gs.insert_template(library["trot"], insert_time=0.2)
            x0 = node.default_stance_state(cfg)
            planner = node.LeggedPlannerAssembly(
                cfg, gs, x0, v_cmd=np.array([0.25, 0.0, 0.0]),
                settings=node.PlannerSettings(solver="ddp"), **kw)
            res = {}
            for what, t, x in (("stance", 0.0, x0),
                               ("off_stance", t_off, x_off)):
                t0 = time.perf_counter()
                pol = planner.solve_fn(obs_cls(time=t, state=x))
                res[what] = {"cost": planner.last_metrics["cost"],
                             "wall_s": time.perf_counter() - t0,
                             "u": pol.u_traj}
            out[pkg] = res
        for what in ("stance", "off_stance"):
            out[f"{what}_forces_port_vs_jax_max_abs_n"] = float(np.abs(
                out[PORT][what]["u"][:, :12]
                - out[JAX][what]["u"][:, :12]).max())
            for pkg in (JAX, PORT):
                out[pkg][what].pop("u")
        _emit(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=67)
    ap.add_argument("--only", default=None,
                    choices=("loops", "jax_launcher", "ddp", "ddp_loop",
                             "node_loop"))
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        task, gait = write_info_files(tmp)
        if args.only in (None, "loops"):
            loops(task, gait, args.horizon)
        if args.only in (None, "jax_launcher"):
            jax_launcher(task, gait, args.horizon, tmp)
        if args.only in (None, "ddp"):
            ddp_solves(task, gait, args.horizon)
        if args.only in (None, "ddp_loop"):
            ddp_loop(task, gait, args.horizon)
        if args.only in (None, "node_loop"):
            node_loop(args.horizon)
    return 0


if __name__ == "__main__":
    sys.exit(main())
