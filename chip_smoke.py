#!/usr/bin/env python3
"""The PyTorch/CUDA port's correctness gates on one NVIDIA GPU.

    python3 chip_smoke.py

The benchmark (``BENCHMARK.json``, ``mpcbench/``) times the port; this
script checks on the card what the benchmark cannot: each hand-written
kernel against its plain PyTorch version, the paths that no cell of the
benchmark runs, and the invariants of those that it does. ``main`` is the
list of phases, in the order they run:

- ``device``, ``build``: the card, and the kernels built from
  ``cheeta_mpc_tpu_torch/csrc/`` in this run (K1, K2: the Riccati
  interior-point solve of one OCP-QP and of a batch; K3, K4: the
  equality-constrained Riccati solve of one and of a batch; L1: the legged
  SQP linearization), with ptxas's registers and spills.
- ``spd_inverse``: the IPM kernels' SPD inverse alone, by a probe that no
  solve launches: the one-warp form against the block form, bit for bit.
- ``kernel_vs_plain``: K1..K4 against their plain versions on the main
  paths' QPs and on seeded instances that reach their other code paths.
- ``main_path_batch1``, ``main_path_fleet``, ``legged_batch1``,
  ``legged_pyramid_batch1``, ``legged_fleet``: the centroidal MPC (batch 1
  through K1, a fleet of 1024 through K2) and the legged SRBD MPC at the
  reference's scale (horizon 67, 24 states and inputs, 16 stage-equality
  rows; batch 1 through K3, pyramid cone through K1, a fleet of 512
  through K4) through the entry points a user calls: launches per solve,
  forces against the f64 CPU solve or the plain executor, swing legs at
  exactly 0, the vertical force, the pyramid.
- ``legged_linearize``: L1 against its plain version (``jacfwd``).
- ``kernel_phases``, ``occupancy``, ``k4_batch_sweep``: cycles by phase
  class inside each kernel (section timers) beside an untimed launch's ms,
  blocks per SM, registers and spills, and K4 at batch 128 to 2048.
- ``graph_vs_eager``: each main path as one CUDA graph per solve against
  its eager run: equal bit for bit, kernels by name in a profiled replay,
  0 host kernel launches and 1 graph launch per solve.
- ``closed_loop``: the 20-tick receding-horizon loop as one graph.
- ``legged_node``: the legged planning node in the lock-step loop.
- ``pyramid_fleet``: the batched pyramid mode through K2 with stage
  equalities at 128 and 512.
- ``convex_mpc``: the convex SRB MPC at one scenario (K1) and 4096 (K2).
- ``device_timing``: device ms per solve by the slope over chained CUDA
  graph replays (``utils/device_timing.py``) on eight of those paths.
- ``projected_condensed``: the second equality mode and the condensed
  backend.
- ``mesh``: the convex fleet sharded over ``parallel.mesh.make_mesh``, the
  fleet's health through a one-process nccl group.
- ``legged_ddp``: the planning node with the DDP solver.
- ``launch``: the deployed topology, ``cli.launch`` with its planner and
  plant in two processes over the shared-memory bus, and this script as
  the tracking side against a spawned planner process.

What a cell of the benchmark already measures is left to it: the times
read here are of paths that no cell runs, of the kernels' sections, or
what a gate needs (``device_timing`` holds its slope against
``graph_vs_eager``'s graphed p50). It prints one JSON object per line. The
last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Any failed gate raises, so the script exits non-zero and prints no result
line; without a CUDA device it fails at once. Needs no network. Besides
``nvidia-smi`` and the compilers it starts the launcher's and the
planner's processes, each in a process group of its own that it waits for
or kills.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cheeta_mpc_tpu_torch.utils.device_timing import (
    F32_FLOPS, HBM_BYTES_PER_S, bound, centroidal_solve_flops, eq_flops,
    ipm_flops, tensors_of, time_chain)

HORIZON = 10
FLEET = 1024
SQP_ITERS, IPM_ITERS = 2, 10
MASS, DT, GRAVITY = 8.0, 0.01, 9.81
# Legged whole-body shape of the JAX package (horizon 67, 24 states and
# inputs, 20 friction-pyramid rows, 16 stage equalities): too large for the
# Riccati factors to stay in shared memory.
LEGGED_SHAPE = dict(N=67, nx=24, nu=24, ng=20, nc=16)

# Kernel against its plain version on the same CUDA tensors. Both run the
# same f32 arithmetic in another summation order; ten IPM iterations at
# barrier conditioning up to 1e6 amplify that rounding. Measured on an H100:
# 1e-5 (batch 1) to 8e-5 (worst of 1024) in dx/du, 1e-7 relative in slacks
# and duals. The bounds leave a factor of five; the JAX package allows its
# own pair of f32 executors 2e-3 and 5e-3.
TOL_PRIMAL = 5e-4
TOL_DUAL = 1e-3
# Ground-reaction forces of a full f32 kernel solve against the f64 solve:
# the JAX package's bound for its f32 kernel path.
TOL_GRF = 5e-2
# The batch-1 kernel solve against the same solve through the plain
# executor on the card: the root bench.py's bound for that pair
# (bench.py:275). Both run the same f32 arithmetic, measured 2e-9 N apart
# on an H100.
TOL_KERNEL_VS_PLAIN = 1e-2


# The legged task at the reference's scale: horizon 1.0 s / dt 0.015, one
# SQP iteration per solve (real-time iteration), a 30 kg body.
LEGGED_HORIZON = 67
LEGGED_FLEET, LEGGED_FLEET_SMALL = 512, 128
SWEEP_BATCHES = (128, 256, 512, 1024, 2048)  # K4's batch sweep
LEGGED_MG = 30.0 * 9.81
PYRAMID_IPM_ITERS = 10
# K3/K4 against their plain versions, relative to the largest entry of the
# plain version's dx/du (at least 1): the same f32 recursion in another
# summation order, no iterations, but 67 stages of unequilibrated
# Gauss-Jordan inverses. On the legged task's own QP an H100 measured 4e-6
# (K3) and 1e-5 (K4, worst of 512); the bound leaves a factor of ten and is
# a twentieth of the JAX package's for this pair of executors (2e-3). The
# seeded random instance at the legged shape is near-singular in f32 (its
# plain version moves by 2e-3 between a batched and an unbatched matrix
# product on a CPU): measured 1.9e-3, bound 5e-3 — the JAX package's own
# for its kernel on such an instance.
TOL_EQ_TASK = 1e-4
TOL_EQ_RANDOM = 5e-3
# Legged contact forces (order 150 N). The f32 kernel solve against the f64
# CPU solve: measured 2.2e-5 N on an H100, bound 2e-4 N (the JAX package
# certifies 4e-4 N for its f32 path at this horizon). Against the plain f32
# executor on the card: measured 1.5e-5 N (pyramid) and 6.1e-5 N (worst of a
# fleet of 512), bound 5e-4 N.
TOL_LEG_F64 = 2e-4
TOL_LEG_PLAIN = 5e-4
TOL_PYRAMID = 1e-3  # stance forces inside the friction pyramid, N

# The graphed paths (one CUDA graph per solve signature, utils/cuda_graph.py).
GRAPH_SOLVES = 200  # host-clock graphed solves per path, for p50 / p99
BUDGET_MS, BUDGET_P99_MS = 20.0, 30.0  # 50 Hz replanning; BASELINE's p99
# The kernels as a profiler trace names them: the QP kernels K1..K4 and
# L1, the legged linearization (one launch per legged SQP iteration).
KERNEL_NAMES = ("ipm_riccati_single_kernel", "ipm_riccati_fleet_kernel",
                "eq_riccati_single_kernel", "eq_riccati_fleet_kernel",
                "legged_linearize_kernel")
IDLE = [0] * len(KERNEL_NAMES)  # launches by the wrappers during a replay
LOOP_TICKS = 20  # the on-device n-tick loop (build_centroidal_mpc_loop)
# The legged planning node: trot at 0.25 m/s after 0.2 s of stance, driven
# for 1.2 s by the lock-step dummy loop with the plant stepping every 5 ms
# and the MPC replanning every fourth step (50 Hz).
NODE_SPEED, NODE_TROT_CYCLE = 0.25, 0.7
NODE_MRT_DT, NODE_RATIO, NODE_STEPS = 0.005, 4, 240
# The DDP planning node (solver='ddp', five iterations per solve, the JAX
# node's default) on the observations of that loop. Its forces against the
# f64 CPU DDP on the first solve's inputs: measured 6.8e-5 N on an H100,
# bound 1e-3 N.
TOL_DDP_F64 = 1e-3
# The deployed topology (cli/launch.py) with the stand-in .info files of
# tests/torch_port_util.py: planner and plant in two processes at the
# launcher's 15 ms plant step and two plant steps per solve, for 1.8 s; the
# soft cone with a live gait switch published at 0.6 s (it lands 1.005 s
# later, at the planner's horizon), and the pyramid cone. The planning node
# of both packages raises once its schedule window (1.5 s back) starts
# inside a trot swing, past 1.83 s here (ROADMAP queue 3 item 5), so the
# runs end at 1.8 s. With the stand-in weights the trotting body sinks, in
# the JAX package's loop as in the port's: 0.128 m over the soft run, on
# the CPU, for both (tests/torch_parity_n67.py). A planner that stops
# replanning lets the body fall once its first 1 s plan runs out: 1.12 m
# over the same run. The height bound lies between the two.
LAUNCH_SECONDS, LAUNCH_SWITCH = 1.8, "standing_trot@0.6"
LAUNCH_TROT_FROM_S = 0.3  # after 0.2 s of stance and 0.1 s of transition
LAUNCH_DRIFT_M = 0.25
LAUNCH_OBS = 60  # observations the script sends the spawned planner
LAUNCH_TIMEOUT_S = 600
# The batched legged pyramid mode (K2 with its 16 stage-equality rows per
# problem) at the reference's scale, as the fleet path runs it. Element 1 of
# a batch against its batch-1 solve (K1): the two kernels run the same
# instructions on a problem, so 5e-4 N leaves room only for the line
# search's batched arithmetic.
PYRAMID_FLEETS = (LEGGED_FLEET_SMALL, LEGGED_FLEET)
TOL_PYRAMID_ELEMENT = 5e-4
PYRAMID_FLEET_SOLVES = 20  # host-clock graphed solves per batch
# The convex SRB MPC, BASELINE config 2 at full width: N=10, dt=0.03, 13
# states, 12 force inputs, 20 pyramid rows, 12 IPM iterations, f32, the
# SrbParams of tests/test_convex_mpc.py:13-14, the JAX tests' scenarios:
# one standing at the nominal 0.3 m (K1) and a fleet of 4096 (K2, BASELINE
# config 5's batch), each standing at its own height in [0.28, 0.32] m
# (tests/test_parallel.py's batch, spread over a band). The IPM's f32
# convergence freeze sits at mu < 1e-6: at the f32 default (1e-4) this QP
# stops before its forces settle, in the JAX package as in the port (its
# f32 forces then miss the f64 ones by up to 7.4 N standing), and below
# 1e-6 the f32 iterates part between executors (K2 against its plain
# version: 0.12 N in du at 1e-8 on an H100). Forces against the f64 CPU
# solve: 4.2e-2 N standing, 1.4e-2 trot on the CPU with the plain versions
# (tests/test_torch_srb_convex_mpc.py), bound 5e-2 N (TOL_GRF). Off the
# feet's centre the split between legs is nearly free (stance force
# regularization 1e-6) and f32 is not held to f64 there, in either package
# (ROADMAP queue 3). Stance forces: the total vertical force within 2 % of
# m g at every stage (the JAX package's test).
SRB_PARAMS = dict(mass=9.0, inertia=(0.07, 0.26, 0.24), mu=0.5, fz_max=250.0)
CONVEX_HORIZON, CONVEX_DT, CONVEX_FLEET = 10, 0.03, 4096
CONVEX_IPM_ITERS, CONVEX_MU_TOL = 12, 1e-6
CONVEX_F64_ROWS = 256  # fleet scenarios held against the f64 CPU solve,
# spread evenly over the batch's height band
# An off-centre CoM (m, in x and y from the feet's centre) for the readings
# that are not gated: the entry point at its shipped IpmSettings(iters=12)
# (f32 freeze at mu < 1e-4) and the off-centre trot, each against the f64
# CPU solve (ROADMAP queue 3). On the CPU with the plain versions: 7.4 N
# standing and 1.4 N trot at the default, 0.67 N off-centre trot at 1e-6.
CONVEX_OFF_CENTRE = (0.03, -0.02)
CONVEX_MG_RTOL = 0.02
# The circular-kinematics OCP (tests/torch_port_util.py) in both equality
# modes, f32 on the card: 25 SQP iterations of one K3 launch each. Measured
# 2.2e-7 (states) and 1.7e-6 (inputs) apart on an H100; bound 1e-4.
CIRCLE_SQP_ITERS = 25
CIRCLE_ALPHAS = (1.0, 0.5, 0.25, 0.125, 1 / 16, 1 / 32, 1 / 64)
TOL_CIRCLE_MODES = 1e-4
TOL_CIRCLE_F64 = 1e-3  # against the f64 CPU solve (tests/test_torch_projection.py)
CONDENSED_SOLVES = 50  # host-clock graphed solves per backend and batch
# Device time per solve by the slope over chained CUDA-graph replays
# (utils/device_timing.py): solves per chain at batch 1 and for fleets, as
# the JAX package's benchmark chains them. A solve's device time is at most
# its graphed host p50 (which adds input copies, the graph launch and the
# host read) and at least the time of its kernel launches by CUDA events;
# the margins leave room for the host clock's spread.
CHAIN_BATCH1, CHAIN_FLEET = (4, 20), (2, 8)
SLOPE_OVER_P50, SLOPE_UNDER_KERNELS = 1.05, 0.9
# L1, the legged linearization kernel, against its plain version
# (torch.func.jacfwd) on the same CUDA tensors, each array's widest gap
# relative to its largest entry. Dual numbers apply jacfwd's own JVP rule
# to each primitive and reassociate nothing that jacfwd does not; the gaps
# come from the compiler fusing a product and a sum into one fmaf, from
# sums of three or four terms in another order and from the card's sincosf
# beside PyTorch's sin and cos: a few f32 roundings, amplified at most by
# the cancellations inside the RK2 step. Measured on an H100 over 16
# instances at batch 1 and 512: at most 5.8e-7 (e; A 2.3e-7, C 3.7e-7),
# where the plain f32 version itself lies up to 7.0e-7 from the f64 one.
# The bound leaves a factor of ten. Inactive equality rows of C and D must
# be exact zeros.
TOL_L1 = 6e-6
L1_TIMED_LAUNCHES = 20  # launches per CUDA graph when timing L1
# The IPM kernels' SPD inverse on its own (csrc/spd_inverse_probe.cu): the
# one-warp form against the block form, which must agree bit for bit at
# every width the warp form takes (the operations on each entry are the
# same), and the block form's use above 32. Widths: the SRB's nu = 12, the
# legged nc = 16, nu = 24, the widest warp instance, and one wider.
INVERSE_WIDTHS = (12, 16, 24, 32, 40)
INVERSE_BATCH = 64  # matrices per width, half barrier-like, half sparse


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def median_ms(fn, repeats: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def events_ms(fn, n: int = 5) -> float:
    """Device ms per ``fn()`` by CUDA events around one replay of a CUDA
    graph of ``n`` calls, captured after a warm-up call: the host's work
    for a call (which can outlast a short kernel) is not timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def random_qp(seed: int, device, N=12, nx=12, nu=8, ng=6, nc=3):
    """A seeded, strictly convex OCP-QP with inequality rows (zero is
    strictly feasible for them) and, for nc > 0, masked stage equalities.
    The coupling blocks shrink with the square root of the width, so that a
    long horizon of wide stages is conditioned like the default shape."""
    from cheeta_mpc_tpu_torch.convert import qp_data_from_numpy
    rng = np.random.default_rng(seed)
    wx, wu = np.sqrt(12.0 / nx), np.sqrt(8.0 / nu)

    def spd(n, count):
        M = rng.normal(size=(count, n, n)) / np.sqrt(n)
        return M @ M.transpose(0, 2, 1) + np.eye(n)

    mask_eq = (rng.uniform(size=(N, nc)) < 0.7).astype(np.float64)
    d = {
        "A": np.eye(nx) + 0.1 * wx * rng.normal(size=(N, nx, nx)),
        "B": 0.3 * rng.normal(size=(N, nx, nu)),
        "b": 0.05 * rng.normal(size=(N, nx)),
        "Q": spd(nx, N + 1), "q": 0.5 * rng.normal(size=(N + 1, nx)),
        "R": spd(nu, N), "r": 0.5 * rng.normal(size=(N, nu)),
        "S": 0.05 * rng.normal(size=(N, nu, nx)),
        "C": rng.normal(size=(N + 1, ng, nx)),
        "D": rng.normal(size=(N + 1, ng, nu)),
        "lg": -1.0 - rng.uniform(size=(N + 1, ng)),
        "ug": 1.0 + rng.uniform(size=(N + 1, ng)),
        "mask": (rng.uniform(size=(N + 1, ng)) < 0.8).astype(np.float64),
        "dx0": 0.1 * rng.normal(size=(nx,)),
    }
    if nc:
        d["eq"] = {
            "C": wx * rng.normal(size=(N, nc, nx)) * mask_eq[:, :, None],
            "D": (wu * rng.normal(size=(N, nc, nu))
                  + 1.5 * np.eye(nc, nu)) * mask_eq[:, :, None],
            "e": 0.05 * rng.normal(size=(N, nc)) * mask_eq,
            "mask": mask_eq,
        }
    return qp_data_from_numpy(d, dtype="float32", device=device)


def compare_eq_solutions(sol, ref, tol_rel: float, value_function: bool,
                         what: str) -> dict:
    """K3/K4 against a plain version: dx, du asserted relative to the plain
    version's largest entry (at least 1); gains reported."""
    errs = {}
    for name in ("dx", "du"):
        a, b = getattr(sol, name), getattr(ref, name)
        check(bool(torch.isfinite(a).all()), f"{what}: {name} is not finite")
        errs[name] = max_abs(a, b)
        errs[f"{name}_scale"] = float(b.abs().max())
        check(errs[name] <= tol_rel * max(1.0, errs[f"{name}_scale"]),
              f"{what}: kernel and plain version disagree: {errs}")
    for name in ("K", "k") + (("P", "p") if value_function else ()):
        a, b = getattr(sol.gains, name), getattr(ref.gains, name)
        check(bool(torch.isfinite(a).all()), f"{what}: gain {name}")
        errs[f"{name}_rel"] = max_abs(a, b) / max(1e-30, float(b.abs().max()))
    return errs


def check_legged_forces(sol, enable, what: str):
    """Finite, exact zeros on swing legs, and at every node a total
    vertical force within 50 % of m g. Returns (min, max) of total Fz."""
    for name in ("forces", "x_traj", "u_traj", "merit"):
        check(bool(torch.isfinite(getattr(sol, name)).all()),
              f"{what}: {name} is not finite")
    check(tuple(sol.forces.shape) == tuple(enable.shape) + (3,),
          f"{what}: forces shape {tuple(sol.forces.shape)}")
    check(bool((sol.forces[enable == 0] == 0).all()),
          f"{what}: swing-leg forces are not exactly 0")
    fz = sol.forces[..., 2].sum(dim=-1)
    lo, hi = float(fz.min()), float(fz.max())
    check(0.5 * LEGGED_MG <= lo and hi <= 1.5 * LEGGED_MG,
          f"{what}: total Fz in [{lo}, {hi}] N leaves m g = {LEGGED_MG} N "
          "by more than 50 %")
    return lo, hi


def check_vertical_force(sol, what: str) -> float:
    """Newton's law on the solution's own trajectory: at every step the
    stance legs together push m (g + zdd), zdd from the COM velocity of
    ``x_traj``. That row of the dynamics is linear in the forces and the
    first iterate is a rollout, so its shooting defect stays zero through
    any line-search step and the law holds to f32 rounding (1.5e-5 N
    measured on an H100; 1e-3 N allowed). Returns the worst residual."""
    fz = sol.contact_force[..., :, 2, :].sum(dim=-2)  # (..., N)
    vz = sol.x_traj[..., :, 5]
    want = MASS * (GRAVITY + (vz[..., 1:] - vz[..., :-1]) / DT)
    resid = float((fz - want).abs().max())
    check(resid <= 1e-3,
          f"{what}: total Fz is off m (g + zdd) by {resid} N")
    return resid


def compare_solutions(sol, ref, gains: bool, what: str) -> dict:
    errs = {name: max_abs(getattr(sol, name), getattr(ref, name))
            for name in ("dx", "du", "s_l", "s_u", "lam_l", "lam_u", "mu")}
    for name in ("dx", "du", "s_l", "s_u", "lam_l", "lam_u"):
        check(bool(torch.isfinite(getattr(sol, name)).all()),
              f"{what}: {name} is not finite")
    check(errs["dx"] <= TOL_PRIMAL and errs["du"] <= TOL_PRIMAL,
          f"{what}: kernel and plain version disagree: {errs}")
    # Duals and slacks scale with the problem; hold them relative to the
    # plain version's largest entry.
    for name in ("s_l", "s_u", "lam_l", "lam_u"):
        scale = max(1.0, float(getattr(ref, name).abs().max()))
        check(errs[name] <= TOL_DUAL * scale,
              f"{what}: {name} differs by {errs[name]} (scale {scale})")
    if gains:
        # Reported, not asserted: with barrier weights up to 1e6 the gains
        # of the last factorization are conditioned far worse than the
        # iterate they produce.
        for name in ("K", "k", "P", "p"):
            a, b = getattr(sol.gains, name), getattr(ref.gains, name)
            errs[f"{name}_rel"] = max_abs(a, b) / max(1e-30,
                                                      float(b.abs().max()))
            check(bool(torch.isfinite(a).all()), f"{what}: gain {name}")
    return errs


def trace_counts(call):
    """One ``call()`` under ``torch.profiler``: the host's kernel launches,
    graph launches and copies, the kernels K1..K4 and L1 by name on the
    device and
    their device time, every device operation (kernels, copies, fills) and
    the device time of them all; returned with what ``call()`` returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        value = call()
        torch.cuda.synchronize()
    out = {"host_kernel_launches": 0, "graph_launches": 0,
           "host_copies": 0, "kernels": [0] * len(KERNEL_NAMES),
           "kernel_ms": [0.0] * len(KERNEL_NAMES), "device_ops": 0,
           "device_ms": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            out["device_ops"] += 1
            out["device_ms"] += ms
            for i, name in enumerate(KERNEL_NAMES):
                if name in e.name:
                    out["kernels"][i] += 1
                    out["kernel_ms"][i] += ms
        elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out["host_kernel_launches"] += 1
        elif e.name == "cudaGraphLaunch":
            out["graph_launches"] += 1
        elif e.name.startswith("cudaMemcpy"):
            out["host_copies"] += 1
    return out, value


def wall_spread(fn, n: int = GRAPH_SOLVES, warmup: int = 3) -> dict:
    """p50 / p99 / max host ms of ``fn()`` over ``n`` calls; ``fn`` ends
    with its outputs on the host, so each call ends in a wait for the
    card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return percentiles(ts)


def percentiles(ms) -> dict:
    """p50 / p99 / max of a list of milliseconds."""
    ts = sorted(ms)
    n = len(ts)

    def pct(p):
        return ts[min(n - 1, int(round(p / 100.0 * (n - 1))))]

    return {"p50": pct(50), "p99": pct(99), "max": ts[-1], "n": n}


def node_gait():
    """The planning-node scenario's gait: stance, then the trot from 0.2 s
    after 0.1 s of transition."""
    from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule, trot_template
    gait = GaitSchedule.stance(trot_template(NODE_TROT_CYCLE), t0=0.0)
    gait.phase_transition_stance_time = 0.1
    gait.insert_template(trot_template(NODE_TROT_CYCLE), insert_time=0.2)
    return gait


def phase_legged_ddp(kit, sqp_observations) -> dict:
    """The legged planning node with the DDP solver (``solver='ddp'``) at
    the legged node's width, in two runs.

    (i) The 60 observations of the soft-cone SQP node's lock-step loop
    (phase ``legged_node``), each answered by the DDP node: graphed
    against eager, host launches per solve, forces against the f64 CPU
    DDP, the force checks at every solve, the solve times, and the device
    ms by stage of the last replay before a profiled one (the graph's
    ``stats["stage_ms"]``). (ii)
    The DDP node closing the loop itself, as phase ``legged_node`` runs
    it. Its first iterate is the open-loop rollout of
    the weight-compensating input, as in the JAX package; over a 1 s
    horizon that rollout tumbles from any state off the symmetric stance,
    and in both packages the loop's cost jumps 145x at the second solve
    and the loop then runs away (tests/torch_parity_n67.py reads both on
    the CPU). Run (ii) is reported, and gated only on its first solve,
    which starts from that stance."""
    from cheeta_mpc_tpu_torch.models.srbd_legged import srbd_step
    from cheeta_mpc_tpu_torch.mpc.legged_ddp import build_legged_ddp_solver
    from cheeta_mpc_tpu_torch.mpc.legged_node import (LeggedPlannerAssembly,
                                                      PlannerSettings,
                                                      default_stance_state)
    from cheeta_mpc_tpu_torch.mpc.runtime import (MpcMrtInterface,
                                                  SystemObservation,
                                                  run_dummy_loop)
    from cheeta_mpc_tpu_torch.solvers.ddp import DdpSettings
    from cheeta_mpc_tpu_torch.utils.timing import Benchmarker
    dev, card, lcfg = kit.dev, kit.card, kit.lcfg
    settings = PlannerSettings(solver="ddp")
    x0 = default_stance_state(lcfg)

    node = LeggedPlannerAssembly(
        lcfg, node_gait(), x0, v_cmd=np.array([NODE_SPEED, 0.0, 0.0]),
        settings=settings, device=dev)
    graph_fn = node._solve
    calls = []

    def recording(*args, **kwargs):
        sol = graph_fn(*args, **kwargs)
        calls.append((args, kwargs, sol))
        return sol

    node._solve = recording

    def check_solve(args, sol, what):
        for name in ("forces", "x_traj", "u_traj", "gains_K", "gains_P",
                     "gains_p", "cost"):
            check(bool(torch.isfinite(getattr(sol, name)).all()),
                  f"{what}: {name} is not finite")
        en = torch.as_tensor(args[2], device=dev)
        check(bool((sol.forces[en == 0] == 0).all()),
              f"{what}: swing-leg forces are not exactly 0")
        fz = sol.forces[..., 2].sum(dim=-1)
        lo, hi = float(fz.min()), float(fz.max())
        check(0.5 * LEGGED_MG <= lo and hi <= 1.5 * LEGGED_MG,
              f"{what}: total Fz in [{lo}, {hi}] N leaves m g = "
              f"{LEGGED_MG} N by more than 50 %")
        return lo, hi

    # (i) The SQP node's observations.
    for t, x in sqp_observations:
        node.solve_fn(SystemObservation(time=t, state=x))
    check(len(graph_fn.graphs) == 1,
          f"DDP node: {len(graph_fn.graphs)} graphs captured; expected one")
    n_solves = len(calls)
    fz_range = [np.inf, -np.inf]
    for i, (a, _, sol) in enumerate(calls):
        lo, hi = check_solve(a, sol, f"DDP node, solve {i}")
        fz_range = [min(fz_range[0], lo), max(fz_range[1], hi)]
    # The first graphed solve (warm-up calls, capture, replay) against an
    # eager solve of the same inputs: the same kernels in the same order,
    # none of them summing in a run-dependent order.
    args, kwargs, first = calls[0]
    eager = graph_fn.__wrapped__(*args, **kwargs)
    torch.cuda.synchronize()
    diff = {k: max_abs(getattr(first, k), getattr(eager, k))
            for k in first._fields}
    bit_equal = all(torch.equal(getattr(first, k), getattr(eager, k))
                    for k in first._fields)
    check(bit_equal, f"DDP node: graphed and eager solves differ: {diff}")
    ref64 = build_legged_ddp_solver(
        lcfg._replace(dtype=torch.float64),
        DdpSettings(iterations=settings.ddp_iterations), device="cpu")(
        *(np.asarray(a, np.float64) for a in args),
        dts=np.asarray(kwargs["dts"], np.float64))
    f64_err = max_abs(first.forces.cpu(), ref64.forces)
    check(f64_err <= TOL_DDP_F64,
          f"DDP node: forces differ from the f64 CPU DDP by {f64_err} N")
    t_last, x_last = sqp_observations[-1]
    tr, _ = trace_counts(lambda: node.solve_fn(
        SystemObservation(time=t_last, state=x_last)))
    check(tr["host_kernel_launches"] == 0 and tr["graph_launches"] == 1,
          f"DDP node: a solve made {tr['host_kernel_launches']} kernel "
          f"launches and {tr['graph_launches']} graph launches on the "
          "host; expected 0 and 1")
    # The profiled solve folded in the stage events of the replay before.
    stage_ms = graph_fn.entry_of(*args, **kwargs).stats.get("stage_ms", {})
    check(stage_ms.get("folded") == 1 and len(stage_ms["ms"]) == 6,
          f"DDP node: the stages of the replay before the profiled one "
          f"were not folded in: "
          f"{stage_ms}")
    steady = Benchmarker()
    steady.samples_ms = node.bench.samples_ms[1:n_solves]
    costs = [float(sol.cost) for _, _, sol in calls[:n_solves]]
    report = {
        "phase": "legged_ddp", "card": card, "horizon": lcfg.horizon,
        "ddp_iterations": settings.ddp_iterations,
        "graph": graph_fn.entry_of(*args, **kwargs).stats,
        "sqp_observations": {
            "solves": n_solves,
            "first_solve_ms": node.bench.samples_ms[0],
            "solve_ms_p50": steady.percentile_ms(50),
            "solve_ms_p99": steady.percentile_ms(99),
            "solve_ms_max": max(steady.samples_ms),
            "p50_within_20ms": steady.percentile_ms(50) <= BUDGET_MS,
            "graphed_vs_eager_max_abs": diff, "bit_equal": bit_equal,
            "force_err_vs_f64_cpu": f64_err, "tolerance": TOL_DDP_F64,
            "total_fz_min_max": fz_range, "mg": LEGGED_MG,
            "cost_first_median_max": [costs[0], statistics.median(costs),
                                      max(costs)],
            "converged": sum(bool(sol.converged)
                             for _, _, sol in calls[:n_solves])},
        "replay": {k: tr[k] for k in ("host_kernel_launches",
                                      "graph_launches", "host_copies",
                                      "device_ops", "device_ms")},
        "replay_stage_ms": stage_ms}

    # (ii) The DDP node closing the loop: the same node (a DDP solve
    # carries no state from one to the next), a fresh gait for the plant.
    gait = node_gait()
    calls.clear()

    def plant(t, x, u):
        e = gait.get_mode_schedule(max(0.0, t - 1.0), t + 1.0)\
            .contact_flags_at(t + 0.5 * NODE_MRT_DT)
        return srbd_step(lcfg.params, torch.as_tensor(x), torch.as_tensor(u),
                         torch.as_tensor(np.asarray(e, np.float64)),
                         dt=NODE_MRT_DT).numpy()

    res = run_dummy_loop(MpcMrtInterface(node.solve_fn), plant, x0=x0,
                         mrt_dt=NODE_MRT_DT, mpc_update_ratio=NODE_RATIO,
                         n_steps=NODE_STEPS)
    check_solve(calls[0][0], calls[0][2], "DDP node, closed loop, solve 0")
    costs = [float(sol.cost) for _, _, sol in calls]
    finite = np.isfinite(res.states).all(axis=1)
    report["closed_loop"] = {
        "solves": res.solves,
        "costs": [c if np.isfinite(c) else None for c in costs],
        "first_solve_over_10x_first_cost": next(
            (i for i, c in enumerate(costs)
             if not abs(c) <= 10.0 * abs(costs[0])), None),
        "first_nonfinite_step": (None if finite.all()
                                 else int(np.argmin(finite))),
        "steps": NODE_STEPS, "mrt_dt": NODE_MRT_DT,
        "mpc_hz": 1.0 / (NODE_MRT_DT * NODE_RATIO)}
    return report


def run_child(cmd, env, cwd, timeout_s=LAUNCH_TIMEOUT_S):
    """Run ``cmd`` in a process group of its own to its end; the group is
    killed if it outlives ``timeout_s`` (or anything goes wrong here).
    Returns (returncode, stdout, stderr)."""
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
        return proc.returncode, out, err
    finally:
        stop_group(proc)


def stop_group(proc, grace_s: float = 30.0) -> None:
    """SIGTERM to ``proc``'s process group, SIGKILL after ``grace_s``."""
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)  # stragglers of the group
    except ProcessLookupError:
        pass
    proc.wait(timeout=grace_s)


def solves_line(stdout: str, what: str) -> dict:
    """The ``[mpc] solves`` line an MPC process prints at shutdown."""
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("[mpc] solves ")]
    check(len(lines) == 1, f"{what}: the MPC process printed "
          f"{len(lines)} '[mpc] solves' lines")
    return json.loads(lines[0][len("[mpc] solves "):])


def drive_mrt(mrt, cfg, gait, dev) -> dict:
    """The tracking side of the deployed loop, played by this script:
    reset handshake, then ``LAUNCH_OBS`` observations, each published once
    and answered by the planner before the plant (the port's SRBD step on
    the card, as the launcher's plant process runs it) takes two steps on
    its policy. Returns the plant's states and each observation's round
    trip, observation published -> its policy received."""
    from cheeta_mpc_tpu_torch.cli.launch import wait_for_policy_at
    from cheeta_mpc_tpu_torch.models.srbd_legged import srbd_step
    from cheeta_mpc_tpu_torch.mpc.legged_node import default_stance_state
    from cheeta_mpc_tpu_torch.mpc.runtime import SystemObservation
    DT = float(cfg.params.dt)
    kw = dict(dtype=cfg.dtype, device=dev)

    def plant(t, x, u):
        e = np.asarray(gait.get_mode_schedule(
            max(0.0, t - 1.0), t + 1.0).contact_flags_at(t + 0.5 * DT))
        return srbd_step(cfg.params, torch.as_tensor(x, **kw),
                         torch.as_tensor(u, **kw),
                         torch.as_tensor(e, **kw)).cpu().numpy().astype(
                             np.float64)

    check(mrt.reset_mpc(timeout_s=120.0), "launch: no reset acknowledgement")
    x = default_stance_state(cfg)
    t, states, rtt = 0.0, [x.copy()], []
    for k in range(LAUNCH_OBS):
        t_pub = time.perf_counter()
        mrt.set_current_observation(
            SystemObservation(time=t, state=x, input=None, mode=0))
        check(wait_for_policy_at(mrt, t, 300.0 if k == 0 else 30.0),
              f"launch: no policy for the observation at t = {t}")
        rtt.append(1e3 * (time.perf_counter() - t_pub))
        for _ in range(2):
            x = plant(t, x, mrt.evaluate_policy(t, x))
            t += DT
            states.append(x.copy())
    return {"states": np.asarray(states), "rtt_ms": rtt}


def gait_switch_evidence(what, summary, node, out) -> dict:
    """The live gait switch as the planner applied it: its receiver's log
    names the command at the time the plant switched, inside the run, and
    the planner's forces load all four feet after that time (the new
    gait's transition stance), which the trot it replaced never does once
    it has started."""
    name = LAUNCH_SWITCH.rsplit("@", 1)[0]
    switched_at = summary["switched_at"]
    check(switched_at is not None and switched_at < LAUNCH_SECONDS,
          f"{what}: the gait switch lands at {switched_at} s, outside the "
          f"{LAUNCH_SECONDS} s run")
    check(node["gaits_applied"] == [[name, switched_at]],
          f"{what}: the planner applied {node['gaits_applied']}; expected "
          f"[[{name!r}, {switched_at}]]")
    traj = np.load(out + "_traj.npz")
    times = traj["times"][:-1]
    four = (traj["inputs"][:, 2:12:3] > 1.0).all(axis=1)  # each foot's Fz
    after = int(four[times >= switched_at].sum())
    before = int(four[(times >= LAUNCH_TROT_FROM_S)
                      & (times < switched_at)].sum())
    check(after > 0 and before == 0,
          f"{what}: steps with all four feet loaded: {before} between "
          f"{LAUNCH_TROT_FROM_S} s and the switch, {after} after it; "
          "expected 0 and some")
    return {"gaits_applied": node["gaits_applied"],
            "four_feet_loaded_steps_before_after": [before, after]}


def phase_launch(dev, card) -> dict:
    """The deployed topology on the card. (a) ``cli.launch`` as a user runs
    it (planner and plant in two processes over shared memory), soft cone
    with a live gait switch and pyramid cone. (b) This script as the
    tracking side against a spawned planner process (``--role mpc``),
    timed per round trip, and against the same loop over the in-process
    bus with the same planner in this process."""
    from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
    from cheeta_mpc_tpu_torch.mpc.legged_node import (LeggedPlannerAssembly,
                                                      default_stance_state)
    from cheeta_mpc_tpu_torch.transport.bus import MessageBus
    from cheeta_mpc_tpu_torch.transport.mpc_mrt import (TOPICS, MpcNode,
                                                        MrtNode)
    from cheeta_mpc_tpu_torch.transport.shm import ShmMessageBus
    from cheeta_mpc_tpu_torch.utils.info_config import load_gait_library
    root = pathlib.Path(__file__).resolve().parent
    util = load_util()
    env = dict(os.environ, PYTHONPATH=str(root))
    launch = [sys.executable, "-m", "cheeta_mpc_tpu_torch.cli.launch",
              "--device", dev.type, "--horizon", str(LEGGED_HORIZON)]
    report = {"phase": "launch", "card": card, "horizon": LEGGED_HORIZON}
    with tempfile.TemporaryDirectory() as tmp:
        task, gait_info = util.write_info_files(tmp)
        files = ["--task-info", task, "--gait-info", gait_info]
        cfg = LeggedMpcConfig.from_task_info(task, horizon=LEGGED_HORIZON)
        x0 = default_stance_state(cfg)
        # (a) The launcher, as a user runs it.
        n_steps = int(round(LAUNCH_SECONDS / cfg.params.dt))
        want_solves = 1 + (n_steps - 1) // 2  # the launcher's ratio of 2
        for mode, extra in (("soft", ["--switch-gait", LAUNCH_SWITCH]),
                            ("pyramid", [])):
            out = os.path.join(tmp, f"launch_{mode}")
            t0 = time.perf_counter()
            rc, stdout, stderr = run_child(
                launch + files + ["--cone", mode, "--seconds",
                                  str(LAUNCH_SECONDS), "--out", out] + extra,
                env, str(root))
            wall = time.perf_counter() - t0
            what = f"launch ({mode})"
            check(rc == 0, f"{what}: exit code {rc}\n{stdout[-3000:]}\n"
                  f"{stderr[-3000:]}")
            with open(out + "_summary.json") as f:
                summary = json.load(f)
            states = np.load(out + "_traj.npz")["states"]
            check(summary["finite"] and bool(np.isfinite(states).all()),
                  f"{what}: non-finite states")
            check(summary["solves"] == want_solves,
                  f"{what}: {summary['solves']} policies applied; the "
                  f"lock-step count is {want_solves}")
            check(summary["height_drift_m"] < LAUNCH_DRIFT_M,
                  f"{what}: height drift {summary['height_drift_m']} m")
            check(summary["forward_m"] > 0.0,
                  f"{what}: no forward progress ({summary['forward_m']} m)")
            up = f"[mpc] node up (sqp, {mode} cone, N={LEGGED_HORIZON}, " \
                 f"device {dev.type}"
            check(up in stdout, f"{what}: no line {up!r} in the output")
            node = solves_line(stdout, what)
            report[f"cli_{mode}"] = {
                "wall_s": wall, "summary": summary,
                "mpc_first_solve_ms": node["first_ms"],
                "mpc_solve_ms": percentiles(node["solve_ms"])}
            if mode == "soft":
                report["cli_soft"]["gait_switch"] = gait_switch_evidence(
                    what, summary, node, out)

        # (b) This script as the tracking side, across the process boundary
        # and then in-process, the same planner (the launcher's default
        # settings, soft cone) and the same plant.
        library = load_gait_library(gait_info)

        def gait():
            gs = GaitSchedule.stance(library["trot"], t0=0.0)
            gs.phase_transition_stance_time = 0.1
            gs.insert_template(library["trot"], insert_time=0.2)
            return gs

        name = f"/cheeta_smoke_{os.getpid()}"
        bus = ShmMessageBus(TOPICS, name, create=True)
        proc = subprocess.Popen(
            launch + files + ["--role", "mpc", "--bus", name, "--cone",
                              "soft"],
            env=env, cwd=str(root), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            shm_run = drive_mrt(MrtNode(bus), cfg, gait(), dev)
            stop_group(proc)
            stdout, stderr = proc.communicate(timeout=60)
        finally:
            stop_group(proc)
            bus.close()
        check(proc.returncode == 0, f"launch (mpc process): exit code "
              f"{proc.returncode}\n{stderr[-3000:]}")
        node = solves_line(stdout, "launch (mpc process)")
        check(node["solves"] == LAUNCH_OBS,
              f"launch (mpc process): {node['solves']} solves for "
              f"{LAUNCH_OBS} observations")
        assembly = LeggedPlannerAssembly(
            cfg, gait(), x0, v_cmd=np.array([NODE_SPEED, 0.0, 0.0]),
            device=dev)
        ibus = MessageBus(TOPICS)
        mpc = MpcNode(ibus, assembly.solve_fn)
        mpc.launch()
        try:
            in_run = drive_mrt(MrtNode(ibus), cfg, gait(), dev)
        finally:
            mpc.shutdown()
            ibus.close()
        a, b = shm_run["states"], in_run["states"]
        scale = max(1.0, float(np.abs(b).max()))
        traj_err = float(np.abs(a - b).max())
        check(a.shape == b.shape and traj_err <= 1e-5 * scale,
              f"launch: the trajectory across processes differs from the "
              f"in-process one by {traj_err} (scale {scale})")
        drift = float(np.abs(a[:, 8] - x0[8]).max())
        check(drift < LAUNCH_DRIFT_M,
              f"launch (script as tracking side): height drift {drift} m")
        rtt = shm_run["rtt_ms"][1:]  # the first includes the capture
        solve = node["solve_ms"]  # solves after the first, one per tick
        check(len(solve) == len(rtt), "launch: round trips and solves do "
              "not pair up")
        report["mrt_vs_spawned_planner"] = {
            "observations": LAUNCH_OBS,
            "first_round_trip_ms": shm_run["rtt_ms"][0],
            "round_trip_ms": percentiles(rtt),
            "node_solve_ms": percentiles(solve),
            "round_trip_minus_solve_ms": percentiles(
                [r - s for r, s in zip(rtt, solve)]),
            "in_process_round_trip_ms": percentiles(in_run["rtt_ms"][1:]),
            "in_process_solve_ms": percentiles(assembly.bench.samples_ms[1:]),
            "trajectory_bit_equal": bool(np.array_equal(a, b)),
            "trajectory_max_abs": traj_err,
            "height_drift_m": drift,
            "forward_m": float(a[-1, 6] - x0[6])}
    return report


def load_util():
    """tests/torch_port_util.py, loaded by path: the stand-in .info files
    and the circular-kinematics problem that the tests share (it imports
    JAX only inside the functions this script does not call)."""
    root = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "torch_port_util", root / "tests" / "torch_port_util.py")
    util = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(util)
    return util


def pyramid_violation(forces, enable, mu, f_max) -> float:
    """How far the stance forces leave the friction pyramid, in N (<= 0
    inside)."""
    outside = torch.stack([
        forces[..., 0].abs() - mu * forces[..., 2],
        forces[..., 1].abs() - mu * forces[..., 2],
        -forces[..., 2], forces[..., 2] - f_max]).amax(dim=0)
    return float((outside * enable).max())


def contig(data):
    from cheeta_mpc_tpu_torch.core.types import tree_map
    return tree_map(lambda t: t.contiguous(), data)


def kernel_row(launch, plain, data, out, flops, what) -> dict:
    """A kernel's time (CUDA events, median), its plain version's, and the
    bound of its work on this run's inputs."""
    (b, by), nbytes = bound(data, out, flops)
    return {"ms": median_ms(launch, repeats=5),
            "plain_ms": median_ms(plain, repeats=2, warmup=1),
            "bound_ms": b, "bound_by": by, "bytes": nbytes, "flops": flops,
            "what": what}


def check_per_problem_cd(kit, qp, sk, ipm, what) -> dict:
    """K2 on ``qp`` with inequality matrices C/D of their own per problem,
    as the projected mode's reduced rows carry the batch of its equalities:
    a copy of the shared C/D per problem gives ``sk``, the launch on the
    shared C/D, bit for bit, and rows scaled by a factor of their own per
    problem (0.9 to 1.1) agree with the plain version at the kernel's
    tolerances."""
    con, batch = qp.con, qp.dx0.shape[0]

    def own(scale):
        return contig(qp.replace(con=con.replace(
            C=con.C.expand((batch,) + con.C.shape) * scale,
            D=con.D.expand((batch,) + con.D.shape) * scale)))

    copies = kit.k2(own(1.0), ipm)
    torch.cuda.synchronize()
    names = ("dx", "du", "s_l", "s_u", "lam_l", "lam_u", "mu")
    bit = all(torch.equal(getattr(copies, n), getattr(sk, n)) for n in names)
    check(bit, f"{what}: K2 on a copy of C/D per problem differs from K2 on "
          "the shared C/D")
    scaled = own(torch.linspace(0.9, 1.1, batch,
                                device=qp.dx0.device)[:, None, None, None])
    err = compare_solutions(kit.k2(scaled, ipm), kit.k2_plain(scaled, ipm),
                            False, f"{what}, C/D scaled per problem")
    return {"copies_equal_shared": bit, "scaled_k2_vs_plain": err}


def phase_pyramid_fleet(kit) -> dict:
    """The batched legged pyramid mode (N=67, 16 stage equalities and 20
    pyramid rows per problem) through the fleet kernel's instantiation with
    the equality elimination, at batch 128 and 512."""
    dev, card, ipm_pyr = kit.dev, kit.card, kit.ipm_pyr
    lsolver_pyr, glsolver_pyr = kit.lsolver_pyr, kit.glsolver_pyr
    report = {"phase": "pyramid_fleet", "card": card,
              "horizon": LEGGED_HORIZON, "ipm_iters": PYRAMID_IPM_ITERS}
    for batch in PYRAMID_FLEETS:
        args_np = tuple(a[:batch] for a in kit.lmany_np.args)
        args = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in args_np)
        qp = contig(lsolver_pyr.initial_qp(*args))
        sk, pk = kit.k2(qp, ipm_pyr), kit.k2_plain(qp, ipm_pyr)
        torch.cuda.synchronize()
        err = compare_solutions(sk, pk, False,
                                f"K2 with stage equalities, batch {batch}")
        check(bool(torch.isnan(sk.gains.K).all()), "K2 must return NaN gains")
        if batch == LEGGED_FLEET_SMALL:
            report["per_problem_cd"] = check_per_problem_cd(
                kit, qp, sk, ipm_pyr, f"pyramid fleet {batch}")
        tr, sol = kit.graphed_run(f"legged pyramid fleet {batch}",
                                  lambda: glsolver_pyr(*args_np),
                                  [0, 1, 0, 0, 1])
        eager = lsolver_pyr(*args)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(getattr(sol, k), getattr(eager, k))
                        for k in ("forces", "x_traj", "u_traj", "merit"))
        check(bit_equal, f"pyramid fleet {batch}: graphed and eager results "
              "differ")
        fz_lo, fz_hi = check_legged_forces(sol, args[2],
                                           f"pyramid fleet {batch}")
        viol = pyramid_violation(sol.forces, args[2],
                                 kit.lcfg_pyr.friction_mu,
                                 kit.lcfg_pyr.force_max)
        check(viol <= TOL_PYRAMID, f"pyramid fleet {batch}: a stance force "
              f"leaves the pyramid by {viol} N")
        kit.reset_counts()
        one = lsolver_pyr(*(a[1] for a in args_np))
        torch.cuda.synchronize()
        check(kit.counts() == [1, 0, 0, 0, 1],
              f"the batch-1 pyramid solve launched K1..K4, L1 "
              f"{kit.counts()}x")
        el1 = max_abs(sol.forces[1], one.forces)
        check(el1 <= TOL_PYRAMID_ELEMENT,
              f"pyramid fleet {batch}: element 1 differs from its batch-1 "
              f"(K1) solve by {el1} N")
        wall = wall_spread(lambda: glsolver_pyr(*args_np).forces.cpu(),
                           n=PYRAMID_FLEET_SOLVES, warmup=1)
        report[f"batch{batch}"] = {
            "k2_vs_plain": err, "replay": tr, "k2_launches": tr["kernels"][1],
            "graphed_equals_eager": bit_equal,
            "total_fz_min_max": [fz_lo, fz_hi], "outside_pyramid": viol,
            "element1_vs_batch1_k1": el1, "graphed_ms": wall,
            "solves_per_s": 1e3 * batch / wall["p50"]}
    N, nx, nu = qp.dyn.horizon, qp.dyn.nx, qp.dyn.nu
    row = kernel_row(
        lambda: kit.k2(qp, ipm_pyr), lambda: kit.k2_plain(qp, ipm_pyr),
        qp, [sk.dx, sk.du, sk.s_l, sk.s_u, sk.lam_l, sk.lam_u],
        LEGGED_FLEET * ipm_flops(N, nx, nu, qp.con.ng, qp.eq.nc,
                                 PYRAMID_IPM_ITERS),
        f"K2 with stage equalities, batch {LEGGED_FLEET}")
    row["launches"] = report[f"batch{LEGGED_FLEET}"]["k2_launches"]
    row["max_abs_err"] = max(err["dx"], err["du"])
    occ = kit.single_mod.launch_occupancy(kit.single_mod.FLEET_ENTRY, qp,
                                          ipm_pyr)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ["waves"] = -(-LEGGED_FLEET // (sms * occ["blocks_per_sm"]))
    check(occ["blocks_per_sm"] >= 1, f"K2 with stage equalities: {occ}")
    report.update({"kernel": row, "occupancy": occ})
    return report


def convex_scenarios(batch: int, gait: str, off_centre: bool = False):
    """The solver's inputs: ``batch`` standing references (each CoM held
    where it starts, over the feet's centre or ``CONVEX_OFF_CENTRE`` from
    it, at heights spread over [0.28, 0.32] m; one scenario, without a
    batch dimension, at the nominal 0.3 m), the nominal feet and the gait's
    contact table."""
    from cheeta_mpc_tpu_torch.examples import NOMINAL_FEET, trot_table
    x0 = np.zeros((batch, 13))
    if off_centre:
        x0[:, 3:5] = CONVEX_OFF_CENTRE
    x0[:, 5] = 0.3 if batch == 1 else np.linspace(0.28, 0.32, batch)
    x0[:, 12] = 1.0
    ref = np.repeat(x0[:, None, :], CONVEX_HORIZON + 1, axis=1)
    enable = (np.ones((CONVEX_HORIZON, 4)) if gait == "stance"
              else trot_table(CONVEX_HORIZON))
    if batch == 1:
        return x0[0], ref[0], NOMINAL_FEET, enable
    return x0, ref, NOMINAL_FEET, enable


def phase_convex_mpc(kit):
    """The convex SRB MPC (BASELINE config 2) through ``build_convex_mpc``:
    one scenario (K1) and 4096 (K2), standing and trot, as CUDA graphs.
    Returns the report, the configuration and IPM settings, and the solver
    (the trot's)."""
    from cheeta_mpc_tpu_torch.models.srb import GRAVITY, SrbParams
    from cheeta_mpc_tpu_torch.mpc.convex_mpc import (ConvexMpcConfig,
                                                     build_convex_mpc)
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    dev, card = kit.dev, kit.card
    params = SrbParams(**SRB_PARAMS)
    cfg = ConvexMpcConfig(params=params, horizon=CONVEX_HORIZON,
                          dt=CONVEX_DT)
    ipm = IpmSettings(iters=CONVEX_IPM_ITERS, mu_tol=CONVEX_MU_TOL)
    solve64 = build_convex_mpc(cfg._replace(dtype=torch.float64),
                               IpmSettings(iters=CONVEX_IPM_ITERS),
                               device="cpu")
    mg = params.mass * GRAVITY

    def err_vs_f64(f, args):
        """Max |f - f64| over the batch-1 scenario, or over
        ``CONVEX_F64_ROWS`` scenarios spread evenly over a fleet."""
        if args[0].ndim == 1:
            return max_abs(f.cpu(), solve64(*args)[0])
        idx = np.linspace(0, len(args[0]) - 1, CONVEX_F64_ROWS).round()
        idx = idx.astype(int)
        f64, _ = solve64(args[0][idx], args[1][idx], *args[2:])
        return max_abs(f[torch.as_tensor(idx, device=f.device)].cpu(), f64)

    report = {"phase": "convex_mpc", "card": card, "mg": mg,
              "ipm": ipm._asdict(), "tolerance_f64": TOL_GRF}
    inputs = {}
    for gait in ("stance", "trot"):
        # A solver per gait, so that each gait's first call captures its
        # graphs (the contact table is an input of the same shape).
        solve = build_convex_mpc(cfg, ipm, device=dev)
        for batch in (1, CONVEX_FLEET):
            args = convex_scenarios(batch, gait)
            inputs[gait, batch] = args
            what = f"convex {gait}, batch {batch}"
            want = [1, 0, 0, 0, 0] if batch == 1 else [0, 1, 0, 0, 0]
            tr, (f, sol) = kit.graphed_run(what, lambda: solve(*args), want)
            f_e, _ = getattr(solve, "__wrapped__", solve)(*args)
            torch.cuda.synchronize()
            check(torch.equal(f, f_e), f"{what}: graphed and eager differ")
            check(bool(torch.isfinite(f).all()), f"{what}: forces not finite")
            on = torch.as_tensor(args[3], dtype=f.dtype, device=dev)
            swing = f.masked_select((on == 0)[..., None].expand_as(f))
            check(bool((swing == 0).all()),
                  f"{what}: swing-leg forces are not exactly 0")
            viol = pyramid_violation(f, on, params.mu, params.fz_max)
            check(viol <= TOL_PYRAMID,
                  f"{what}: a stance force leaves the pyramid by {viol} N")
            fz = f[..., 2].sum(dim=-1)
            mg_err = float((fz - mg).abs().max()) / mg
            if gait == "stance":
                check(mg_err <= CONVEX_MG_RTOL,
                      f"{what}: total Fz leaves m g by {mg_err:.2%}")
            f64_err = err_vs_f64(f, args)
            check(f64_err <= TOL_GRF, f"{what}: forces differ from the f64 "
                  f"CPU solve by {f64_err} N")
            report[f"{gait}_batch{batch}"] = {
                "replay": tr, "launches": tr["kernels"][:2],
                "outside_pyramid": viol, "fz_vs_mg_rel_max": mg_err,
                "force_err_vs_f64_cpu": f64_err,
                "f64_rows": min(batch, CONVEX_F64_ROWS),
                "qp_mu_max": float(sol.mu.max())}
    # Readings, not gated (ROADMAP queue 3): the entry point as it ships,
    # IpmSettings(iters=12), on the gated scenarios, and the off-centre trot
    # at both settings, each against the f64 CPU solve.
    readings = {}
    for name, ipm_r in (("default", IpmSettings(iters=CONVEX_IPM_ITERS)),
                        ("mu_tol_1e-6", ipm)):
        solve_r = build_convex_mpc(cfg, ipm_r, device=dev)
        solve_r = getattr(solve_r, "__wrapped__", solve_r)
        for gait, off in (("stance", False), ("trot", False), ("trot", True)):
            if name != "default" and not off:
                continue
            for batch in (1, CONVEX_FLEET):
                args = convex_scenarios(batch, gait, off)
                f, _ = solve_r(*args)
                what = (f"convex {gait}{' off-centre' if off else ''}, "
                        f"batch {batch}, {name}")
                check(bool(torch.isfinite(f).all()),
                      f"{what}: forces not finite")
                key = f"{gait}{'_off_centre' if off else ''}_batch{batch}"
                readings.setdefault(name, {})[key] = err_vs_f64(f, args)
    report["force_err_vs_f64_cpu_not_gated"] = readings
    # Each kernel against its plain version on the trot QPs, and its time.
    rows = {}
    for batch, kern, plain, gains in (
            (1, kit.k1, kit.k1_plain, True),
            (CONVEX_FLEET, kit.k2, kit.k2_plain, False)):
        qp = contig(solve.initial_qp(*inputs["trot", batch]))
        sk, pk = kern(qp, ipm), plain(qp, ipm)
        torch.cuda.synchronize()
        err = compare_solutions(sk, pk, gains, f"SRB QP, batch {batch}")
        flops = batch * ipm_flops(CONVEX_HORIZON, 13, 12, qp.con.ng, 0,
                                  CONVEX_IPM_ITERS)
        out = [sk.dx, sk.du, sk.s_l, sk.s_u, sk.lam_l, sk.lam_u]
        out += tensors_of(sk.gains) if gains else []
        row = kernel_row(lambda: kern(qp, ipm), lambda: plain(qp, ipm),
                         qp, out, flops, f"SRB QP, batch {batch}")
        row["max_abs_err"] = max(err["dx"], err["du"])
        row["vs_plain"] = err
        if batch > 1:
            report["per_problem_cd"] = check_per_problem_cd(
                kit, qp, sk, ipm, f"SRB QP, batch {batch}")
        entry = kit.single_mod.FLEET_ENTRY if batch > 1 else \
            "cheeta_ipm_riccati_single"
        row["occupancy"] = kit.single_mod.launch_occupancy(entry, qp, ipm)
        rows["k1" if batch == 1 else "k2"] = row
    # Graphed host ms on the trot scenario, which device_timing's gate
    # reads (the speed of these paths is the convex_srb cells').
    for batch in (1, CONVEX_FLEET):
        args = inputs["trot", batch]
        report[f"trot_batch{batch}"]["graphed_ms"] = wall_spread(
            lambda: solve(*args)[0].cpu())
    report["kernels"] = rows
    return report, (cfg, ipm), solve


class TimedPath(NamedTuple):
    """One path of phase ``device_timing`` and this run's other readings
    of it."""

    name: str
    eager: Callable  # the eager solve, chained into CUDA graphs
    args: tuple  # its inputs as CUDA tensors
    graphed: Callable  # one graphed solve on the same inputs
    out: Callable  # solve result -> the forces compared
    batch: int
    want: list  # K1..K4, L1 launches per solve
    kernel: Callable  # one launch of its QP kernel, on the path's first QP
    host_p50_ms: float  # graphed host p50
    replay_device_ms: float  # device ms summed over a profiled replay
    tol: float  # the kernel's tolerance against its plain version
    flops: Optional[float] = None  # centroidal_solve_flops, for mfu_pct


def timed_paths(kit, graph, pyramid, convex, convex_setup, convex_solve):
    """The paths of phase ``device_timing``: the five of
    ``graph_vs_eager``, the pyramid fleet of 128 of ``pyramid_fleet`` and
    the convex trot at 1 and 4096 of ``convex_mpc``, each with those
    phases' readings of it. The DDP solve (one graph of ~160,000 nodes) is
    left out: a chain would be k times that."""
    def seen(entry):  # a path's graphed host p50 and replay device ms
        return entry["graphed_ms"]["p50"], entry["replay"]["device_ms"]

    def force(sol):
        return sol.forces

    k1, k2, k3, k4 = kit.k1, kit.k2, kit.k3, kit.k4
    mpc, one, many = kit.mpc, kit.one, kit.many
    lone_np, lmany_np = kit.lone_np, kit.lmany_np
    glsolver, glsolver_pyr = kit.glsolver, kit.glsolver_pyr
    paths = graph["paths"]
    cent_flops = centroidal_solve_flops(*shape_of(kit.qp1), kit.qp1.con.ng,
                                        SQP_ITERS, IPM_ITERS)
    lsmall_np = tuple(a[:LEGGED_FLEET_SMALL] for a in lmany_np.args)
    qp_pyr_small = contig(kit.lsolver_pyr.initial_qp(*kit.lsmall))
    cvx1, cvxf = (convex_scenarios(b, "trot") for b in (1, CONVEX_FLEET))
    qp_cvx1, qp_cvxf = (contig(convex_solve.initial_qp(*a))
                        for a in (cvx1, cvxf))
    cvx_eager, cvx_ipm = convex_solve.__wrapped__, convex_setup[1]
    return [
        TimedPath("centroidal_batch1", kit.solver, kit.on_card(one),
                  lambda: mpc.solver(*one), lambda s: s.contact_force, 1,
                  [SQP_ITERS, 0, 0, 0, 0], lambda: k1(kit.qp1, kit.ipm),
                  *seen(paths["centroidal_batch1"]), TOL_PRIMAL,
                  cent_flops),
        TimedPath(f"centroidal_fleet{FLEET}", kit.solver, kit.on_card(many),
                  lambda: mpc.solver(*many), lambda s: s.contact_force,
                  FLEET, [0, SQP_ITERS, 0, 0, 0],
                  lambda: k2(kit.qpf, kit.ipm),
                  *seen(paths[f"centroidal_fleet{FLEET}"]),
                  TOL_PRIMAL, cent_flops),
        TimedPath("legged_soft_batch1", kit.lsolver, kit.lone,
                  lambda: glsolver(*lone_np.args), force, 1,
                  [0, 0, 1, 0, 1],
                  lambda: k3(kit.qpl, reg=kit.leg_reg),
                  *seen(paths["legged_soft_batch1"]), TOL_LEG_PLAIN),
        TimedPath("legged_pyramid_batch1", kit.lsolver_pyr, kit.lone,
                  lambda: glsolver_pyr(*lone_np.args), force, 1,
                  [1, 0, 0, 0, 1], lambda: k1(kit.qpp, kit.ipm_pyr),
                  *seen(paths["legged_pyramid_batch1"]),
                  TOL_LEG_PLAIN),
        TimedPath(f"legged_fleet{LEGGED_FLEET}", kit.lsolver, kit.lmany,
                  lambda: glsolver(*lmany_np.args), force, LEGGED_FLEET,
                  [0, 0, 0, 1, 1], lambda: k4(kit.qplf, reg=kit.leg_reg),
                  *seen(paths[f"legged_fleet{LEGGED_FLEET}"]),
                  TOL_LEG_PLAIN),
        TimedPath(f"legged_pyramid_fleet{LEGGED_FLEET_SMALL}",
                  kit.lsolver_pyr, kit.lsmall,
                  lambda: glsolver_pyr(*lsmall_np), force,
                  LEGGED_FLEET_SMALL, [0, 1, 0, 0, 1],
                  lambda: k2(qp_pyr_small, kit.ipm_pyr),
                  *seen(pyramid[f"batch{LEGGED_FLEET_SMALL}"]),
                  TOL_LEG_PLAIN),
        TimedPath("convex_trot_batch1", cvx_eager, kit.on_card(cvx1),
                  lambda: convex_solve(*cvx1), lambda s: s[0], 1,
                  [1, 0, 0, 0, 0],
                  lambda: k1(qp_cvx1, cvx_ipm),
                  *seen(convex["trot_batch1"]), TOL_PRIMAL),
        TimedPath(f"convex_trot_fleet{CONVEX_FLEET}", cvx_eager,
                  kit.on_card(cvxf), lambda: convex_solve(*cvxf),
                  lambda s: s[0], CONVEX_FLEET, [0, 1, 0, 0, 0],
                  lambda: k2(qp_cvxf, cvx_ipm),
                  *seen(convex[f"trot_batch{CONVEX_FLEET}"]),
                  TOL_PRIMAL)]


def phase_device_timing(kit, paths) -> dict:
    """Device ms per solve of each path (``timed_paths``) by the slope over
    chained CUDA-graph replays (``utils.device_timing.time_chain``), beside
    its graphed host p50 and its profiled replay's device ms from this run.
    Gated: the slope is positive and finite; the host issued every timed
    chain call in less time than the device ran it (so the device did not
    wait for the launch, ``time_chain``); the slope is at most
    ``SLOPE_OVER_P50`` times the host p50 and at least
    ``SLOPE_UNDER_KERNELS`` times the device time of the path's kernel
    launches per solve by CUDA events (``events_ms``); each chain ran the
    path's kernels once per solve in its warm-up calls and capture; the
    k_big chain's last solve equals one graphed solve on the same inputs
    within the kernel's tolerance against its plain version (the nudge
    changes nothing a solve can see)."""
    from cheeta_mpc_tpu_torch.utils.cuda_graph import WARMUP_CALLS
    dev = kit.dev
    t_start = time.perf_counter()
    report = {"phase": "device_timing", "card": kit.card,
              "chain_solves": {"batch1": CHAIN_BATCH1, "fleet": CHAIN_FLEET}}
    for p in paths:
        k_small, k_big = CHAIN_BATCH1 if p.batch == 1 else CHAIN_FLEET
        kernel_ms = sum(p.want[:4]) * events_ms(p.kernel)  # K1..K4
        kit.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time_chain(p.eager, p.args, k_small, k_big, device=dev)
        want = [(WARMUP_CALLS + 1) * (k_small + k_big) * w for w in p.want]
        check(kit.counts() == want,
              f"{p.name}: the chains' warm-up calls and captures launched "
              f"K1..K4, L1 {kit.counts()}x; expected {want}")
        ms = 1e3 * t.seconds
        check(math.isfinite(ms) and ms > 0,
              f"{p.name}: device time by slope {ms} ms")
        for k in (k_small, k_big):
            check(max(t.issue_s[k]) < min(t.chain_s[k]),
                  f"{p.name}: the host took {max(t.issue_s[k])} s to issue "
                  f"a chain of {k} that the device ran in "
                  f"{min(t.chain_s[k])} s: the device waited for the host")
        check(ms <= SLOPE_OVER_P50 * p.host_p50_ms,
              f"{p.name}: device time by slope {ms} ms is above "
              f"{SLOPE_OVER_P50} x the graphed host p50 {p.host_p50_ms} ms")
        check(ms >= SLOPE_UNDER_KERNELS * kernel_ms,
              f"{p.name}: device time by slope {ms} ms is below "
              f"{SLOPE_UNDER_KERNELS} x its kernels' {kernel_ms} ms")
        err = max_abs(p.out(t.output), p.out(p.graphed()))
        check(err <= p.tol, f"{p.name}: the k_big chain's last solve differs "
              f"from a graphed solve by {err}")
        row = {"device_ms": ms, "slopes_ms": [1e3 * s for s in t.slopes],
               "graphed_p50_ms": p.host_p50_ms,
               "replay_device_ms": p.replay_device_ms,
               "kernel_events_ms": kernel_ms, "k_small_big": [k_small, k_big],
               "chain_ms": {k: [1e3 * x for x in v]
                            for k, v in t.chain_s.items()},
               "issue_ms": {k: [1e3 * x for x in v]
                            for k, v in t.issue_s.items()},
               "chain_vs_graphed_max_abs": err,
               "chain_graphs": {k: {n: g[n] for n in ("nodes", "pool_bytes",
                                                      "capture_s")}
                                for k, g in t.graphs.items()},
               "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
        if p.flops is not None:
            row["mfu_pct"] = 100.0 * p.batch * p.flops / t.seconds / F32_FLOPS
        report[p.name] = row
    report["seconds"] = time.perf_counter() - t_start
    return report


def phase_projected_condensed(kit) -> dict:
    """The second equality mode and the condensed backend: the
    circular-kinematics OCP in both ``eq_mode``s (K3, on the reduced
    problem with one all-masked row in the projected mode), and the
    centroidal MPC under ``qp_backend='condensed'`` against the kernel
    backend."""
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import \
        build_centroidal_solver
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import (ScpSettings,
                                                  solve_nonlinear_ocp)
    from cheeta_mpc_tpu_torch.utils.cuda_graph import graphed
    dev, util, mpc = kit.dev, load_util(), kit.mpc
    report = {"phase": "projected_condensed", "card": kit.card}
    sols = {}
    for dtype, where in ((torch.float32, dev), (torch.float64, "cpu")):
        for mode in ("riccati", "projected"):
            lin, perf, x_init, u_init = util.circular_kinematics_problem(
                dtype, where)
            st = ScpSettings(iterations=CIRCLE_SQP_ITERS, eq_mode=mode,
                             alphas=CIRCLE_ALPHAS, ipm=IpmSettings(iters=10),
                             qp_backend="riccati_kernel" if where == dev
                             else "riccati")
            kit.reset_counts()
            t0 = time.perf_counter()
            res = solve_nonlinear_ocp(lin, perf, x_init, u_init, st)
            x, u = res.x.cpu(), res.u.cpu()
            wall = time.perf_counter() - t0
            if where == dev:
                check(kit.counts() == [0, 0, CIRCLE_SQP_ITERS, 0, 0],
                      f"circle ({mode}) launched K1..K4, L1 "
                      f"{kit.counts()}x; expected "
                      f"[0, 0, {CIRCLE_SQP_ITERS}, 0, 0]")
                report[f"circle_{mode}"] = {"k3_launches": kit.counts()[2],
                                            "eager_s": wall}
            sols[mode, where == dev] = (x, u)
    for mode in ("riccati", "projected"):
        x, u = sols[mode, True]
        d = x[:-1] + util.CIRCLE_DT * u - x[1:]
        g = (x[:-1] * u).sum(dim=-1)
        err64 = max(max_abs(x, sols[mode, False][0]),
                    max_abs(u, sols[mode, False][1]))
        check(bool(torch.isfinite(x).all()) and float((d * d).sum()) < 1e-8
              and float((g * g).sum()) < 1e-8 and err64 <= TOL_CIRCLE_F64,
              f"circle ({mode}): defects {float((d * d).sum())}, path "
              f"{float((g * g).sum())}, {err64} from the f64 CPU solve")
        report[f"circle_{mode}"]["err_vs_f64_cpu"] = err64
    modes = max(max_abs(sols["riccati", True][0], sols["projected", True][0]),
                max_abs(sols["riccati", True][1], sols["projected", True][1]))
    check(modes <= TOL_CIRCLE_MODES,
          f"circle: the two equality modes differ by {modes}")
    report["circle_modes_max_abs"] = modes
    # The centroidal MPC under the condensed backend (plain torch: dense
    # products and a batched Cholesky, as the JAX package computes it),
    # one CUDA graph per signature, against the kernel backend's graph.
    cond = graphed(build_centroidal_solver(
        kit.cfg, kit.scp._replace(qp_backend="condensed"), device=dev), dev)
    for name, args in (("batch1", kit.one), (f"fleet{FLEET}", kit.many)):
        tr, sol_c = kit.graphed_run(f"condensed {name}", lambda: cond(*args),
                                    [0, 0, 0, 0, 0])
        sol_k = mpc.solver(*args)
        torch.cuda.synchronize()
        grf = max_abs(sol_c.contact_force, sol_k.contact_force)
        check(bool(torch.isfinite(sol_c.contact_force).all())
              and grf <= TOL_GRF,
              f"condensed {name}: GRF differs from the kernel backend by "
              f"{grf} N")
        t_c = wall_spread(lambda: cond(*args).contact_force.cpu(),
                          n=CONDENSED_SOLVES)
        t_k = wall_spread(lambda: mpc.solver(*args).contact_force.cpu(),
                          n=CONDENSED_SOLVES)
        report[f"condensed_{name}"] = {
            "grf_vs_kernel_backend": grf, "replay": tr,
            "graphed_ms": t_c, "kernel_backend_graphed_ms": t_k}
    return report


def phase_mesh(kit, convex, solf) -> dict:
    """``parallel.mesh`` on the card: the convex trot fleet of 4096
    scenarios, every input with its batch dimension, sharded over
    ``make_mesh`` (this run's one card) against the unsharded eager solve,
    and ``aggregate_fleet_health`` / ``host_local_batch_to_global`` of the
    centroidal fleet's solver health through a one-process nccl group on a
    localhost store."""
    import socket
    import torch.distributed as dist
    from cheeta_mpc_tpu_torch.mpc.convex_mpc import build_convex_mpc
    from cheeta_mpc_tpu_torch.parallel import mesh as pm
    from cheeta_mpc_tpu_torch.solvers.scp import (CONV_METRICS, CONV_PRIMAL,
                                                  CONV_STEPSIZE)
    cfg, ipm = convex
    dev = kit.dev
    x0, ref, feet, enable = convex_scenarios(CONVEX_FLEET, "trot")
    args = (x0, ref, np.tile(feet, (CONVEX_FLEET, 1, 1)),
            np.tile(enable, (CONVEX_FLEET, 1, 1)))
    eager = build_convex_mpc(cfg, ipm, device=dev)
    unsharded, _ = getattr(eager, "__wrapped__", eager)(*args)
    mesh = pm.make_mesh(1)
    sharded = pm.sharded_batch_solver(
        lambda d: build_convex_mpc(cfg, ipm, device=d), mesh)
    tr, (f, _) = kit.graphed_run("sharded convex fleet",
                                 lambda: sharded(*args), [0, 1, 0, 0, 0])
    diff = max_abs(f, unsharded)
    check(torch.equal(f, unsharded), f"the sharded convex fleet differs "
          f"from the unsharded solve by {diff} N")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pm.initialize_distributed(f"localhost:{port}", 1, 0)
    try:
        gmesh = pm.make_global_mesh()
        check(dist.get_backend() == "nccl" and gmesh.distributed,
              f"expected a one-process nccl group: {gmesh}")
        health = pm.aggregate_fleet_health(gmesh, solf.qp_mu,
                                           solf.convergence, solf.merit)
        gathered = pm.host_local_batch_to_global(gmesh, (f,))[0]
    finally:
        dist.destroy_process_group()
    mer = solf.merit.double()
    finite = torch.isfinite(mer)
    conv = solf.convergence
    want = {"n_solves": mer.numel(),
            "n_converged": int(((conv == CONV_STEPSIZE)
                                | (conv == CONV_METRICS)
                                | (conv == CONV_PRIMAL)).sum()),
            "n_nonfinite": int((~finite).sum()),
            "mu_mean": float(solf.qp_mu.double()[finite].mean()),
            "mu_max": float(solf.qp_mu.double()[finite].max()),
            "merit_mean": float(mer[finite].mean())}
    got = {k: float(getattr(health, k)) for k in want}
    check(all(abs(got[k] - want[k]) <= 1e-9 * max(1.0, abs(want[k]))
              for k in want) and torch.equal(gathered, f),
          f"fleet health over nccl {got} != local reduction {want}")
    return {"phase": "mesh", "card": kit.card, "devices": len(mesh.devices),
            "batch": int(f.shape[0]), "replay": tr,
            "sharded_vs_unsharded_max_abs": diff,
            "fleet_health": got,
            "health_of": f"centroidal fleet of {FLEET}"}


def inverse_cases(n: int, count: int, seed: int) -> np.ndarray:
    """``count`` SPD matrices of width n: half conditioned like the barrier
    Hessian (a core of condition ~10 scaled by 1..1e3 on the diagonal,
    cond ~1e6), half sparse like an input Hessian G (a diagonal with
    couplings inside blocks of three and exact zeros elsewhere)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        if i % 2 == 0:
            A = rng.normal(size=(n, n))
            core = A @ A.T / n + 0.5 * np.eye(n)
            d = np.logspace(0, 3, n)
            rng.shuffle(d)
            out.append(d[:, None] * core * d[None, :])
        else:
            M = np.diag(rng.uniform(1.0, 1e3, n))
            for b in range(0, n - 1, 3):
                e = min(b + 3, n)
                B = rng.normal(size=(e - b, e - b))
                M[b:e, b:e] += B @ B.T
            out.append(M)
    return np.stack(out).astype(np.float32)


def phase_spd_inverse(dev, card) -> dict:
    """The IPM kernels' SPD inverse alone, by the probe that no solve
    launches: at each of INVERSE_WIDTHS the form the kernels take against
    the block form on the same matrices, bit for bit, with the cycles of
    each form per pivot (clock64 of thread 0, median over the blocks)."""
    from cheeta_mpc_tpu_torch.native.build import load_library
    from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati as tk
    lib = load_library()
    rows = {}
    for n in INVERSE_WIDTHS:
        M = torch.as_tensor(inverse_cases(n, INVERSE_BATCH, 500 + n),
                            device=dev)
        kernel_form = tk.inverse_form(lib, n)
        check(kernel_form == ("warp" if n <= tk.WARP_INVERSE_MAX
                              else "block"),
              f"the kernels take the {kernel_form} form of the SPD inverse "
              f"at n = {n}")
        got, cyc = tk.spd_inverse_probe(M, block_form=False)
        ref, cyc_block = tk.spd_inverse_probe(M, block_form=True)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        check(differ == 0,
              f"SPD inverse at n = {n}: the {kernel_form} form differs from "
              f"the block form in {differ} entries")
        check(bool(torch.isfinite(got).all()),
              f"SPD inverse at n = {n}: not finite")
        inv64 = torch.linalg.inv(M.double())
        rel = float(((got.double() - inv64).abs().amax(dim=(-2, -1))
                     / inv64.abs().amax(dim=(-2, -1))).max())
        rows[f"n{n}"] = {
            "form": kernel_form, "entries_differing_from_block": differ,
            "cycles_per_pivot": float(cyc.median()) / n,
            "block_cycles_per_pivot": float(cyc_block.median()) / n,
            "rel_err_vs_f64_not_gated": rel}
    return {"phase": "spd_inverse", "card": card, "batch": INVERSE_BATCH,
            "widths": rows}


def phase_legged_linearize(dev, card) -> dict:
    """L1 (``ops/cuda_legged_linearize.py``) against the solver's plain
    linearization (``initial_qp(..., plain=True)``, ``torch.func.jacfwd``)
    on the same CUDA tensors, on seeded legged inputs at the reference's
    scale: batch 1 and ``LEGGED_FLEET``, soft and pyramid cone, the uniform
    and the event-aligned grid, a trot and an all-stance contact table,
    RK2, and the Euler step on the trot's uniform grid, each from a
    perturbed warm start; every array within ``TOL_L1`` of the plain
    version relative to its largest entry, inactive equality rows of C and
    D exactly zero, one L1 launch per linearization and none by the plain
    version. Then graphed legged solves of one and two SQP iterations at
    both batches: the wrapper launches L1 once per SQP iteration in each
    warm-up call and the capture, and a profiled replay runs it once per
    iteration. Last, L1's time (``events_ms`` over ``L1_TIMED_LAUNCHES``
    launches) beside the bytes it reads and writes over the card's
    bandwidth, and the plain version's: ``initial_qp`` timed both ways
    (the references' set-up in both), the difference added to L1's."""
    from cheeta_mpc_tpu_torch.examples import (LEGGED_TEST_WEIGHTS,
                                               make_legged_example_inputs)
    from cheeta_mpc_tpu_torch.mpc import legged_mpc as lm
    from cheeta_mpc_tpu_torch.ops import cuda_legged_linearize as ll
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    from cheeta_mpc_tpu_torch.utils.cuda_graph import WARMUP_CALLS, graphed
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    report = {"phase": "legged_linearize", "card": card,
              "tolerance_rel": TOL_L1,
              "occupancy": ll.launch_occupancy(dev)}

    def config(cone, integrator="rk2"):
        cfg = lm.LeggedMpcConfig(horizon=LEGGED_HORIZON, cone_mode=cone,
                                 **LEGGED_TEST_WEIGHTS)
        return cfg._replace(params=cfg.params._replace(integrator=integrator))

    def inputs(cfg, batch, event, stance, seed):
        """The trot (or all-stance) scenario and a perturbed warm start, as
        CUDA tensors."""
        inp = make_legged_example_inputs(cfg, batch=batch, seed=seed,
                                         event_aligned=event)
        if stance:
            inp = inp._replace(enable=np.ones_like(inp.enable))
        rng = np.random.default_rng(seed)
        lead = () if batch is None else (batch,)
        n = cfg.horizon
        xw = (np.asarray(inp.x0)[..., None, :] + np.zeros(lead + (n + 1, 24))
              + 0.05 * rng.standard_normal(lead + (n + 1, 24)))
        uw = rng.standard_normal(lead + (n, 24)) * np.r_[np.full(12, 20.0),
                                                         np.full(12, 0.5)]
        uw[..., 2:12:3] += 70.0

        def card_(a):
            return None if a is None else torch.as_tensor(
                a, dtype=torch.float32, device=dev)

        return (tuple(card_(a) for a in inp.args),
                dict(warm=(card_(xw), card_(uw)), dts=card_(inp.dts)))

    def arrays(qp):
        return {"A": qp.dyn.A, "B": qp.dyn.B, "b": qp.dyn.b, "C": qp.eq.C,
                "D": qp.eq.D, "e": qp.eq.e, "q": qp.cost.q, "R": qp.cost.R,
                "r": qp.cost.r}

    instances = [(batch, cone, event, stance, "rk2")
                 for batch in (None, LEGGED_FLEET)
                 for cone in ("soft", "pyramid") for event in (False, True)
                 for stance in (False, True)]
    instances += [(batch, cone, False, False, "euler")
                  for batch in (None, LEGGED_FLEET)
                  for cone in ("soft", "pyramid")]
    worst, rows = 0.0, []
    for batch, cone, event, stance, integrator in instances:
        cfg = config(cone, integrator)
        solver = lm.build_legged_solver(cfg, device=dev)
        args, kwargs = inputs(cfg, batch, event, stance, len(rows) + 1)
        before = ll.legged_linearize.launches
        got = solver.initial_qp(*args, **kwargs)
        torch.cuda.synchronize()
        check(ll.legged_linearize.launches == before + 1,
              "L1: the solver's linearization on the card did not launch "
              "it once")
        want = solver.initial_qp(*args, plain=True, **kwargs)
        torch.cuda.synchronize()
        check(ll.legged_linearize.launches == before + 1,
              "L1: the plain linearization launched it")
        what = (f"L1 batch {batch or 1} {cone} "
                f"{'event' if event else 'uniform'} "
                f"{'stance' if stance else 'trot'} {integrator}")
        errs = {}
        for name, t in arrays(got).items():
            ref = arrays(want)[name]
            check(bool(torch.isfinite(t).all()),
                  f"{what}: {name} is not finite")
            errs[name] = max_abs(t, ref) / max(float(ref.abs().max()),
                                               1e-30)
            check(errs[name] <= TOL_L1,
                  f"{what}: {name} differs from the plain version by "
                  f"{errs[name]} of its largest entry")
        off = got.eq.mask.expand(got.eq.e.shape) == 0
        check(bool(off.any()) and bool((got.eq.C[off] == 0).all())
              and bool((got.eq.D[off] == 0).all()),
              f"{what}: an inactive equality row of C or D is not exactly "
              "zero")
        worst = max(worst, max(errs.values()))
        rows.append({"what": what, "rel_err": errs})
    report["against_plain"] = rows
    report["worst_rel_err"] = worst

    # Graphed solves: one L1 launch per SQP iteration.
    per_iteration = {}
    for iters in (1, 2):
        for batch in (None, LEGGED_FLEET):
            cfg = config("soft")
            inp = make_legged_example_inputs(cfg, batch=batch)
            solve = graphed(lm.build_legged_solver(
                cfg, ScpSettings(iterations=iters), device=dev), dev)
            before = ll.legged_linearize.launches
            solve(*inp.args)
            torch.cuda.synchronize()
            capture = ll.legged_linearize.launches - before
            check(capture == (WARMUP_CALLS + 1) * iters,
                  f"L1: a graphed legged solve of {iters} SQP iterations "
                  f"launched it {capture}x in its warm-up calls and capture; "
                  f"expected {(WARMUP_CALLS + 1) * iters}")
            before = ll.legged_linearize.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                solve(*inp.args)
                torch.cuda.synchronize()
            ran = sum(1 for e in prof.events()
                      if "legged_linearize_kernel" in e.name)
            check(ran == iters and ll.legged_linearize.launches == before,
                  f"L1: a profiled replay of {iters} SQP iterations at batch "
                  f"{batch or 1} ran it {ran}x and called its wrapper "
                  f"{ll.legged_linearize.launches - before}x; expected "
                  f"{iters} and none")
            per_iteration[f"iterations{iters}_batch{batch or 1}"] = ran
    report["replay_launches"] = per_iteration

    # Times, soft cone on the trot, uniform grid: the bytes L1 reads (the
    # trajectories and the references it takes) and writes, each once.
    times = {}
    for batch in (None, LEGGED_FLEET):
        cfg = config("soft")
        solver = lm.build_legged_solver(cfg, device=dev)
        args, kwargs = inputs(cfg, batch, False, False, 99)
        cap = {}
        launch = lm.legged_linearize

        def spy(*a, **k):
            cap.update(args=a, kwargs=k)
            return launch(*a, **k)

        lm.legged_linearize = spy
        try:
            solver.initial_qp(*args, **kwargs)
        finally:
            lm.legged_linearize = launch
        out = ll.legged_linearize(*cap["args"], **cap["kwargs"])
        nbytes = 4 * (sum(t.numel() for t in out if t is not None)
                      + sum(t.numel() for t in cap["args"]
                            if torch.is_tensor(t)))
        ms = events_ms(lambda: ll.legged_linearize(*cap["args"],
                                                   **cap["kwargs"]),
                       n=L1_TIMED_LAUNCHES)
        qp_ms = events_ms(lambda: solver.initial_qp(*args, **kwargs), n=3)
        plain_qp_ms = events_ms(
            lambda: solver.initial_qp(*args, plain=True, **kwargs), n=3)
        times[f"batch{batch or 1}"] = {
            "ms": ms, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes", "bytes": nbytes,
            "initial_qp_ms": qp_ms, "plain_initial_qp_ms": plain_qp_ms,
            "plain_ms": plain_qp_ms - qp_ms + ms}
    report["times"] = times
    report["seconds"] = time.perf_counter() - t_start
    return report


def shape_of(qp):
    return (qp.dyn.horizon, qp.dyn.nx, qp.dyn.nu)


class Kit:
    """What the phases share: the card, the kernel wrappers K1..K4 and L1
    with their launch counters, the centroidal and legged main paths'
    solvers and inputs, and the first QP of each main path."""

    def __init__(self, dev, card):
        from cheeta_mpc_tpu_torch.examples import (LEGGED_TEST_WEIGHTS,
                                                   TEST_WEIGHTS,
                                                   make_example_inputs,
                                                   make_legged_example_inputs)
        from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import (
            CentroidalMPC, build_centroidal_solver)
        from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                         build_legged_solver)
        from cheeta_mpc_tpu_torch.ops import cuda_eq_batch as eq_fleet_mod
        from cheeta_mpc_tpu_torch.ops import cuda_eq_riccati as eq_single_mod
        from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch as fleet_mod
        from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati as single_mod
        from cheeta_mpc_tpu_torch.ops import cuda_legged_linearize as l1_mod
        from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
        from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
        from cheeta_mpc_tpu_torch.utils.cuda_graph import graphed
        self.dev, self.card = dev, card
        self.single_mod, self.eq_single_mod = single_mod, eq_single_mod
        self.k1 = single_mod.solve_ocp_qp_kernel
        self.k1_plain = single_mod.solve_ocp_qp_plain
        self.k2 = fleet_mod.solve_ocp_qp_fleet
        self.k2_plain = fleet_mod.solve_ocp_qp_fleet_plain
        self.k3 = eq_single_mod.solve_eq_lqr_kernel
        self.k3_plain = eq_single_mod.solve_eq_lqr_plain
        self.k4 = eq_fleet_mod.solve_eq_lqr_fleet
        self.k4_plain = eq_fleet_mod.solve_eq_lqr_fleet_plain
        self.l1 = l1_mod.legged_linearize
        self.kernels = (self.k1, self.k2, self.k3, self.k4, self.l1)

        # The centroidal MPC on its default backend, the kernels; scp64
        # is the plain executor.
        self.ipm = IpmSettings(iters=IPM_ITERS)
        self.scp = ScpSettings(iterations=SQP_ITERS, ipm=self.ipm)
        self.scp64 = self.scp._replace(qp_backend="riccati")
        self.mpc = CentroidalMPC(MASS, 4, HORIZON, DT, TEST_WEIGHTS,
                                 [0.8] * 4, scp=self.scp).setup_mpc()
        self.cfg = self.mpc.config
        self.solver = build_centroidal_solver(self.cfg, self.scp, device=dev)
        self.one = make_example_inputs(self.cfg)
        self.many = make_example_inputs(self.cfg, batch=FLEET)

        # The legged task: the reference's configuration (horizon 67, dt
        # 0.015, RK2, friction 0.5, barrier mu 0.1 / delta 5.0,
        # position-error gain 20) with the stand-in Q/R of examples.py, on
        # the trot scenario; one SQP iteration on the kernels. The graphed
        # solvers are the ones the legged planning node builds.
        self.lcfg = LeggedMpcConfig(horizon=LEGGED_HORIZON, cone_mode='soft',
                                    **LEGGED_TEST_WEIGHTS)
        self.lcfg_pyr = self.lcfg._replace(cone_mode='pyramid')
        self.lscp = ScpSettings(iterations=1)
        self.ipm_pyr = IpmSettings(iters=PYRAMID_IPM_ITERS)
        self.lscp_pyr = ScpSettings(iterations=1, ipm=self.ipm_pyr)
        self.leg_reg = self.lscp.ipm.reg
        self.lsolver = build_legged_solver(self.lcfg, self.lscp, device=dev)
        self.lsolver_pyr = build_legged_solver(self.lcfg_pyr, self.lscp_pyr,
                                               device=dev)
        self.glsolver = graphed(self.lsolver, dev)
        self.glsolver_pyr = graphed(self.lsolver_pyr, dev)
        self.lone_np = make_legged_example_inputs(self.lcfg)
        self.lmany_np = make_legged_example_inputs(self.lcfg,
                                                   batch=LEGGED_FLEET)
        self.lone = self.on_card(self.lone_np.args)
        self.lmany = self.on_card(self.lmany_np.args)
        self.lsmall = tuple(a[:LEGGED_FLEET_SMALL] for a in self.lmany)

        # Each main path's first QP: centroidal batch 1 and fleet, legged
        # batch 1, fleet and small fleet, legged pyramid batch 1.
        self.qp1 = contig(self.solver.initial_qp(*self.one))
        self.qpf = contig(self.solver.initial_qp(*self.many))
        self.qpl = contig(self.lsolver.initial_qp(*self.lone))
        self.qplf = contig(self.lsolver.initial_qp(*self.lmany))
        self.qpls = contig(self.lsolver.initial_qp(*self.lsmall))
        self.qpp = contig(self.lsolver_pyr.initial_qp(*self.lone))

    def on_card(self, arrays):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=self.dev)
                     for a in arrays)

    def reset_counts(self):
        for k in self.kernels:
            k.launches = 0

    def counts(self):
        return [k.launches for k in self.kernels]

    def graphed_run(self, what, call, want):
        """A graphed path's main-path run: its first call (the warm-up
        calls and the capture, each through the kernel wrappers, whose
        counters count them) and then one replay under the profiler. A
        replay calls no wrapper, so its kernels are counted by name in the
        trace. Returns the trace and the replay's result."""
        from cheeta_mpc_tpu_torch.utils.cuda_graph import WARMUP_CALLS
        self.reset_counts()
        call()
        torch.cuda.synchronize()
        want_capture = [(WARMUP_CALLS + 1) * w for w in want]
        check(self.counts() == want_capture,
              f"{what}: the first call (warm-up calls and capture) launched "
              f"K1..K4, L1 {self.counts()}x; expected {want_capture}")
        self.reset_counts()
        tr, value = trace_counts(call)
        check(tr["kernels"] == want,
              f"{what}: a profiled replay ran K1..K4, L1 {tr['kernels']}x; "
              f"expected {want}")
        check(tr["graph_launches"] == 1 and self.counts() == IDLE,
              f"{what}: the second call made {tr['graph_launches']} graph "
              f"launches and called the kernel wrappers {self.counts()}x; "
              "expected one replay")
        return tr, value

    def placement_of(self, qp, settings):
        """Where K1 keeps ``qp``'s Riccati factors, and its shared bytes."""
        from cheeta_mpc_tpu_torch.native.build import load_library
        eq = qp.eq
        shape = (qp.dyn.horizon, qp.dyn.nx, qp.dyn.nu, qp.con.ng,
                 0 if eq is None else eq.nc)
        name, _, nbytes = self.single_mod.shared_memory_plan(
            load_library(), "cheeta_ipm_riccati_single", shape,
            settings.iters, self.dev)
        return name, nbytes


def check_centroidal_swing(grf, des_inputs, what: str) -> None:
    """Exact zeros on the legs that the contact table packed in
    ``des_inputs`` (leg i's flags at ``[i (4N + 3), i (4N + 3) + N)``)
    puts in swing; ``grf`` is ``(..., legs, 3, N)``."""
    des = np.asarray(des_inputs)
    enable = torch.as_tensor(np.stack(
        [des[..., i * (4 * HORIZON + 3):][..., :HORIZON] for i in range(4)],
        axis=-2), device=grf.device)  # (..., legs, N)
    swing = grf[(enable[..., :, None, :] == 0).expand_as(grf)]
    check(bool((swing == 0).all()), f"{what}: swing-leg forces are not "
          "exactly 0")


def phase_device(dev):
    """The card's name and power limit and the versions; returns the
    report and the card. Starts the profiler's device tracing once before
    any graph is captured, so that later traces see the kernels of every
    graph's replays."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    trace_counts(lambda: torch.ones(1, device=dev).sum())
    return {"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
            "cuda": torch.version.cuda}, card


def phase_build() -> dict:
    """The kernels, built from their sources in this run, with ptxas's
    registers and spills of every instantiation, by source."""
    from cheeta_mpc_tpu_torch.native import build
    build.load_library()
    ptxas, source = {}, None
    for ln in build.build_log.splitlines():
        if ln.startswith("$ ") and " -c " in ln:
            source = pathlib.Path(ln.split(" -c ")[1].split()[0]).name
        elif source and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(source, []).append(ln.split(": ")[-1].strip())
    check(build.build_seconds is not None,
          "the kernels were not built from the sources in this run")
    return {"phase": "build", "seconds": build.build_seconds,
            "sources": sorted(p.name for p in build.CSRC_DIR.glob("*.cu*")),
            "ptxas": ptxas}


def phase_kernel_vs_plain(kit) -> dict:
    """Each kernel against its plain version on the same CUDA tensors: K1
    on the centroidal QP and on seeded instances that reach its other code
    paths, K2 on the fleet's QP and at batch 1 against K1, K3 on the legged
    QP and on seeded instances, K4 on the legged fleet's QP and at batch 1
    against K3."""
    from cheeta_mpc_tpu_torch.native.build import load_library
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    dev, leg_reg, ipm = kit.dev, kit.leg_reg, kit.ipm
    k1, k1_plain, k2, k2_plain = kit.k1, kit.k1_plain, kit.k2, kit.k2_plain
    k3, k3_plain, k4, k4_plain = kit.k3, kit.k3_plain, kit.k4, kit.k4_plain
    s1, p1 = k1(kit.qp1, ipm), k1_plain(kit.qp1, ipm)
    torch.cuda.synchronize()
    err_k1 = compare_solutions(s1, p1, True, "K1, centroidal QP")

    # Seeded instances that reach the other code paths: stage equalities at
    # a small shape (factors in shared memory); the centroidal widths at
    # horizon 18; the legged shape, whose factors go to the global scratch
    # buffer; an input wider than one warp's tableau (nu = 36), whose SPD
    # inverse takes the block form. Six iterations bring mu to about 5e-4.
    # Further on, the barrier Hessian of this random family is numerically
    # singular in f32 at the wide shapes: the last factorization, whose step
    # the guard rejects, leaves non-finite gains in either executor. At
    # nu = 36 that happens at the sixth, so there the iterate alone is
    # compared.
    ipm_e = IpmSettings(iters=6)
    others = {}
    placements = {"k1_centroidal": kit.placement_of(kit.qp1, ipm)}
    for name, qp, gains in (
            ("k1_equalities", random_qp(7, dev), True),
            ("k1_horizon18", random_qp(8, dev, N=18, nx=33, nu=24, ng=32,
                                       nc=0), True),
            ("k1_legged_shape", random_qp(7, dev, **LEGGED_SHAPE), True),
            ("k1_past_the_warp", random_qp(7, dev, N=6, nu=36), False)):
        sk, pk = k1(qp, ipm_e), k1_plain(qp, ipm_e)
        torch.cuda.synchronize()
        others[name] = compare_solutions(sk, pk, gains, name)
        placements[name] = kit.placement_of(qp, ipm_e)
    check(sorted({name for name, _ in placements.values()})
          == sorted(n for n, _ in kit.single_mod.PLACEMENTS),
          f"the instances do not reach every placement: {placements}")

    sf, pf = k2(kit.qpf, ipm), k2_plain(kit.qpf, ipm)
    torch.cuda.synchronize()
    err_k2 = compare_solutions(sf, pf, False, f"K2, batch {FLEET}")
    check(bool(torch.isnan(sf.gains.K).all()),
          "K2 must return NaN gains")
    # The two kernels share their device code: problem 0 of the fleet is
    # the batch-1 problem only up to the scenario, so compare K2 on a fleet
    # of one against K1.
    qp11 = contig(kit.solver.initial_qp(*(a[None] for a in kit.one)))
    s11 = k2(qp11, ipm)
    torch.cuda.synchronize()
    k2_vs_k1 = max(max_abs(s11.du[0], s1.du), max_abs(s11.dx[0], s1.dx))
    check(k2_vs_k1 <= 1e-5, f"K2 at batch 1 differs from K1 by {k2_vs_k1}")

    # K3 on the legged task's own first QP and on the seeded instance at the
    # legged shape with its inequality rows dropped; K4 at batch 512 on the
    # fleet's first QP, and at batch 1 against K3 (same device code).
    s3, p3 = k3(kit.qpl, reg=leg_reg), k3_plain(kit.qpl, reg=leg_reg)
    torch.cuda.synchronize()
    err_k3 = compare_eq_solutions(s3, p3, TOL_EQ_TASK, True,
                                  "K3, legged QP")
    qpr = random_qp(7, dev, **LEGGED_SHAPE).replace(con=None)
    s3r, p3r = k3(qpr, reg=leg_reg), k3_plain(qpr, reg=leg_reg)
    torch.cuda.synchronize()
    err_k3r = compare_eq_solutions(s3r, p3r, TOL_EQ_RANDOM, True,
                                   "K3, random instance")
    # Shapes off the main path that K3/K4 keep taking: constraint widths
    # past one warp's register tableau (the inverse on a shared-memory
    # tableau), and a state wide enough that one stage slot is all that fits
    # a block (each stage's data loaded when the stage starts).
    err_k3_off = {}
    for name, shape in (("k3_wide_inverse", dict(N=6, nx=16, nu=40, nc=36)),
                        ("k3_one_stage_slot", dict(N=3, nx=110, nu=8,
                                                   nc=4))):
        qpo = random_qp(11, dev, ng=1, **shape).replace(con=None)
        dims, nbytes = kit.eq_single_mod.shared_memory_plan(
            load_library(), qpo)
        so, po = k3(qpo, reg=leg_reg), k3_plain(qpo, reg=leg_reg)
        torch.cuda.synchronize()
        err_k3_off[name] = compare_eq_solutions(so, po, TOL_EQ_RANDOM, True,
                                                f"K3, {name}")
        err_k3_off[name]["stage_slots_and_bytes"] = [dims[4], nbytes]
    s4, p4 = k4(kit.qplf, reg=leg_reg), k4_plain(kit.qplf, reg=leg_reg)
    torch.cuda.synchronize()
    err_k4 = compare_eq_solutions(s4, p4, TOL_EQ_TASK, False,
                                  f"K4, batch {LEGGED_FLEET}")
    check(bool(torch.isnan(s4.gains.P).all())
          and bool(torch.isnan(s4.gains.p).all()),
          "K4 must return a NaN value function (P, p)")
    qpl1 = contig(kit.lsolver.initial_qp(*(a[None] for a in kit.lone)))
    s41 = k4(qpl1, reg=leg_reg)
    torch.cuda.synchronize()
    k4_vs_k3 = max(max_abs(s41.du[0], s3.du), max_abs(s41.dx[0], s3.dx),
                   max_abs(s41.gains.K[0], s3.gains.K))
    check(k4_vs_k3 <= 1e-6 * max(1.0, float(s3.gains.K.abs().max())),
          f"K4 at batch 1 differs from K3 by {k4_vs_k3}")
    return {"phase": "kernel_vs_plain", "tolerance": {
        "dx_du": TOL_PRIMAL, "duals_slacks_rel": TOL_DUAL,
        "eq_task_rel": TOL_EQ_TASK, "eq_random_rel": TOL_EQ_RANDOM},
        "k1_centroidal": err_k1, **others, "k2_fleet": err_k2,
        "k2_batch1_vs_k1": k2_vs_k1, "k3_legged": err_k3,
        "k3_random_legged_shape": err_k3r, **err_k3_off, "k4_fleet": err_k4,
        "k4_batch1_vs_k3": k4_vs_k3,
        "kept_in_shared_memory_and_bytes": placements}


def phase_main_path_batch1(kit) -> dict:
    """The centroidal main path at batch 1: ``update_mpc`` runs one CUDA
    graph per input signature (the first call captures it, every later
    call replays it, ``graphed_run``). Forces against the f64 CPU solve and
    against the same solve through the plain executor on the card."""
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import \
        build_centroidal_solver
    tr1, sol1 = kit.graphed_run("centroidal batch-1 main path",
                                lambda: kit.mpc.update_mpc(*kit.one),
                                [SQP_ITERS, 0, 0, 0, 0])
    grf = sol1.contact_force  # (legs, 3, N)
    for name in ("contact_force", "foot_pos", "x_traj", "u_traj", "merit"):
        check(bool(torch.isfinite(getattr(sol1, name)).all()),
              f"batch 1: {name} is not finite")
    check(tuple(grf.shape) == (4, 3, HORIZON), f"GRF shape {grf.shape}")
    check_centroidal_swing(grf, kit.one[2], "batch 1")
    fz = grf[:, 2, :].sum(dim=0)
    fz_resid = check_vertical_force(sol1, "batch 1")
    ref64 = build_centroidal_solver(
        kit.cfg._replace(dtype=torch.float64), kit.scp64,
        device="cpu")(*kit.one)
    grf_err = max_abs(grf.cpu(), ref64.contact_force)
    check(grf_err <= TOL_GRF,
          f"batch-1 GRF differs from the f64 CPU solve by {grf_err} N")
    plain = build_centroidal_solver(kit.cfg, kit.scp64,
                                    device=kit.dev)(*kit.one)
    torch.cuda.synchronize()
    plain_err = max_abs(grf, plain.contact_force)
    check(plain_err <= TOL_KERNEL_VS_PLAIN,
          f"batch-1 GRF differs from the plain executor by {plain_err} N")
    return {"phase": "main_path_batch1", "k1_launches": tr1["kernels"][0],
            "total_fz": [round(v, 3) for v in fz.tolist()],
            "mg": MASS * GRAVITY, "fz_minus_m_g_plus_zdd": fz_resid,
            "grf_err_vs_f64_cpu": grf_err, "tolerance": TOL_GRF,
            "grf_err_vs_plain_executor": plain_err,
            "tolerance_plain": TOL_KERNEL_VS_PLAIN,
            "step_size": sol1.step_size.tolist(),
            "convergence": int(sol1.convergence)}


def phase_main_path_fleet(kit):
    """The centroidal main path on the fleet (a graph of its own), against
    the plain executor and element 0 against its batch-1 solve; returns the
    report and the solution."""
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import \
        build_centroidal_solver
    trf, solf = kit.graphed_run("centroidal fleet main path",
                                lambda: kit.mpc.update_mpc(*kit.many),
                                [0, SQP_ITERS, 0, 0, 0])
    check(tuple(solf.contact_force.shape) == (FLEET, 4, 3, HORIZON),
          f"fleet GRF shape {solf.contact_force.shape}")
    for name in ("contact_force", "foot_pos", "x_traj", "u_traj", "merit"):
        check(bool(torch.isfinite(getattr(solf, name)).all()),
              f"fleet: {name} is not finite")
    check_centroidal_swing(solf.contact_force, kit.many[2], "fleet")
    solp = build_centroidal_solver(kit.cfg, kit.scp64,
                                   device=kit.dev)(*kit.many)
    torch.cuda.synchronize()
    fleet_err = max_abs(solf.contact_force, solp.contact_force)
    check(fleet_err <= TOL_GRF,
          f"fleet GRF differs from the plain executor by {fleet_err} N")
    check(bool((solf.step_size == solp.step_size).all()),
          "fleet line-search steps differ from the plain executor's")
    sol0 = kit.mpc.update_mpc(*(a[0] for a in kit.many))
    torch.cuda.synchronize()
    el0_err = max_abs(solf.contact_force[0], sol0.contact_force)
    check(el0_err <= TOL_GRF,
          f"fleet element 0 differs from its batch-1 solve by {el0_err} N")
    fzf_resid = check_vertical_force(solf, "fleet")
    return {"phase": "main_path_fleet", "batch": FLEET,
            "k2_launches": trf["kernels"][1],
            "grf_err_vs_plain_executor": fleet_err,
            "element0_vs_batch1": el0_err, "tolerance": TOL_GRF,
            "fz_minus_m_g_plus_zdd": fzf_resid}, solf


def phase_legged_batch1(kit):
    """The legged main path at batch 1, soft cone: one K3 launch and one L1
    launch (one SQP iteration). The legged main-path phases hold the forces
    against an independent path only here: the f64 CPU solve linearizes by
    the plain version (jacfwd). The plain executor of the pyramid and fleet
    phases on the card runs L1 too, so there it checks the QP kernels
    alone; the fleet's element 0, the batch-1 scenario, is held to this
    solve, which is returned with the report."""
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import build_legged_solver
    kit.reset_counts()
    lsol = kit.lsolver(*kit.lone)
    torch.cuda.synchronize()
    launches = kit.counts()
    check(launches == [0, 0, 1, 0, 1],
          f"legged batch-1 main path launched K1..K4, L1 {launches}x; "
          "expected [0, 0, 1, 0, 1]")
    fz_lo, fz_hi = check_legged_forces(lsol, kit.lone[2], "legged batch 1")
    check(bool(torch.isfinite(lsol.gains_P).all()),
          "legged batch 1: K3 must return a finite value function")
    lref64 = build_legged_solver(
        kit.lcfg._replace(dtype=torch.float64),
        kit.lscp._replace(qp_backend="riccati"),
        device="cpu")(*kit.lone_np.args)
    leg_err = max_abs(lsol.forces.cpu(), lref64.forces)
    check(leg_err <= TOL_LEG_F64,
          f"legged batch-1 forces differ from the f64 CPU solve by "
          f"{leg_err} N")
    check(lsol.step_size.tolist() == lref64.step_size.tolist(),
          "legged batch 1: line-search steps differ from the f64 solve's")
    return {"phase": "legged_batch1", "horizon": LEGGED_HORIZON,
            "k3_launches": launches[2], "l1_launches": launches[4],
            "total_fz_min_max": [fz_lo, fz_hi],
            "mg": LEGGED_MG, "force_err_vs_f64_cpu": leg_err,
            "tolerance": TOL_LEG_F64, "step_size": lsol.step_size.tolist(),
            "convergence": int(lsol.convergence)}, lsol


def phase_legged_pyramid_batch1(kit) -> dict:
    """The legged main path at batch 1, pyramid cone: one K1 launch with 20
    pyramid rows and 16 masked stage equalities, factors in the global
    scratch buffer."""
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import build_legged_solver
    lcfg_pyr = kit.lcfg_pyr
    pyr_placement = kit.placement_of(kit.qpp, kit.ipm_pyr)
    check(pyr_placement[0] == "none",
          f"the legged pyramid QP was expected to keep its factors in "
          f"global memory, got placement {pyr_placement}")
    kit.reset_counts()
    psol = kit.lsolver_pyr(*kit.lone)
    torch.cuda.synchronize()
    launches_k1 = kit.k1.launches
    check(kit.counts() == [1, 0, 0, 0, 1],
          f"legged pyramid main path launched K1..K4, L1 {kit.counts()}x; "
          "expected [1, 0, 0, 0, 1]")
    enable = kit.lone[2]
    pfz_lo, pfz_hi = check_legged_forces(psol, enable, "legged pyramid")
    check(bool(torch.isfinite(psol.gains_K).all()),
          f"legged pyramid: non-finite gains after {PYRAMID_IPM_ITERS} IPM "
          "iterations")
    pyr_viol = pyramid_violation(psol.forces, enable, lcfg_pyr.friction_mu,
                                 lcfg_pyr.force_max)
    check(pyr_viol <= TOL_PYRAMID,
          f"legged pyramid: a stance force leaves the pyramid by "
          f"{pyr_viol} N")
    pplain = build_legged_solver(
        lcfg_pyr, kit.lscp_pyr._replace(qp_backend="riccati"),
        device=kit.dev)(*kit.lone)
    torch.cuda.synchronize()
    pyr_err = max_abs(psol.forces, pplain.forces)
    check(pyr_err <= TOL_LEG_PLAIN,
          f"legged pyramid forces differ from the plain executor by "
          f"{pyr_err} N")
    check(psol.step_size.tolist() == pplain.step_size.tolist(),
          "legged pyramid: line-search steps differ from the plain "
          "executor's")
    return {"phase": "legged_pyramid_batch1", "ipm_iters": PYRAMID_IPM_ITERS,
            "k1_launches": launches_k1,
            "kept_in_shared_memory_and_bytes": pyr_placement,
            "total_fz_min_max": [pfz_lo, pfz_hi],
            "outside_pyramid": pyr_viol, "tolerance_pyramid": TOL_PYRAMID,
            "force_err_vs_plain_executor": pyr_err,
            "tolerance": TOL_LEG_PLAIN, "qp_mu": float(psol.qp_mu),
            "step_size": psol.step_size.tolist()}


def phase_legged_fleet(kit, lsol) -> dict:
    """The legged main path on a fleet of 512 scenarios: one K4 launch,
    against the plain executor, element 0 against its batch-1 solve
    ``lsol``."""
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import build_legged_solver
    kit.reset_counts()
    lsolf = kit.lsolver(*kit.lmany)
    torch.cuda.synchronize()
    launches_k4 = kit.k4.launches
    check(kit.counts() == [0, 0, 0, 1, 1],
          f"legged fleet main path launched K1..K4, L1 {kit.counts()}x; "
          "expected [0, 0, 0, 1, 1]")
    ffz_lo, ffz_hi = check_legged_forces(lsolf, kit.lmany[2], "legged fleet")
    check(bool(torch.isnan(lsolf.gains_P).all())
          and bool(torch.isfinite(lsolf.gains_K).all()),
          "legged fleet: expected NaN P and finite K from K4")
    lplain = build_legged_solver(
        kit.lcfg, kit.lscp._replace(qp_backend="riccati"),
        device=kit.dev)(*kit.lmany)
    torch.cuda.synchronize()
    lfleet_err = max_abs(lsolf.forces, lplain.forces)
    check(lfleet_err <= TOL_LEG_PLAIN,
          f"legged fleet forces differ from the plain executor by "
          f"{lfleet_err} N")
    check(bool((lsolf.step_size == lplain.step_size).all()),
          "legged fleet line-search steps differ from the plain executor's")
    lel0_err = max_abs(lsolf.forces[0], lsol.forces)
    check(lel0_err <= TOL_LEG_PLAIN,
          f"legged fleet element 0 differs from its batch-1 solve by "
          f"{lel0_err} N")
    return {"phase": "legged_fleet", "batch": LEGGED_FLEET,
            "k4_launches": launches_k4, "total_fz_min_max": [ffz_lo, ffz_hi],
            "force_err_vs_plain_executor": lfleet_err,
            "element0_vs_batch1": lel0_err, "tolerance": TOL_LEG_PLAIN}


def kernel_shapes(kit):
    """The launch shapes of phases ``kernel_phases`` and ``occupancy``:
    ``(name, entry, qp, settings)`` of K1/K2 and ``(name, entry, qp)`` of
    K3/K4."""
    eq = kit.eq_single_mod
    return ((("k1_centroidal", "cheeta_ipm_riccati_single", kit.qp1,
              kit.ipm),
             ("k1_legged_pyramid", "cheeta_ipm_riccati_single", kit.qpp,
              kit.ipm_pyr),
             (f"k2_batch{FLEET}", "cheeta_ipm_riccati_fleet", kit.qpf,
              kit.ipm)),
            (("k3_legged", eq.SINGLE_ENTRY, kit.qpl),
             (f"k4_batch{LEGGED_FLEET}", eq.FLEET_ENTRY, kit.qplf),
             (f"k4_batch{LEGGED_FLEET_SMALL}", eq.FLEET_ENTRY, kit.qpls)))


def phase_kernel_phases(kit) -> dict:
    """Inside the kernels: timed launches per shape (section timers:
    cycles of thread 0 per class of barrier phase) beside plain ones
    (``untimed_ms``), so that the timers' own cost shows."""
    shapes, eq_shapes = kernel_shapes(kit)
    phases = {name: kit.single_mod.phase_cycles(entry, qp, st)
              for name, entry, qp, st in shapes}
    phases.update({name: kit.eq_single_mod.phase_cycles(entry, qp,
                                                        reg=kit.leg_reg)
                   for name, entry, qp in eq_shapes})
    for ph in phases.values():
        ph["timed_over_untimed"] = ph["timed_ms"] / ph["untimed_ms"]
    return {"phase": "kernel_phases", "card": kit.card, **phases}


def phase_occupancy(kit) -> dict:
    """What the card makes of each launch shape: blocks or problems per
    SM, registers, spills and waves. Gated: two K2 blocks and four K4
    problems per SM."""
    shapes, eq_shapes = kernel_shapes(kit)
    occupancy = {name: kit.single_mod.launch_occupancy(entry, qp, st)
                 for name, entry, qp, st in shapes}
    sms = torch.cuda.get_device_properties(kit.dev).multi_processor_count
    for (name, _, qp, _), occ in zip(shapes, occupancy.values()):
        blocks = qp.dx0.shape[0] if qp.dx0.dim() == 2 else 1
        occ["waves"] = -(-blocks // (sms * occ["blocks_per_sm"]))
    occupancy.update({name: kit.eq_single_mod.launch_occupancy(entry, qp)
                      for name, entry, qp in eq_shapes})
    check(occupancy[f"k2_batch{FLEET}"]["blocks_per_sm"] >= 2,
          f"K2 at batch {FLEET} holds fewer than two blocks per SM: "
          f"{occupancy[f'k2_batch{FLEET}']}")
    k4_occ = occupancy[f"k4_batch{LEGGED_FLEET}"]
    check(k4_occ["problems_per_sm"] >= 4,
          f"K4 at batch {LEGGED_FLEET} holds fewer than four problems per "
          f"SM: {k4_occ}")
    return {"phase": "occupancy", "sms": sms, **occupancy}


def phase_k4_batch_sweep(kit) -> dict:
    """K4 on the legged fleet's QP, repeated along the batch: kernel ms,
    problems/s, bound and waves at each of ``SWEEP_BATCHES``."""
    from cheeta_mpc_tpu_torch.core.types import tree_map
    k4, leg_reg = kit.k4, kit.leg_reg

    def fleet_of(batch):
        reps = -(-batch // LEGGED_FLEET)
        return contig(tree_map(
            lambda t: (t.repeat((reps,) + (1,) * (t.dim() - 1))[:batch]
                       if t.dim() and t.shape[0] == LEGGED_FLEET else t),
            kit.qplf))

    sweep = {}
    for batch in SWEEP_BATCHES:
        qpb = fleet_of(batch)
        sb = k4(qpb, reg=leg_reg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(sb.du).all()),
              f"K4 at batch {batch}: du is not finite")
        ms = median_ms(lambda: k4(qpb, reg=leg_reg), repeats=5)
        (bb, byb), _ = bound(qpb, [sb.dx, sb.du, sb.gains.K, sb.gains.k],
                             batch * eq_flops(*shape_of(qpb), qpb.eq.nc))
        occ = kit.eq_single_mod.launch_occupancy(
            kit.eq_single_mod.FLEET_ENTRY, qpb)
        sweep[batch] = {"ms": ms, "problems_per_s": 1e3 * batch / ms,
                        "bound_ms": bb, "bound_by": byb,
                        "waves": occ["waves"]}
        del qpb, sb
    return {"phase": "k4_batch_sweep", "card": kit.card, "batches": sweep}


def phase_graph_vs_eager(kit) -> dict:
    """Each main path as one CUDA graph per solve against its eager run on
    the same inputs, as numpy: the graphed solvers of the entry points (the
    one ``CentroidalMPC.update_mpc`` calls; ``utils.cuda_graph.graphed``
    around the legged solver, as the legged planning node builds it).
    Gated: results equal bit for bit, K1..K4 and L1 by name in a profiled
    replay, no kernel wrapper called, 0 host kernel launches and 1 graph
    launch per solve. The graphed host p50 is read by phase
    ``device_timing``."""
    graph_paths = (
        ("centroidal_batch1", kit.solver, kit.mpc.solver, kit.one,
         "contact_force", [SQP_ITERS, 0, 0, 0, 0]),
        (f"centroidal_fleet{FLEET}", kit.solver, kit.mpc.solver, kit.many,
         "contact_force", [0, SQP_ITERS, 0, 0, 0]),
        ("legged_soft_batch1", kit.lsolver, kit.glsolver,
         kit.lone_np.args, "forces", [0, 0, 1, 0, 1]),
        ("legged_pyramid_batch1", kit.lsolver_pyr, kit.glsolver_pyr,
         kit.lone_np.args, "forces", [1, 0, 0, 0, 1]),
        (f"legged_fleet{LEGGED_FLEET}", kit.lsolver, kit.glsolver,
         kit.lmany_np.args, "forces", [0, 0, 0, 1, 1]))
    graph_report = {}
    for name, eager, graph_fn, args, out_name, want in graph_paths:
        graph_fn(*args)  # captures the graph if this signature has none
        torch.cuda.synchronize()

        def to_host(sol, out_name=out_name):
            return getattr(sol, out_name).cpu(), sol.u_traj.cpu()

        def replay(graph_fn=graph_fn, args=args, to_host=to_host):
            sol = graph_fn(*args)
            to_host(sol)
            return sol

        kit.reset_counts()
        tr, sol_g = trace_counts(replay)
        check(tr["kernels"] == want and kit.counts() == IDLE,
              f"{name}: a profiled replay ran K1..K4, L1 {tr['kernels']}x and "
              f"called their wrappers {kit.counts()}x; expected {want} and "
              "none")
        check(tr["host_kernel_launches"] == 0 and tr["graph_launches"] == 1,
              f"{name}: a graphed solve made {tr['host_kernel_launches']} "
              f"kernel launches and {tr['graph_launches']} graph launches "
              "on the host; expected 0 and 1")
        sol_e = eager(*args)
        torch.cuda.synchronize()
        # A replay runs the kernels of the eager solve on the same inputs in
        # the same order, and none of them sums in a run-dependent order:
        # the results are equal bit for bit (measured on an H100 on all five
        # paths), and that is the gate.
        diff = {k: max_abs(getattr(sol_g, k), getattr(sol_e, k))
                for k in (out_name, "x_traj", "u_traj", "merit",
                          "step_size")}
        bit_equal = all(torch.equal(getattr(sol_g, k), getattr(sol_e, k))
                        for k in diff)
        check(bit_equal, f"{name}: graphed and eager results differ: {diff}")
        tr_eager, _ = trace_counts(lambda: to_host(eager(*args)))
        graph_report[name] = {
            "graphed_vs_eager_max_abs": diff, "bit_equal": bit_equal,
            "replay": tr,
            "eager_host_kernel_launches": tr_eager["host_kernel_launches"],
            "eager_device_ms": tr_eager["device_ms"],
            "graph": graph_fn.entry_of(*args).stats,
            "graphed_ms": wall_spread(lambda: to_host(graph_fn(*args)))}
    return {"phase": "graph_vs_eager", "card": kit.card,
            "graphed_solves": GRAPH_SOLVES, "paths": graph_report}


def phase_closed_loop(kit) -> dict:
    """The on-device loop: a cold solve and ``LOOP_TICKS`` warm-started
    receding-horizon ticks on an all-stance hold, captured as one graph;
    against a warm re-solve at tick 0 and the f64 CPU loop."""
    from cheeta_mpc_tpu_torch.examples import make_example_inputs
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import \
        build_centroidal_mpc_loop
    cfg, scp, solver = kit.cfg, kit.scp, kit.solver
    stance = make_example_inputs(cfg, gait="stance")
    loop = build_centroidal_mpc_loop(cfg, scp, n_ticks=LOOP_TICKS,
                                     device=kit.dev)
    want_loop = [SQP_ITERS * (LOOP_TICKS + 1), 0, 0, 0, 0]
    tr_loop, (xs, fs) = kit.graphed_run("closed loop", lambda: loop(*stance),
                                        want_loop)
    cold = solver(*stance)
    check(tuple(xs.shape) == (LOOP_TICKS, cold.x_traj.shape[-1])
          and tuple(fs.shape) == (LOOP_TICKS, 4, 3),
          f"closed loop: shapes {tuple(xs.shape)}, {tuple(fs.shape)}")
    check(bool(torch.isfinite(xs).all()) and bool(torch.isfinite(fs).all()),
          "closed loop: non-finite states or forces")
    loop_fz = fs[:, :, 2].sum(dim=1)
    mg = MASS * GRAVITY
    check(bool(((loop_fz - mg).abs() < 0.05 * mg).all()),
          f"closed loop: total Fz {loop_fz.tolist()} leaves m g = {mg} N "
          "by more than 5 %")
    dz = float((xs[-1, 2] - xs[0, 2]).abs())
    check(dz < 0.01, f"closed loop: CoM height drifts by {dz} m")
    warm1 = solver(*stance, warm=(cold.x_traj, cold.u_traj))
    tick0 = max_abs(fs[0], warm1.contact_force[..., 0])
    check(tick0 <= 1e-4,
          f"closed loop: tick 0 differs from the warm re-solve by {tick0} N")
    xs64, fs64 = build_centroidal_mpc_loop(
        cfg._replace(dtype=torch.float64), kit.scp64, n_ticks=LOOP_TICKS,
        device="cpu")(*stance)
    loop_err = max_abs(fs.cpu(), fs64)
    check(loop_err <= TOL_GRF,
          f"closed loop: forces differ from the f64 CPU loop by {loop_err} N")
    loop_wall = wall_spread(lambda: [t.cpu() for t in loop(*stance)], n=20,
                            warmup=1)
    return {"phase": "closed_loop", "card": kit.card, "ticks": LOOP_TICKS,
            "closed_loop_hz": 1e3 * LOOP_TICKS / loop_wall["p50"],
            "replay_ms": loop_wall, "k1_launches": tr_loop["kernels"][0],
            "replay": tr_loop, "graph": loop.entry_of(*stance).stats,
            "total_fz_min_max": [float(loop_fz.min()), float(loop_fz.max())],
            "com_z_drift": dz, "tick0_vs_warm_solve": tick0,
            "force_err_vs_f64_cpu_loop": loop_err,
            "state_err_vs_f64_cpu_loop": max_abs(xs.cpu(), xs64),
            "tolerance": TOL_GRF}


def phase_legged_node(kit):
    """The legged planning node at the reference's scale, soft and pyramid
    cone, one SQP iteration per solve (the reference's real-time
    iteration), driven by the lock-step dummy loop, plant == model.
    Returns the report and the soft node's observations, which phase
    ``legged_ddp`` answers."""
    from cheeta_mpc_tpu_torch.models.srbd_legged import srbd_step
    from cheeta_mpc_tpu_torch.mpc.legged_node import (LeggedPlannerAssembly,
                                                      PlannerSettings,
                                                      default_stance_state)
    from cheeta_mpc_tpu_torch.mpc.runtime import (MpcMrtInterface,
                                                  SystemObservation,
                                                  run_dummy_loop)
    from cheeta_mpc_tpu_torch.utils.cuda_graph import WARMUP_CALLS
    from cheeta_mpc_tpu_torch.utils.timing import Benchmarker
    dev = kit.dev
    node_report = {}
    for mode, ncfg, want in (("soft", kit.lcfg, [0, 0, 1, 0, 1]),
                             ("pyramid", kit.lcfg_pyr, [1, 0, 0, 0, 1])):
        gait = node_gait()
        x0 = default_stance_state(ncfg)
        node = LeggedPlannerAssembly(
            ncfg, gait, x0, v_cmd=np.array([NODE_SPEED, 0.0, 0.0]),
            settings=PlannerSettings(sqp_iterations=1,
                                     ipm_iterations=PYRAMID_IPM_ITERS),
            device=dev)
        solutions = []
        node_solve = node._solve

        def recording(*args, node_solve=node_solve, solutions=solutions,
                      **kwargs):
            sol = node_solve(*args, **kwargs)
            solutions.append((sol, args[2]))
            return sol

        node._solve = recording

        def plant(t, x, u, gait=gait, params=ncfg.params):
            e = gait.get_mode_schedule(max(0.0, t - 1.0), t + 1.0)\
                .contact_flags_at(t + 0.5 * NODE_MRT_DT)
            return srbd_step(params, torch.as_tensor(x), torch.as_tensor(u),
                             torch.as_tensor(np.asarray(e, np.float64)),
                             dt=NODE_MRT_DT).numpy()

        kit.reset_counts()
        res = run_dummy_loop(MpcMrtInterface(node.solve_fn), plant, x0=x0,
                             mrt_dt=NODE_MRT_DT, mpc_update_ratio=NODE_RATIO,
                             n_steps=NODE_STEPS)
        # The first solve captures the graph after the warm-up solves; every
        # later solve replays it and calls no kernel wrapper.
        capture_counts = kit.counts()
        want_run = [(WARMUP_CALLS + 1) * w for w in want]
        check(capture_counts == want_run and len(node_solve.graphs) == 1,
              f"legged node ({mode}): K1..K4, L1 launched {capture_counts}x "
              "and "
              f"{len(node_solve.graphs)} graphs captured over {res.solves} "
              f"solves; expected {want_run} and one graph")
        check(np.isfinite(res.states).all(),
              f"legged node ({mode}): non-finite plant states")
        fz_range = [np.inf, -np.inf]
        pyr_viol = 0.0
        for i, (sol, enable) in enumerate(solutions):
            en = torch.as_tensor(enable, device=dev)
            lo, hi = check_legged_forces(sol, en, f"legged node ({mode}), "
                                         f"solve {i}")
            fz_range = [min(fz_range[0], lo), max(fz_range[1], hi)]
            if mode == "pyramid":
                pyr_viol = max(pyr_viol, pyramid_violation(
                    sol.forces, en, ncfg.friction_mu, ncfg.force_max))
        check(pyr_viol <= TOL_PYRAMID,
              f"legged node ({mode}): a stance force leaves the pyramid by "
              f"{pyr_viol} N")
        obs = SystemObservation(time=res.times[-1], state=res.states[-1])
        kit.reset_counts()
        tr_node, _ = trace_counts(lambda: node.solve_fn(obs))
        check(tr_node["kernels"] == want and kit.counts() == IDLE
              and tr_node["graph_launches"] == 1,
              f"legged node ({mode}): a profiled solve ran K1..K4, L1 "
              f"{tr_node['kernels']}x in {tr_node['graph_launches']} graph "
              f"launches and called their wrappers {kit.counts()}x; "
              f"expected {want} in one and none")
        steady = Benchmarker()
        steady.samples_ms = node.bench.samples_ms[1:]  # after the capture
        if mode == "soft":  # the observations phase legged_ddp answers
            sqp_observations = list(zip(res.times[:-1:NODE_RATIO],
                                        res.states[:-1:NODE_RATIO]))
        node_report[mode] = {
            "solves": res.solves, "first_solve_ms": node.bench.samples_ms[0],
            "solve_ms_p50": steady.percentile_ms(50),
            "solve_ms_p99": steady.percentile_ms(99),
            "solve_ms_max": max(steady.samples_ms),
            "p50_within_20ms": steady.percentile_ms(50) <= BUDGET_MS,
            "p99_within_30ms": steady.percentile_ms(99) <= BUDGET_P99_MS,
            "capture_counts_k1_k4_l1": capture_counts, "replay": tr_node,
            "total_fz_min_max": fz_range, "mg": LEGGED_MG,
            "outside_pyramid": pyr_viol if mode == "pyramid" else None,
            "progress_x_m": float(res.states[-1, 6] - x0[6]),
            "height_change_max_m": float(np.abs(res.states[:, 8]
                                                - x0[8]).max()),
            "roll_pitch_max": float(np.abs(res.states[:, 10:12]).max()),
            "last_metrics": node.last_metrics}
    return {"phase": "legged_node", "card": kit.card,
            "horizon": LEGGED_HORIZON, "speed": NODE_SPEED,
            "mrt_dt": NODE_MRT_DT,
            "mpc_hz": 1.0 / (NODE_MRT_DT * NODE_RATIO),
            "seconds_simulated": NODE_MRT_DT * NODE_STEPS,
            **node_report}, sqp_observations


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a GPU only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    report, card = phase_device(dev)
    emit(report)
    emit(phase_build())
    emit(phase_spd_inverse(dev, card))
    kit = Kit(dev, card)
    emit(phase_kernel_vs_plain(kit))
    emit(phase_main_path_batch1(kit))
    report, solf = phase_main_path_fleet(kit)
    emit(report)
    report, lsol = phase_legged_batch1(kit)
    emit(report)
    emit(phase_legged_pyramid_batch1(kit))
    emit(phase_legged_fleet(kit, lsol))
    emit(phase_legged_linearize(dev, card))
    emit(phase_kernel_phases(kit))
    emit(phase_occupancy(kit))
    emit(phase_k4_batch_sweep(kit))
    graph = phase_graph_vs_eager(kit)
    emit(graph)
    emit(phase_closed_loop(kit))
    report, sqp_observations = phase_legged_node(kit)
    emit(report)
    pyramid = phase_pyramid_fleet(kit)
    emit(pyramid)
    convex, convex_setup, convex_solve = phase_convex_mpc(kit)
    emit(convex)
    emit(phase_device_timing(kit, timed_paths(
        kit, graph, pyramid, convex, convex_setup, convex_solve)))
    emit(phase_projected_condensed(kit))
    emit(phase_mesh(kit, convex_setup, solf))
    emit(phase_legged_ddp(kit, sqp_observations))
    emit(phase_launch(dev, card))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    # The run uses one card, whatever the host holds.
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
