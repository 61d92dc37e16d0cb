"""The port's benchmark: the BASELINE metrics on one card, in a process that
runs no profiler. Counterpart of the JAX package's ``bench.py``.

    python3 -m cheeta_mpc_tpu_torch.bench                 # on the card
    python3 -m cheeta_mpc_tpu_torch.bench --small --device cpu

Prints progress on lines that start with ``#`` and ONE JSON line last. The
paths, scenarios and settings are ``bench.py``'s, each run through the
port's entry points (``build_centroidal_solver``,
``build_centroidal_mpc_loop``, ``build_legged_solver``) as one CUDA graph
per call signature (``utils.cuda_graph.graphed``, the port's ``jax.jit``):

- the centroidal fleet (N=10) at 1024 scenarios, 2 SQP x 10 IPM through K2,
  under two settings: ``bench.py``'s "scan" path, at
  ``matmul_precision='high'`` (TF32 here), and its "fleet" path, at the
  default precision. ``value`` is the better of their wall rates;
- the centroidal batch-1 cold solve (2 x 10, K1) and the warm-started
  real-time tick (1 SQP x 6 IPM from the previous solution shifted one
  node, the shift inside the graph: one K1 per tick);
- the on-device loop of 20 such ticks (``closed_loop_hz``);
- the legged task at N=67: soft cone at batch 1 (K3), pyramid cone at batch
  1 (K1 with stage equalities, 10 IPM iterations), soft cone batched at 512
  and 128 (K4, ``matmul_precision='high'``).

The legged configuration is built in code with the stand-in weights of
``examples.LEGGED_TEST_WEIGHTS`` (horizon 67, the reference's dt, RK2 and
friction settings): ``bench.py`` reads the reference's task.info, which is
not in the repository.

Timing. A wall time starts with the inputs on the device and stops once the
output has been read to the host (``bench.py``'s ``_percentiles``). Device
ms per solve come from ``utils.device_timing.device_time_per_call`` (the
slope over chained CUDA-graph replays; chains of 4 and 20 solves at batch
1, of 2 and 8 for fleets). ``mfu_pct`` is batch x
``centroidal_solve_flops(10, 33, 24, 32, 2, 10)`` / device s /
``F32_FLOPS``. Nothing here starts a profiler: a profiler session raises
what a graph launch costs the host for the rest of the process.

Launches. Each path's first call runs the graph's warm-up calls and its
capture through the kernel wrappers: their counters must read (warm-up
calls + 1) x the path's K1..K4 launches per solve, and a replay must call
no wrapper. The ``kernels`` field reports the launches per solve of each
path (zero on the CPU, where the wrappers run their plain versions).

Oracles and gates. Where ``bench.py`` holds a kernel against its scan
executor, this program holds the kernel path against the same solve
through the plain executor on the same device (``qp_backend='riccati'``);
"scan" in a key name means that plain executor, or, in
``fleet_vs_scan_grf_err_N``, the "scan" setting above. Each bound is the
tighter of ``bench.py``'s and ``chip_smoke.py``'s for the pair. A failed
gate raises; nothing is caught.

``--small`` (for tests): centroidal batch 4, legged horizon 8, legged
batches 4 and 2, 3 loop ticks, 3 repetitions per percentile, chains of 1
and 2 solves. The default runs the full widths and depths above. The
entry runs on the card; ``--device cpu`` is the only way onto the CPU
(plain versions of the kernels, host clock for the chains).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cheeta_mpc_tpu_torch.examples import (LEGGED_TEST_WEIGHTS, TEST_WEIGHTS,
                                           make_example_inputs)
from cheeta_mpc_tpu_torch.models.centroidal import GRAVITY
from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import (
    CentroidalMpcConfig, build_centroidal_mpc_loop, build_centroidal_solver)
from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                 build_legged_solver)
from cheeta_mpc_tpu_torch.ops import cuda_eq_batch, cuda_eq_riccati
from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch, cuda_ipm_riccati
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
from cheeta_mpc_tpu_torch.utils.cuda_graph import WARMUP_CALLS, graphed
from cheeta_mpc_tpu_torch.utils.device_timing import (F32_FLOPS,
                                                      centroidal_solve_flops,
                                                      device_time_per_call)

HORIZON = 10
# Settings of bench.py's paths (bench.py:186-187, 228-230, 255-256, 278-279,
# 314-315, 349-350, 379-380, 401-403, 433-435). The port's default backend
# is the kernels, so every path runs on them; 'high' is TF32 on the card.
SCAN = ScpSettings(iterations=2, ipm=IpmSettings(iters=10),
                   matmul_precision='high')
FLEET = ScpSettings(iterations=2, ipm=IpmSettings(iters=10))
COLD = FLEET
RTI = ScpSettings(iterations=1, ipm=IpmSettings(iters=6))
LEGGED = ScpSettings(iterations=1)
PYRAMID = ScpSettings(iterations=1, ipm=IpmSettings(iters=10))
LEGGED_BATCH = ScpSettings(iterations=1, matmul_precision='high')
PLAIN = 'riccati'  # the oracles' backend: the plain torch executor

# Gates, N: each the tighter of bench.py's and chip_smoke.py's for the pair.
TOL_FLEET_VS_SCAN = 0.05  # bench.py:239; chip_smoke.py TOL_GRF
TOL_KERNEL_VS_PLAIN = 0.01  # bench.py:275 (chip_smoke.py: TOL_GRF, 0.05)
TOL_LEG_PLAIN = 5e-4  # chip_smoke.py TOL_LEG_PLAIN (bench.py: 0.2)
LOOP_MG_RTOL = 0.1  # bench.py:339
TIER_MG_RTOL = 0.5  # bench.py:463

# The keys of the result line: bench.py's (bench.py:467-514) less
# vs_baseline and dispatch_floor_ms, tpu_selftest as gpu_selftest, with the
# card's name and power limit and each path's launches.
RESULT_KEYS = frozenset((
    "metric", "value", "unit", "scan_wall_solves_per_s",
    "fleet_wall_solves_per_s", "fleet_device_ms",
    "fleet_device_solves_per_s", "fleet_mfu_pct", "fleet_vs_scan_grf_err_N",
    "batch", "batch_latency_ms", "batch_device_ms", "device_solves_per_s",
    "batch_matmul_precision", "mfu_pct", "flops_per_solve_M",
    "batch1_cold_p50_ms", "batch1_cold_p99_ms", "batch1_device_ms",
    "batch1_warm_p50_ms", "batch1_warm_p99_ms", "closed_loop_ticks",
    "closed_loop_wall_ms", "closed_loop_hz", "legged_N", "legged_p50_ms",
    "legged_p99_ms", "legged_device_ms", "legged_pyr_device_ms",
    "pyr_kernel_vs_scan_err_N", "legged_solves_per_s_chip_N67",
    "legged_batch_solves_per_s_chip_N67", "legged_batch_scan_solves_per_s",
    "legged_fleet_wall_solves_per_s", "legged_fleet_device_ms",
    "legged_fleet_device_solves_per_s", "legged_fleet_batch", "legged_batch",
    "kernel_vs_scan_grf_err_N", "eq_kernel_vs_scan_force_err_N",
    "eq_fleet_vs_scan_force_err_N", "f32_tier", "gpu_selftest", "device",
    "card", "kernels"))
KERNELS = ("K1", "K2", "K3", "K4")
_WRAPPERS = (cuda_ipm_riccati.solve_ocp_qp_kernel,
             cuda_ipm_batch.solve_ocp_qp_fleet,
             cuda_eq_riccati.solve_eq_lqr_kernel,
             cuda_eq_batch.solve_eq_lqr_fleet)


class Size(NamedTuple):
    """How large a run is. ``reps`` replaces every repetition count of
    ``bench.py`` when set."""

    batch: int  # centroidal fleet
    legged_horizon: int
    legged_batch: int  # bench.py's batched legged path
    legged_fleet: int  # bench.py's legged fleet-kernel path
    loop_ticks: int
    reps: Optional[int]
    chain_batch1: tuple  # solves per chain for the device time, batch 1
    chain_fleet: tuple  # and for fleets
    chain_reps: int  # repetitions of each chain

    def n(self, count: int) -> int:
        return count if self.reps is None else self.reps


FULL = Size(1024, 67, 512, 128, 20, None, (4, 20), (2, 8), 3)
SMALL = Size(4, 8, 4, 2, 3, 3, (1, 2), (1, 2), 1)


# ---------------------------------------------------------------------------
# Scenarios (bench.py:174-201, 316-319, 356-366, 404-412), numpy.
# ---------------------------------------------------------------------------

def centroidal_config(dtype=torch.float32) -> CentroidalMpcConfig:
    """bench.py's centroidal configuration (bench.py:177-179)."""
    return CentroidalMpcConfig(mass=8.0, num_legs=4, horizon=HORIZON,
                               dt=0.01, weights=tuple(TEST_WEIGHTS),
                               mu=(0.8,) * 4, dtype=dtype)


def centroidal_scenarios(cfg, batch: int):
    """``(one, many)``: the batch-1 scenario and a batch of ``batch`` whose
    element 0 is that scenario (bench.py:195-200), packed numpy inputs."""
    many = make_example_inputs(cfg, batch=batch)
    one = make_example_inputs(cfg)
    for part, first in zip(many, one):
        part[0] = first
    return one, many


def loop_command(des_inputs, horizon: int) -> np.ndarray:
    """The loop's all-stance hold command (bench.py:316-318)."""
    dins = np.asarray(des_inputs).copy()
    for leg in range(4):
        off = leg * (4 * horizon + 3)
        dins[off:off + horizon] = 1.0
    return dins


def legged_config(horizon: int, cone_mode: str,
                  dtype=torch.float32) -> LeggedMpcConfig:
    """The legged task at ``horizon`` with the stand-in weights."""
    return LeggedMpcConfig(horizon=horizon, cone_mode=cone_mode, dtype=dtype,
                           **LEGGED_TEST_WEIGHTS)


def legged_scenario(horizon: int):
    """``(x0, x_ref, enable, z_pos, z_vel)`` of bench.py:353-361, float32:
    standing at 0.3 m, legs 1 and 2 lifted on every other node."""
    x0 = np.zeros(24, np.float32)
    x0[8] = 0.3
    x0[12:] = [0., 0.4, -0.8, 0., -0.4, 0.8, 0., 0.4, -0.8, 0., -0.4, 0.8]
    x_ref = np.tile(x0, (horizon + 1, 1))
    enable = np.ones((horizon, 4), np.float32)
    enable[::2, 1] = 0.0
    enable[::2, 2] = 0.0
    zp = np.zeros((horizon, 4), np.float32)
    zv = np.zeros((horizon, 4), np.float32)
    return x0, x_ref, enable, zp, zv


def legged_batch(scenario, batch: int):
    """The batch of bench.py:404-411: the scenario's x0 with seeded noise
    of 0.05 on its first entry, element 0 left as it is."""
    x0, _, enable, zp, zv = scenario
    horizon = enable.shape[0]
    x0b = np.tile(x0, (batch, 1)).astype(np.float32)
    x0b[:, 0] += 0.05 * np.random.default_rng(0).standard_normal(batch)
    x0b[0] = x0
    return (x0b, np.repeat(x0b[:, None, :], horizon + 1, axis=1),
            np.tile(enable, (batch, 1, 1)), np.tile(zp, (batch, 1, 1)),
            np.tile(zv, (batch, 1, 1)))


def make_tick(cfg, scp: ScpSettings, device) -> Callable:
    """bench.py's warm MPC tick (bench.py:282-288): the previous solution
    shifted one node warm-starts one solve. Returns ``tick(state,
    des_state, des_inputs, x_prev, u_prev) -> (x_traj, u_traj,
    contact_force)``, eager."""
    solve = build_centroidal_solver(cfg, scp, device=device)

    def tick(state, des_state, des_inputs, x_prev, u_prev):
        x_w = torch.cat([x_prev[..., 1:, :], x_prev[..., -1:, :]], dim=-2)
        u_w = torch.cat([u_prev[..., 1:, :], u_prev[..., -1:, :]], dim=-2)
        sol = solve(state, des_state, des_inputs, warm=(x_w, u_w))
        return sol.x_traj, sol.u_traj, sol.contact_force

    return tick


class Path(NamedTuple):
    """One path: its solve as one CUDA graph per signature (``call``), the
    same solve eager (for the device time), its inputs on the device, its
    K1..K4 launches per solve, and ``plain()``, the same solve through the
    plain executor (the oracle)."""

    call: Callable
    eager: Callable
    args: tuple
    want: tuple
    plain: Callable


def build_paths(device, size: Size, dtype=torch.float32,
                backend: Optional[str] = None) -> dict:
    """Every path of the benchmark at ``size``, by name, with bench.py's
    settings; ``backend`` replaces their ``qp_backend`` (the tests run the
    paths through the plain executor in f64). The warm tick's inputs are
    the batch-1 ones; the previous solution comes with the call."""
    dev = torch.device(device)

    def settings(scp):
        return scp if backend is None else scp._replace(qp_backend=backend)

    def tensors(arrays):
        return tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                     for a in arrays)

    def path(build, cfg, scp, args, want, graph=True):
        eager = build(cfg, settings(scp), device=dev)
        call = graphed(eager, dev) if graph else eager
        return Path(call, eager, args, want, lambda: build(
            cfg, scp._replace(qp_backend=PLAIN), device=dev)(*args))

    cfg = centroidal_config(dtype)
    one, many = centroidal_scenarios(cfg, size.batch)
    args_b, args1 = tensors(many), tensors(one)
    stance = tensors((one[0], one[1], loop_command(one[2], HORIZON)))
    n = size.loop_ticks
    lcfg = legged_config(size.legged_horizon, 'soft', dtype)
    lcfg_pyr = legged_config(size.legged_horizon, 'pyramid', dtype)
    scenario = legged_scenario(size.legged_horizon)
    largs = tensors(scenario)
    bargs = tensors(legged_batch(scenario, size.legged_batch))
    tick = make_tick(cfg, settings(RTI), dev)
    return {
        "centroidal_fleet_scan": path(build_centroidal_solver, cfg, SCAN,
                                      args_b, (0, 2, 0, 0)),
        "centroidal_fleet": path(build_centroidal_solver, cfg, FLEET, args_b,
                                 (0, 2, 0, 0)),
        "batch1_cold": path(build_centroidal_solver, cfg, COLD, args1,
                            (2, 0, 0, 0)),
        "batch1_warm": Path(graphed(tick, dev), tick, args1, (1, 0, 0, 0),
                            None),
        "closed_loop": path(  # the loop is graphed by its builder
            lambda c, s, device: build_centroidal_mpc_loop(
                c, s, n_ticks=n, device=device), cfg, RTI, stance,
            (n + 1, 0, 0, 0), graph=False),
        "legged": path(build_legged_solver, lcfg, LEGGED, largs,
                       (0, 0, 1, 0)),
        "legged_pyr": path(build_legged_solver, lcfg_pyr, PYRAMID, largs,
                           (1, 0, 0, 0)),
        "legged_batch": path(build_legged_solver, lcfg, LEGGED_BATCH, bargs,
                             (0, 0, 0, 1)),
        "legged_fleet": path(build_legged_solver, lcfg, LEGGED_BATCH,
                             tuple(a[:size.legged_fleet] for a in bargs),
                             (0, 0, 0, 1)),
    }


# ---------------------------------------------------------------------------
# Measurement.
# ---------------------------------------------------------------------------

def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def percentiles(fn: Callable, args: Sequence, reps: int):
    """(p50, p99) host ms of ``fn(*args)``, each call ending with its output
    read to the host (bench.py:43-55)."""
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)))


class Bench:
    """One run: the device, its size, and each path's kernel launches."""

    def __init__(self, device, size: Size):
        self.dev = torch.device(device)
        self.size = size
        self.kernels: dict = {}
        self.t0 = time.perf_counter()

    def progress(self, msg: str) -> None:
        print(f"# t={time.perf_counter() - self.t0:.1f}s {msg}", flush=True)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def first_call(self, name: str, call: Callable, want: Sequence[int]):
        """The path's first call, with its launches checked: on the card
        the warm-up calls and the capture launch ``want`` (K1..K4 per
        solve) ``WARMUP_CALLS + 1`` times, and a second call (a replay)
        calls no kernel wrapper; on the CPU nothing is launched (the
        wrappers run their plain versions) and nothing is graphed. Returns
        the first call's value."""
        on_card = self.dev.type == "cuda"
        per_call = WARMUP_CALLS + 1 if on_card else 0
        for k in _WRAPPERS:
            k.launches = 0
        value = call()
        self.sync()
        got = [k.launches for k in _WRAPPERS]
        expect = [per_call * w for w in want]
        check(got == expect, f"{name}: the first call launched K1..K4 "
              f"{got}x; expected {expect}")
        if on_card:
            call()
            self.sync()
            replay = [k.launches - g for k, g in zip(_WRAPPERS, got)]
            check(replay == [0] * 4, f"{name}: a replay called the kernel "
                  f"wrappers {replay}x; expected none")
        self.kernels[name] = {k: (g // per_call if per_call else 0)
                              for k, g in zip(KERNELS, got)}
        return value

    def device_seconds(self, fn: Callable, args: Sequence,
                       fleet: bool) -> float:
        k_small, k_big = (self.size.chain_fleet if fleet
                          else self.size.chain_batch1)
        return device_time_per_call(fn, args, k_small, k_big,
                                    reps=self.size.chain_reps,
                                    device=self.dev)


def run(device, size: Size) -> dict:
    """Every path of the benchmark; returns the result line's object."""
    b = Bench(device, size)
    dev = b.dev
    on_card = dev.type == "cuda"
    card = None
    if on_card:
        from cheeta_mpc_tpu_torch.native import build
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        build.load_library()
        b.progress(f"card {card}; kernels built in {build.build_seconds} s "
                   "(None: loaded from the build directory)")

    paths = build_paths(dev, size)
    cfg = centroidal_config()
    mg = cfg.mass * GRAVITY
    batch = size.batch
    flops_per_solve = centroidal_solve_flops(HORIZON, 33, 24, 32, 2, 10)

    def first(name, out, extra=()):
        """The path's first call, read through ``out`` (result -> tensor);
        ``extra`` arguments follow the path's own."""
        p = paths[name]
        value = b.first_call(name, lambda: out(p.call(*p.args, *extra)),
                             p.want)
        check(bool(torch.isfinite(value).all()), f"{name}: non-finite")
        return value

    def grf(sol):
        return sol.contact_force

    def forces(sol):
        return sol.forces

    def eager_out(name, out):
        eager = paths[name].eager
        return lambda *a: out(eager(*a))

    # ---- the centroidal fleet: the 'high' ("scan") setting --------------
    p = paths["centroidal_fleet_scan"]
    force = first("centroidal_fleet_scan", grf)
    reps = size.n(10)
    t0 = time.perf_counter()
    for _ in range(reps):
        force = p.call(*p.args).contact_force.cpu()
    dt_s = (time.perf_counter() - t0) / reps
    solves_per_s = batch / dt_s
    dev_batch_s = b.device_seconds(eager_out("centroidal_fleet_scan", grf),
                                   p.args, fleet=True)
    mfu = batch * flops_per_solve / dev_batch_s / F32_FLOPS
    b.progress(f"fleet 'high': {1e3 * dt_s:.2f} ms wall, "
               f"{1e3 * dev_batch_s:.2f} ms device")

    # ---- the centroidal fleet: the default precision ---------------------
    p = paths["centroidal_fleet"]
    force_fleet = first("centroidal_fleet", grf)
    ferr = max_abs(force_fleet.cpu(), force)
    check(ferr < TOL_FLEET_VS_SCAN,
          f"fleet vs 'high' fleet GRF mismatch: {ferr} N")
    dev_fleet_s = b.device_seconds(eager_out("centroidal_fleet", grf),
                                   p.args, fleet=True)
    fleet_wall_p50, _ = percentiles(lambda *a: p.call(*a).contact_force,
                                    p.args, size.n(10))
    fleet_wall_sps = batch / (fleet_wall_p50 / 1e3)
    mfu_fleet = batch * flops_per_solve / dev_fleet_s / F32_FLOPS
    b.progress(f"fleet: {fleet_wall_p50:.2f} ms wall p50, "
               f"{1e3 * dev_fleet_s:.2f} ms device, vs 'high' {ferr:.3g} N")

    # ---- batch 1, cold ---------------------------------------------------
    p = paths["batch1_cold"]
    force1 = first("batch1_cold", grf)
    cold_p50, cold_p99 = percentiles(lambda *a: p.call(*a).contact_force,
                                     p.args, size.n(50))
    dev_b1_s = b.device_seconds(eager_out("batch1_cold", grf), p.args,
                                fleet=False)
    kerr = max_abs(force1, p.plain().contact_force)
    check(kerr < TOL_KERNEL_VS_PLAIN,
          f"K1 vs plain executor GRF mismatch: {kerr} N")
    b.progress(f"batch 1 cold: p50 {cold_p50:.3f} ms, device "
               f"{1e3 * dev_b1_s:.3f} ms, vs plain {kerr:.3g} N")

    # ---- batch 1, warm RTI tick (the 50 Hz loop): one graph, shift in it -
    sol0 = p.call(*p.args)
    x_prev, u_prev = sol0.x_traj, sol0.u_traj
    p = paths["batch1_warm"]
    first("batch1_warm", lambda out: out[2], (x_prev, u_prev))
    lat = []
    for _ in range(size.n(50)):
        t0 = time.perf_counter()
        x_prev, u_prev, force_w = p.call(*p.args, x_prev, u_prev)
        force_w.cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    warm_p50 = float(np.percentile(lat, 50))
    warm_p99 = float(np.percentile(lat, 99))
    check(bool(torch.isfinite(force_w).all()), "warm tick: non-finite")
    b.progress(f"batch 1 warm tick: p50 {warm_p50:.3f} ms")

    # ---- the on-device loop ----------------------------------------------
    n_ticks = size.loop_ticks
    p = paths["closed_loop"]
    first("closed_loop", lambda out: out[1])
    lat = []
    for _ in range(size.n(20)):
        t0 = time.perf_counter()
        fs_l = p.call(*p.args)[1].cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    loop_p50 = float(np.percentile(lat, 50))
    closed_loop_hz = n_ticks / (loop_p50 / 1e3)
    check(bool(torch.isfinite(fs_l).all()), "loop: non-finite forces")
    fz_l = fs_l[:, :, 2].sum(dim=1)
    check(bool(((fz_l - mg).abs() < LOOP_MG_RTOL * mg).all()),
          f"loop: total Fz {fz_l.tolist()} leaves m g = {mg} N by more "
          f"than {LOOP_MG_RTOL:.0%}")
    b.progress(f"loop: {loop_p50:.2f} ms for {n_ticks} ticks, "
               f"{closed_loop_hz:.1f} Hz")

    # ---- legged N=67, soft cone, batch 1 (K3) ----------------------------
    nl = size.legged_horizon
    p = paths["legged"]
    lf = first("legged", forces)
    leg_p50, leg_p99 = percentiles(lambda *a: p.call(*a).forces, p.args,
                                   size.n(30))
    dev_leg_s = b.device_seconds(eager_out("legged", forces), p.args,
                                 fleet=False)
    lerr = max_abs(lf, p.plain().forces)
    check(lerr < TOL_LEG_PLAIN,
          f"K3 vs plain executor force mismatch: {lerr} N")
    b.progress(f"legged soft: p50 {leg_p50:.3f} ms, device "
               f"{1e3 * dev_leg_s:.3f} ms, vs plain {lerr:.3g} N")

    # ---- legged pyramid cone, batch 1 (K1 with stage equalities) ---------
    p = paths["legged_pyr"]
    pf = first("legged_pyr", forces)
    dev_pyr_s = b.device_seconds(eager_out("legged_pyr", forces), p.args,
                                 fleet=False)
    perr = max_abs(pf, p.plain().forces)
    check(perr < TOL_LEG_PLAIN,
          f"pyramid K1 vs plain executor force mismatch: {perr} N")
    b.progress(f"legged pyramid: device {1e3 * dev_pyr_s:.3f} ms, vs plain "
               f"{perr:.3g} N")

    # ---- legged batched (K4) at bench.py's two batches -------------------
    lbatch, lbatch_f = size.legged_batch, size.legged_fleet
    p = paths["legged_batch"]
    first("legged_batch", forces)
    lb_p50, _ = percentiles(lambda *a: p.call(*a).forces, p.args,
                            size.n(9))
    leg_batch_scan_sps = lbatch / (lb_p50 / 1e3)
    p = paths["legged_fleet"]
    lff = first("legged_fleet", forces)
    flerr = max_abs(lff, p.plain().forces)
    check(flerr < TOL_LEG_PLAIN, f"K4 vs plain executor forces: {flerr} N")
    lbf_p50, _ = percentiles(lambda *a: p.call(*a).forces, p.args,
                             size.n(9))
    leg_fleet_wall_sps = lbatch_f / (lbf_p50 / 1e3)
    dev_legb_s = b.device_seconds(eager_out("legged_fleet", forces), p.args,
                                  fleet=True)
    leg_fleet_dev_sps = lbatch_f / dev_legb_s
    leg_batch_sps = max(leg_batch_scan_sps, leg_fleet_wall_sps)
    b.progress(f"legged batch {lbatch}: p50 {lb_p50:.2f} ms; fleet "
               f"{lbatch_f}: p50 {lbf_p50:.2f} ms, device "
               f"{1e3 * dev_legb_s:.2f} ms, vs plain {flerr:.3g} N")

    # ---- structural tier (bench.py:452-463) on the 'high' fleet ----------
    dins = paths["centroidal_fleet_scan"].args[2].cpu().numpy()
    table = np.zeros((batch, 4, HORIZON), bool)
    for leg in range(4):
        off = leg * (4 * HORIZON + 3)
        table[:, leg, :] = dins[:, off:off + HORIZON] > 0.5
    f_np = force.numpy()
    swing = ~np.broadcast_to(table[:, :, None, :], f_np.shape)
    sw = float(np.abs(f_np[swing]).max()) if swing.any() else 0.0
    check(sw == 0.0, f"swing-leg force leak: {sw}")
    fz_tot = f_np[:, :, 2, :].sum(axis=1)
    check(bool((np.abs(fz_tot - mg) < TIER_MG_RTOL * mg).all()),
          "weight support off")

    head_sps = max(solves_per_s, fleet_wall_sps)
    result = {
        "metric": f"centroidal_mpc_solves_per_s_chip_N{HORIZON}",
        "value": head_sps,
        "unit": "solves/s",
        "scan_wall_solves_per_s": solves_per_s,
        "fleet_wall_solves_per_s": fleet_wall_sps,
        "fleet_device_ms": dev_fleet_s * 1e3,
        "fleet_device_solves_per_s": batch / dev_fleet_s,
        "fleet_mfu_pct": 100.0 * mfu_fleet,
        "fleet_vs_scan_grf_err_N": ferr,
        "batch": batch,
        "batch_latency_ms": dt_s * 1e3,
        "batch_device_ms": dev_batch_s * 1e3,
        "device_solves_per_s": batch / dev_batch_s,
        "batch_matmul_precision": SCAN.matmul_precision,
        "mfu_pct": 100.0 * mfu,
        "flops_per_solve_M": flops_per_solve / 1e6,
        "batch1_cold_p50_ms": cold_p50,
        "batch1_cold_p99_ms": cold_p99,
        "batch1_device_ms": dev_b1_s * 1e3,
        "batch1_warm_p50_ms": warm_p50,
        "batch1_warm_p99_ms": warm_p99,
        "closed_loop_ticks": n_ticks,
        "closed_loop_wall_ms": loop_p50,
        "closed_loop_hz": closed_loop_hz,
        "legged_N": nl,
        "legged_p50_ms": leg_p50,
        "legged_p99_ms": leg_p99,
        "legged_device_ms": dev_leg_s * 1e3,
        "legged_pyr_device_ms": dev_pyr_s * 1e3,
        "pyr_kernel_vs_scan_err_N": perr,
        "legged_solves_per_s_chip_N67": 1000.0 / leg_p50,
        "legged_batch_solves_per_s_chip_N67": leg_batch_sps,
        "legged_batch_scan_solves_per_s": leg_batch_scan_sps,
        "legged_fleet_wall_solves_per_s": leg_fleet_wall_sps,
        "legged_fleet_device_ms": dev_legb_s * 1e3,
        "legged_fleet_device_solves_per_s": leg_fleet_dev_sps,
        "legged_fleet_batch": lbatch_f,
        "legged_batch": lbatch,
        "kernel_vs_scan_grf_err_N": kerr,
        "eq_kernel_vs_scan_force_err_N": lerr,
        "eq_fleet_vs_scan_force_err_N": flerr,
        "f32_tier": "pass",
        "gpu_selftest": "pass" if on_card else "not run: cpu",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card,
        "kernels": b.kernels,
    }
    check(set(result) == RESULT_KEYS, "result keys")
    b.progress("done")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m cheeta_mpc_tpu_torch.bench",
        description="The BASELINE metrics of the port on one card; one "
                    "JSON line last.")
    parser.add_argument("--device", default="cuda",
                        help="the card (default) or 'cpu', for tests")
    parser.add_argument("--small", action="store_true",
                        help="the small sizes of the tests")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    if dev.type not in ("cuda", "cpu"):
        print(f"bench: unknown device {args.device!r}", file=sys.stderr)
        return 1
    result = run(dev, SMALL if args.small else FULL)
    bad = [k for k, v in result.items()
           if isinstance(v, float) and not math.isfinite(v)]
    check(not bad, f"non-finite readings: {bad}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
