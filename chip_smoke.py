#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cheeta_mpc_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version on the card, drives the centroidal
MPC main path (batch 1 and a fleet of 1024 scenarios) through the entry
point a user calls, checks the results, times kernels and solves with CUDA
events, counts what one solve costs the host, and prints one JSON object per
line. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Any failed phase raises, so the script exits non-zero and prints no result
line; without a CUDA device it fails at once. Needs no network and starts no
process besides ``nvidia-smi`` and the compiler, both of which it waits for.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and f32
# FLOP/s outside the tensor cores. The bound of a kernel is the larger of
# bytes / HBM_BYTES_PER_S and operations / F32_FLOPS.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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


def wall_ms(fn, repeats: int = 10, warmup: int = 2) -> float:
    """Median host time of ``fn()`` ending in a synchronize, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def ipm_flops(N, nx, nu, ng, nc, iters) -> float:
    """f32 operations (2 per multiply-add) of one fixed-iteration solve,
    counted from the shapes: per iteration one residual pass, one
    factorization, two Newton passes and one stationarity pass."""

    def inv(n):  # Gauss-Jordan on an n x 2n augmented matrix
        return 2.0 * n * n * (n + 1)

    grads = ((N + 1) * 2 * nx * (nx + ng)
             + N * 2 * nu * (2 * nx + nu + ng))
    residuals = ((N + 1) * 2 * ng * nx + N * 2 * ng * nu
                 + N * 2 * nx * (nx + nu) + N * 2 * nc * (nx + nu))
    stage = (2 * nx ** 3 + 2 * nx * nx * nu  # P A, P B
             + 2 * nu * nu * (ng + nx) + 2 * nu * nx * (ng + nx)  # G, H
             + 2 * nx * nx * (ng + nx) + inv(nu)  # Q + A'PA, G^-1
             + 2 * nu * nu * nx + 2 * nx * nx * nu)  # K, P += H'K
    if nc:
        stage += (4 * nu * nu * nc + 4 * nu * nc * nc + inv(nc)
                  + 4 * nc * nu * nx + 2 * nc * nc * nx + 2 * nx * nx * nc)
    factorize = N * stage + 2 * nx * nx * ng + N * 2 * nx * nx
    back = 2 * nx * nu + 2 * nu * nu + 2 * nx * nx + 2 * nu * nx
    if nc:
        back += 4 * nu * nc + 2 * nc * nc + 2 * nc * nx
    fwd = 4 * nu * nx + 2 * nx * nx
    newton = (grads + N * (back + fwd) + (N + 1) * 2 * ng * nx
              + N * 2 * ng * nu + 30 * (N + 1) * ng)
    stat = grads + N * (2 * nx * nu + 2 * nx * nx + 2 * nc * (2 * nu + nx))
    lid = N * (2 * nc * nc * nu * 2 + inv(nc)) if nc else 0
    return float(lid + stat
                 + iters * (residuals + factorize + 2 * newton + stat))


def tensors_of(obj):
    """Every tensor of a (nested) container dataclass."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            out += tensors_of(getattr(obj, f.name))
        return out
    return []


def bound(data, out_tensors, batch: int, iters: int):
    """(bound_ms, bound_by): every input read once, every output written
    once, and the operations of ``batch`` solves, at the card's peaks."""
    dyn, con, eq = data.dyn, data.con, data.eq
    nbytes = sum(t.numel() * t.element_size() for t in tensors_of(data))
    nbytes += sum(t.numel() * t.element_size() for t in out_tensors)
    flops = batch * ipm_flops(dyn.horizon, dyn.nx, dyn.nu, con.ng,
                              0 if eq is None else eq.nc, iters)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS
    return ((t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations"),
            nbytes, flops)


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


def host_cost(solve) -> dict:
    """What one ``solve()`` costs the host, from a ``torch.profiler`` pass:
    kernel launches, waits for the stream, host-to-device copies, and the
    device time of everything it launched."""
    from torch.profiler import ProfilerActivity, profile
    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    events = {e.key: e for e in prof.key_averages()}

    def count(key):
        return events[key].count if key in events else 0

    return {"kernel_launches": count("cudaLaunchKernel"),
            # one of the waits is the synchronize that ends the window
            "host_waits": (count("cudaStreamSynchronize")
                           + count("cudaDeviceSynchronize")),
            "host_to_device_copies": count("cudaMemcpyAsync"),
            "device_ms": sum(e.self_device_time_total
                             for e in events.values()) / 1e3}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a GPU only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from cheeta_mpc_tpu_torch.core.types import tree_map
    from cheeta_mpc_tpu_torch.examples import (TEST_WEIGHTS,
                                               make_example_inputs)
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import (
        CentroidalMPC, build_centroidal_solver)
    from cheeta_mpc_tpu_torch.native import build
    from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch as fleet_mod
    from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati as single_mod
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings

    k1, k1_plain = single_mod.solve_ocp_qp_kernel, single_mod.solve_ocp_qp_plain
    k2 = fleet_mod.solve_ocp_qp_fleet
    k2_plain = fleet_mod.solve_ocp_qp_fleet_plain

    # Phase 2: build.
    build.load_library()
    ptxas = [ln for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build.build_seconds,
          "sources": sorted(p.name for p in build.CSRC_DIR.glob("*.cu*")),
          "ptxas": ptxas[:8]})
    check(build.build_seconds is not None,
          "the kernels were not built from the sources in this run")

    ipm = IpmSettings(iters=IPM_ITERS)
    scp = ScpSettings(iterations=SQP_ITERS, ipm=ipm)  # default: the kernels
    mpc = CentroidalMPC(MASS, 4, HORIZON, DT, TEST_WEIGHTS, [0.8] * 4,
                        scp=scp).setup_mpc()
    cfg = mpc.config
    solver = build_centroidal_solver(cfg, scp, device=dev)
    one = make_example_inputs(cfg)
    many = make_example_inputs(cfg, batch=FLEET)

    def contig(data):
        return tree_map(lambda t: t.contiguous(), data)

    def placement_of(qp, settings):
        eq = qp.eq
        shape = (qp.dyn.horizon, qp.dyn.nx, qp.dyn.nu, qp.con.ng,
                 0 if eq is None else eq.nc)
        name, _, nbytes = single_mod.shared_memory_plan(
            build.load_library(), shape, settings.iters, dev)
        return name, nbytes

    # Phase 3: each kernel against its plain version on the card.
    qp1 = contig(solver.initial_qp(*one))
    s1, p1 = k1(qp1, ipm), k1_plain(qp1, ipm)
    torch.cuda.synchronize()
    err_k1 = compare_solutions(s1, p1, True, "K1, centroidal QP")

    # Seeded instances that reach the other code paths: stage equalities at
    # a small shape; the centroidal widths at a horizon whose A, B no
    # longer fit beside the factors; the legged shape, whose factors spill
    # to the global scratch buffer. Six iterations bring mu to about 5e-4.
    # Further on, the barrier Hessian of this random family is numerically
    # singular in f32 at the wide shapes: the last factorization, whose step
    # the guard rejects, leaves non-finite gains in either executor.
    ipm_e = IpmSettings(iters=6)
    others, placements = {}, {"k1_centroidal": placement_of(qp1, ipm)}
    for name, qp in (
            ("k1_equalities", random_qp(7, dev)),
            ("k1_horizon18", random_qp(8, dev, N=18, nx=33, nu=24, ng=32,
                                       nc=0)),
            ("k1_legged_shape", random_qp(7, dev, **LEGGED_SHAPE))):
        sk, pk = k1(qp, ipm_e), k1_plain(qp, ipm_e)
        torch.cuda.synchronize()
        others[name] = compare_solutions(sk, pk, True, name)
        placements[name] = placement_of(qp, ipm_e)
    check(sorted({name for name, _ in placements.values()})
          == sorted(n for n, _, _ in single_mod.PLACEMENTS),
          f"the instances do not reach every placement: {placements}")

    qpf = contig(solver.initial_qp(*many))
    sf, pf = k2(qpf, ipm), k2_plain(qpf, ipm)
    torch.cuda.synchronize()
    err_k2 = compare_solutions(sf, pf, False, f"K2, batch {FLEET}")
    check(bool(torch.isnan(sf.gains.K).all()),
          "K2 must return NaN gains")
    # The two kernels share their device code: problem 0 of the fleet is
    # the batch-1 problem only up to the scenario, so compare K2 on a fleet
    # of one against K1.
    qp11 = contig(solver.initial_qp(*(a[None] for a in one)))
    s11 = k2(qp11, ipm)
    torch.cuda.synchronize()
    k2_vs_k1 = max(max_abs(s11.du[0], s1.du), max_abs(s11.dx[0], s1.dx))
    check(k2_vs_k1 <= 1e-5, f"K2 at batch 1 differs from K1 by {k2_vs_k1}")
    emit({"phase": "kernel_vs_plain", "tolerance": {
        "dx_du": TOL_PRIMAL, "duals_slacks_rel": TOL_DUAL},
        "k1_centroidal": err_k1, **others, "k2_fleet": err_k2,
        "k2_batch1_vs_k1": k2_vs_k1,
        "kept_in_shared_memory_and_bytes": placements})

    # Phase 4: main path, batch 1.
    k1.launches = 0
    k2.launches = 0
    sol1 = mpc.update_mpc(*one)
    torch.cuda.synchronize()
    launches_k1, other = k1.launches, k2.launches
    check(launches_k1 == SQP_ITERS and other == 0,
          f"batch-1 main path launched K1 {launches_k1}x, K2 {other}x; "
          f"expected {SQP_ITERS} and 0")
    grf = sol1.contact_force  # (legs, 3, N)
    for name in ("contact_force", "foot_pos", "x_traj", "u_traj", "merit"):
        check(bool(torch.isfinite(getattr(sol1, name)).all()),
              f"batch 1: {name} is not finite")
    check(tuple(grf.shape) == (4, 3, HORIZON), f"GRF shape {grf.shape}")
    enable = torch.as_tensor(
        np.stack([one[2][i * (4 * HORIZON + 3):][:HORIZON]
                  for i in range(4)]), device=dev)  # (legs, N)
    swing = grf[enable[:, None, :].expand_as(grf) == 0]
    check(bool((swing == 0).all()), "swing-leg forces are not exactly 0")
    fz = grf[:, 2, :].sum(dim=0)
    fz_resid = check_vertical_force(sol1, "batch 1")
    scp64 = scp._replace(qp_backend="riccati")
    ref64 = build_centroidal_solver(
        cfg._replace(dtype=torch.float64), scp64, device="cpu")(*one)
    grf_err = max_abs(grf.cpu(), ref64.contact_force)
    check(grf_err <= TOL_GRF,
          f"batch-1 GRF differs from the f64 CPU solve by {grf_err} N")
    emit({"phase": "main_path_batch1", "k1_launches": launches_k1,
          "total_fz": [round(v, 3) for v in fz.tolist()],
          "mg": MASS * GRAVITY, "fz_minus_m_g_plus_zdd": fz_resid,
          "grf_err_vs_f64_cpu": grf_err, "tolerance": TOL_GRF,
          "step_size": sol1.step_size.tolist(),
          "convergence": int(sol1.convergence)})

    # Phase 5: main path, fleet.
    k1.launches = 0
    k2.launches = 0
    solf = mpc.update_mpc(*many)
    torch.cuda.synchronize()
    launches_k2, other = k2.launches, k1.launches
    check(launches_k2 == SQP_ITERS and other == 0,
          f"fleet main path launched K2 {launches_k2}x, K1 {other}x; "
          f"expected {SQP_ITERS} and 0")
    check(tuple(solf.contact_force.shape) == (FLEET, 4, 3, HORIZON),
          f"fleet GRF shape {solf.contact_force.shape}")
    for name in ("contact_force", "foot_pos", "x_traj", "u_traj", "merit"):
        check(bool(torch.isfinite(getattr(solf, name)).all()),
              f"fleet: {name} is not finite")
    plain_solver = build_centroidal_solver(cfg, scp64, device=dev)
    solp = plain_solver(*many)
    torch.cuda.synchronize()
    fleet_err = max_abs(solf.contact_force, solp.contact_force)
    check(fleet_err <= TOL_GRF,
          f"fleet GRF differs from the plain executor by {fleet_err} N")
    check(bool((solf.step_size == solp.step_size).all()),
          "fleet line-search steps differ from the plain executor's")
    sol0 = mpc.update_mpc(*(a[0] for a in many))
    torch.cuda.synchronize()
    el0_err = max_abs(solf.contact_force[0], sol0.contact_force)
    check(el0_err <= TOL_GRF,
          f"fleet element 0 differs from its batch-1 solve by {el0_err} N")
    fzf_resid = check_vertical_force(solf, "fleet")
    emit({"phase": "main_path_fleet", "batch": FLEET,
          "k2_launches": launches_k2, "grf_err_vs_plain_executor": fleet_err,
          "element0_vs_batch1": el0_err, "tolerance": TOL_GRF,
          "fz_minus_m_g_plus_zdd": fzf_resid})

    # Phase 6: times (CUDA events, median of 10 after warm-up).
    t_k1 = median_ms(lambda: k1(qp1, ipm))
    t_k2 = median_ms(lambda: k2(qpf, ipm))
    t_k1_plain = median_ms(lambda: k1_plain(qp1, ipm), repeats=10, warmup=1)
    t_k2_plain = median_ms(lambda: k2_plain(qpf, ipm), repeats=10, warmup=1)
    t_solve1 = wall_ms(lambda: mpc.update_mpc(*one))
    t_solvef = wall_ms(lambda: mpc.update_mpc(*many))
    emit({"phase": "times", "card": card, "k1_ms": t_k1, "k2_ms": t_k2,
          "k1_plain_ms": t_k1_plain, "k2_plain_ms": t_k2_plain,
          "solve_batch1_ms": t_solve1, "solve_fleet_ms": t_solvef,
          "fleet_solves_per_s": 1e3 * FLEET / t_solvef,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    emit({"phase": "host_cost",
          "batch1": host_cost(lambda: mpc.update_mpc(*one)),
          "fleet": host_cost(lambda: mpc.update_mpc(*many))})

    # Phase 7: the kernels.
    (b1, by1), bytes1, flops1 = bound(
        qp1, [s1.dx, s1.du, s1.s_l, s1.s_u, s1.lam_l, s1.lam_u,
              *tensors_of(s1.gains)], 1, IPM_ITERS)
    (b2, by2), bytes2, flops2 = bound(
        qpf, [sf.dx, sf.du, sf.s_l, sf.s_u, sf.lam_l, sf.lam_u], FLEET,
        IPM_ITERS)
    emit({"phase": "bounds", "k1": {"bytes": bytes1, "flops": flops1},
          "k2": {"bytes": bytes2, "flops": flops2},
          "peaks": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                    "f32_flops": F32_FLOPS}})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [
        {"name": "ipm_riccati_single", "route": "cuda",
         "source": "cheeta_mpc_tpu_torch/csrc/ipm_riccati_single.cu",
         "replaces": "cheeta_mpc_tpu/ops/pallas_ipm_riccati.py:455",
         "launches": launches_k1,
         "max_abs_err": max(err_k1["dx"], err_k1["du"]),
         "ms": t_k1, "plain_ms": t_k1_plain, "bound_ms": b1,
         "bound_by": by1, "library_ms": None},
        {"name": "ipm_riccati_fleet", "route": "cuda",
         "source": "cheeta_mpc_tpu_torch/csrc/ipm_riccati_fleet.cu",
         "replaces": "cheeta_mpc_tpu/ops/pallas_ipm_batch.py:620",
         "launches": launches_k2,
         "max_abs_err": max(err_k2["dx"], err_k2["du"]),
         "ms": t_k2, "plain_ms": t_k2_plain, "bound_ms": b2,
         "bound_by": by2, "library_ms": None},
    ]})
    # The run uses one card, whatever the host holds.
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
