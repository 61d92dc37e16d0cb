"""PyTorch port: the benchmark program ``cheeta_mpc_tpu_torch/bench.py``
against the JAX package's ``bench.py`` and solvers, on the CPU at its
``--small`` size.

- Its scenario functions return the arrays of ``bench.py``'s own numpy code,
  copied here with line citations, exactly (``np.array_equal``).
- Its paths (``build_paths``: the centroidal fleet under both settings, the
  cold batch-1 solve, three chained warm ticks, the on-device loop, the
  legged soft and pyramid solves, the legged batch and fleet) run in f64
  through the plain executor (``qp_backend='riccati'``) and are held against
  the JAX solvers in f64 on the same inputs (scan executor, jitted), at
  1e-6 on forces and trajectories, the bound of
  tests/test_torch_centroidal_mpc.py and tests/test_torch_legged_mpc.py.
- ``main(["--device", "cpu", "--small"])`` prints one JSON line last, with
  ``bench.py``'s keys less ``vs_baseline`` and ``dispatch_floor_ms``,
  ``gpu_selftest`` for ``tpu_selftest``, and ``card`` and ``kernels`` added;
  every number finite, ``mfu_pct`` by its formula, and no profiler session
  started.
- Without a card and without ``--device cpu`` it exits non-zero.
"""

import ast
import functools
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu import examples as jex
from cheeta_mpc_tpu.mpc import centroidal_mpc as jm
from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu.solvers.scp import ScpSettings as JScp
from cheeta_mpc_tpu_torch import bench
from cheeta_mpc_tpu_torch.utils.device_timing import (F32_FLOPS,
                                                      centroidal_solve_flops)
from tests.torch_port_util import assert_close, legged_configs

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL_SOLVE = 1e-6
S = bench.SMALL
N = bench.HORIZON
NL = S.legged_horizon

# bench.py's keys (bench.py:467-514) less vs_baseline and dispatch_floor_ms,
# tpu_selftest renamed, card and kernels added.
BENCH_PY_KEYS = {
    "metric", "value", "unit", "vs_baseline", "scan_wall_solves_per_s",
    "fleet_wall_solves_per_s", "fleet_device_ms",
    "fleet_device_solves_per_s", "fleet_mfu_pct", "fleet_vs_scan_grf_err_N",
    "batch", "batch_latency_ms", "batch_device_ms", "device_solves_per_s",
    "batch_matmul_precision", "mfu_pct", "flops_per_solve_M",
    "batch1_cold_p50_ms", "batch1_cold_p99_ms", "batch1_device_ms",
    "batch1_warm_p50_ms", "batch1_warm_p99_ms", "dispatch_floor_ms",
    "closed_loop_ticks", "closed_loop_wall_ms", "closed_loop_hz", "legged_N",
    "legged_p50_ms", "legged_p99_ms", "legged_device_ms",
    "legged_pyr_device_ms", "pyr_kernel_vs_scan_err_N",
    "legged_solves_per_s_chip_N67", "legged_batch_solves_per_s_chip_N67",
    "legged_batch_scan_solves_per_s", "legged_fleet_wall_solves_per_s",
    "legged_fleet_device_ms", "legged_fleet_device_solves_per_s",
    "legged_fleet_batch", "legged_batch", "kernel_vs_scan_grf_err_N",
    "eq_kernel_vs_scan_force_err_N", "eq_fleet_vs_scan_force_err_N",
    "f32_tier", "tpu_selftest", "device"}
PORT_KEYS = (BENCH_PY_KEYS - {"vs_baseline", "dispatch_floor_ms",
                              "tpu_selftest"}
             | {"gpu_selftest", "card", "kernels"})
PATHS = ("centroidal_fleet_scan", "centroidal_fleet", "batch1_cold",
         "batch1_warm", "closed_loop", "legged", "legged_pyr", "legged_batch",
         "legged_fleet")


def _jax_centroidal_config(dtype):
    return jm.CentroidalMpcConfig(mass=8.0, num_legs=4, horizon=N, dt=0.01,
                                  weights=tuple(jex.TEST_WEIGHTS),
                                  mu=(0.8,) * 4, dtype=jnp.dtype(dtype))


# ---------------------------------------------------------------------------
# Scenarios: bench.py's numpy code, copied.
# ---------------------------------------------------------------------------

def _bench_py_centroidal(batch):
    cfg = _jax_centroidal_config("float32")
    # bench.py:195-200
    state, des_state, des_inputs = jex.make_example_inputs(cfg, batch=batch)
    s1, d1, i1 = jex.make_example_inputs(cfg)  # unbatched scenario
    state[0], des_state[0], des_inputs[0] = s1, d1, i1
    # bench.py:316-318
    horizon = N
    dins_st = np.asarray(i1).copy()
    for li in range(4):  # all-stance hold command for the loop scenario
        dins_st[li * (4 * horizon + 3):li * (4 * horizon + 3) + horizon] = 1.0
    return (s1, d1, i1), (state, des_state, des_inputs), dins_st


def _bench_py_legged(NL_, lbatch):
    # bench.py:353-361
    x0l = np.zeros(24, np.float32)
    x0l[8] = 0.3
    x0l[12:] = [0., 0.4, -0.8, 0., -0.4, 0.8, 0., 0.4, -0.8, 0., -0.4, 0.8]
    x_ref = np.tile(x0l, (NL_ + 1, 1))
    enable = np.ones((NL_, 4), np.float32)
    enable[::2, 1] = 0.0
    enable[::2, 2] = 0.0
    zp = np.zeros((NL_, 4), np.float32)
    zv = np.zeros((NL_, 4), np.float32)
    # bench.py:404-411 (as numpy arrays)
    x0b = np.tile(x0l, (lbatch, 1)).astype(np.float32)
    x0b[:, 0] += 0.05 * np.random.default_rng(0).standard_normal(lbatch)
    x0b[0] = x0l  # element 0 = the batch-1 scenario (scan-path oracle)
    bargs = (x0b, np.repeat(x0b[:, None, :], NL_ + 1, axis=1),
             np.tile(enable, (lbatch, 1, 1)), np.tile(zp, (lbatch, 1, 1)),
             np.tile(zv, (lbatch, 1, 1)))
    return (x0l, x_ref, enable, zp, zv), bargs


def _equal(port, ref):
    assert len(port) == len(ref)
    for a, r in zip(port, ref):
        assert a.dtype == r.dtype and np.array_equal(a, r)


@pytest.mark.parametrize("batch", [S.batch, bench.FULL.batch])
def test_centroidal_scenarios_are_bench_py_s(batch):
    one, many = bench.centroidal_scenarios(bench.centroidal_config(), batch)
    r_one, r_many, r_stance = _bench_py_centroidal(batch)
    _equal(one, r_one)
    _equal(many, r_many)
    _equal((bench.loop_command(one[2], N),), (r_stance,))
    cfg = bench.centroidal_config()
    jcfg = _jax_centroidal_config("float32")
    for key in ("mass", "num_legs", "horizon", "dt", "weights", "mu"):
        assert getattr(cfg, key) == getattr(jcfg, key), key


@pytest.mark.parametrize("horizon,lbatch", [(NL, S.legged_batch),
                                            (67, bench.FULL.legged_batch)])
def test_legged_scenarios_are_bench_py_s(horizon, lbatch):
    scenario = bench.legged_scenario(horizon)
    r_scenario, r_bargs = _bench_py_legged(horizon, lbatch)
    _equal(scenario, r_scenario)
    _equal(bench.legged_batch(scenario, lbatch), r_bargs)


# ---------------------------------------------------------------------------
# The paths, f64 through the plain executor, against the JAX solvers.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port():
    """Every path of the port's bench, called once on its inputs (three
    chained ticks for the warm tick)."""
    paths = bench.build_paths("cpu", S, torch.float64, backend="riccati")
    out = {name: p.call(*p.args) for name, p in paths.items()
           if name != "batch1_warm"}
    cold = out["batch1_cold"]
    x_prev, u_prev = cold.x_traj, cold.u_traj
    ticks = []
    for _ in range(3):
        x_prev, u_prev, f = paths["batch1_warm"].call(
            *paths["batch1_warm"].args, x_prev, u_prev)
        ticks.append((x_prev, u_prev, f))
    out["batch1_warm"] = ticks
    return paths, out


@functools.lru_cache(maxsize=None)
def _jax_centroidal():
    """The JAX centroidal solves in f64 with the scan executor, jitted: the
    batch (2 SQP x 10 IPM, vmapped), three ticks of bench.py:282-288 from
    its element 0, and the loop of build_centroidal_mpc_loop."""
    jcfg = _jax_centroidal_config("float64")
    one, many, stance = _bench_py_centroidal(S.batch)

    def arrays(parts):
        return tuple(jnp.asarray(a, jnp.float64) for a in parts)

    fleet = jax.jit(jax.vmap(jm.build_centroidal_solver(
        jcfg, JScp(iterations=2, ipm=JIpm(iters=10),
                   qp_backend='riccati'))))(*arrays(many))
    rti = JScp(iterations=1, ipm=JIpm(iters=6), qp_backend='riccati')
    solve_warm = jax.jit(jm.build_centroidal_solver(jcfg, rti))

    def tick(state, des_state, des_inputs, x_prev, u_prev):  # bench.py:282
        x_w = jnp.concatenate([x_prev[1:], x_prev[-1:]])
        u_w = jnp.concatenate([u_prev[1:], u_prev[-1:]])
        sol = solve_warm(state, des_state, des_inputs, warm=(x_w, u_w))
        return sol.x_traj, sol.u_traj, sol.contact_force

    tick_j = jax.jit(tick)
    x_prev, u_prev = fleet.x_traj[0], fleet.u_traj[0]
    ticks = []
    for _ in range(3):
        x_prev, u_prev, f = tick_j(*arrays(one), x_prev, u_prev)
        ticks.append((x_prev, u_prev, f))
    loop = jax.jit(jm.build_centroidal_mpc_loop(jcfg, rti,
                                                n_ticks=S.loop_ticks))(
        *arrays((one[0], one[1], stance)))
    return fleet, ticks, loop


@functools.lru_cache(maxsize=None)
def _jax_legged(cone_mode):
    """The JAX legged solve in f64 (scan executor, jitted) on bench.py's
    scenario: the soft cone on the batch (vmapped; element 0 is the batch-1
    scenario), the pyramid cone at batch 1."""
    from cheeta_mpc_tpu.mpc import legged_mpc as jl
    ipm = {} if cone_mode == "soft" else dict(iters=10)
    jcfg, jscp, tcfg, tscp = legged_configs(NL, cone_mode, iterations=1,
                                            qp_backend='riccati', ipm=ipm)
    scenario, bargs = _bench_py_legged(NL, S.legged_batch)
    solve = jl.build_legged_solver(jcfg, jscp)
    if cone_mode == "soft":
        solve, scenario = jax.vmap(solve), bargs
    return tcfg, tscp, jax.jit(solve)(
        *(jnp.asarray(a, jnp.float64) for a in scenario))


def _close(port, ref, names, what):
    for name in names:
        assert_close(getattr(port, name), getattr(ref, name), ATOL_SOLVE,
                     what=f"{what}: {name}")


@pytest.mark.parametrize("name", ["centroidal_fleet_scan",
                                  "centroidal_fleet", "batch1_cold"])
def test_centroidal_solve_paths_match_jax(name):
    _, out = _port()
    ref = _jax_centroidal()[0]
    sol = out[name]
    assert sol.contact_force.dtype == torch.float64
    if name == "batch1_cold":  # bench.py's oracle: element 0 of the batch
        ref = jax.tree.map(lambda a: a[0], ref)
    _close(sol, ref, ("contact_force", "x_traj", "u_traj", "foot_pos"), name)


def test_warm_ticks_match_jax():
    _, out = _port()
    ticks = _jax_centroidal()[1]
    for i, (port, ref) in enumerate(zip(out["batch1_warm"], ticks)):
        for what, a, r in zip(("x_traj", "u_traj", "contact_force"),
                              port, ref):
            assert_close(a, r, ATOL_SOLVE, what=f"tick {i}: {what}")


def test_closed_loop_matches_jax():
    _, out = _port()
    xs, fs = out["closed_loop"]
    rxs, rfs = _jax_centroidal()[2]
    assert fs.shape == (S.loop_ticks, 4, 3)
    assert_close(xs, rxs, ATOL_SOLVE, what="loop states")
    assert_close(fs, rfs, ATOL_SOLVE, what="loop forces")


@pytest.mark.parametrize("name", ["legged", "legged_batch", "legged_fleet",
                                  "legged_pyr"])
def test_legged_paths_match_jax(name):
    _, out = _port()
    cone = "pyramid" if name == "legged_pyr" else "soft"
    tcfg, tscp, ref = _jax_legged(cone)
    # The bench's configuration is the one the JAX package's converts to.
    assert bench.legged_config(NL, cone, torch.float64) == tcfg
    scp = bench.PYRAMID if cone == "pyramid" else bench.LEGGED
    assert (scp.iterations, scp.ipm.iters) == (tscp.iterations,
                                               tscp.ipm.iters)
    if name == "legged":
        ref = jax.tree.map(lambda a: a[0], ref)
    elif name == "legged_fleet":
        ref = jax.tree.map(lambda a: a[:S.legged_fleet], ref)
    _close(out[name], ref, ("forces", "x_traj", "u_traj"), name)


# ---------------------------------------------------------------------------
# The program.
# ---------------------------------------------------------------------------

def _numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


# ``main(["--device", "cpu", "--small"])`` with every profiler session
# made to raise, in a child process that the module's first test starts, so
# that it runs beside the JAX compilations of the tests above.
MAIN = """
import sys
from unittest import mock

def refuse(*args, **kwargs):
    raise AssertionError("the bench started a profiler session")

with mock.patch("torch.profiler.profile", refuse), \\
        mock.patch("torch.autograd.profiler.profile", refuse):
    from cheeta_mpc_tpu_torch import bench
    sys.exit(bench.main(["--device", "cpu", "--small"]))
"""
_child = {}


@pytest.fixture(autouse=True, scope="module")
def _start_main():
    """Starts the child; the module's own torch work runs on one thread
    (its solves are small: more threads only contend with the child and
    the JAX compilations)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    _child["proc"] = subprocess.Popen(
        [sys.executable, "-c", MAIN], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if _child["proc"].poll() is None:
        _child["proc"].kill()
        _child["proc"].communicate()


@functools.lru_cache(maxsize=None)
def _main_output():
    """(exit code, stdout, stderr) of the child running ``main``."""
    out, err = _child["proc"].communicate(timeout=600)
    return _child["proc"].returncode, out, err


def _result():
    return json.loads(_main_output()[1].strip().splitlines()[-1])


def test_main_prints_one_json_line_last():
    rc, out, err = _main_output()
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert all(ln.startswith("#") for ln in lines[:-1])
    result = json.loads(lines[-1])
    assert set(result) == PORT_KEYS == bench.RESULT_KEYS
    assert all(math.isfinite(v) for v in _numbers(result))
    assert result["device"] == "cpu" and result["card"] is None
    assert (result["batch"], result["legged_N"], result["legged_batch"],
            result["legged_fleet_batch"], result["closed_loop_ticks"]) == (
        S.batch, NL, S.legged_batch, S.legged_fleet, S.loop_ticks)
    assert result["value"] == max(result["scan_wall_solves_per_s"],
                                  result["fleet_wall_solves_per_s"])


def test_main_reports_each_paths_launches():
    """On the CPU the wrappers run their plain versions: no launch."""
    result = _result()
    assert set(result["kernels"]) == set(PATHS)
    for counts in result["kernels"].values():
        assert counts == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


@pytest.mark.parametrize("key,device_key", [("mfu_pct", "batch_device_ms"),
                                            ("fleet_mfu_pct",
                                             "fleet_device_ms")])
def test_mfu_pct_is_the_formula(key, device_key):
    result = _result()
    flops = centroidal_solve_flops(10, 33, 24, 32, 2, 10)
    assert result["flops_per_solve_M"] == flops / 1e6
    want = 100.0 * S.batch * flops / (result[device_key] / 1e3) / F32_FLOPS
    assert result[key] == pytest.approx(want, rel=1e-12)


def test_without_a_card_it_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "cheeta_mpc_tpu_torch.bench", "--small"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "--device cpu" in proc.stderr


def test_source_names_no_profiler():
    path = ROOT / "cheeta_mpc_tpu_torch" / "bench.py"
    text = path.read_text()
    assert "torch.profiler" not in text and "autograd.profiler" not in text
    imported = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            imported.add(node.module)
        elif isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
    assert not any("profiler" in m for m in imported)


def test_import_check_covers_the_bench():
    from tests import test_torch_imports
    assert ROOT / "cheeta_mpc_tpu_torch" / "bench.py" in \
        test_torch_imports.PORT_FILES
