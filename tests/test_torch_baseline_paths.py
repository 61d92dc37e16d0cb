"""PyTorch port: the BASELINE scenarios of the root ``bench.py`` through the
port's entry points, against the JAX solvers, on the CPU.

The scenarios are ``bench.py``'s own numpy code, copied here with line
citations. Each path runs in f64 through the plain executor
(``qp_backend='riccati'``) and is held against the JAX solver in f64 on the
same inputs (scan executor, jitted), at 1e-6 on forces and trajectories, the
bound of tests/test_torch_centroidal_mpc.py and
tests/test_torch_legged_mpc.py:

- ``build_centroidal_solver`` on a fleet under ``bench.py``'s "scan"
  setting (``matmul_precision='high'``) and its "fleet" setting (the
  default), and ``CentroidalMPC.update_mpc`` on the cold batch-1 scenario,
  2 SQP x 10 IPM each;
- three chained warm ticks (``bench.py:282-288``: 1 SQP x 6 IPM, the
  previous solution shifted one node);
- ``build_centroidal_mpc_loop``: the on-device loop on the all-stance hold;
- ``build_legged_solver``: the soft cone at batch 1 and on two batches, the
  pyramid cone (10 IPM iterations) at batch 1.

The sizes are cut for the CPU: a centroidal fleet of 4 (``bench.py``: 1024),
3 loop ticks (20), the legged task at horizon 8 (67) on batches of 4 and 2
(512 and 128). The benchmark measures the port at full size
(``BENCHMARK.json``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu import examples as jex
from cheeta_mpc_tpu.mpc import centroidal_mpc as jm
from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu.solvers.scp import ScpSettings as JScp
from cheeta_mpc_tpu_torch.examples import LEGGED_TEST_WEIGHTS, TEST_WEIGHTS
from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import (
    CentroidalMPC, CentroidalMpcConfig, build_centroidal_mpc_loop,
    build_centroidal_solver)
from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                 build_legged_solver)
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
from tests.torch_port_util import assert_close, legged_configs

ATOL_SOLVE = 1e-6
N = 10  # bench.py's centroidal horizon
BATCH, LOOP_TICKS = 4, 3
NL, LEGGED_BATCH, LEGGED_FLEET = 8, 4, 2
F64 = torch.float64
# bench.py's settings (bench.py:186-187, 228-230, 278-279, 349-350, 379-380,
# 401-403) on the plain executor.
SCAN = ScpSettings(iterations=2, ipm=IpmSettings(iters=10),
                   matmul_precision='high', qp_backend='riccati')
FLEET = ScpSettings(iterations=2, ipm=IpmSettings(iters=10),
                    qp_backend='riccati')
RTI = ScpSettings(iterations=1, ipm=IpmSettings(iters=6),
                  qp_backend='riccati')
LEGGED = {"soft": ScpSettings(iterations=1, qp_backend='riccati'),
          "pyramid": ScpSettings(iterations=1, ipm=IpmSettings(iters=10),
                                 qp_backend='riccati')}
LEGGED_BATCH_SCP = LEGGED["soft"]._replace(matmul_precision='high')


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


# ---------------------------------------------------------------------------
# The port's paths, f64 through the plain executor.
# ---------------------------------------------------------------------------

def _f64(arrays):
    return tuple(torch.as_tensor(a, dtype=F64) for a in arrays)


@functools.lru_cache(maxsize=None)
def _port():
    """Every path, called once on its inputs (three chained ticks for the
    warm tick), by name."""
    cfg = CentroidalMpcConfig(mass=8.0, num_legs=4, horizon=N, dt=0.01,
                              weights=tuple(TEST_WEIGHTS), mu=(0.8,) * 4,
                              dtype=F64)
    one, many, stance = _bench_py_centroidal(BATCH)
    one, many = _f64(one), _f64(many)
    out = {
        "centroidal_fleet_scan": build_centroidal_solver(
            cfg, SCAN, device="cpu")(*many),
        "centroidal_fleet": build_centroidal_solver(
            cfg, FLEET, device="cpu")(*many)}
    mpc = CentroidalMPC(cfg.mass, cfg.num_legs, N, cfg.dt, TEST_WEIGHTS,
                        cfg.mu, dtype=F64, scp=FLEET,
                        device="cpu").setup_mpc()
    cold = out["batch1_cold"] = mpc.update_mpc(*one)
    solve_warm = build_centroidal_solver(cfg, RTI, device="cpu")
    x_prev, u_prev, ticks = cold.x_traj, cold.u_traj, []
    for _ in range(3):  # bench.py:282-288
        x_w = torch.cat([x_prev[1:], x_prev[-1:]])
        u_w = torch.cat([u_prev[1:], u_prev[-1:]])
        sol = solve_warm(*one, warm=(x_w, u_w))
        x_prev, u_prev = sol.x_traj, sol.u_traj
        ticks.append((x_prev, u_prev, sol.contact_force))
    out["batch1_warm"] = ticks
    out["closed_loop"] = build_centroidal_mpc_loop(
        cfg, RTI, n_ticks=LOOP_TICKS, device="cpu")(
        *_f64((one[0], one[1], stance)))
    scenario, bargs = _bench_py_legged(NL, LEGGED_BATCH)
    for name, cone, scp, args in (
            ("legged", "soft", LEGGED["soft"], scenario),
            ("legged_pyr", "pyramid", LEGGED["pyramid"], scenario),
            ("legged_batch", "soft", LEGGED_BATCH_SCP, bargs),
            ("legged_fleet", "soft", LEGGED_BATCH_SCP,
             tuple(a[:LEGGED_FLEET] for a in bargs))):
        lcfg = LeggedMpcConfig(horizon=NL, cone_mode=cone, dtype=F64,
                               **LEGGED_TEST_WEIGHTS)
        out[name] = build_legged_solver(lcfg, scp, device="cpu")(*_f64(args))
    return out


# ---------------------------------------------------------------------------
# The JAX solvers, f64, scan executor.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_centroidal():
    """The JAX centroidal solves in f64 with the scan executor, jitted: the
    batch (2 SQP x 10 IPM, vmapped), three ticks of bench.py:282-288 from
    its element 0, and the loop of build_centroidal_mpc_loop."""
    jcfg = _jax_centroidal_config("float64")
    one, many, stance = _bench_py_centroidal(BATCH)

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
                                                n_ticks=LOOP_TICKS))(
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
    scenario, bargs = _bench_py_legged(NL, LEGGED_BATCH)
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
    ref = _jax_centroidal()[0]
    sol = _port()[name]
    assert sol.contact_force.dtype == torch.float64
    if name == "batch1_cold":  # bench.py's oracle: element 0 of the batch
        ref = jax.tree.map(lambda a: a[0], ref)
    _close(sol, ref, ("contact_force", "x_traj", "u_traj", "foot_pos"), name)


def test_warm_ticks_match_jax():
    ticks = _jax_centroidal()[1]
    for i, (port, ref) in enumerate(zip(_port()["batch1_warm"], ticks)):
        for what, a, r in zip(("x_traj", "u_traj", "contact_force"),
                              port, ref):
            assert_close(a, r, ATOL_SOLVE, what=f"tick {i}: {what}")


def test_closed_loop_matches_jax():
    xs, fs = _port()["closed_loop"]
    rxs, rfs = _jax_centroidal()[2]
    assert fs.shape == (LOOP_TICKS, 4, 3)
    assert_close(xs, rxs, ATOL_SOLVE, what="loop states")
    assert_close(fs, rfs, ATOL_SOLVE, what="loop forces")


@pytest.mark.parametrize("name", ["legged", "legged_batch", "legged_fleet",
                                  "legged_pyr"])
def test_legged_paths_match_jax(name):
    cone = "pyramid" if name == "legged_pyr" else "soft"
    tcfg, tscp, ref = _jax_legged(cone)
    # The port's configuration is the one the JAX package's converts to.
    assert LeggedMpcConfig(horizon=NL, cone_mode=cone, dtype=F64,
                           **LEGGED_TEST_WEIGHTS) == tcfg
    scp = LEGGED[cone]
    assert (scp.iterations, scp.ipm.iters) == (tscp.iterations,
                                               tscp.ipm.iters)
    if name == "legged":
        ref = jax.tree.map(lambda a: a[0], ref)
    elif name == "legged_fleet":
        ref = jax.tree.map(lambda a: a[:LEGGED_FLEET], ref)
    _close(_port()[name], ref, ("forces", "x_traj", "u_traj"), name)
