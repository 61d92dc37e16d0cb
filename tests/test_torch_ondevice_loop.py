"""PyTorch port: the n-tick receding-horizon loop
(mpc/centroidal_mpc.build_centroidal_mpc_loop) against the JAX package's
``lax.scan`` loop on the same packed numpy inputs.

On a card the port captures the whole loop as one CUDA graph
(``chip_smoke.py`` phase ``closed_loop``); here it runs eagerly on the CPU.
f64 with ``qp_backend='riccati'`` on both sides, N=10, four ticks on an
all-stance hold. Tolerance: 1e-6 on states and forces, that of
tests/test_torch_centroidal_mpc.py for the same solver (each tick is one
warm-started solve of the same algorithm; the plant step is exact
arithmetic on the solution). The two properties of tests/test_ondevice_loop.py
hold for the port's loop: it supports the weight within 5 % and holds the
CoM height within 1 cm, and its first tick is the warm re-solve of a cold
solve (bound 1e-4 N, that test's).
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
from cheeta_mpc_tpu_torch import examples as tex
from cheeta_mpc_tpu_torch.convert import (config_from_dict,
                                          scp_settings_from_dict)
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from tests.torch_port_util import assert_close, max_err

N, TICKS = 10, 4
ATOL = 1e-6
MG = 8.0 * 9.81


def _configs(dtype="float64", qp_backend="riccati"):
    jcfg = jm.CentroidalMpcConfig(
        mass=8.0, num_legs=4, horizon=N, dt=0.01,
        weights=tuple(jex.TEST_WEIGHTS), mu=(0.8,) * 4,
        dtype=jnp.dtype(dtype))
    d = jcfg._asdict()
    d["dtype"] = dtype
    jscp = JScp(iterations=1, ipm=JIpm(iters=6), qp_backend=qp_backend)
    sd = jscp._asdict()
    sd["ipm"] = jscp.ipm._asdict()
    return jcfg, jscp, config_from_dict(d), scp_settings_from_dict(sd)


def _stance_inputs(cfg):
    """The trot scenario with an all-stance contact table (a hold)."""
    state, des, dins = tex.make_example_inputs(cfg)
    dins = dins.copy()
    for i in range(4):
        dins[i * (4 * N + 3):i * (4 * N + 3) + N] = 1.0
    return state, des, dins


@functools.lru_cache(maxsize=None)
def _loops():
    jcfg, jscp, tcfg, tscp = _configs()
    inputs = _stance_inputs(tcfg)
    ref = jax.jit(jm.build_centroidal_mpc_loop(jcfg, jscp, n_ticks=TICKS))(
        *(jnp.asarray(a) for a in inputs))
    loop = tm.build_centroidal_mpc_loop(tcfg, tscp, n_ticks=TICKS,
                                        device="cpu")
    return tcfg, tscp, inputs, loop(*inputs), tuple(np.asarray(r)
                                                    for r in ref)


def test_loop_matches_jax():
    _, _, _, (xs, fs), (rxs, rfs) = _loops()
    assert xs.shape == (TICKS, 33) and fs.shape == (TICKS, 4, 3)
    assert xs.dtype == torch.float64
    assert_close(xs, rxs, ATOL, what="states")
    assert_close(fs, rfs, ATOL, what="forces")


def test_loop_regulates_and_supports_weight():
    _, _, _, (xs, fs), _ = _loops()
    assert bool(torch.isfinite(xs).all()) and bool(torch.isfinite(fs).all())
    fz = fs[:, :, 2].sum(dim=1)
    assert bool(((fz - MG).abs() < 0.05 * MG).all()), fz
    assert abs(float(xs[-1, 2] - xs[0, 2])) < 0.01


def test_loop_first_tick_matches_single_solve():
    tcfg, tscp, inputs, (_, fs), _ = _loops()
    solve = tm.build_centroidal_solver(tcfg, tscp, device="cpu")
    sol = solve(*inputs)
    sol_w = solve(*inputs, warm=(sol.x_traj, sol.u_traj))
    err = max_err(fs[0], sol_w.contact_force[:, :, 0])
    print(f"tick 0 vs warm re-solve: {err} N")
    assert err <= 1e-4


def test_loop_takes_a_batch_of_scenarios():
    """A leading batch dimension runs a loop per scenario; each equals its
    own unbatched loop."""
    tcfg, tscp, inputs, (xs, fs), _ = _loops()
    loop = tm.build_centroidal_mpc_loop(tcfg, tscp, n_ticks=2, device="cpu")
    moved = (inputs[0] + np.r_[0.0, 0.0, 0.01, np.zeros(18)],) + inputs[1:]
    bxs, bfs = loop(*(np.stack([a, b]) for a, b in zip(inputs, moved)))
    assert bxs.shape == (2, 2, 33) and bfs.shape == (2, 2, 4, 3)
    assert_close(bxs[0], xs[:2], 1e-9, what="batched states")
    one_xs, _ = loop(*moved)
    assert_close(bxs[1], one_xs, 1e-9, what="batched states, element 1")


def test_f32_default_backend_loop_against_f64():
    """The port's default backend in f32 (the kernels' plain versions on
    the CPU; K1 on the card) against the f64 loop: the JAX package's bound
    for its f32 kernel path, 5e-2 N."""
    _, _, tcfg, tscp = _configs(dtype="float32",
                                qp_backend="riccati_pallas")
    assert tscp.qp_backend == "riccati_kernel"
    tcfg64, tscp64, inputs, (_, fs64), _ = _loops()
    _, fs = tm.build_centroidal_mpc_loop(tcfg, tscp, n_ticks=TICKS,
                                         device="cpu")(*inputs)
    assert fs.dtype == torch.float32
    assert max_err(fs, fs64) <= 5e-2

