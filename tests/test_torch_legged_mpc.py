"""PyTorch port, the legged slice as a whole: mpc/legged_mpc.py (with
solvers/scp.py, models/srbd_legged.py, mpc/friction_cone.py and the QP
executors under it) against the JAX package on the same numpy inputs.

The configuration is built in code with the port's stand-in weights
(``LEGGED_TEST_WEIGHTS``), never from task.info. f64 with
``qp_backend='riccati'`` on both sides: the same algorithm in the same
order, differing in the SPD inverse and in how the Jacobians are obtained
(nested ``jax.jvp``/``jax.jacfwd`` vs closed-form foot velocities under one
``torch.func.jacfwd``). Tolerances: 1e-9 on every leaf of the first OCP-QP;
1e-6 on forces and trajectories after the SQP iterations (forces are of
order 150 N); line-search steps, step types and convergence codes are
discrete and must be identical.

In f32 the port's default backend on the CPU (the kernels' plain versions)
is held against the JAX solver with ``eq_backend='pallas'`` in interpret
mode to the JAX package's own bound for that pair, 2e-3 of the force scale.
"""

import functools

import numpy as np
import pytest
import torch

from cheeta_mpc_tpu_torch import examples as tex
from cheeta_mpc_tpu_torch.convert import solution_to_numpy, warm_from_numpy
from cheeta_mpc_tpu_torch.mpc import legged_mpc as tl
from tests.torch_port_util import (assert_close, assert_qp_data_close,
                                   jax_legged_solve, legged_configs, max_err)

N = 6
ATOL_SOLVE = 1e-6
ATOL_DATA = 1e-9


def _compare(sol, ref, steps, atol=ATOL_SOLVE):
    for name in ("forces", "x_traj", "u_traj", "joint_vel"):
        assert_close(getattr(sol, name), getattr(ref, name), atol, what=name)
    assert_close(sol.merit, ref.merit, atol, rtol=1e-9, what="merit")
    assert np.array_equal(sol.step_size.numpy(), np.asarray(steps))
    assert np.array_equal(sol.convergence.numpy(), np.asarray(ref.convergence))
    assert sol.convergence.dtype == torch.int32


@functools.lru_cache(maxsize=None)
def _solved(cone_mode):
    """One JAX solve (2 SQP iterations, cold start) and the port's, shared
    by the tests below: the JAX side costs tens of seconds of tracing."""
    jcfg, jscp, tcfg, tscp = legged_configs(N, cone_mode, iterations=2,
                                            qp_backend='riccati')
    inp = tex.make_legged_example_inputs(tcfg, seed=1)
    ref = jax_legged_solve(jcfg, jscp, inp.args)
    solve = tl.build_legged_solver(tcfg, tscp, device="cpu")
    return jcfg, jscp, tcfg, tscp, inp, ref, solve, solve(*inp.args)


@pytest.fixture(scope="module", params=["soft", "pyramid"])
def solved(request):
    return _solved(request.param)


def test_config_converts_one_to_one(solved):
    jcfg, jscp, tcfg, tscp = solved[:4]
    jd, td = jcfg._asdict(), tcfg._asdict()
    assert set(jd) == set(td)
    for key in ("horizon", "q_diag", "r_diag", "friction_mu", "force_max",
                "position_error_gain", "cone_mode", "barrier_mu",
                "barrier_delta"):
        assert jd[key] == td[key], key
    assert jcfg.params.desc._asdict() == tcfg.params.desc._asdict()
    assert (jcfg.params.dt, jcfg.params.integrator) == (
        tcfg.params.dt, tcfg.params.integrator)
    assert tcfg.dtype == torch.float64 and tscp.qp_backend == 'riccati'
    # Ported with the runtime; held against the JAX package's on a written
    # task.info in tests/test_torch_info_config.py.
    assert callable(tl.LeggedMpcConfig.from_task_info)


def test_first_qp_leaf_by_leaf(solved):
    """The assembled OCP-QP at the initial iterate: dynamics Jacobians, the
    block-diagonal barrier Hessian in R (soft) or the pyramid rows
    (pyramid), the masked equality rows."""
    _, _, tcfg, _, inp, ref, solve, _ = solved
    qp = solve.initial_qp(*inp.args)
    assert_qp_data_close(qp, ref[3], ATOL_DATA)
    assert (qp.con is None) == (tcfg.cone_mode == "soft")
    # inactive equality rows are exactly zero
    off = qp.eq.mask == 0
    assert float(qp.eq.C[off].abs().max()) == 0.0
    assert float(qp.eq.D[off].abs().max()) == 0.0
    assert bool(off.any()) and bool((~off).any())


def test_solve_matches_jax(solved):
    ref, steps, _, _ = solved[5]
    sol = solved[7]
    _compare(sol, ref, steps)
    assert tuple(sol.forces.shape) == (N, 4, 3)
    assert tuple(sol.step_size.shape) == (2,)
    enable = torch.as_tensor(solved[4].enable)
    assert float(sol.forces[enable == 0].abs().max()) == 0.0
    for name in ("gains_K", "gains_P", "gains_p"):
        assert_close(getattr(sol, name), getattr(ref, name), 1e-5, rtol=1e-7,
                     what=name)
    perf = solution_to_numpy(sol.performance)
    for name in ("cost", "dyn_violation_sse", "eq_constraint_sse"):
        assert_close(perf[name], getattr(ref.performance, name), 1e-6,
                     rtol=1e-9, what=name)


def test_warm_start_and_event_aligned_grid(solved):
    """One SQP iteration from the previous solution (``warm=``) on the
    event-aligned grid (``dts=``)."""
    jcfg, jscp, tcfg, tscp, _, ref, _, _ = solved
    many = tex.make_legged_example_inputs(tcfg, batch=8, seed=1,
                                          event_aligned=True)
    # a scenario whose short window holds a gait event (a snapped node)
    pick = next(i for i in range(8) if np.ptp(many.dts[i]) > 1e-3)
    inp = tex.LeggedExampleInputs(*(a[pick] for a in many))
    warm = (np.asarray(ref[0].x_traj), np.asarray(ref[0].u_traj))
    jscp1, tscp1 = jscp._replace(iterations=1), tscp._replace(iterations=1)
    jref, steps, _, qp = jax_legged_solve(jcfg, jscp1, inp.args, warm=warm,
                                          dts=inp.dts)
    solve = tl.build_legged_solver(tcfg, tscp1, device="cpu")
    twarm = warm_from_numpy(*warm, dtype=torch.float64, device="cpu")
    assert_qp_data_close(
        solve.initial_qp(*inp.args, warm=twarm, dts=inp.dts), qp, ATOL_DATA)
    sol = solve(*inp.args, warm=twarm, dts=inp.dts)
    _compare(sol, jref, steps)
    assert tuple(sol.step_size.shape) == (1,)
    # the state at node 0 is the measured one, not the warm start's
    assert_close(sol.x_traj[0], inp.x0, 1e-15)


def test_f32_default_backend_against_jax_pallas_kernel():
    """The port's default backend on the CPU runs K3's plain version; the
    JAX solver with ``eq_backend='pallas'`` runs the Pallas kernel in
    interpret mode. Bound: the JAX package's own for this pair of f32
    executors, 2e-3 of the force scale."""
    jcfg, jscp, tcfg, tscp = legged_configs(
        N, "soft", dtype="float32", iterations=1,
        ipm=dict(eq_backend='pallas'))
    # One switch in the port: the JAX package's eq_backend='pallas' is the
    # port's qp_backend='riccati_kernel'; eq_backend itself selects nothing.
    assert tscp.ipm.eq_backend == 'pallas' and tscp.qp_backend == 'riccati'
    tscp = tscp._replace(qp_backend='riccati_kernel')
    assert tcfg.dtype == torch.float32
    inp = tex.make_legged_example_inputs(tcfg, seed=1)
    ref, steps, _, _ = jax_legged_solve(jcfg, jscp, inp.args)
    sol = tl.build_legged_solver(tcfg, tscp, device="cpu")(*inp.args)
    scale = max(1.0, float(np.abs(np.asarray(ref.forces)).max()))
    err = max_err(sol.forces, ref.forces)
    print(f"f32 K3 plain vs Pallas interpret: {err} N at scale {scale}")
    assert sol.forces.dtype == torch.float32
    assert err <= 2e-3 * scale
    assert np.array_equal(sol.step_size.numpy(), np.asarray(steps))
    assert bool(torch.isfinite(sol.gains_P).all())


@pytest.mark.parametrize("cone_mode", ["soft", "pyramid"])
def test_f32_default_backend_against_f64(cone_mode):
    """The kernels' plain versions in f32 (K3 for the soft cone, K1 with
    stage equalities for the pyramid) against the port's f64 solve: 2e-3 of
    the force scale."""
    _, _, tcfg, tscp = legged_configs(N, cone_mode, dtype="float32",
                                      iterations=1,
                                      qp_backend='riccati_pallas')
    assert tscp.qp_backend == 'riccati_kernel'
    inp = tex.make_legged_example_inputs(tcfg, seed=1)
    sol = tl.build_legged_solver(tcfg, tscp, device="cpu")(*inp.args)
    ref = tl.build_legged_solver(
        tcfg._replace(dtype=torch.float64),
        tscp._replace(qp_backend='riccati'), device="cpu")(*inp.args)
    scale = max(1.0, float(ref.forces.abs().max()))
    assert max_err(sol.forces, ref.forces) <= 2e-3 * scale
    assert np.array_equal(sol.step_size.numpy(), ref.step_size.numpy())


def test_entry_point_defaults_to_the_card():
    """``device`` defaults to "cuda": without a card ``build_legged_solver``
    raises instead of carrying on on the CPU."""
    _, _, tcfg, tscp = legged_configs(N, "soft")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.build_legged_solver(tcfg, tscp)


def test_reference_trajectories_match_jax():
    from cheeta_mpc_tpu.mpc import legged_mpc as jl
    jcfg, _, tcfg, _ = legged_configs(N, "soft")
    x0 = tex.default_stance_state(tcfg)
    assert np.array_equal(tl.make_standing_reference(tcfg, x0, 0.5),
                          jl.make_standing_reference(jcfg, x0, 0.5))
    assert np.array_equal(
        tl.make_velocity_command_reference(tcfg, x0, (0.3, 0.0, 0.0), 0.1),
        jl.make_velocity_command_reference(jcfg, x0, (0.3, 0.0, 0.0), 0.1))
    assert (tl.NL, tl.NC_EQ, tl.NG) == (jl.NL, jl.NC_EQ, jl.NG)
