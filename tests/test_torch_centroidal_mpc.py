"""PyTorch port, the slice as a whole: mpc/centroidal_mpc.py (with
solvers/scp.py, models/centroidal.py and the QP executors under it) against
the JAX package on the same packed numpy inputs.

f64 throughout, ``qp_backend='riccati'`` on both sides: the same algorithm
in the same order, differing in the SPD inverse (Cholesky vs Schur + Newton)
and in the cost derivatives (closed form vs ``jax.grad``/``jax.hessian``).
Tolerances: 1e-10 on the QP data of one linearization (roundoff of order-100
weights times order-50 forces); 1e-6 on forces and trajectories after 2 SQP
x 10 IPM iterations, which amplify inverse roundoff through barrier weights
up to 1e9. Line-search steps, step types and convergence codes are discrete
and must be identical.
"""

import functools

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
                                          scp_settings_from_dict,
                                          solution_to_numpy, warm_from_numpy)
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from tests.torch_port_util import (assert_close, assert_qp_data_close,
                                   jax_centroidal_solve)

ATOL_SOLVE = 1e-6
ATOL_DATA = 1e-10


def _configs(N, dtype="float64"):
    """The JAX config and the port's, the latter made from the former's
    ``_asdict()`` as ``convert`` documents."""
    jcfg = jm.CentroidalMpcConfig(
        mass=8.0, num_legs=4, horizon=N, dt=0.01,
        weights=tuple(jex.TEST_WEIGHTS), mu=(0.8,) * 4,
        dtype=jnp.dtype(dtype))
    d = jcfg._asdict()
    d["dtype"] = dtype
    jscp = JScp(iterations=2, ipm=JIpm(iters=10), qp_backend='riccati')
    sd = jscp._asdict()
    sd["ipm"] = jscp.ipm._asdict()
    return jcfg, jscp, config_from_dict(d), scp_settings_from_dict(sd)


def _compare_solutions(sol, ref, steps, types, atol=ATOL_SOLVE):
    for name in ("contact_force", "foot_pos", "x_traj", "u_traj", "com_pos",
                 "com_vel", "ang_mom"):
        assert_close(getattr(sol, name), getattr(ref, name), atol, what=name)
    # The merit is a sum of order 1e3: same tolerance, relative.
    assert_close(sol.merit, ref.merit, atol, rtol=1e-9, what="merit")
    assert np.array_equal(sol.step_size.numpy(), np.asarray(steps))
    assert np.array_equal(sol.step_type.numpy(), np.asarray(types))
    assert np.array_equal(sol.convergence.numpy(), np.asarray(ref.convergence))
    assert sol.step_type.dtype == torch.int32


def test_examples_are_the_same_numbers():
    """The copied scenario generator gives the JAX package's packed inputs
    bit for bit (both are numpy)."""
    jcfg, _, tcfg, _ = _configs(10)
    assert tex.TEST_WEIGHTS == jex.TEST_WEIGHTS
    for kw in (dict(), dict(seed=5, gait="bound"),
               dict(batch=3, seed=2, gait="gallop"), dict(gait="stance")):
        for a, b in zip(tex.make_example_inputs(tcfg, **kw),
                        jex.make_example_inputs(jcfg, **kw)):
            assert np.array_equal(a, b)
    for kind in ("trot", "bound", "pace", "gallop", "stance"):
        assert np.array_equal(tex.gait_table(kind, 10),
                              jex.gait_table(kind, 10))
    with pytest.raises(ValueError):
        tex.gait_table("hop", 10)


def test_unpack_reference_inputs_matches_jax():
    jcfg, _, tcfg, _ = _configs(6)
    inputs = tex.make_example_inputs(tcfg, seed=4)
    ref = jm._unpack_reference_inputs(jcfg, *inputs)
    got = tm._unpack_reference_inputs(tcfg, *inputs)
    for name in ref._fields:
        assert_close(getattr(got, name), getattr(ref, name), 0.0, what=name)
    # A batch on a leading dimension: element i is the unbatched decode.
    many = tex.make_example_inputs(tcfg, batch=3, seed=4)
    gotb = tm._unpack_reference_inputs(tcfg, *many)
    for i in range(3):
        refi = jm._unpack_reference_inputs(jcfg, *(a[i] for a in many))
        for name in refi._fields:
            assert_close(getattr(gotb, name)[i], getattr(refi, name), 0.0,
                         what=name)


@functools.lru_cache(maxsize=None)
def _solved(N):
    """One JAX solve and one port solve per horizon, shared by the tests
    below (the JAX side costs tens of seconds of tracing)."""
    jcfg, jscp, tcfg, tscp = _configs(N)
    inputs = tex.make_example_inputs(tcfg, seed=3)
    ref = jax_centroidal_solve(jcfg, jscp, inputs)
    solve = tm.build_centroidal_solver(tcfg, tscp, device="cpu")
    return N, jcfg, jscp, tcfg, tscp, inputs, ref, solve, solve(*inputs)


@pytest.fixture(scope="module", params=[6, 10])
def solved(request):
    return _solved(request.param)


def test_first_qp_matches_jax(solved):
    """Dynamics Jacobians, closed-form cost blocks (vs jax.grad/hessian),
    constraint rows, shifted bounds and masks of the linearization at the
    initial iterate."""
    _, _, _, _, _, inputs, ref, solve, _ = solved
    assert_qp_data_close(solve.initial_qp(*inputs), ref[3], ATOL_DATA)


def test_full_solve_matches_jax(solved):
    N, _, _, _, _, _, ref, _, sol = solved
    rsol, steps, types, _ = ref
    _compare_solutions(sol, rsol, steps, types)
    assert sol.contact_force.shape == (4, 3, N)
    assert sol.foot_pos.shape == (4, 3, N + 1)
    assert_close(sol.qp_mu, rsol.qp_mu, ATOL_SOLVE)
    for name in ("merit", "cost", "dyn_violation_sse", "eq_constraint_sse",
                 "ineq_constraint_sse"):
        assert_close(getattr(sol.performance, name),
                     getattr(rsol.performance, name), ATOL_SOLVE, rtol=1e-9,
                     what=name)
    # The solve moved: forces differ from the warm start's m g / stance.
    assert float(sol.step_size.sum()) > 0


def test_warm_started_second_solve_matches_jax():
    """``warm=`` from the first solution, at a state moved one step on: the
    linearization point is then not the rollout of the reference forces, so
    the first QP also checks the cost derivatives away from it."""
    N, jcfg, jscp, tcfg, tscp, inputs, ref, solve, sol = _solved(6)
    state = np.array(inputs[0])
    state[:9] = sol.x_traj[1, :9].numpy()
    moved = (state, inputs[1], inputs[2])
    x_w, u_w = sol.x_traj.numpy(), sol.u_traj.numpy()
    rsol, steps, types, rqp = jax_centroidal_solve(jcfg, jscp, moved,
                                                   warm=(x_w, u_w))
    warm = warm_from_numpy(x_w, u_w, dtype="float64", device="cpu")
    assert_qp_data_close(solve.initial_qp(*moved, warm=warm), rqp, ATOL_DATA)
    _compare_solutions(solve(*moved, warm=warm), rsol, steps, types)


def test_facade_and_numpy_export(solved):
    N, _, _, tcfg, tscp, inputs, _, _, sol = solved
    mpc = tm.CentroidalMPC(8.0, 4, N, 0.01, tex.TEST_WEIGHTS, [0.8] * 4,
                           dtype=torch.float64, scp=tscp, device="cpu")
    with pytest.raises(RuntimeError, match="setup_mpc"):
        mpc.update_mpc(*inputs)
    assert mpc.config == tcfg
    again = mpc.setup_mpc().update_mpc(*inputs)
    assert torch.equal(again.contact_force, sol.contact_force)
    out = solution_to_numpy(again)
    assert isinstance(out["contact_force"], np.ndarray)
    assert out["performance"]["merit"].shape == ()
    # Swing legs carry exactly zero force; stance legs carry the weight.
    enable = np.stack([inputs[2][i * (4 * N + 3):][:N] for i in range(4)])
    f = out["contact_force"]
    assert np.all(np.transpose(f, (0, 2, 1))[enable == 0] == 0.0)
    assert np.all(np.abs(f[:, 2, :].sum(axis=0) - 78.48) < 40.0)


def test_unported_backends_raise(solved):
    _, _, _, tcfg, tscp, inputs, _, _, _ = solved
    for kw, exc in ((dict(qp_backend="condensed"), NotImplementedError),
                    (dict(eq_mode="projected"), NotImplementedError),
                    (dict(qp_backend="nope"), ValueError)):
        solve = tm.build_centroidal_solver(tcfg, tscp._replace(**kw),
                                           device="cpu")
        with pytest.raises(exc):
            solve(*inputs)
