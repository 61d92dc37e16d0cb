"""PyTorch port, ``ops.riccati.fold_terminal_equality`` against the JAX
package: the two cases of tests/test_terminal_eq.py on the same seeded
problems, f64. The folded problem agrees leaf by leaf to 1e-12, its exact
equality-Riccati solve to 1e-9 and its interior-point solve to 1e-8; the
terminal rows hold in the port's solutions as in the JAX tests.
"""

import jax.numpy as jnp
import numpy as np
import torch

from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu.ops.ocpqp import solve_ocp_qp as jsolve_ocp_qp
from cheeta_mpc_tpu.ops.riccati import fold_terminal_equality as jfold
from cheeta_mpc_tpu.ops.riccati import solve_eq_lqr as jsolve_eq_lqr
from cheeta_mpc_tpu.ops.riccati import solve_lqr as jsolve_lqr
from cheeta_mpc_tpu_torch.ops import ocpqp as to
from cheeta_mpc_tpu_torch.ops import riccati as tr
from tests.problem_gen import add_random_constraints, random_lq_problem
from tests.torch_port_util import (assert_qp_data_close, max_err,
                                   qp_data_to_torch)


def test_terminal_equality_exact():
    rng = np.random.default_rng(7)
    N, nx, nu = 8, 5, 3
    data = random_lq_problem(rng, N=N, nx=nx, nu=nu)
    C_N, target = np.eye(nx)[:2], np.array([0.3, -0.2])
    jd = jfold(data, jnp.asarray(C_N), jnp.asarray(-target), jnp.ones(2))
    td = tr.fold_terminal_equality(qp_data_to_torch(data), C_N, -target,
                                   np.ones(2))
    assert tuple(td.eq.C.shape) == (N, 2, nx)
    assert float(td.eq.mask[:-1].abs().max()) == 0.0
    assert_qp_data_close(td, jd, 1e-12)
    ref = jsolve_eq_lqr(jd)
    sol = tr.solve_eq_lqr(td)
    assert max_err(sol.dx, ref.dx) <= 1e-9
    assert max_err(sol.du, ref.du) <= 1e-9
    np.testing.assert_allclose(sol.dx[-1, :2].numpy(), target, atol=1e-9)


def test_terminal_equality_with_inequalities():
    """Folded onto existing stage equalities' absence and then given
    inequality rows: the port's interior-point solve against the JAX
    package's; the masked-off row of a second fold is inert."""
    rng = np.random.default_rng(11)
    data = random_lq_problem(rng, N=6, nx=4, nu=2)
    base = jsolve_lqr(data)
    target = np.asarray(base.dx[-1][:1]) + 0.05
    jd = jfold(data, jnp.asarray(np.eye(4)[:1]), jnp.asarray(-target),
               jnp.ones((1,)))
    jd = add_random_constraints(rng, jd, ng=2, tight=3.0,
                                ref=(base.dx, base.du))
    td = qp_data_to_torch(jd)
    ref = jsolve_ocp_qp(jd, JIpm(iters=30))
    sol = to.solve_ocp_qp(td, to.IpmSettings(iters=30))
    assert max_err(sol.dx, ref.dx) <= 1e-8
    assert max_err(sol.du, ref.du) <= 1e-8
    np.testing.assert_allclose(sol.dx[-1, :1].numpy(), target, atol=1e-6)
    res = to.kkt_residuals(td, sol)
    assert float(res["dynamics"]) < 1e-8
    assert float(res["ineq_primal"]) < 1e-7
    # A second fold appends rows; masked off, they change nothing.
    jd2 = jfold(jd, jnp.asarray(np.eye(4)[1:3]), jnp.zeros(2), jnp.zeros(2))
    td2 = tr.fold_terminal_equality(td, torch.eye(4, dtype=torch.float64)[1:3],
                                    np.zeros(2), np.zeros(2))
    assert tuple(td2.eq.C.shape) == (6, 3, 4)
    assert_qp_data_close(td2, jd2, 1e-12)
    sol2 = to.solve_ocp_qp(td2, to.IpmSettings(iters=30))
    assert max_err(sol2.dx, sol.dx) <= 1e-9
