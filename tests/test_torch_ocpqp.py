"""PyTorch port, ops/ocpqp.py: the fixed-iteration Mehrotra IPM against the
JAX package's, same numpy inputs, f64.

Same algorithm, same order of operations; the executors differ only in the
SPD inverse (Cholesky vs Schur + Newton), a roundoff-level difference that
the 18 IPM iterations amplify through barrier weights up to ~1/mu_tol = 1e9
— hence atol 1e-6 on the iterate, slacks, duals and diagnostics rather than
1e-10.

The Riccati gains K, k, P, p of the LAST factorization are another matter:
at convergence the barrier-augmented Hessians reach 1e10 (P entries too), so
K = -G^-1 H is a difference of huge numbers and either inverse leaves O(1e-4
.. 1) absolute noise in it (measured; swapping the port's inverse for a
transcription of the JAX one does not change that). The gains are therefore
compared after 6 iterations, where the weights are still moderate and both
executors agree to 1e-10 relative; the converged solves compare everything
else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.core.types import StageEquality
from cheeta_mpc_tpu.ops import ocpqp as jo
from cheeta_mpc_tpu.ops.riccati import solve_eq_lqr as j_solve_eq_lqr
from cheeta_mpc_tpu_torch.ops import ocpqp as to
from tests.problem_gen import add_random_constraints, random_lq_problem
from tests.torch_port_util import assert_close, qp_data_to_torch

ATOL = 1e-6
# Relative floor for entries far above 1: an instance whose random bounds
# cannot all be met drives some duals to ~1e8, where 1e-6 absolute would ask
# for 14 digits.
RTOL = 1e-8
FIELDS = ("dx", "du", "lam_l", "lam_u", "s_l", "s_u", "mu")
GAINS = ("K", "k", "P", "p")


def _ineq_problem(rng, N=8, nx=5, nu=3, ng=4, tight=0.4):
    data = random_lq_problem(rng, N=N, nx=nx, nu=nu)
    return add_random_constraints(rng, data, ng=ng, tight=tight)


def _eq_problem(rng, N=8, nx=5, nu=4, nc=2, ng=3):
    data = random_lq_problem(rng, N=N, nx=nx, nu=nu)
    C = rng.normal(size=(N, nc, nx))
    D = rng.normal(size=(N, nc, nu)) + 1.5 * np.eye(nc, nu)[None]
    e = rng.normal(size=(N, nc)) * 0.1
    mask = (rng.uniform(size=(N, nc)) < 0.7).astype(np.float64)
    eq = StageEquality(C=jnp.asarray(C * mask[:, :, None]),
                       D=jnp.asarray(D * mask[:, :, None]),
                       e=jnp.asarray(e * mask), mask=jnp.asarray(mask))
    eq_sol = j_solve_eq_lqr(data.replace(eq=eq))
    data = add_random_constraints(
        rng, data, ng=ng, tight=0.6,
        ref=(np.asarray(eq_sol.dx), np.asarray(eq_sol.du)))
    return data.replace(eq=eq)


def _check(sol, ref, atol=ATOL, gains=False):
    for name in FIELDS:
        assert_close(getattr(sol, name), getattr(ref, name), atol, RTOL,
                     what=name)
    if gains:
        # atol 1e-6 relative to the largest entry (P grows with the barrier
        # weights even early on).
        for name in GAINS:
            r = np.asarray(getattr(ref.gains, name))
            assert_close(getattr(sol.gains, name), r,
                         atol * max(1.0, float(np.abs(r).max())), what=name)
    for name in ("stat_res", "ineq_res", "eq_res"):
        assert_close(getattr(sol, name), getattr(ref, name), atol, RTOL,
                     what=name)
    assert np.array_equal(sol.iterations.numpy(), np.asarray(ref.iterations))


@pytest.mark.parametrize("with_eq", [False, True])
@pytest.mark.parametrize("seed", [15, 16])
def test_gains_match_jax_before_the_barrier_blows_up(seed, with_eq):
    """K, k, P, p after 6 iterations (see the module docstring)."""
    data = (_eq_problem if with_eq else _ineq_problem)(
        np.random.default_rng(seed))
    ref = jo.solve_ocp_qp(data, jo.IpmSettings(iters=6))
    sol = to.solve_ocp_qp(qp_data_to_torch(data), to.IpmSettings(iters=6))
    _check(sol, ref, gains=True)
    assert float(np.abs(np.asarray(ref.gains.K)).max()) > 1e-2  # not vacuous


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_inequalities_match_jax(seed):
    data = _ineq_problem(np.random.default_rng(seed))
    s = dict(iters=18)
    ref = jo.solve_ocp_qp(data, jo.IpmSettings(**s))
    sol = to.solve_ocp_qp(qp_data_to_torch(data), to.IpmSettings(**s))
    _check(sol, ref)


def test_all_rows_masked_off_is_the_lqr():
    """With every inequality row masked the IPM takes the plain LQR step."""
    data = _ineq_problem(np.random.default_rng(14))
    data = data.replace(con=data.con.replace(
        mask=jnp.zeros_like(data.con.mask)))
    ref = jo.solve_ocp_qp(data, jo.IpmSettings(iters=6))
    sol = to.solve_ocp_qp(qp_data_to_torch(data), to.IpmSettings(iters=6))
    _check(sol, ref)
    assert torch.all(sol.s_l == 1.0) and torch.all(sol.lam_u == 0.0)


@pytest.mark.parametrize("seed", [21, 22])
def test_stage_equalities_match_jax(seed):
    data = _eq_problem(np.random.default_rng(seed))
    ref = jo.solve_ocp_qp(data, jo.IpmSettings(iters=18))
    sol = to.solve_ocp_qp(qp_data_to_torch(data), to.IpmSettings(iters=18))
    _check(sol, ref)


@pytest.mark.parametrize("with_eq", [False, True])
def test_batch_of_three_matches_vmap(with_eq):
    """A leading batch dimension vs jax.vmap: every data-dependent choice
    (freeze, guard, step lengths) must be made per element."""
    rng = np.random.default_rng(31 + with_eq)
    make = _eq_problem if with_eq else _ineq_problem
    # Different tightness -> different convergence speed per element, so
    # the freeze engages at different iterations across the batch.
    probs = [make(rng) for _ in range(3)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
    s = jo.IpmSettings(iters=18)
    ref = jax.vmap(lambda d: jo.solve_ocp_qp(d, s))(stacked)
    sol = to.solve_ocp_qp(qp_data_to_torch(stacked), to.IpmSettings(iters=18))
    assert sol.dx.shape[0] == 3 and sol.mu.shape == (3,)
    _check(sol, ref)


def test_shared_constraint_matrices_broadcast():
    """C/D without the batch dimension (one set shared by the batch) give
    what explicitly repeated C/D give."""
    rng = np.random.default_rng(41)
    base = _ineq_problem(rng)
    probs = []
    for _ in range(3):
        d = random_lq_problem(rng, N=8, nx=5, nu=3)
        probs.append(d.replace(con=base.con.replace(
            lg=base.con.lg - rng.uniform(0, 0.2, base.con.lg.shape),
            ug=base.con.ug + rng.uniform(0, 0.2, base.con.ug.shape))))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
    full = qp_data_to_torch(stacked)
    shared = full.replace(con=full.con.replace(C=full.con.C[0],
                                               D=full.con.D[0]))
    s = to.IpmSettings(iters=12)
    a, b = to.solve_ocp_qp(full, s), to.solve_ocp_qp(shared, s)
    torch.testing.assert_close(a.du, b.du, atol=1e-12, rtol=0)
    ref = jax.vmap(lambda d: jo.solve_ocp_qp(d, jo.IpmSettings(iters=12)))(
        stacked)
    _check(b, ref)


def test_kkt_residuals_match_jax():
    data = _ineq_problem(np.random.default_rng(51))
    ref_sol = jo.solve_ocp_qp(data, jo.IpmSettings(iters=20))
    td = qp_data_to_torch(data)
    sol = to.solve_ocp_qp(td, to.IpmSettings(iters=20))
    ref = jo.kkt_residuals(data, ref_sol)
    got = to.kkt_residuals(td, sol)
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k], ref[k], ATOL, what=k)
    # f64 optimum certifies.
    assert float(got["stationarity"]) < 1e-5
    assert float(got["ineq_primal"]) < 1e-6


def test_no_inequalities_reduce_to_exact_solves():
    rng = np.random.default_rng(61)
    data = random_lq_problem(rng, N=6, nx=4, nu=3)
    ref = jo.solve_ocp_qp(data)
    sol = to.solve_ocp_qp(qp_data_to_torch(data))
    assert_close(sol.du, ref.du, 1e-10)
    assert int(sol.iterations) == 0


def test_dtype_clamps():
    s = to.IpmSettings()
    assert to.dtype_clamps(s, torch.float64).mu_tol == 1e-9
    assert to.dtype_clamps(s, torch.float32).mu_tol == 1e-4
    assert to.dtype_clamps(s, torch.float32).w_max == 1e6
    assert to.dtype_clamps(s, torch.float64).w_max == 1e10
    assert to.dtype_clamps(s._replace(mu_tol=1e-3), torch.float32
                           ).mu_tol == 1e-3
