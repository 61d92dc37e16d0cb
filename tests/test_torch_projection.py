"""PyTorch port, ``ops/projection.py`` (null-space projection of stage
equalities, ``eq_mode='projected'``) against the JAX package.

- The identities of tests/test_projection.py on the same random systems,
  and the particular solution (Px, Pe) against the JAX package's (1e-10;
  the null-space basis Pu is unique only up to rotation, so its projector
  Pu Pu' is compared).
- The two QP cases of tests/test_circular_kinematics.py: projected against
  the eq-Riccati elimination on an equality-only QP, and projected against
  the full interior-point solve with inequality rows; each against the JAX
  package's result (1e-8 and 1e-7); a batch of the latter whose equalities
  differ from problem to problem, through the fleet kernel's plain version
  with C/D per problem, against ``jax.vmap`` of the JAX package's (1e-6).
- The circular-kinematics OCP through the SQP in both equality modes, f64,
  against the JAX package's projected-mode solve (1e-9 the same mode, 1e-6
  the other: the reference's agreement criterion), and
  in f32 through the kernel backend's plain versions, where the projected
  mode's reduced problem has neither equalities nor inequalities and goes
  to the equality-Riccati kernel with one all-masked row: the two modes
  agree to 1e-4 (the bound chip_smoke.py holds the kernels to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.core.types import StageEquality as JEq
from cheeta_mpc_tpu.ops import projection as jp
from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu.ops.ocpqp import solve_ocp_qp as jsolve_ocp_qp
from cheeta_mpc_tpu.ops.riccati import solve_eq_lqr as jsolve_eq_lqr
from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch as tb
from cheeta_mpc_tpu_torch.ops import projection as tp
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings, solve_ocp_qp
from cheeta_mpc_tpu_torch.ops.riccati import lqr_forward, solve_eq_lqr
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings, solve_nonlinear_ocp
from tests.problem_gen import add_random_constraints, random_lq_problem
from tests.torch_port_util import (CIRCLE_DT, CIRCLE_N,
                                   circular_kinematics_problem, max_err,
                                   qp_data_to_torch)

NC, NU, NX = 10, 20, 30


@pytest.mark.parametrize("method", ["qr", "lu"])
def test_projection_identities(method):
    rng = np.random.default_rng(0)
    C, D = rng.normal(size=(NC, NX)), rng.normal(size=(NC, NU))
    e = rng.normal(size=NC)
    P = getattr(tp, f"{method}_projection")(*map(torch.as_tensor, (C, D, e)))
    J = getattr(jp, f"{method}_projection")(*map(jnp.asarray, (C, D, e)))
    Pu, Px, Pe = (t.numpy() for t in P)
    np.testing.assert_allclose(D @ Pu, 0.0, atol=1e-10)
    for _ in range(3):
        dx, w = rng.normal(size=NX), rng.normal(size=NU - NC)
        du = Pu @ w + Px @ dx + Pe
        np.testing.assert_allclose(C @ dx + D @ du + e, 0.0, atol=1e-9)
    np.testing.assert_allclose(Pu.T @ Pu, np.eye(NU - NC), atol=1e-10)
    assert max_err(Px, J.Px) <= 1e-10 and max_err(Pe, J.Pe) <= 1e-10
    ju = np.asarray(J.Pu)
    assert max_err(Pu @ Pu.T, ju @ ju.T) <= 1e-10


def test_projection_takes_leading_dimensions():
    """Stage-stacked blocks (the JAX package vmaps one stage) give each
    stage's own projection."""
    rng = np.random.default_rng(1)
    C, D = rng.normal(size=(3, 2, 5)), rng.normal(size=(3, 2, 4))
    e = rng.normal(size=(3, 2))
    P = tp.qr_projection(*map(torch.as_tensor, (C, D, e)))
    one = tp.qr_projection(*map(torch.as_tensor, (C[1], D[1], e[1])))
    for a, b in zip(P, one):
        assert max_err(a[1], b) <= 1e-12


def _full_rank_eq_problem(seed, N=6, nx=5, nu=4, nc=2):
    """tests/test_circular_kinematics.py's generator: a random LQ problem
    with statically active full-row-rank equalities (JAX data)."""
    rng = np.random.default_rng(seed)
    data = random_lq_problem(rng, N, nx, nu)
    eq = JEq(C=jnp.asarray(rng.normal(size=(N, nc, nx))),
             D=jnp.asarray(rng.normal(size=(N, nc, nu))
                           + 2.0 * np.eye(nc, nu)[None]),
             e=jnp.asarray(rng.normal(size=(N, nc)) * 0.1),
             mask=jnp.ones((N, nc)))
    return data.replace(eq=eq)


@pytest.mark.parametrize("seed", range(3))
def test_projected_matches_eq_riccati_qp(seed):
    data = _full_rank_eq_problem(seed)
    td = qp_data_to_torch(data)
    jref = jax.jit(lambda d: jp.solve_ocp_qp_projected(
        d, inner=jsolve_ocp_qp))(data)
    ref = solve_eq_lqr(td)
    sol = tp.solve_ocp_qp_projected(td, inner=solve_ocp_qp)
    # 1e-8: the JAX test's 1e-9 for this pair, with room for entries of dx
    # up to ~7 here (measured 1.5e-9 at seed 0).
    for name in ("dx", "du"):
        assert max_err(getattr(sol, name), getattr(ref, name)) <= 1e-8
        assert max_err(getattr(sol, name), getattr(jref, name)) <= 1e-8
    assert max_err(sol.dx, jsolve_eq_lqr(data).dx) <= 1e-8
    assert float(sol.eq_res) < 1e-9
    # The remapped feedback policy reproduces the optimal inputs.
    _, du_r = lqr_forward(td.dyn, sol.gains.K, sol.gains.k, td.dx0)
    assert max_err(du_r, sol.du) <= 1e-8
    assert max_err(sol.gains.K, jref.gains.K) <= 1e-8
    # The default inner solve is the kernel dispatch (plain versions here):
    # the reduced problem has no rows at all and goes to the
    # equality-Riccati kernel's plain version with one all-masked row.
    dflt = tp.solve_ocp_qp_projected(td, IpmSettings(reg=0.0))
    assert max_err(dflt.du, sol.du) <= 1e-8
    lu = tp.solve_ocp_qp_projected(td, inner=solve_ocp_qp, method="lu")
    assert max_err(lu.du, sol.du) <= 1e-8


def test_projected_matches_ipm_with_inequalities():
    data = _full_rank_eq_problem(7, N=5, nx=4, nu=3, nc=1)
    eq_sol = jsolve_eq_lqr(data)
    ref = (np.asarray(eq_sol.dx), np.asarray(eq_sol.du))
    rng = np.random.default_rng(11)
    data = add_random_constraints(rng, data.replace(eq=None), ng=2,
                                  tight=0.8, ref=ref).replace(eq=data.eq)
    td = qp_data_to_torch(data)
    st = IpmSettings(iters=30)
    jproj = jax.jit(lambda d: jp.solve_ocp_qp_projected(d, JIpm(iters=30)))(
        data)
    full = solve_ocp_qp(td, st)
    proj = tp.solve_ocp_qp_projected(td, st, inner=solve_ocp_qp)
    for name in ("dx", "du"):
        assert max_err(getattr(proj, name), getattr(full, name)) <= 1e-6
        assert max_err(getattr(proj, name), getattr(jproj, name)) <= 1e-7
    assert float(proj.eq_res) < 1e-7
    # The kernel dispatch (K1's plain version with the reduced inequality
    # rows): the same solve to 1e-6.
    kern = tp.solve_ocp_qp_projected(td, st)
    assert max_err(kern.du, proj.du) <= 1e-6


def _with_inequalities(seed):
    """``test_projected_matches_ipm_with_inequalities``'s problem, from
    ``seed``: full-rank equalities and two inequality rows per stage."""
    data = _full_rank_eq_problem(seed, N=5, nx=4, nu=3, nc=1)
    eq_sol = jsolve_eq_lqr(data)
    ref = (np.asarray(eq_sol.dx), np.asarray(eq_sol.du))
    rng = np.random.default_rng(seed + 4)
    return add_random_constraints(rng, data.replace(eq=None), ng=2,
                                  tight=0.8, ref=ref).replace(eq=data.eq)


def test_projected_batch_with_inequalities():
    """A batch whose equalities differ from problem to problem: the reduced
    inequality rows C + D Px, D Pu then carry the batch, and the default
    inner solve sends them to the fleet interior-point kernel (its plain
    version here) with C/D of their own per problem. Against ``jax.vmap``
    of the JAX package's projected solve (1e-6, the bound of the kernel
    dispatch against the scan solver above), and each element against its
    batch-1 projected solve (K1's plain version; 1e-9, f64)."""
    probs = [_with_inequalities(seed) for seed in (7, 8, 9)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
    ref = jax.jit(jax.vmap(lambda d: jp.solve_ocp_qp_projected(
        d, JIpm(iters=30))))(stacked)
    st = IpmSettings(iters=30)
    sol = tp.solve_ocp_qp_projected(qp_data_to_torch(stacked), st)
    assert bool(torch.isnan(sol.gains.K).all())
    for name in ("dx", "du"):
        assert max_err(getattr(sol, name), getattr(ref, name)) <= 1e-6
    for i, prob in enumerate(probs):
        one = tp.solve_ocp_qp_projected(qp_data_to_torch(prob), st)
        assert max_err(sol.du[i], one.du) <= 1e-9
        assert max_err(sol.dx[i], one.dx) <= 1e-9


# ---- the nonlinear circular-kinematics OCP through the SQP ----------------

N, DT = CIRCLE_N, CIRCLE_DT
ALPHAS = (1.0, 0.5, 0.25, 0.125, 1 / 16, 1 / 32, 1 / 64)


def solve_circle(eq_mode, qp_backend="riccati", dtype=torch.float64):
    lin, perf, x_init, u_init = circular_kinematics_problem(dtype, "cpu")
    st = ScpSettings(iterations=25, eq_mode=eq_mode, alphas=ALPHAS,
                     ipm=IpmSettings(iters=10), qp_backend=qp_backend)
    return solve_nonlinear_ocp(lin, perf, x_init, u_init, st)


@pytest.fixture(scope="module")
def jax_circle():
    """The JAX package's projected-mode SQP, jitted (its own test holds it
    against its eq-Riccati mode to 1e-6; one JAX solve keeps this file
    short)."""
    from tests.test_circular_kinematics import _solve_circle
    return jax.jit(_solve_circle, static_argnums=0)("projected")


@pytest.mark.parametrize("eq_mode, tol", [("projected", 1e-9),
                                          ("riccati", 1e-6)])
def test_circular_kinematics_against_jax(eq_mode, tol, jax_circle):
    """Against the JAX package's projected-mode solve: the same mode to
    1e-9 (measured 2e-16), the other to 1e-6, the reference's agreement
    criterion for the two modes (measured 3.4e-10)."""
    res = solve_circle(eq_mode)
    ref = jax_circle
    assert max_err(res.x, ref.x) <= tol and max_err(res.u, ref.u) <= tol
    x, u = res.x.numpy(), res.u.numpy()
    d = x[:-1] + DT * u - x[1:]
    assert np.sum(d * d) < 1e-9
    g = np.sum(x[:-1] * u, axis=-1)
    assert np.sum(g * g) < 1e-9
    r = np.linalg.norm(x, axis=-1)
    assert r.min() > 1.0 - 1e-6 and r.max() < 1.3
    assert abs(x[-1, 0]) < 0.05 and x[-1, 1] > 0.9


def test_circular_kinematics_both_modes_f32_kernel_backend(monkeypatch):
    """f32, ``qp_backend='riccati_kernel'`` on the CPU: the eq-Riccati mode
    goes to K3's plain version, the projected mode's reduced problem (no
    rows at all) to K3's plain version with one all-masked row. The two
    modes agree to 1e-4 and reach the f64 solution to 1e-3."""
    seen = []
    real = tb.with_masked_equality_row
    monkeypatch.setattr(tb, "with_masked_equality_row",
                        lambda d: (seen.append(d.dyn.nu), real(d))[1])
    r32 = solve_circle("riccati", "riccati_kernel", torch.float32)
    assert not seen
    p32 = solve_circle("projected", "riccati_kernel", torch.float32)
    assert seen and set(seen) == {1}  # nu - nc = 1
    assert r32.x.dtype == torch.float32
    assert max_err(p32.x, r32.x) <= 1e-4 and max_err(p32.u, r32.u) <= 1e-4
    r64 = solve_circle("riccati")
    assert max_err(r32.x, r64.x) <= 1e-3
