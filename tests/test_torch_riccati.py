"""PyTorch port, ops/riccati.py: the Riccati recursions against the JAX
package's, same numpy inputs, f64.

Both sides run the same recursion in the same order; what differs is the
SPD inverse (Cholesky in the port, Schur recursion + one Newton step in the
JAX package), which agree to roundoff in f64 on these well-conditioned
instances — hence rtol 1e-8 with an absolute floor of 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.core.types import StageEquality
from cheeta_mpc_tpu.ops import riccati as jr
from cheeta_mpc_tpu_torch.core.types import DynamicsLin
from cheeta_mpc_tpu_torch.ops import riccati as tr
from cheeta_mpc_tpu_torch.ops.linalg_small import spd_inverse
from tests.problem_gen import random_lq_problem, random_psd
from tests.torch_port_util import assert_close, qp_data_to_torch

RTOL, ATOL = 1e-8, 1e-10


def _eq_rows(rng, N, nx, nu, nc):
    C = rng.normal(size=(N, nc, nx))
    D = rng.normal(size=(N, nc, nu)) + 1.5 * np.eye(nc, nu)[None]
    e = rng.normal(size=(N, nc)) * 0.1
    mask = (rng.uniform(size=(N, nc)) < 0.7).astype(np.float64)
    return C * mask[:, :, None], D * mask[:, :, None], e * mask, mask


def _with_eq(data, C, D, e, mask):
    return data.replace(eq=StageEquality(
        C=jnp.asarray(C), D=jnp.asarray(D), e=jnp.asarray(e),
        mask=jnp.asarray(mask)))


@pytest.mark.parametrize("seed,N,nx,nu", [(0, 8, 5, 3), (1, 12, 7, 4)])
def test_solve_lqr_matches_jax(seed, N, nx, nu):
    rng = np.random.default_rng(seed)
    data = random_lq_problem(rng, N, nx, nu)
    ref = jr.solve_lqr(data, reg=1e-9)
    sol = tr.solve_lqr(qp_data_to_torch(data), reg=1e-9)
    for name in ("dx", "du"):
        assert_close(getattr(sol, name), getattr(ref, name), ATOL, RTOL, name)
    for name in ("K", "k", "P", "p"):
        assert_close(getattr(sol.gains, name), getattr(ref.gains, name),
                     ATOL, RTOL, name)
    cost = tr.cost_of(qp_data_to_torch(data).cost, sol.dx, sol.du)
    assert_close(cost, jr.cost_of(data.cost, ref.dx, ref.du), ATOL, RTOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_eq_factorize_vector_forward_match_jax(seed):
    rng = np.random.default_rng(seed)
    N, nx, nu, nc = 8, 5, 4, 2
    data = random_lq_problem(rng, N, nx, nu)
    C, D, e, mask = _eq_rows(rng, N, nx, nu, nc)
    cost = data.cost
    fj = jr.riccati_factorize_eq(data.dyn, cost.Q, cost.R, cost.S,
                                 jnp.asarray(C), jnp.asarray(D),
                                 jnp.asarray(mask), reg=1e-9)
    kj, pj = jr.riccati_vector_eq(data.dyn, cost.q, cost.r, jnp.asarray(-e),
                                  jnp.asarray(C), fj)
    xj, uj = jr.lqr_forward(data.dyn, fj.K, kj, dx0=data.dx0)

    td = qp_data_to_torch(data)
    tC, tD, te, tm = (torch.as_tensor(a) for a in (C, D, e, mask))
    ft = tr.riccati_factorize_eq(td.dyn, td.cost.Q, td.cost.R, td.cost.S,
                                 tC, tD, tm, reg=1e-9)
    kt, pt = tr.riccati_vector_eq(td.dyn, td.cost.q, td.cost.r, -te, tC, ft)
    xt, ut = tr.lqr_forward(td.dyn, ft.K, kt, dx0=td.dx0)
    for name in fj._fields:
        assert_close(getattr(ft, name), getattr(fj, name), ATOL, RTOL, name)
    for a, b, name in ((kt, kj, "k"), (pt, pj, "p"), (xt, xj, "dx"),
                       (ut, uj, "du")):
        assert_close(a, b, ATOL, RTOL, name)


def test_solve_eq_lqr_matches_jax_batched():
    """Batch of 3 problems on a leading dimension vs jax.vmap."""
    rng = np.random.default_rng(4)
    N, nx, nu, nc = 6, 4, 3, 2
    probs = []
    for _ in range(3):
        data = random_lq_problem(rng, N, nx, nu)
        probs.append(_with_eq(data, *_eq_rows(rng, N, nx, nu, nc)))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
    ref = jax.vmap(lambda d: jr.solve_eq_lqr(d, reg=1e-9))(stacked)
    sol = tr.solve_eq_lqr(qp_data_to_torch(stacked), reg=1e-9)
    assert sol.dx.shape == (3, N + 1, nx)
    for name in ("dx", "du"):
        assert_close(getattr(sol, name), getattr(ref, name), ATOL, RTOL, name)
    for name in ("K", "k", "P", "p"):
        assert_close(getattr(sol.gains, name), getattr(ref.gains, name),
                     ATOL, RTOL, name)
    # Element 0 alone gives what the batch gave it.
    one = tr.solve_eq_lqr(qp_data_to_torch(probs[0]), reg=1e-9)
    assert_close(one.du, np.asarray(ref.du)[0], ATOL, RTOL)


def test_riccati_factorize_and_vector_match_jax():
    rng = np.random.default_rng(5)
    data = random_lq_problem(rng, 7, 4, 2)
    c = data.cost
    fj = jr.riccati_factorize(data.dyn, c.Q, c.R, c.S, reg=1e-9)
    kj, pj = jr.riccati_vector(data.dyn, c.q, c.r, fj)
    td = qp_data_to_torch(data)
    ft = tr.riccati_factorize(td.dyn, td.cost.Q, td.cost.R, td.cost.S,
                              reg=1e-9)
    kt, pt = tr.riccati_vector(td.dyn, td.cost.q, td.cost.r, ft)
    for name in fj._fields:
        assert_close(getattr(ft, name), getattr(fj, name), ATOL, RTOL, name)
    assert_close(kt, kj, ATOL, RTOL)
    assert_close(pt, pj, ATOL, RTOL)


def test_spd_inverse_matches_jax_f64():
    """The port's Cholesky inverse vs the JAX package's Schur + Newton
    inverse: both exact to roundoff in f64 (condition ~1e2 here)."""
    from cheeta_mpc_tpu.ops.linalg_small import spd_inverse as j_inv
    rng = np.random.default_rng(6)
    M = np.stack([random_psd(rng, 24) for _ in range(4)])
    assert_close(spd_inverse(torch.as_tensor(M)), j_inv(jnp.asarray(M)),
                 1e-10, 1e-8)
    # A non-SPD element yields NaN for that element only, not an exception.
    M[1] = -M[1]
    out = spd_inverse(torch.as_tensor(M))
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2, 3]]).all()


def test_bmv_helpers():
    rng = np.random.default_rng(7)
    M = torch.as_tensor(rng.normal(size=(2, 5, 4, 3)))
    v = torch.as_tensor(rng.normal(size=(2, 5, 3)))
    w = torch.as_tensor(rng.normal(size=(2, 5, 4)))
    torch.testing.assert_close(tr.bmv(M, v), (M @ v[..., None])[..., 0])
    torch.testing.assert_close(
        tr.bmv_t(M, w), (M.transpose(-1, -2) @ w[..., None])[..., 0])
    dyn = DynamicsLin(A=M[..., :3], B=M, b=w)
    assert (dyn.horizon, dyn.nx, dyn.nu) == (5, 3, 3)
