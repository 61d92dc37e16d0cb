"""PyTorch port: solvers/ddp.py against the JAX package's on the same
problems, f64 (the oracles of ``tests/test_ddp.py``).

- The one-iteration LQR problem (random, seeded with numpy): DDP at
  alpha = 1 is exact LQR, in both packages.
- The centroidal tracking problem (bilinear dynamics, 5 iterations).

Both sides run the same arithmetic: forward-mode Jacobians, a gradient and
a forward-over-reverse Hessian, the same Riccati recursion, the same ladder
and the same pick. What differs is summation order and the SPD inverse
(Cholesky in the port, the Schur recursion in the JAX package), so x, u,
K, P, p and the cost agree to 1e-8 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.models.centroidal import CentroidalParams as JParams
from cheeta_mpc_tpu.models.centroidal import centroidal_step as j_step
from cheeta_mpc_tpu.ops.riccati import solve_lqr
from cheeta_mpc_tpu.solvers import ddp as jd
from cheeta_mpc_tpu_torch.models.centroidal import CentroidalParams as TParams
from cheeta_mpc_tpu_torch.models.centroidal import centroidal_step as t_step
from cheeta_mpc_tpu_torch.solvers import ddp as td
from tests.problem_gen import random_lq_problem
from tests.torch_port_util import max_err

REL = 1e-8
FIELDS = ("x", "u", "K", "P", "p", "cost")


def _assert_results_close(port, ref, rel=REL):
    for name in FIELDS:
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = max(1.0, float(np.abs(b).max()))
        err = max_err(a, b)
        assert err <= rel * scale, (name, err, scale)
    assert bool(port.converged) == bool(ref.converged)


def _lq_problem(seed):
    data = random_lq_problem(np.random.default_rng(seed), N=8, nx=4, nu=3,
                             with_x0=True)
    return {k: np.asarray(v) for k, v in (
        ("A", data.dyn.A), ("B", data.dyn.B), ("b", data.dyn.b),
        ("Q", data.cost.Q), ("R", data.cost.R), ("S", data.cost.S),
        ("q", data.cost.q), ("r", data.cost.r), ("x0", data.dx0))}, data


def _lq_callbacks(d, xp):
    """step / stage / terminal cost of the LQ problem in numpy-like ``xp``
    (jnp or torch) on arrays ``d``."""
    A, B, b, Q, R, S, q, r = (d[k] for k in "A B b Q R S q r".split())

    def step(k, x, u):
        return A[k] @ x + B[k] @ u + b[k]

    def stage_cost(k, x, u):
        return (0.5 * x @ Q[k] @ x + 0.5 * u @ R[k] @ u + u @ S[k] @ x
                + q[k] @ x + r[k] @ u)

    def terminal_cost(x):
        return 0.5 * x @ Q[-1] @ x + q[-1] @ x

    return step, stage_cost, terminal_cost


@pytest.mark.parametrize("seed", [0, 1])
def test_lqr_problem_matches_jax(seed):
    d, data = _lq_problem(seed)
    settings = dict(iterations=2, reg=0.0)
    jres = jd.solve_ddp(*_lq_callbacks({k: jnp.asarray(v) for k, v in
                                        d.items()}, jnp),
                        jnp.asarray(d["x0"]), jnp.zeros((8, 3)),
                        jd.DdpSettings(**settings))
    td_d = {k: torch.as_tensor(np.array(v)) for k, v in d.items()}
    tres = td.solve_ddp(*_lq_callbacks(td_d, torch), td_d["x0"],
                        torch.zeros((8, 3), dtype=torch.float64),
                        td.DdpSettings(**settings))
    _assert_results_close(tres, jres)
    # DDP at alpha = 1 on an LQ problem is exact LQR.
    ref = solve_lqr(data)
    assert max_err(tres.u, ref.du) <= 1e-8
    assert max_err(tres.x, ref.dx) <= 1e-8


def _centroidal_problem(pkg):
    """tests/test_ddp.py::test_centroidal_tracking_converges in ``pkg``
    ('jax' or 'torch')."""
    N = 8
    f_ff = 8.0 * 9.81 / 4
    x0 = np.zeros(33)
    x0[2] = 0.3
    x_des = np.zeros(33)
    x_des[2], x_des[0] = 0.35, 0.05
    u0 = np.zeros((N, 24))
    u0[:, 14::3] = f_ff
    if pkg == "jax":
        xp, arr = jnp, jnp.asarray
        params = JParams.create(mass=8.0, num_legs=4, dt=0.01, mu=0.8)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        step_fn = j_step
    else:
        xp, arr = torch, torch.as_tensor
        params = TParams.create(mass=8.0, num_legs=4, dt=0.01, mu=0.8)
        step_fn = t_step
    enable = arr(np.ones((N, 4)))
    xd = arr(x_des)

    def step(k, x, u):
        return step_fn(params, x, u, enable[k])

    def stage_cost(k, x, u):
        forces = u[12:]
        fz_err = forces.reshape(4, 3)[:, 2] - f_ff
        return (10.0 * xp.sum((x[:9] - xd[:9]) ** 2)
                + 1e-3 * xp.sum(fz_err ** 2)
                + 1e-3 * xp.sum(forces.reshape(4, 3)[:, :2] ** 2)
                + 1e-4 * xp.sum(u[:12] ** 2))

    def terminal_cost(x):
        return 10.0 * xp.sum((x[:9] - xd[:9]) ** 2)

    return step, stage_cost, terminal_cost, arr(x0), arr(u0)


def test_centroidal_tracking_matches_jax():
    settings = dict(iterations=5)
    jres = jd.solve_ddp(*_centroidal_problem("jax"),
                        jd.DdpSettings(**settings))
    tres = td.solve_ddp(*_centroidal_problem("torch"),
                        td.DdpSettings(**settings))
    _assert_results_close(tres, jres)
    # The JAX oracle's property: 8 iterations improve on 5 and barely move.
    tres8 = td.solve_ddp(*_centroidal_problem("torch"),
                         td.DdpSettings(iterations=8))
    assert float(tres8.cost) <= float(tres.cost) + 1e-9
    assert max_err(tres8.u, tres.u) < 1e-3


def test_relaxed_barrier_properties():
    """Matches -mu*ln(h) above delta, C1 at delta, and the JAX package's
    function everywhere."""
    mu, delta = 0.1, 5.0
    hs = np.linspace(6.0, 50.0, 10)
    np.testing.assert_allclose(
        td.relaxed_barrier(torch.as_tensor(hs), mu, delta).numpy(),
        -mu * np.log(hs), atol=1e-12)
    eps = 1e-6

    def g(h):
        t = torch.tensor(h, dtype=torch.float64, requires_grad=True)
        td.relaxed_barrier(t, mu, delta).backward()
        return float(t.grad)

    f64 = torch.float64
    lo = float(td.relaxed_barrier(torch.tensor(delta - eps, dtype=f64), mu,
                                  delta))
    hi = float(td.relaxed_barrier(torch.tensor(delta + eps, dtype=f64), mu,
                                  delta))
    assert abs(lo - hi) < 1e-5
    assert abs(g(delta - eps) - g(delta + eps)) < 1e-4
    assert float(td.relaxed_barrier(torch.tensor(-1.0), mu, delta)) > \
        float(td.relaxed_barrier(torch.tensor(1.0), mu, delta))
    grid = np.linspace(-20.0, 40.0, 61)
    np.testing.assert_allclose(
        td.relaxed_barrier(torch.as_tensor(grid), mu, delta).numpy(),
        np.asarray(jd.relaxed_barrier(jnp.asarray(grid), mu, delta)),
        rtol=1e-14, atol=1e-14)
