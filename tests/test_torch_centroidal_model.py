"""PyTorch port, models/centroidal.py against the JAX package's: the Euler
step, its closed-form Jacobians (vs ``jax.jacfwd``) and the rollout, on the
same numpy inputs in f64.

Both sides evaluate the same bilinear expressions in f64, so they agree to
roundoff: atol 1e-12 at states of order 1 and forces of order 50 N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.models import centroidal as jc
from cheeta_mpc_tpu_torch.models import centroidal as tc
from tests.torch_port_util import assert_close

ATOL = 1e-12
MASS, DT = 8.0, 0.01


def _params(nl):
    mu = (0.8, 0.7, 0.6, 0.5, 0.4, 0.3)[:nl]
    return (jc.CentroidalParams.create(MASS, nl, DT, np.asarray(mu)),
            tc.CentroidalParams.create(MASS, nl, DT, mu))


def _point(rng, nl, lead=()):
    nx, nu = 9 + 6 * nl, 6 * nl
    x = rng.normal(size=lead + (nx,))
    u = rng.normal(size=lead + (nu,))
    u[..., 3 * nl:] *= 30.0  # forces of tens of newtons
    # Contact flags: mixed stance/swing, not all equal.
    enable = (rng.uniform(size=lead + (nl,)) < 0.6).astype(np.float64)
    return x, u, enable


def test_dimensions_and_packing():
    jp, tp = _params(4)
    assert (tp.nx, tp.nu, tp.nx_ref) == (jp.nx, jp.nu, jp.nx_ref) == (33, 24,
                                                                      21)
    assert tc.CentroidalParams.create(MASS, 4, DT, 0.8).mu == (0.8,) * 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 33))
    parts = tc.unpack_state(tp, torch.as_tensor(x))
    for a, b in zip(parts, jc.unpack_state(jp, jnp.asarray(x))):
        assert_close(a, b, 0.0)
    assert torch.equal(tc.pack_state(*parts), torch.as_tensor(x))
    u = rng.normal(size=(5, 24))
    for a, b in zip(tc.unpack_input(tp, torch.as_tensor(u)),
                    jc.unpack_input(jp, jnp.asarray(u))):
        assert_close(a, b, 0.0)


@pytest.mark.parametrize("nl", [4, 2])
def test_step_matches_jax(nl):
    jp, tp = _params(nl)
    rng = np.random.default_rng(1 + nl)
    for _ in range(4):
        x, u, e = _point(rng, nl)
        ref = jc.centroidal_step(jp, jnp.asarray(x), jnp.asarray(u),
                                 jnp.asarray(e))
        got = tc.centroidal_step(tp, *(torch.as_tensor(a) for a in (x, u, e)))
        assert_close(got, ref, ATOL)


@pytest.mark.parametrize("nl", [4, 2])
def test_closed_form_jacobians_match_jacfwd(nl):
    jp, tp = _params(nl)
    rng = np.random.default_rng(10 + nl)
    for _ in range(4):
        x, u, e = _point(rng, nl)
        A, B, f = jc.linearize_step(jp, jnp.asarray(x), jnp.asarray(u),
                                    jnp.asarray(e))
        tA, tB, tf = tc.linearize_step(
            tp, *(torch.as_tensor(a) for a in (x, u, e)))
        assert_close(tA, A, ATOL, what="A")
        assert_close(tB, B, ATOL, what="B")
        assert_close(tf, f, ATOL, what="f")
        assert float(np.abs(np.asarray(B)).max()) > 0.1  # not vacuous


def test_batched_linearization_matches_vmap():
    """Leading dimensions (fleet, stage) in place of nested ``vmap``."""
    jp, tp = _params(4)
    rng = np.random.default_rng(20)
    x, u, e = _point(rng, 4, lead=(3, 5))
    lin = jax.vmap(jax.vmap(lambda a, b, c: jc.linearize_step(jp, a, b, c)))
    A, B, f = lin(jnp.asarray(x), jnp.asarray(u), jnp.asarray(e))
    tA, tB, tf = tc.linearize_step(
        tp, *(torch.as_tensor(a) for a in (x, u, e)))
    assert tA.shape == (3, 5, 33, 33) and tB.shape == (3, 5, 33, 24)
    assert_close(tA, A, ATOL)
    assert_close(tB, B, ATOL)
    assert_close(tf, f, ATOL)
    # Contact flags shared by the batch broadcast.
    tA2, tB2, _ = tc.linearize_step(tp, torch.as_tensor(x),
                                    torch.as_tensor(u),
                                    torch.as_tensor(e[0]))
    A2, B2, _ = lin(jnp.asarray(x), jnp.asarray(u),
                    jnp.broadcast_to(jnp.asarray(e[0]), e.shape))
    assert_close(tA2, A2, ATOL)
    assert_close(tB2, B2, ATOL)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_rollout_matches_jax(lead):
    jp, tp = _params(4)
    rng = np.random.default_rng(30)
    N = 7
    x0 = rng.normal(size=lead + (33,))
    u = rng.normal(size=lead + (N, 24))
    u[..., 12:] *= 20.0
    e = (rng.uniform(size=lead + (N, 4)) < 0.5).astype(np.float64)
    roll = lambda a, b, c: jc.rollout(jp, a, b, c)
    for _ in lead:
        roll = jax.vmap(roll)
    ref = roll(jnp.asarray(x0), jnp.asarray(u), jnp.asarray(e))
    got = tc.rollout(tp, *(torch.as_tensor(a) for a in (x0, u, e)))
    assert got.shape == lead + (N + 1, 33)
    # N steps compound the roundoff of a step; still f64 roundoff.
    assert_close(got, ref, 1e-11)
