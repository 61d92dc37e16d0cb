"""PyTorch port, the legged slice on a batch: every input of the solver
carries one leading batch dimension, with a per-scenario gait phase and
command — against ``jax.vmap`` of the JAX solver and against a loop over
the port's batch-1 solve. f64, ``qp_backend='riccati'``; tolerances as in
tests/test_torch_legged_mpc.py.
"""

import numpy as np
import pytest
import torch

from cheeta_mpc_tpu_torch import examples as tex
from cheeta_mpc_tpu_torch.mpc import legged_mpc as tl
from tests.torch_port_util import (assert_close, assert_qp_data_close,
                                   jax_legged_solve, legged_configs, max_err)

N, B = 6, 3


@pytest.fixture(scope="module")
def soft_batch():
    jcfg, jscp, tcfg, tscp = legged_configs(N, "soft", iterations=2,
                                            qp_backend='riccati')
    inb = tex.make_legged_example_inputs(tcfg, batch=B, seed=2)
    solve = tl.build_legged_solver(tcfg, tscp, device="cpu")
    return jcfg, jscp, tcfg, tscp, inb, solve, solve(*inb.args)


def test_batch_matches_vmapped_jax(soft_batch):
    jcfg, jscp, _, _, inb, solve, sol = soft_batch
    assert not np.array_equal(inb.enable[0], inb.enable[1])
    ref, steps, _, qp = jax_legged_solve(jcfg, jscp, inb.args, batched=True)
    assert_qp_data_close(solve.initial_qp(*inb.args), qp, 1e-9)
    for name in ("forces", "x_traj", "u_traj"):
        assert_close(getattr(sol, name), getattr(ref, name), 1e-6, what=name)
    assert np.array_equal(sol.step_size.numpy(), np.asarray(steps))
    assert np.array_equal(sol.convergence.numpy(), np.asarray(ref.convergence))
    assert tuple(sol.forces.shape) == (B, N, 4, 3)


@pytest.mark.parametrize("i", range(B))
def test_batch_element_equals_batch1_solve(soft_batch, i):
    _, _, _, _, inb, solve, sol = soft_batch
    one = solve(*(a[i] for a in inb.args))
    for name in ("forces", "x_traj", "u_traj", "merit"):
        assert max_err(getattr(sol, name)[i], getattr(one, name)) <= 1e-8
    assert np.array_equal(sol.step_size[i].numpy(), one.step_size.numpy())


def test_shared_inputs_broadcast_over_the_batch(soft_batch):
    """An input without the batch dimension is shared by all scenarios."""
    _, _, _, _, inb, solve, _ = soft_batch
    mixed = solve(inb.x0, inb.x_ref, inb.enable[1], inb.z_pos[1],
                  inb.z_vel[1])
    one = solve(inb.x0[2], inb.x_ref[2], inb.enable[1], inb.z_pos[1],
                inb.z_vel[1])
    assert max_err(mixed.forces[2], one.forces) <= 1e-8
    with pytest.raises(ValueError, match="at most one batch dimension"):
        solve(inb.x0[None], inb.x_ref, inb.enable, inb.z_pos, inb.z_vel)


def test_batched_default_backend_uses_the_fleet_plain_version(soft_batch):
    """f32, default backend, CPU: K4's plain version; NaN value function,
    real feedback gains, forces within 2e-3 of scale of the f64 solve."""
    _, _, tcfg, tscp, inb, _, ref = soft_batch
    solve = tl.build_legged_solver(
        tcfg._replace(dtype=torch.float32),
        tscp._replace(qp_backend='riccati_kernel'), device="cpu")
    sol = solve(*inb.args)
    assert bool(torch.isnan(sol.gains_P).all())
    assert bool(torch.isfinite(sol.gains_K).all())
    scale = max(1.0, float(ref.forces.abs().max()))
    assert max_err(sol.forces, ref.forces) <= 2e-3 * scale
    assert np.array_equal(sol.step_size.numpy(), ref.step_size.numpy())


def test_batched_pyramid():
    """Batched pyramid mode (inequalities and equalities). The f64 plain
    executor against ``jax.vmap`` of the JAX solver (1e-6, as above), its
    element 1 equal to the batch-1 solve. The f32 kernel backend takes the
    fleet interior-point kernel with stage equalities (K2; here on the CPU
    its plain version): NaN gains, forces within 2e-3 of the force scale of
    the JAX f64 solve (the bound of the f32 backend against f64 in
    tests/test_torch_legged_mpc.py), and element 1 within 1e-5 of scale of
    the f32 batch-1 solve (K1's plain version: the same arithmetic, summed
    over a batch dimension)."""
    jcfg, jscp, tcfg, tscp = legged_configs(N, "pyramid", iterations=1,
                                            qp_backend='riccati')
    inb = tex.make_legged_example_inputs(tcfg, batch=B, seed=2)
    solve = tl.build_legged_solver(tcfg, tscp, device="cpu")
    sol = solve(*inb.args)
    one = solve(*(a[1] for a in inb.args))
    assert max_err(sol.forces[1], one.forces) <= 1e-7
    ref, steps, _, _ = jax_legged_solve(jcfg, jscp, inb.args, batched=True)
    assert_close(sol.forces, ref.forces, 1e-6, what="forces")
    assert np.array_equal(sol.step_size.numpy(), np.asarray(steps))
    kernel = tl.build_legged_solver(
        tcfg._replace(dtype=torch.float32),
        tscp._replace(qp_backend='riccati_kernel'), device="cpu")
    ksol = kernel(*inb.args)
    assert bool(torch.isnan(ksol.gains_K).all())
    scale = max(1.0, float(np.abs(np.asarray(ref.forces)).max()))
    assert max_err(ksol.forces, ref.forces) <= 2e-3 * scale
    assert np.array_equal(ksol.step_size.numpy(), np.asarray(steps))
    kone = kernel(*(a[1] for a in inb.args))
    assert max_err(ksol.forces[1], kone.forces) <= 1e-5 * scale
