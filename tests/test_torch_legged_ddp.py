"""PyTorch port: mpc/legged_ddp.py and DdpSettings.from_task_info against
the JAX package's on the same configuration and inputs.

The configuration is built in code (``LEGGED_TEST_WEIGHTS``, horizon 10,
soft cone), never from the reference's task.info (which the JAX oracle
``tests/test_legged_ddp.py`` reads at import); the inputs are the port's
trot scenario on an event-aligned grid.

- f64: x, u and the forces within 1e-7 of their scale; after the fixed
  budget of five iterations the last backward pass's K, P and p too (both
  packages take the same steps; what differs is summation order and the
  inverse of G, LU here and the Schur recursion there).
- f32 on each package's own path: forces within 1e-3 N.
- The JAX oracle's properties on the standing task (weight carried, cone
  respected, value function PSD, converged), on the port alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.mpc.legged_ddp import build_legged_ddp_solver as j_build
from cheeta_mpc_tpu.solvers.ddp import DdpSettings as JDdp
from cheeta_mpc_tpu_torch.examples import make_legged_example_inputs
from cheeta_mpc_tpu_torch.models.srbd_legged import GRAVITY
from cheeta_mpc_tpu_torch.mpc import legged_node as tnode
from cheeta_mpc_tpu_torch.mpc.legged_ddp import build_legged_ddp_solver
from cheeta_mpc_tpu_torch.mpc.legged_mpc import make_standing_reference
from cheeta_mpc_tpu_torch.solvers.ddp import DdpSettings
from tests.torch_port_util import (legged_configs, max_err,
                                   write_info_files)

N = 10
REL_F64 = 1e-7
F32_FORCE_ATOL = 1e-3  # N
FIELDS = ("x_traj", "u_traj", "forces", "gains_K", "gains_P", "gains_p",
          "cost")


@functools.lru_cache(maxsize=None)
def _run(dtype):
    """Both packages' DDP solve of the trot scenario (5 iterations)."""
    jcfg, _, tcfg, _ = legged_configs(N, "soft", dtype=dtype)
    inp = make_legged_example_inputs(tcfg, event_aligned=True)
    port = build_legged_ddp_solver(tcfg, DdpSettings(iterations=5),
                                   device="cpu")(*inp.args, dts=inp.dts)
    ref = jax.jit(j_build(jcfg, JDdp(iterations=5)))(
        *(jnp.asarray(a) for a in inp.args), dts=jnp.asarray(inp.dts))
    return port, ref, inp


def test_f64_solution_matches_jax():
    port, ref, inp = _run("float64")
    for name in FIELDS:
        a, b = getattr(port, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == b.shape, name
        assert a.dtype == torch.float64
        scale = max(1.0, float(np.abs(b).max()))
        err = max_err(a, b)
        print(f"{name}: {err} at scale {scale}")
        assert err <= REL_F64 * scale, (name, err, scale)
    assert bool(port.converged) == bool(ref.converged)
    # The scenario is not trivial: a swing phase, forces that moved off
    # the weight-compensating start, an uneven grid.
    assert (inp.enable == 0).any() and np.ptp(inp.dts) > 0
    fz = port.forces[..., 2].sum(-1)
    assert float(fz.max() - fz.min()) > 1.0


def test_f32_forces_match_jax():
    port, ref, _ = _run("float32")
    assert port.forces.dtype == torch.float32
    err = max_err(port.forces, ref.forces)
    print(f"f32 forces: {err} N")
    assert err <= F32_FORCE_ATOL
    assert bool(torch.isfinite(port.gains_P).all())


def test_swing_forces_are_exactly_zero():
    port, _, inp = _run("float64")
    swing = torch.as_tensor(inp.enable) == 0
    assert bool((port.forces[swing] == 0).all())


def test_ddp_settings_from_task_info_match_jax(tmp_path):
    task, _ = write_info_files(tmp_path)
    port, ref = DdpSettings.from_task_info(task), JDdp.from_task_info(task)
    assert port._fields == ref._fields
    assert port._asdict() == ref._asdict()
    assert port.iterations == 1 and port.reg == 1e-5
    assert port.alphas[0] == 1.0 and port.alphas[-1] >= 1e-2
    assert all(a > b for a, b in zip(port.alphas, port.alphas[1:]))
    over = dict(iterations=7, min_rel_cost=0.5)
    assert (DdpSettings.from_task_info(task, **over)._asdict()
            == JDdp.from_task_info(task, **over)._asdict())
    # A file without a ddp block gives the defaults' counterparts.
    bare = tmp_path / "bare.info"
    bare.write_text("mpc\n{\n  timeHorizon 1.0\n}\n")
    assert (DdpSettings.from_task_info(str(bare))._asdict()
            == JDdp.from_task_info(str(bare))._asdict())


def test_node_floors_the_task_info_penalty(tmp_path, monkeypatch):
    """The node configured from the task.info ddp block floors the file's
    constraintPenaltyInitialValue (20) at 1e2, as the JAX node does."""
    task, _ = write_info_files(tmp_path)
    seen = {}
    real = tnode.build_legged_ddp_solver

    def spy(cfg, ddp, eq_penalty=1e2, **kw):
        seen.update(ddp=ddp, eq_penalty=eq_penalty)
        return real(cfg, ddp, eq_penalty=eq_penalty, **kw)

    monkeypatch.setattr(tnode, "build_legged_ddp_solver", spy)
    _, _, tcfg, _ = legged_configs(N, "soft")
    ddp = DdpSettings.from_task_info(task, iterations=3)
    from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule, trot_template
    node = tnode.LeggedPlannerAssembly(
        tcfg, GaitSchedule.stance(trot_template(0.7)),
        tnode.default_stance_state(tcfg), np.zeros(3),
        settings=tnode.PlannerSettings(solver="ddp", ddp=ddp), device="cpu")
    assert seen == {"ddp": ddp, "eq_penalty": 1e2}
    from cheeta_mpc_tpu_torch.mpc.runtime import SystemObservation
    x0 = tnode.default_stance_state(tcfg)
    pol = node.solve_fn(SystemObservation(time=0.0, state=x0))
    assert pol.P.shape == (N + 1, 24, 24) and pol.p.shape == (N + 1, 24)
    assert np.isfinite(pol.P).all() and np.isfinite(pol.u_traj).all()
    assert set(node.last_metrics) == {"t", "solve_ms", "cost", "converged"}


def test_standing_solve_properties():
    """The JAX oracle's standing task on the port: the weight is carried,
    the friction cone holds, the value function is PSD and five iterations
    converge."""
    _, _, tcfg, _ = legged_configs(N, "soft")
    x0 = tnode.default_stance_state(tcfg)
    ones, zeros = np.ones((N, 4)), np.zeros((N, 4))
    sol = build_legged_ddp_solver(tcfg, DdpSettings(iterations=5),
                                  device="cpu")(
        x0, make_standing_reference(tcfg, x0), ones, zeros, zeros)
    f = sol.forces.numpy()
    assert np.isfinite(f).all() and (f[:, :, 2] > 1.0).all()
    m = float(tcfg.params.desc.mass)
    np.testing.assert_allclose(f[:, :, 2].sum(axis=1), m * GRAVITY,
                               rtol=0.15)
    ft = np.sqrt(f[:, :, 0] ** 2 + f[:, :, 1] ** 2)
    assert (ft <= tcfg.friction_mu * f[:, :, 2] + 1e-6).all()
    P = sol.gains_P.numpy()
    eigs = np.linalg.eigvalsh(0.5 * (P + P.transpose(0, 2, 1)))
    assert eigs.min() > -1e-6 * max(1.0, eigs.max())
    assert bool(sol.converged)


def test_one_problem_only():
    _, _, tcfg, _ = legged_configs(N, "soft")
    inp = make_legged_example_inputs(tcfg, batch=2)
    with pytest.raises(ValueError, match="takes one problem"):
        build_legged_ddp_solver(tcfg, device="cpu")(*inp.args)
