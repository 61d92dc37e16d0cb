"""PyTorch port, ``ops/condensed.py`` (the condensed dense-IPM backend)
against the JAX package: the six cases of tests/test_condensed.py on the
same seeded problems, and the SQP with ``qp_backend='condensed'`` on the
centroidal MPC.

f64 unless stated. Tolerances: 1e-10 on the condensed operators (sums of
products of order-1 blocks), 1e-8 on solutions after 30 IPM iterations (the
two packages run the same dense Mehrotra loop; measured ~1e-14), 1e-6 on
the SQP's forces (as tests/test_torch_centroidal_mpc.py). The Riccati gains
of a converged solve are not compared across packages (barrier weights up
to 1e10 leave them O(1) noise in f64, ROADMAP "Known"); the feedback
identity is checked instead.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.core.types import StageEquality as JEq
from cheeta_mpc_tpu.mpc import centroidal_mpc as jm
from cheeta_mpc_tpu.ops.condensed import condense as jcondense
from cheeta_mpc_tpu.ops.condensed import solve_ocp_qp_condensed as jsolve
from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu_torch import examples as tex
from cheeta_mpc_tpu_torch.convert import (config_from_dict,
                                          scp_settings_from_dict)
from cheeta_mpc_tpu_torch.core.types import tree_map
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from cheeta_mpc_tpu_torch.ops import condensed as tc
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings, kkt_residuals
from cheeta_mpc_tpu_torch.ops.riccati import solve_lqr
from tests.problem_gen import add_random_constraints, random_lq_problem
from tests.torch_port_util import assert_close, max_err, qp_data_to_torch

SETTINGS = IpmSettings(iters=30)
JSETTINGS = JIpm(iters=30)
TOL_SOL = 1e-8


def assert_kkt(data, sol, tol):
    res = {k: float(v) for k, v in kkt_residuals(data, sol).items()}
    for name, val in res.items():
        t = 10 * tol if name == "stationarity" else tol
        assert val < t, f"KKT residual {name}={val} (all: {res})"


def _stack(objs):
    """Port containers of equal shapes -> one with a leading batch dim."""
    first = objs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(objs)
    return dataclasses.replace(first, **{
        f.name: _stack([getattr(o, f.name) for o in objs])
        for f in dataclasses.fields(first)})


def _constrained(rng, N, nx, nu, ng, tight):
    data = random_lq_problem(rng, N=N, nx=nx, nu=nu)
    return add_random_constraints(rng, data, ng=ng, tight=tight)


def test_condense_unconstrained_matches_lqr():
    rng = np.random.default_rng(10)
    data = random_lq_problem(rng, N=7, nx=5, nu=3)
    jq, tq = jcondense(data), tc.condense(qp_data_to_torch(data))
    for name in ("H", "g0", "Phi", "phi"):
        assert max_err(getattr(tq, name), getattr(jq, name)) <= 1e-10, name
    z = torch.linalg.solve(tq.H, -tq.g0)
    ref = solve_lqr(qp_data_to_torch(data), reg=SETTINGS.reg)
    assert max_err(z.reshape(7, 3), ref.du) <= 1e-8
    dx = torch.einsum("kim,m->ki", tq.Phi, z) + tq.phi
    assert max_err(dx, ref.dx) <= 1e-8
    # Without inequality rows the solve is the exact Riccati solve.
    sol = tc.solve_ocp_qp_condensed(qp_data_to_torch(data), SETTINGS)
    assert max_err(sol.du, ref.du) == 0.0


@pytest.mark.parametrize("trial", range(4))
def test_condensed_matches_jax(trial):
    """Four seeded constrained problems: the condensed operators, the
    solution and its duals against the JAX package's condensed solve, and
    the port's KKT certificate."""
    rng = np.random.default_rng(11)
    for _ in range(trial + 1):
        data = _constrained(rng, 8, 5, 3, 4, 0.3)
    td = qp_data_to_torch(data)
    jq, tq = jcondense(data), tc.condense(td)
    for name in tq._fields:
        assert max_err(getattr(tq, name), getattr(jq, name)) <= 1e-10, name
    ref = jsolve(data, JSETTINGS)
    sol = tc.solve_ocp_qp_condensed(td, SETTINGS)
    for name in ("dx", "du", "lam_l", "lam_u", "s_l", "s_u"):
        assert max_err(getattr(sol, name), getattr(ref, name)) <= TOL_SOL, \
            name
    assert_kkt(td, sol, 1e-6)
    spd = tc.solve_ocp_qp_condensed(td, SETTINGS, factor="spd_inverse")
    jspd = jsolve(data, JSETTINGS, factor="spd_inverse")
    assert max_err(spd.du, jspd.du) <= TOL_SOL


def test_condensed_gains_consistency():
    """du_0' ~= du_0 + K_0 (dx0' - dx0) for a perturbed initial state when
    no constraint changes activity, as in the JAX test; the prediction
    agrees with the JAX package's."""
    rng = np.random.default_rng(12)
    data = _constrained(rng, 6, 4, 3, 3, 100.0)
    delta = 1e-3 * rng.normal(size=4)
    td = qp_data_to_torch(data)
    sol = tc.solve_ocp_qp_condensed(td, SETTINGS)
    sol2 = tc.solve_ocp_qp_condensed(
        td.replace(dx0=td.dx0 + torch.as_tensor(delta)), SETTINGS)
    pred = sol.du[0] + sol.gains.K[0] @ torch.as_tensor(delta)
    assert max_err(sol2.du[0], pred) <= 1e-6
    ref = jsolve(data, JSETTINGS)
    jpred = np.asarray(ref.du[0]) + np.asarray(ref.gains.K[0]) @ delta
    assert max_err(pred, jpred) <= 1e-6


def test_condensed_batch():
    """A leading batch of four problems (the port's counterpart of the JAX
    test's ``jax.vmap``): each element equals its own solve and the JAX
    package's, and certifies."""
    rng = np.random.default_rng(13)
    datas = [_constrained(rng, 5, 4, 3, 3, 0.4) for _ in range(4)]
    ports = [qp_data_to_torch(d) for d in datas]
    stacked = _stack(ports)
    sols = tc.solve_ocp_qp_condensed(stacked, SETTINGS)
    assert tuple(sols.du.shape) == (4, 5, 3)
    for i, (d, p) in enumerate(zip(datas, ports)):
        one = tc.solve_ocp_qp_condensed(p, SETTINGS)
        assert max_err(sols.du[i], one.du) <= 1e-10
        assert max_err(sols.du[i], jsolve(d, JSETTINGS).du) <= TOL_SOL
        sol_i = tree_map(lambda t, i=i: t[i], sols)
        assert_kkt(p, sol_i, 1e-5)


def test_condensed_float32():
    """f32 against the f64 Riccati solve: 2e-2, the JAX test's bound (the
    f32 convergence freeze at mu < 1e-4 limits it, not the backend)."""
    from cheeta_mpc_tpu.ops.ocpqp import solve_ocp_qp as jsolve_riccati
    rng = np.random.default_rng(14)
    data = _constrained(rng, 6, 4, 3, 3, 0.4)
    ref = jsolve_riccati(data, JSETTINGS)
    sol = tc.solve_ocp_qp_condensed(qp_data_to_torch(data, "float32"),
                                    IpmSettings(iters=25))
    assert sol.du.dtype == torch.float32
    assert max_err(sol.du, ref.du) <= 2e-2


def test_condensed_rejects_stage_equalities():
    rng = np.random.default_rng(15)
    data = random_lq_problem(rng, N=4, nx=3, nu=2)
    eq = JEq(C=jnp.zeros((4, 1, 3)), D=jnp.zeros((4, 1, 2)),
             e=jnp.zeros((4, 1)), mask=jnp.ones((4, 1)))
    with pytest.raises(ValueError):
        jsolve(data.replace(eq=eq), JSETTINGS)
    with pytest.raises(ValueError, match="stage equalities"):
        tc.solve_ocp_qp_condensed(qp_data_to_torch(data.replace(eq=eq)),
                                  SETTINGS)


def test_scp_with_the_condensed_backend():
    """The centroidal MPC's SQP with ``qp_backend='condensed'`` on both
    sides (2 SQP x 10 IPM iterations, f64, the JAX solver jitted): forces
    and trajectories 1e-6, the same convergence code."""
    import jax
    from cheeta_mpc_tpu import examples as jex
    from cheeta_mpc_tpu.solvers.scp import ScpSettings as JScp
    N = 6
    jcfg = jm.CentroidalMpcConfig(
        mass=8.0, num_legs=4, horizon=N, dt=0.01,
        weights=tuple(jex.TEST_WEIGHTS), mu=(0.8,) * 4,
        dtype=jnp.dtype("float64"))
    jscp = JScp(iterations=2, ipm=JIpm(iters=10), qp_backend="condensed")
    d = jcfg._asdict()
    d["dtype"] = "float64"
    sd = jscp._asdict()
    sd["ipm"] = jscp.ipm._asdict()
    tcfg, tscp = config_from_dict(d), scp_settings_from_dict(sd)
    assert tscp.qp_backend == "condensed"
    inputs = tex.make_example_inputs(tcfg)
    ref = jax.jit(jm.build_centroidal_solver(jcfg, jscp))(*inputs)
    sol = tm.build_centroidal_solver(tcfg, tscp, device="cpu")(*inputs)
    for name in ("contact_force", "x_traj", "u_traj"):
        assert_close(getattr(sol, name), getattr(ref, name), 1e-6, what=name)
    assert int(sol.convergence) == int(ref.convergence)
