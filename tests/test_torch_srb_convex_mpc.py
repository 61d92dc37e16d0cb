"""PyTorch port, the convex SRB MPC (models/srb.py, mpc/convex_mpc.py)
against the JAX package on the same numpy inputs.

The SRB step's A and B agree to 1e-12 in f64. The controller runs the four
scenarios of tests/test_convex_mpc.py (standing, trot, the height closed
loop, a batch) through the port's QP dispatch on the CPU, i.e. the plain
versions of the interior-point kernels (K1 for one scenario, K2 for a
batch), and its forces agree with the JAX package's scan solve to 1e-6 N in
f64. The f32 run of the same path stays within 5e-2 N of the f64 one (the
ground-reaction-force bound that chip_smoke.py holds the f32 kernels to),
with the f32 convergence freeze lowered so that f32 runs the iterations f64
runs.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cheeta_mpc_tpu.examples import NOMINAL_FEET, trot_table
from cheeta_mpc_tpu.models import srb as jsrb
from cheeta_mpc_tpu.mpc.convex_mpc import ConvexMpcConfig as JCfg
from cheeta_mpc_tpu.mpc.convex_mpc import build_convex_mpc as jbuild
from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu_torch.convert import convex_config_from_dict
from cheeta_mpc_tpu_torch.models import srb as tsrb
from cheeta_mpc_tpu_torch.mpc import convex_mpc as tc
from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch as tb
from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati as tk
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.utils import timing
from tests.torch_port_util import max_err

PARAMS = jsrb.SrbParams(mass=9.0, inertia=(0.07, 0.26, 0.24), mu=0.5,
                        fz_max=250.0)
JCFG = JCfg(params=PARAMS, horizon=8, dt=0.03, dtype=jnp.float64)
N = JCFG.horizon
ITERS = 20
TOL_F64 = 1e-6  # N, port against the JAX package, both f64
TOL_F32 = 5e-2  # N, the port's f32 path against its f64 one


def _port_config(dtype="float64"):
    d = JCFG._asdict()
    d["dtype"] = dtype
    return convex_config_from_dict(d)


def nominal_state(height=0.3):
    x = np.zeros(13)
    x[5] = height
    x[12] = 1.0
    return x


def standing_reference(x0):
    return np.tile(np.asarray(x0), (N + 1, 1))


@pytest.fixture(scope="module")
def solvers():
    jsolve = jax.jit(jbuild(JCFG, JIpm(iters=ITERS)))
    tsolve = tc.build_convex_mpc(_port_config(), IpmSettings(iters=ITERS),
                                 device="cpu")
    return jsolve, tsolve


def _both(solvers, *args):
    jsolve, tsolve = solvers
    jf, jsol = jsolve(*(jnp.asarray(a) for a in args))
    tf, tsol = tsolve(*args)
    return np.asarray(jf), tf, jsol, tsol


@pytest.mark.parametrize("seed", range(3))
def test_srb_dynamics_against_jax(seed):
    """One step at a random yaw, CoM, footholds and contact flags, and the
    stage stack the MPC builds (yaw and flags per stage): 1e-12."""
    rng = np.random.default_rng(seed)
    tp = tsrb.SrbParams(**PARAMS._asdict())
    com, feet = rng.normal(size=3), rng.normal(size=(4, 3))
    yaws = rng.uniform(-np.pi, np.pi, size=N)
    flags = (rng.uniform(size=(N, 4)) < 0.5).astype(np.float64)
    tA, tB = tsrb.srb_discrete_dynamics(tp, torch.as_tensor(yaws), com, feet,
                                        flags, 0.03, torch.float64)
    assert tuple(tA.shape) == (N, 13, 13) and tuple(tB.shape) == (N, 13, 12)
    for k in (0, N - 1):
        jA, jB = jsrb.srb_discrete_dynamics(
            PARAMS, yaws[k], jnp.asarray(com), jnp.asarray(feet),
            jnp.asarray(flags[k]), 0.03, jnp.float64)
        assert max_err(tA[k], jA) <= 1e-12
        assert max_err(tB[k], jB) <= 1e-12
    one = tsrb.srb_discrete_dynamics(tp, torch.tensor(yaws[0]), com, feet,
                                     flags[0], 0.03, torch.float64)
    assert max_err(one[0], tA[0]) == 0.0 and max_err(one[1], tB[0]) == 0.0
    assert max_err(tsrb.friction_pyramid_rows(0.5, torch.float64),
                   jsrb.friction_pyramid_rows(0.5, jnp.float64)) == 0.0


def test_config_converts_one_to_one():
    tcfg = _port_config()
    assert tcfg.params == tsrb.SrbParams(**PARAMS._asdict())
    assert (tcfg.horizon, tcfg.dt, tcfg.q_diag, tcfg.r_force) == (
        JCFG.horizon, JCFG.dt, JCFG.q_diag, JCFG.r_force)
    assert tcfg.dtype == torch.float64


def test_standing_forces_share_weight(solvers):
    x0 = nominal_state()
    jf, tf, jsol, tsol = _both(solvers, x0, standing_reference(x0),
                               NOMINAL_FEET, np.ones((N, 4)))
    assert max_err(tf, jf) <= TOL_F64
    np.testing.assert_allclose(tf[:, :, 2].sum(dim=1).numpy(),
                               PARAMS.mass * jsrb.GRAVITY, rtol=0.02)
    assert float(tsol.mu) < 1e-6
    assert max_err(tsol.dx, jsol.dx) <= TOL_F64


def test_trot_swing_forces_zero(solvers):
    x0 = nominal_state()
    enable = trot_table(N)
    jf, tf, _, _ = _both(solvers, x0, standing_reference(x0), NOMINAL_FEET,
                         enable)
    assert max_err(tf, jf) <= TOL_F64
    assert float(tf[torch.as_tensor(enable) == 0].abs().max()) == 0.0
    fx, fy, fz = tf[..., 0], tf[..., 1], tf[..., 2]
    on = torch.as_tensor(enable) > 0
    assert bool((fz[on] > 0.2 * PARAMS.mass * jsrb.GRAVITY).all())
    assert bool((fx.abs() <= PARAMS.mu * fz + 1e-8)[on].all())
    assert bool((fy.abs() <= PARAMS.mu * fz + 1e-8)[on].all())


def test_height_regulation_closed_loop(solvers):
    """Dropped CoM, 30 closed-loop steps through each package's own SRB
    step: the forces of every step and the final state agree."""
    jsolve, tsolve = solvers
    ref = standing_reference(nominal_state(height=0.3))
    enable = np.ones((N, 4))
    tp = tsrb.SrbParams(**PARAMS._asdict())
    xj = xt = nominal_state(height=0.27)
    worst = 0.0
    for _ in range(30):
        fj, _ = jsolve(jnp.asarray(xj), jnp.asarray(ref),
                       jnp.asarray(NOMINAL_FEET), jnp.asarray(enable))
        ft, _ = tsolve(xt, ref, NOMINAL_FEET, enable)
        worst = max(worst, max_err(ft, fj))
        A, B = jsrb.srb_discrete_dynamics(PARAMS, 0.0, jnp.asarray(xj[3:6]),
                                          jnp.asarray(NOMINAL_FEET),
                                          jnp.ones(4), JCFG.dt, jnp.float64)
        xj = np.asarray(A @ xj + B @ np.asarray(fj)[0].reshape(-1))
        tA, tB = tsrb.srb_discrete_dynamics(tp, torch.tensor(0.0), xt[3:6],
                                            NOMINAL_FEET, np.ones(4), JCFG.dt,
                                            torch.float64)
        xt = (tA @ torch.as_tensor(xt) + tB @ ft[0].reshape(-1)).numpy()
    assert worst <= TOL_F64
    assert max_err(xt, xj) <= 1e-9
    assert abs(xt[5] - 0.3) < 0.01 and abs(xt[11]) < 0.05


def test_batched_scenarios(solvers):
    """A leading batch of initial heights (the fleet kernel's plain version)
    against ``jax.vmap``; element 2 equal to its batch-1 solve."""
    _, tsolve = solvers
    x0 = nominal_state()
    ref, enable = standing_reference(x0), trot_table(N)
    xs = np.tile(x0, (4, 1))
    xs[:, 5] += 0.01 * np.arange(4)
    jone = jbuild(JCFG, JIpm(iters=ITERS))
    jf, jsol = jax.jit(jax.vmap(lambda x: jone(
        x, jnp.asarray(ref), jnp.asarray(NOMINAL_FEET),
        jnp.asarray(enable))))(jnp.asarray(xs))
    tf, tsol = tsolve(xs, ref, NOMINAL_FEET, enable)
    assert tuple(tf.shape) == (4, N, 4, 3)
    assert max_err(tf, jf) <= TOL_F64
    assert float(torch.max(tsol.mu)) < 1e-6
    assert bool(torch.isnan(tsol.gains.K).all())  # the fleet path's gains
    one, _ = tsolve(xs[2], ref, NOMINAL_FEET, enable)
    assert max_err(tf[2], one) <= 1e-9
    with pytest.raises(ValueError, match="at most one batch dimension"):
        tsolve(xs[None], ref, NOMINAL_FEET, enable)


def test_qp_goes_through_the_kernel_dispatch(monkeypatch):
    """One scenario reaches K1's wrapper and a batch K2's (their plain
    versions on the CPU); the QP keeps C/D without a batch dimension."""
    seen = []
    for mod, name in ((tb, "solve_ocp_qp_kernel"),
                      (tb, "solve_ocp_qp_fleet")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda d, s, real=real, name=name: (
            seen.append(name), real(d, s))[1])
    tsolve = tc.build_convex_mpc(_port_config(), IpmSettings(iters=4),
                                 device="cpu")
    x0 = nominal_state()
    args = (x0, standing_reference(x0), NOMINAL_FEET, trot_table(N))
    tsolve(*args)
    tsolve(np.stack([x0, x0]), *args[1:])
    assert seen == ["solve_ocp_qp_kernel", "solve_ocp_qp_fleet"]
    qp = tsolve.initial_qp(np.stack([x0, x0]), *args[1:])
    assert qp.con.C.dim() == 3 and qp.con.D.dim() == 3
    assert tb.out_of_scope_reason(qp) is None
    assert tk.solve_ocp_qp_kernel.launches == 0


@pytest.mark.parametrize("gait", ["stance", "trot"])
def test_f32_against_f64(gait):
    """BASELINE config 2 (N=10, 12 iterations) in f32 (the kernels' plain
    versions) against f64 on a standing reference over the feet's centre:
    forces within 5e-2 N (measured 4.0e-2 stance, 1.3e-2 trot), the total
    vertical force of every stage within 2 % of m g standing. The f32 solve
    freezes at mu < 1e-6 (chip_smoke.py says why not lower): at the f32
    default freeze (mu < 1e-4) this QP stops before its forces settle, in
    both packages (asserted below for the JAX package: its f32 forces then
    miss its f64 ones by more than 1 N)."""
    ipm32 = IpmSettings(iters=12, mu_tol=1e-6)
    cfg = _port_config()._replace(horizon=10)
    n = cfg.horizon
    x0 = nominal_state()
    enable = np.ones((n, 4)) if gait == "stance" else trot_table(n)
    args = (x0, np.tile(x0, (n + 1, 1)), NOMINAL_FEET, enable)
    f32, _ = tc.build_convex_mpc(cfg._replace(dtype=torch.float32), ipm32,
                                 device="cpu")(*args)
    f64, _ = tc.build_convex_mpc(cfg, device="cpu")(*args)
    assert f32.dtype == torch.float32
    assert max_err(f32, f64) <= TOL_F32
    if gait == "stance":
        np.testing.assert_allclose(f32[:, :, 2].sum(dim=1).numpy(),
                                   PARAMS.mass * jsrb.GRAVITY, rtol=0.02)
    j32 = JCFG._replace(horizon=10, dtype=jnp.float32)
    jargs = tuple(jnp.asarray(a) for a in args)
    jf32, _ = jax.jit(jbuild(j32))(*jargs)
    jf64, _ = jax.jit(jbuild(j32._replace(dtype=jnp.float64)))(*jargs)
    assert max_err(f64, jf64) <= TOL_F64
    assert max_err(jf32, jf64) > 1.0


def test_f32_off_centre_no_worse_than_jax():
    """64 seeded standing scenarios with the CoM up to 2 cm off the feet's
    centre, f32 at mu_tol=1e-6 on both sides. The split between legs is
    nearly free there (stance force regularization 1e-6), and f32 is not
    held to f64 in either package: measured 0.91 N (port) and 1.11 N (JAX)
    from f64 standing, 0.21 and 0.29 N trot, and the two f32 solves 1.08
    and 0.27 N apart. Held: the port no farther from f64 than the JAX
    package (+0.1 N)."""
    rng = np.random.default_rng(0)
    n, B = 10, 64
    x0 = np.zeros((B, 13))
    x0[:, 3:5] = rng.uniform(-0.02, 0.02, size=(B, 2))
    x0[:, 5], x0[:, 12] = 0.3, 1.0
    ref = np.repeat(x0[:, None, :], n + 1, axis=1)
    cfg = _port_config()._replace(horizon=10)
    j32 = JCFG._replace(horizon=10, dtype=jnp.float32)
    for enable in (np.ones((n, 4)), trot_table(n)):
        args = (x0, ref, NOMINAL_FEET, enable)
        f64, _ = tc.build_convex_mpc(cfg, device="cpu")(*args)
        f32, _ = tc.build_convex_mpc(cfg._replace(dtype=torch.float32),
                                     IpmSettings(iters=12, mu_tol=1e-6),
                                     device="cpu")(*args)
        jone = jbuild(j32, JIpm(iters=12, mu_tol=1e-6))
        jf32, _ = jax.jit(jax.vmap(lambda x, r, e=enable: jone(
            x, r, jnp.asarray(NOMINAL_FEET, jnp.float32),
            jnp.asarray(e, jnp.float32))))(jnp.asarray(x0, jnp.float32),
                                           jnp.asarray(ref, jnp.float32))
        assert max_err(f32, f64) <= max_err(jf32, f64) + 0.1


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.build_convex_mpc(_port_config())


STAGES = ("convex.linearize", "convex.qp")


@pytest.mark.parametrize("batch", [None, 3], ids=["batch1", "batch3"])
def test_solve_marks_its_two_stages(batch, monkeypatch):
    """Under ``torch.profiler`` on the CPU the solve opens
    ``convex.linearize`` then ``convex.qp``, once each; its forces and
    iterate are bit for bit those of the same solve with the marks taken
    out, and without a profiler no range is opened."""
    x0 = nominal_state()
    x0[3:5] = (0.02, -0.01)
    args = (x0 if batch is None else np.tile(x0, (batch, 1)),
            standing_reference(nominal_state()), NOMINAL_FEET,
            trot_table(N, phase=2))
    solve = tc.build_convex_mpc(_port_config(), IpmSettings(iters=6),
                                device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        marked, msol = solve(*args)
    seen = sorted((e.time_range.start, e.name) for e in prof.events()
                  if e.name in STAGES)
    assert [name for _, name in seen] == list(STAGES)

    def no_range(*a, **kw):
        raise AssertionError("a range was opened without a profiler")

    monkeypatch.setattr(timing, "record_function", no_range)
    quiet, _ = solve(*args)
    monkeypatch.setattr(tc, "stage", lambda name: contextlib.nullcontext())
    unmarked, usol = tc.build_convex_mpc(
        _port_config(), IpmSettings(iters=6), device="cpu")(*args)
    for a, b in ((marked, unmarked), (quiet, unmarked), (msol.dx, usol.dx),
                 (msol.du, usol.du)):
        assert a.dtype == b.dtype and torch.equal(a, b)
