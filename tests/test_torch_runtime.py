"""PyTorch port: the copied numpy runtime (mpc/runtime.py,
mpc/loopshaping.py, mpc/solver_observer.py) against the JAX package's.

Each scenario is written once, takes a package's three modules and returns
what it observed; it runs through both packages on the same numpy inputs and
the two results must be equal bit for bit (tolerance 0: the modules are
copies and numpy only). The scenarios are those of tests/test_runtime.py,
the PolicyData / MpcMrtInterface parts of tests/test_value_query.py,
tests/test_loopshaping.py and the multiplier observer of
tests/test_viz_observers.py. The realtime loop runs a worker thread, so of
it only what its contract fixes is compared: the error count's sign, the
first error's text and the number of landed solves.
"""

import types

import numpy as np
import pytest

from cheeta_mpc_tpu.mpc import loopshaping as jls
from cheeta_mpc_tpu.mpc import runtime as jrt
from cheeta_mpc_tpu.mpc import solver_observer as jso
from cheeta_mpc_tpu_torch.mpc import loopshaping as tls
from cheeta_mpc_tpu_torch.mpc import runtime as trt
from cheeta_mpc_tpu_torch.mpc import solver_observer as tso

PACKAGES = {
    "jax": types.SimpleNamespace(rt=jrt, ls=jls, so=jso),
    "torch": types.SimpleNamespace(rt=trt, ls=tls, so=tso),
}
DT = 0.1
A = np.array([[1.0, DT], [0.0, 1.0]])
B = np.array([[0.0], [DT]])


def _toy_policy(pkg, t0, x0, N=10, dt=DT):
    """Discrete double integrator under a stabilizing hand-rolled policy."""
    Ad = np.array([[1.0, dt], [0.0, 1.0]])
    Bd = np.array([[0.0], [dt]])
    K = np.array([[-0.8, -1.2]])
    xs, us = [np.asarray(x0, float)], []
    for _ in range(N):
        u = K @ xs[-1]
        us.append(u)
        xs.append(Ad @ xs[-1] + Bd @ u)
    return pkg.rt.PolicyData(times=t0 + dt * np.arange(N + 1),
                             x_traj=np.stack(xs), u_traj=np.stack(us),
                             K=np.tile(K[None], (N, 1, 1)))


def _policy_with_value(pkg, N=8, nx=3, nu=2, dt=0.1):
    rng = np.random.default_rng(5)
    return pkg.rt.PolicyData(
        times=dt * np.arange(N + 1), x_traj=rng.standard_normal((N + 1, nx)),
        u_traj=rng.standard_normal((N, nu)),
        K=rng.standard_normal((N, nu, nx)),
        P=np.stack([np.eye(nx) * (1.0 + k) for k in range(N + 1)]),
        p=rng.standard_normal((N + 1, nx)), lam_l=rng.random((N + 1, 4)),
        lam_u=rng.random((N + 1, 4)))


def double_buffer_swap(pkg):
    mrt = pkg.rt.MrtBase()
    seen = [mrt.initial_policy_received]
    p1 = _toy_policy(pkg, 0.0, [1.0, 0.0])
    mrt.move_to_buffer(p1)
    seen += [mrt.initial_policy_received, mrt.update_policy(),
             mrt.active_policy is p1, mrt.update_policy()]
    p2 = _toy_policy(pkg, 0.5, [0.5, 0.0])
    mrt.move_to_buffer(p2)
    seen += [mrt.update_policy(), mrt.active_policy is p2,
             mrt.trylock_failures]
    return seen


def policy_evaluation(pkg):
    p = _toy_policy(pkg, 0.0, [1.0, 0.0])
    x = p.x_traj[0] + np.array([0.1, 0.0])
    return [p.evaluate(t) for t in (0.0, 0.05, 0.31, 2.0)] + [
        p.evaluate(t, x) for t in (0.0, 0.17)] + [
        p.interp_state(t) for t in (-1.0, 0.25, 0.7, 5.0)]


def observer_fanout(pkg):
    mrt = pkg.rt.MrtBase()
    seen = []
    mrt.observers.append(seen.append)
    p = _toy_policy(pkg, 0.0, [1.0, 0.0])
    mrt.move_to_buffer(p)
    return [len(seen), seen[0] is p]


def lockstep_dummy_loop(pkg):
    def solve_fn(obs):
        return _toy_policy(pkg, obs.time, obs.state)

    out = []
    for ratio, feedback in ((5, True), (4, False)):
        res = pkg.rt.run_dummy_loop(
            pkg.rt.MpcMrtInterface(solve_fn), lambda t, x, u: A @ x + B @ u,
            x0=[1.0, 0.0], mrt_dt=DT, mpc_update_ratio=ratio, n_steps=60,
            use_feedback=feedback)
        out += [res.times, res.states, res.inputs, res.solves,
                res.solve_errors, res.first_error]
    return out


def realtime_loop(pkg):
    calls = {"n": 0}

    def failing(obs):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("synthetic NAN_SOL")
        return _toy_policy(pkg, obs.time, obs.state, dt=0.05)

    # Paced at 100x real time (a 0.5 ms sleep per tick), so that the
    # failing worker surely runs while the loop ticks.
    bad = pkg.rt.run_realtime_dummy_loop(
        pkg.rt.MpcMrtInterface(failing), lambda t, x, u: A @ x + B @ u,
        x0=[1.0, 0.0], mrt_dt=0.05, n_steps=20, realtime_factor=100.0)
    good = pkg.rt.run_realtime_dummy_loop(
        pkg.rt.MpcMrtInterface(
            lambda obs: _toy_policy(pkg, obs.time, obs.state, dt=0.05)),
        lambda t, x, u: A @ x + B @ u, x0=[1.0, 0.0], mrt_dt=0.05,
        n_steps=40)
    return [bad.solve_errors > 0, bad.first_error, bad.solves,
            bad.states.shape, good.solve_errors, good.first_error,
            good.solves >= 1, bool(np.isfinite(good.inputs).all()),
            good.states.shape]


def value_function_queries(pkg):
    pol = _policy_with_value(pkg)
    d = np.array([0.1, -0.2, 0.05])
    tm = 0.5 * (pol.times[3] + pol.times[4])
    xm = 0.5 * (pol.x_traj[3] + pol.x_traj[4])
    duals = pol.dual_at(0.25)
    return [pol.value_at(float(pol.times[3]), pol.x_traj[3]),
            pol.value_at(float(pol.times[3]), pol.x_traj[3] + d),
            pol.value_at(tm, xm + d), pol.value_at(7.0, xm),
            pol.feedback_gain_at(0.25), pol.feedback_gain_at(-3.0),
            duals["lam_l"], duals["lam_u"]]


def missing_queries_raise(pkg):
    pol = _toy_policy(pkg, 0.0, [1.0, 0.0])
    out = []
    for query in (lambda: pol.value_at(0.0, pol.x_traj[0]),
                  lambda: pol.dual_at(0.0),
                  lambda: pkg.rt.MrtBase().evaluate_policy(0.0)):
        with pytest.raises(RuntimeError) as err:
            query()
        out.append(str(err.value))
    return out


def interface_and_window(pkg):
    itf = pkg.rt.MpcMrtInterface(lambda obs: _policy_with_value(pkg),
                                 pkg.rt.MpcSettings(solution_time_window=0.35))
    with pytest.raises(RuntimeError):
        itf.advance_mpc()
    x0 = _policy_with_value(pkg).x_traj[0]
    itf.set_current_observation(pkg.rt.SystemObservation(time=0.0,
                                                         state=x0))
    itf.advance_mpc()
    ok = itf.update_policy()
    act = itf.active_policy
    d = itf.get_intermediate_dual_solution(0.15)
    return [ok, act.times, act.x_traj, act.u_traj, act.K, act.P, act.p,
            act.lam_l, act.lam_u, act.init_observation.time,
            itf.get_linear_feedback_gain(0.15),
            itf.get_value_function(0.0, act.x_traj[0]),
            itf.get_value_function(0.12, act.x_traj[1] + 0.3),
            d["lam_l"], d["lam_u"], itf.solve_count,
            vars(pkg.rt.MpcSettings())]


def windowed_and_warm_start(pkg):
    pol = _policy_with_value(pkg)
    out = []
    for window in (-1.0, 0.0, 0.35, 0.8, 5.0):
        w = pol.windowed(window)
        out += [w is pol, w.times, w.u_traj, w.K, w.P, w.lam_u]
    for grid in (0.05 + 0.1 * np.arange(9), np.linspace(0.0, 1.2, 7),
                 np.array([0.0, 0.013, 0.2, 0.21, 0.5])):
        out += list(pkg.rt.shift_warm_start(pol, grid))
    return out


def mrt_observer_hooks_and_rollout(pkg):
    calls = []

    class Obs(pkg.rt.MrtObserver):
        def modify_buffered_solution(self, policy):
            calls.append("buffered")
            policy.performance = {"tag": 1}

        def modify_active_solution(self, policy):
            calls.append("active")

    mrt = pkg.rt.MrtBase()
    mrt.mrt_observers.append(Obs())
    pkg.rt.MrtObserver().modify_buffered_solution(None)  # default: no-op
    pol = _policy_with_value(pkg)
    mrt.move_to_buffer(pol)
    ok = mrt.update_policy()

    def plant(t, x, u):
        return x + 0.1 * np.concatenate([u, [0.0]])

    times, states, inputs = mrt.rollout_policy(0.0, pol.x_traj[0], 0.1, 5,
                                               plant)
    return [calls, pol.performance, ok, times, states, inputs,
            mrt.evaluate_policy(0.33, pol.x_traj[2])]


def loopshaping(pkg):
    rng = np.random.default_rng(0)
    nx, nf = 3, 2
    C, D = rng.standard_normal((2, nf)), rng.standard_normal((2, 2))
    ident = pkg.ls.LoopshapingDefinition(nx_sys=4)
    filt = pkg.ls.LoopshapingDefinition(nx_sys=nx, nf=nf, C_f=C, D_f=D)
    x_aug, u_aug = rng.standard_normal(nx + nf), rng.standard_normal(2)
    out = []
    for defn, state, inp in ((ident, np.arange(4.0), np.array([2.0, 3.0])),
                             (filt, x_aug, u_aug), (filt, x_aug, None)):
        obs = pkg.rt.SystemObservation(time=0.2, state=state, input=inp,
                                       mode=9)
        o = pkg.ls.loopshaping_to_system_observation(defn, obs)
        out += [o.time, o.mode, o.state, o.input]
    seen = []

    class Sink:
        def update(self, obs, *args, **kwargs):
            seen.append((obs.state, obs.input, args, kwargs))

    w = pkg.ls.LoopshapingObserver(
        pkg.ls.LoopshapingDefinition(nx_sys=2, nf=1, C_f=np.zeros((1, 1)),
                                     D_f=np.eye(1)), [Sink(), Sink()])
    w.update(pkg.rt.SystemObservation(time=0.0, state=np.array([1., 2., 9.]),
                                      input=np.array([4.0])), 7, tag="x")
    return out + [seen]


def multiplier_observer(pkg):
    N, ng = 5, 3
    times = 0.1 * np.arange(N + 1)
    lam_l = np.arange((N + 1) * ng, dtype=np.float64).reshape(N + 1, ng)
    pol = pkg.rt.PolicyData(times=times, x_traj=np.zeros((N + 1, 2)),
                            u_traj=np.zeros((N, 1)), lam_l=lam_l,
                            lam_u=np.sin(lam_l))
    out = []
    for offsets, interp in (((0.0, 0.25), "nearest"),
                            ((0.25, 0.07, 3.0), "linear")):
        obs = pkg.so.ConstraintMultiplierObserver(time_offsets=offsets,
                                                  interpolation=interp)
        obs(pol)
        obs(pkg.rt.PolicyData(times=times, x_traj=np.zeros((N + 1, 2)),
                              u_traj=np.zeros((N, 1))))  # no duals: skipped
        out += [len(obs.samples)] + [vars(s) for s in obs.samples]
    mrt = pkg.rt.MrtBase()
    hooked = pkg.so.ConstraintMultiplierObserver()
    mrt.observers.append(hooked)
    mrt.move_to_buffer(pol)
    return out + [vars(hooked.samples[0])]


SCENARIOS = (double_buffer_swap, policy_evaluation, observer_fanout,
             lockstep_dummy_loop, realtime_loop, value_function_queries,
             missing_queries_raise, interface_and_window,
             windowed_and_warm_start, mrt_observer_hooks_and_rollout,
             loopshaping, multiplier_observer)


def _assert_same(a, b, path="result"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_scenario_matches_jax_bit_for_bit(scenario):
    _assert_same(scenario(PACKAGES["torch"]), scenario(PACKAGES["jax"]))

