"""PyTorch port: mpc/legged_node.py (the legged planning node) against the
JAX package's on the same configuration, gait and plant, driven by each
package's ``run_dummy_loop`` for four MPC ticks.

The configuration is built in code (``LEGGED_TEST_WEIGHTS``, horizon 10,
soft cone), never from task.info.

- Plumbing, f64: each node's solver is wrapped to record what the node
  hands it every tick (x, x_ref, enable, z_pos, z_vel, dts, warm) and to
  answer with one shared solver (the port's f64 CPU solve), so that both
  nodes see the same solutions. What they hand over must agree to 1e-12
  (the gait, swing, grid and warm-start code are numpy copies; the
  tolerance leaves room for the weight-compensating input's float
  arithmetic in two frameworks), and so must the policies they return.
- Policies, f32 on each package's default backends (the JAX scan; the
  port's kernel path, here its plain versions): every tick's contact forces
  within 2e-3 of the force scale, the JAX package's bound for that pair of
  f32 executors.
- The DDP node (``solver='ddp'``), f64 on each package's own solver: the
  same policies and metrics.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.gait import schedule as jsch
from cheeta_mpc_tpu.mpc import legged_node as jnode
from cheeta_mpc_tpu.mpc import runtime as jrt
from cheeta_mpc_tpu_torch.gait import schedule as tsch
from cheeta_mpc_tpu_torch.models.srbd_legged import srbd_step
from cheeta_mpc_tpu_torch.mpc import legged_mpc as tl
from cheeta_mpc_tpu_torch.mpc import legged_node as tnode
from cheeta_mpc_tpu_torch.mpc import runtime as trt
from tests.torch_port_util import legged_configs, max_err

N = 10
V_CMD = np.array([0.25, 0.0, 0.0])
RATIO, STEPS = 2, 8  # four MPC ticks: t = 0, 0.03, 0.06, 0.09
ATOL_PLUMBING = 1e-12
FORCE_BOUND = 2e-3  # of the force scale


def _gait(sch):
    gs = sch.GaitSchedule.stance(sch.trot_template(0.7), t0=0.0)
    gs.phase_transition_stance_time = 0.0
    gs.insert_template(sch.trot_template(0.7), insert_time=0.05)
    return gs


def _plant(tcfg, gait):
    """plant == model: the port's SRBD step in f64 on the CPU."""
    dt = tcfg.params.dt

    def step(t, x, u):
        e = gait.get_mode_schedule(max(0.0, t - 1.0), t + 1.0)\
            .contact_flags_at(t + 0.5 * dt)
        return srbd_step(tcfg.params, torch.as_tensor(x),
                         torch.as_tensor(u, dtype=torch.float64),
                         torch.as_tensor(np.asarray(e, np.float64))).numpy()

    return step


def _record(node, answer):
    """Wrap ``node._solve``: keep what it is handed (as float64 numpy) and
    its result; ``answer(args, kwargs)`` produces the result."""
    seen = []

    def solve(*args, **kwargs):
        rec = [np.array(a, np.float64) for a in args]
        rec.append(np.array(kwargs["dts"], np.float64))
        rec += [np.array(w, np.float64) for w in kwargs["warm"]]
        sol = answer(args, kwargs)
        seen.append((rec, sol))
        return sol

    node._solve = solve
    return seen


def _drive(rt, node, tcfg, gait, x0):
    return rt.run_dummy_loop(rt.MpcMrtInterface(node.solve_fn),
                             _plant(tcfg, gait), x0=x0,
                             mrt_dt=tcfg.params.dt, mpc_update_ratio=RATIO,
                             n_steps=STEPS)


@functools.lru_cache(maxsize=None)
def _plumbing_run():
    jcfg, jscp, tcfg, tscp = legged_configs(N, "soft", iterations=2)
    shared = tl.build_legged_solver(tcfg, tscp, device="cpu")

    def answer(args, kwargs):
        warm = tuple(np.array(w, np.float64) for w in kwargs["warm"])
        return shared(*(np.array(a, np.float64) for a in args), warm=warm,
                      dts=np.array(kwargs["dts"], np.float64))

    x0 = tnode.default_stance_state(tcfg)
    out = {}
    for name, mod, rt, sch, cfg in (("jax", jnode, jrt, jsch, jcfg),
                                    ("torch", tnode, trt, tsch, tcfg)):
        gait = _gait(sch)
        kw = {} if name == "jax" else {"device": "cpu"}
        node = mod.LeggedPlannerAssembly(cfg, gait, x0, v_cmd=V_CMD, **kw)
        seen = _record(node, answer)
        res = _drive(rt, node, tcfg, gait, x0)
        out[name] = (seen, res, node)
    return out


def test_default_stance_state_matches_jax():
    jcfg, _, tcfg, _ = legged_configs(N, "soft")
    assert np.allclose(tnode.default_stance_state(tcfg),
                       jnode.default_stance_state(jcfg), rtol=0, atol=1e-15)


def test_node_hands_the_solver_what_the_jax_node_does():
    run = _plumbing_run()
    seen_t, seen_j = run["torch"][0], run["jax"][0]
    assert len(seen_t) == len(seen_j) == 1 + (STEPS - 1) // RATIO
    names = ("x", "x_ref", "enable", "z_pos", "z_vel", "dts", "warm_x",
             "warm_u")
    for tick, ((rt_, _), (rj, _)) in enumerate(zip(seen_t, seen_j)):
        for name, a, b in zip(names, rt_, rj):
            assert a.shape == b.shape, (tick, name)
            err = float(np.max(np.abs(a - b)))
            assert err <= ATOL_PLUMBING, (tick, name, err)
    # The swing references and the event-aligned grid are not trivial.
    assert any(r[2].min() == 0.0 for r, _ in seen_t)  # a swing leg
    assert any(np.ptp(r[5]) > 0 for r, _ in seen_t)  # uneven dts


def test_node_returns_the_policies_the_jax_node_does():
    run = _plumbing_run()
    (_, res_t, node_t), (_, res_j, node_j) = run["torch"], run["jax"]
    assert res_t.solves == res_j.solves == 4
    assert np.abs(res_t.states - res_j.states).max() <= ATOL_PLUMBING
    assert np.abs(res_t.inputs - res_j.inputs).max() <= ATOL_PLUMBING
    pt, pj = node_t._prev_policy, node_j._prev_policy
    for name in ("times", "x_traj", "u_traj", "K", "P", "p"):
        a, b = getattr(pt, name), getattr(pj, name)
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        assert np.abs(a - b).max() <= ATOL_PLUMBING, name
    mt, mj = dict(node_t.last_metrics), dict(node_j.last_metrics)
    mt.pop("solve_ms"), mj.pop("solve_ms")
    assert mt == mj
    assert len(node_t.bench.samples_ms) == res_t.solves


def test_f32_policies_match_jax_on_default_backends():
    jcfg, _, tcfg, _ = legged_configs(N, "soft", dtype="float32")
    x0 = tnode.default_stance_state(tcfg)
    forces = {}
    for name, mod, rt, sch, cfg in (("jax", jnode, jrt, jsch, jcfg),
                                    ("torch", tnode, trt, tsch, tcfg)):
        gait = _gait(sch)
        kw = {} if name == "jax" else {"device": "cpu"}
        node = mod.LeggedPlannerAssembly(cfg, gait, x0, v_cmd=V_CMD, **kw)
        real = node._solve
        seen = _record(node, lambda args, kwargs, real=real:
                       real(*args, **kwargs))
        res = _drive(rt, node, tcfg, gait, x0)
        assert res.solves == 4 and np.isfinite(res.states).all()
        forces[name] = [np.asarray(sol.forces, np.float64) for _, sol in seen]
    assert tcfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    scale = max(1.0, max(float(np.abs(f).max()) for f in forces["jax"]))
    for tick, (a, b) in enumerate(zip(forces["torch"], forces["jax"])):
        err = max_err(a, b)
        print(f"tick {tick}: {err} N at scale {scale}")
        assert err <= FORCE_BOUND * scale, (tick, err)


@functools.lru_cache(maxsize=None)
def _ddp_run():
    """Both packages' DDP nodes (five iterations, f64) on their own solvers,
    driven by each package's loop for four MPC ticks with the port's
    plant."""
    jcfg, _, tcfg, _ = legged_configs(N, "soft")
    x0 = tnode.default_stance_state(tcfg)
    out = {}
    for name, mod, rt, sch, cfg in (("jax", jnode, jrt, jsch, jcfg),
                                    ("torch", tnode, trt, tsch, tcfg)):
        gait = _gait(sch)
        kw = {} if name == "jax" else {"device": "cpu"}
        node = mod.LeggedPlannerAssembly(
            cfg, gait, x0, v_cmd=V_CMD,
            settings=mod.PlannerSettings(solver="ddp"), **kw)
        out[name] = (_drive(rt, node, tcfg, gait, x0), node)
    return out


def test_ddp_node_returns_the_policies_the_jax_node_does():
    """solver='ddp' (the LeggedRobotDdpMpcNode role): the same policies,
    value function included, and the same metrics as the JAX node. Both
    run the same arithmetic in f64 (tests/test_torch_legged_ddp.py holds
    the solvers to 1e-7 of scale); the closed loop feeds their states
    back, so the bound is 1e-7 of each field's scale here too."""
    run = _ddp_run()
    (res_t, node_t), (res_j, node_j) = run["torch"], run["jax"]
    assert res_t.solves == res_j.solves == 4
    for name in ("states", "inputs"):
        a, b = getattr(res_t, name), getattr(res_j, name)
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-7 * scale, name
    pt, pj = node_t._prev_policy, node_j._prev_policy
    for name in ("times", "x_traj", "u_traj", "K", "P", "p"):
        a, b = getattr(pt, name), getattr(pj, name)
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        scale = max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        print(f"{name}: {err} at scale {scale}")
        assert err <= 1e-7 * scale, (name, err)
    mt, mj = dict(node_t.last_metrics), dict(node_j.last_metrics)
    mt.pop("solve_ms"), mj.pop("solve_ms")
    assert mt.keys() == mj.keys() == {"t", "cost", "converged"}
    assert mt["t"] == mj["t"] and mt["converged"] == mj["converged"]
    assert abs(mt["cost"] - mj["cost"]) <= 1e-7 * max(1.0, abs(mj["cost"]))


def test_unknown_solver_raises():
    _, _, tcfg, _ = legged_configs(N, "soft")
    with pytest.raises(ValueError, match="unknown solver"):
        tnode.LeggedPlannerAssembly(
            tcfg, _gait(tsch), tnode.default_stance_state(tcfg), V_CMD,
            settings=tnode.PlannerSettings(solver="ilqr"), device="cpu")


def test_gait_and_velocity_commands_reach_the_next_solve():
    """Commands from another thread land between solves: the velocity at
    the next solve's reference, the gait at the next solve's final time."""
    _, _, tcfg, tscp = legged_configs(N, "soft")
    gait = _gait(tsch)
    x0 = tnode.default_stance_state(tcfg)
    node = tnode.LeggedPlannerAssembly(tcfg, gait, x0, V_CMD, device="cpu")
    seen = _record(node, lambda args, kwargs: tl.build_legged_solver(
        tcfg, tscp, device="cpu")(*args, **kwargs))
    obs = trt.SystemObservation(time=0.0, state=x0)
    node.solve_fn(obs)
    node.set_velocity_command([0.0, 0.1, 0.2, 99.0])
    node.on_gait_command("stance", tsch.stance_template(0.5))
    node.solve_fn(trt.SystemObservation(time=0.03, state=x0))
    x_ref = seen[-1][0][1]
    assert np.allclose(x_ref[:, 0:3], [0.0, 0.1, 0.2])
    assert node.receiver.applied == [("stance", 0.03 + N * tcfg.params.dt)]
