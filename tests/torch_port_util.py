"""JAX-side half of the exchange between the JAX package and its PyTorch
port (the port-side half is ``cheeta_mpc_tpu_torch/convert.py``): pytrees of
the JAX package -> nested dicts of numpy arrays, and comparison helpers;
and the stand-in ``.info`` files that the port's tests and ``chip_smoke.py``
write. Only tests may import both packages, so this lives with the tests;
it imports JAX only inside the functions that need it.
"""

import dataclasses
import pathlib

import numpy as np
import torch

from cheeta_mpc_tpu_torch.convert import (qp_data_from_numpy,
                                          solution_to_numpy)
from cheeta_mpc_tpu_torch.core.types import (CostApprox, DynamicsLin,
                                             OcpQpData, PerformanceIndex,
                                             StageEquality)


# Stand-in task.info and gait.info: the reference's own files are not in the
# repository, so tests (and chip_smoke.py, which loads this file by path)
# write files of their shape with stand-in numbers: every section the
# loaders read, comments of both kinds, a matrix with ``scaling``, braces on
# their own lines and on the key's line. The Q/R diagonals are the port's
# ``LEGGED_TEST_WEIGHTS``.

def _diag_block(values, scaling=None):
    lines = [] if scaling is None else [f"  scaling {scaling}"]
    lines += [f"  ({i},{i})  {v}   ; entry {i}" for i, v in enumerate(values)]
    return "\n".join(lines)


Q_DIAG = [15.0, 15.0, 30.0, 5.0, 10.0, 10.0, 500.0, 500.0, 500.0, 100.0,
          200.0, 200.0] + [20.0] * 12
R_DIAG = [1.0] * 12 + [20.0] * 12

TASK_INFO = f"""; stand-in task.info (same sections as the reference's)
centroidalModelType             1      // SRBD

multiple_shooting
{{
  nThreads                      3
  dt                            0.015
  sqpIteration                  1
  integratorType                RK2
  deltaTol                      1e-4
}}

mpc
{{
  timeHorizon                   1.0  ; [s]
  solutionTimeWindow            -1
  coldStart                     false
  debugPrint                    true
  mpcDesiredFrequency           50   ; [Hz]
  mrtDesiredFrequency           400  ; [Hz]
}}

initialState
{{
  (0,0)  0.0
  (8,0)  0.575
  (23,0) -0.8
}}

Q
{{
{_diag_block(Q_DIAG)}
}}

R {{
{_diag_block([v / 2.0 for v in R_DIAG], scaling=2.0)}
  (0,3) 0.25
}}

frictionConeSoftConstraint
{{
  frictionCoefficient    0.7
  mu                     0.2
  delta                  4.0
}}

model_settings
{{
  positionErrorGain      15.0
  verboseCppAd           true
}}

ddp
{{
  algorithm                       SLQ
  maxNumIterations                1
  minRelCost                      0.1
  constraintPenaltyInitialValue   20.0
  lineSearch
  {{
    minStepLength                 1e-2
    maxStepLength                 1.0
    hessianCorrectionMultiple     1e-5
  }}
}}
"""

GAIT_INFO = """list
{
  [0] stance
  [1] trot
  [2] standing_trot
}
stance
{
  modeSequence
  {
    [0] STANCE
  }
  switchingTimes
  {
    [0] 0.0
    [1] 0.5
  }
}
trot
{
  modeSequence
  {
    [0]  LF_RH
    [1]  RF_LH
  }
  switchingTimes
  {
    [0]  0.0
    [1]  0.35
    [2]  0.70
  }
}
standing_trot
{
  modeSequence { [0] LF_RH  [1] STANCE  [2] RF_LH  [3] STANCE }
  switchingTimes { [0] 0.00 [1] 0.25 [2] 0.3 [3] 0.55 [4] 0.6 }
}
"""


def write_info_files(directory) -> tuple:
    """Write the stand-in ``task.info`` and ``gait.info`` into
    ``directory``; returns their paths as strings."""
    d = pathlib.Path(directory)
    task, gait = d / "task.info", d / "gait.info"
    task.write_text(TASK_INFO)
    gait.write_text(GAIT_INFO)
    return str(task), str(gait)


def qp_data_to_numpy(data) -> dict:
    """A JAX ``OcpQpData`` -> the dict ``convert.qp_data_from_numpy`` takes."""
    d = {k: np.asarray(v) for k, v in (
        ("A", data.dyn.A), ("B", data.dyn.B), ("b", data.dyn.b),
        ("Q", data.cost.Q), ("q", data.cost.q), ("R", data.cost.R),
        ("r", data.cost.r), ("S", data.cost.S), ("dx0", data.dx0))}
    if data.con is not None:
        d.update({k: np.asarray(getattr(data.con, k))
                  for k in ("C", "D", "lg", "ug", "mask")})
    if data.eq is not None:
        d["eq"] = {k: np.asarray(getattr(data.eq, k))
                   for k in ("C", "D", "e", "mask")}
    return d


def qp_data_to_torch(data, dtype=None):
    """A JAX ``OcpQpData`` -> the port's, on the CPU."""
    return qp_data_from_numpy(qp_data_to_numpy(data), dtype=dtype,
                              device="cpu")


def tree_to_numpy(tree):
    """Any pytree of the JAX package (flax dataclass, NamedTuple, array) ->
    nested dicts of numpy arrays."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return {f.name: tree_to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if hasattr(tree, "_asdict"):
        return {k: tree_to_numpy(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_err(a, b) -> float:
    a, b = np.broadcast_arrays(to_np(a), to_np(b))
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def assert_close(port, ref, atol, rtol=0.0, what=""):
    """Port tensor vs JAX array, shapes included (after broadcasting the
    port's batch-shared leaves)."""
    p, r = to_np(port), np.asarray(ref)
    assert np.broadcast_shapes(p.shape, r.shape) == r.shape, (
        what, p.shape, r.shape)
    np.testing.assert_allclose(np.broadcast_to(p, r.shape), r, atol=atol,
                               rtol=rtol, err_msg=what)


def assert_qp_data_close(port_data, jax_data, atol, what=""):
    """Every leaf of two OCP-QPs."""
    p = solution_to_numpy(port_data)
    j = tree_to_numpy(jax_data)

    def walk(a, b, path):
        if b is None:
            assert a is None, path
            return
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
            return
        assert_close(a, b, atol=atol, what=f"{what}{path}")

    walk(p, j, "")


def jax_centroidal_solve(cfg, scp, inputs, warm=None, batched=False):
    """Run the JAX package's centroidal solver and also hand out what its
    public result hides: the ``ScpResult`` (line-search steps and types) and
    the OCP-QP of the first SQP iteration. Done by wrapping the solver's
    reference to ``solve_nonlinear_ocp`` for the duration of the call; with
    ``batched`` the solve runs under ``jax.vmap`` over the leading axis of
    ``inputs`` (and of ``warm``).

    Returns ``(solution, step_size, step_type, first_qp)`` as JAX pytrees.
    """
    import jax
    import jax.numpy as jnp
    from cheeta_mpc_tpu.mpc import centroidal_mpc as jm

    real = jm.solve_nonlinear_ocp

    def run(state, des_state, des_inputs, *warm_args):
        seen = {}

        def spy(linearize, performance, x_init, u_init, settings):
            seen["qp"] = linearize(x_init, u_init)
            seen["res"] = real(linearize=linearize, performance=performance,
                               x_init=x_init, u_init=u_init,
                               settings=settings)
            return seen["res"]

        jm.solve_nonlinear_ocp = spy
        try:
            sol = jm.build_centroidal_solver(cfg, scp)(
                state, des_state, des_inputs, warm=warm_args or None)
        finally:
            jm.solve_nonlinear_ocp = real
        info = seen["res"].step_info
        return sol, info.step_size, info.step_type, seen["qp"]

    args = tuple(jnp.asarray(a, cfg.dtype) for a in inputs)
    if warm is not None:
        args += tuple(jnp.asarray(a, cfg.dtype) for a in warm)
    return (jax.vmap(run) if batched else run)(*args)


def legged_configs(horizon, cone_mode, dtype="float64", integrator="rk2",
                   **scp_kw):
    """The JAX legged config and settings, built in code with the port's
    stand-in weights (never from task.info), and the port's made from their
    ``_asdict()`` as ``convert`` documents."""
    import jax.numpy as jnp
    from cheeta_mpc_tpu.models.srbd_legged import SrbdParams as JSrbd
    from cheeta_mpc_tpu.mpc.legged_mpc import LeggedMpcConfig as JCfg
    from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
    from cheeta_mpc_tpu.solvers.scp import ScpSettings as JScp
    from cheeta_mpc_tpu_torch.convert import (legged_config_from_dict,
                                              scp_settings_from_dict)
    from cheeta_mpc_tpu_torch.examples import LEGGED_TEST_WEIGHTS

    jcfg = JCfg(params=JSrbd(integrator=integrator), horizon=horizon,
                cone_mode=cone_mode, dtype=jnp.dtype(dtype),
                **LEGGED_TEST_WEIGHTS)
    d = jcfg._asdict()
    d["dtype"] = dtype
    ipm_kw = scp_kw.pop("ipm", dict(iters=10))
    jscp = JScp(ipm=JIpm(**ipm_kw), **scp_kw)
    sd = jscp._asdict()
    sd["ipm"] = jscp.ipm._asdict()
    return jcfg, jscp, legged_config_from_dict(d), scp_settings_from_dict(sd)


def jax_legged_solve(cfg, scp, inputs, warm=None, dts=None, batched=False):
    """Run the JAX package's legged solver (jitted) and also hand out what
    its public result hides, as :func:`jax_centroidal_solve` does: the line
    search's steps and the OCP-QP of the first SQP iteration. ``inputs`` are
    the five positional arrays; with ``batched`` the solve runs under
    ``jax.vmap`` over their leading axis (and that of ``warm``/``dts``).

    Returns ``(solution, step_size, step_type, first_qp)`` as JAX pytrees.
    """
    import jax
    import jax.numpy as jnp
    from cheeta_mpc_tpu.mpc import legged_mpc as jl

    real = jl.solve_nonlinear_ocp
    n_warm = 0 if warm is None else 2

    def run(*args):
        seen = {}

        def spy(linearize, performance, x_init, u_init, settings):
            seen["qp"] = linearize(x_init, u_init)
            seen["res"] = real(linearize, performance, x_init, u_init,
                               settings)
            return seen["res"]

        main, rest = args[:5], args[5:]
        w = tuple(rest[:n_warm]) or None
        d = rest[n_warm] if dts is not None else None
        jl.solve_nonlinear_ocp = spy
        try:
            sol = jl.build_legged_solver(cfg, scp)(*main, warm=w, dts=d)
        finally:
            jl.solve_nonlinear_ocp = real
        info = seen["res"].step_info
        return sol, info.step_size, info.step_type, seen["qp"]

    args = tuple(jnp.asarray(a, cfg.dtype) for a in inputs)
    if warm is not None:
        args += tuple(jnp.asarray(a, cfg.dtype) for a in warm)
    if dts is not None:
        args += (jnp.asarray(dts, cfg.dtype),)
    return jax.jit(jax.vmap(run) if batched else run)(*args)


def launch_loop(pkg, task_info, gait_info, *, horizon, seconds,
                cone="soft", solver="sqp", switch=None, f64=False,
                handshake_repeats=0, replan=True) -> dict:
    """The deployed loop of ``cli/launch.py`` (its ``--role mpc`` and
    ``--role dummy`` processes at their defaults: trot at 0.25 m/s, two
    plant steps per solve) in one process on package ``pkg``
    (``"cheeta_mpc_tpu"`` or ``"cheeta_mpc_tpu_torch"``, on the CPU), in
    lock-step: every message crosses that package's wire codec, a gait
    command ``switch`` = (name, t) reaches the planner before the
    observation it precedes, and each tick applies the policy of its own
    observation.

    ``handshake_repeats``: how many more times the planner answered the
    initial observation (the handshake re-publishes it while the first
    solve runs). Those policies warm-start the next solve and are not
    applied, as in the launcher. ``replan=False`` applies the first policy
    throughout: a planner that stopped answering.

    Returns a dict of ``times``, ``states``, ``inputs`` (as the launcher's
    ``_traj.npz``), ``switched_at`` and the planner's ``gaits_applied``.
    """
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    if pkg == "cheeta_mpc_tpu":
        import jax.numpy as jnp
        dtype, device = (jnp.float64 if f64 else jnp.float32), {}

        def arr(a):
            return jnp.asarray(a, dtype)
    else:
        dtype = torch.float64 if f64 else torch.float32
        device = {"device": "cpu"}

        def arr(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype)

    node, runtime, wire = (mod("mpc.legged_node"), mod("mpc.runtime"),
                           mod("transport.wire"))
    srbd_step = mod("models.srbd_legged").srbd_step
    cfg = mod("mpc.legged_mpc").LeggedMpcConfig.from_task_info(
        task_info, horizon=horizon, cone_mode=cone, dtype=dtype)
    library = mod("utils.info_config").load_gait_library(gait_info)

    def trot():
        gs = mod("gait.schedule").GaitSchedule.stance(library["trot"], t0=0.0)
        gs.phase_transition_stance_time = 0.1
        gs.insert_template(library["trot"], insert_time=0.2)
        return gs

    x0 = node.default_stance_state(cfg)
    planner = node.LeggedPlannerAssembly(
        cfg, trot(), x0, v_cmd=np.array([0.25, 0.0, 0.0]),
        settings=node.PlannerSettings(solver=solver), **device)
    plant_gait = trot()
    DT = float(cfg.params.dt)
    mrt = runtime.MrtBase()

    def answer(t, x):
        obs = wire.decode_observation(wire.encode_observation(
            runtime.SystemObservation(time=t, state=x, input=None, mode=0)))
        mrt.move_to_buffer(wire.decode_policy(wire.encode_policy(
            planner.solve_fn(obs))))

    answer(0.0, x0)
    mrt.update_policy()
    for _ in range(handshake_repeats):
        answer(0.0, x0)
    t, x, switched_at = 0.0, x0.copy(), None
    times, states, inputs = [t], [x.copy()], []
    for step in range(int(round(seconds / DT))):
        if replan and step > 0 and step % 2 == 0:
            if switch is not None and t >= switch[1]:
                name = switch[0]
                planner.on_gait_command(*wire.decode_gait_command(
                    wire.encode_gait_command(name, library[name])))
                switched_at = t + horizon * DT
                plant_gait.insert_template(library[name],
                                           insert_time=switched_at)
                switch = None
            answer(t, x)
            mrt.update_policy()
        u = mrt.evaluate_policy(t, x)
        e = plant_gait.get_mode_schedule(max(0.0, t - 1.0), t + 1.0)\
            .contact_flags_at(t + 0.5 * DT)
        x = np.asarray(srbd_step(cfg.params, arr(x), arr(u),
                                 arr(np.asarray(e))), np.float64)
        t += DT
        times.append(t)
        states.append(x.copy())
        inputs.append(np.asarray(u, np.float64).copy())
    return {"times": np.asarray(times), "states": np.asarray(states),
            "inputs": np.asarray(inputs), "switched_at": switched_at,
            "gaits_applied": list(planner.receiver.applied)}


# The circular-kinematics OCP of tests/test_circular_kinematics.py (the
# reference's testCircularKinematics.cpp capability): a point in the plane
# with single-integrator kinematics x_{k+1} = x_k + dt u_k, the bilinear
# path equality x.u = 0 (motion tangent to the circle), a quadratic cost
# tracking a target a quarter turn away. Shared by the port's tests and
# chip_smoke.py, which runs it on the card.
CIRCLE_N, CIRCLE_DT = 20, 0.1
CIRCLE_W_X, CIRCLE_W_U = 10.0, 0.1
CIRCLE_X0, CIRCLE_TARGET = (1.0, 0.0), (0.0, 1.0)


def circular_kinematics_problem(dtype, device):
    """``(linearize, performance, x_init, u_init)`` for
    ``solvers.scp.solve_nonlinear_ocp``: the JAX test's ``_linearize``
    (x.u = 0 linearized at the iterate, ``dx0 = x0 - x[0]``) and
    ``_performance`` (rho = 10), on ``device``; ``performance`` takes the
    line search's leading ladder axis."""
    N, dt = CIRCLE_N, CIRCLE_DT
    kw = dict(dtype=dtype, device=device)
    eye = torch.eye(2, **kw)
    target = torch.tensor(CIRCLE_TARGET, **kw)
    x0 = torch.tensor(CIRCLE_X0, **kw)
    eyeN, ones = eye.expand(N, 2, 2), torch.ones((N, 1), **kw)
    Q, S = CIRCLE_W_X * eye.expand(N + 1, 2, 2), torch.zeros((N, 2, 2), **kw)

    def linearize(x, u):
        eq = StageEquality(C=u[:, None, :], D=x[:-1][:, None, :],
                           e=torch.sum(x[:-1] * u, dim=-1, keepdim=True),
                           mask=ones)
        return OcpQpData(
            dyn=DynamicsLin(A=eyeN, B=dt * eyeN, b=x[:-1] + dt * u - x[1:]),
            cost=CostApprox(Q=Q, q=CIRCLE_W_X * (x - target),
                            R=CIRCLE_W_U * eyeN, r=CIRCLE_W_U * u, S=S),
            con=None, dx0=x0 - x[0], eq=eq)

    def performance(x, u):
        cost = (0.5 * CIRCLE_W_X * torch.sum((x - target) ** 2, dim=(-2, -1))
                + 0.5 * CIRCLE_W_U * torch.sum(u * u, dim=(-2, -1)))
        d = x[..., :-1, :] + dt * u - x[..., 1:, :]
        g = torch.sum(x[..., :-1, :] * u, dim=-1)
        l1 = (torch.sum(torch.abs(d), dim=(-2, -1))
              + torch.sum(torch.abs(g), dim=-1))
        return PerformanceIndex(
            merit=cost + 10.0 * l1, cost=cost,
            dyn_violation_sse=torch.sum(d * d, dim=(-2, -1)),
            eq_constraint_sse=torch.sum(g * g, dim=-1),
            ineq_constraint_sse=torch.zeros_like(cost))

    return (linearize, performance, x0.expand(N + 1, 2).clone(),
            torch.zeros((N, 2), **kw))
