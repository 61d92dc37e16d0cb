"""Gauss-Newton DDP / SLQ solver, torch.

Counterpart of ``cheeta_mpc_tpu/solvers/ddp.py`` — the reference's
alternative solver path (``GaussNewtonDDP_MPC`` with ``ddp.algorithm SLQ``,
used by ``LeggedRobotDdpMpcNode.cpp:32`` via the external ``ocs2_ddp``):
iterate {linearize along the nominal trajectory -> Riccati backward pass ->
nonlinear closed-loop forward rollout with feedback}. Constraints enter
through penalties — the reference's DDP mode uses relaxed-barrier penalties
for the friction cone (task.info:215-222, mu 0.1 / delta 5.0), provided here
as :func:`relaxed_barrier`.

The same arithmetic as the JAX package's, in PyTorch's idiom:

- The Jacobians of the step and the gradient and Hessian of the stage cost
  come from ``torch.func`` (``jacfwd``, ``jacfwd`` over ``grad``) under
  ``torch.func.vmap`` over the stages, where the JAX package vmaps
  ``jax.jacfwd`` / ``jax.grad`` / ``jax.hessian``.
- The iteration ``lax.scan`` is a Python loop over ``settings.iterations``;
  the rollouts are Python loops over the stages.
- The line search is a ladder of closed-loop rollouts, one per step size,
  run at once on a leading axis; ``argmin`` and ``where`` pick the result
  on the device.

A solve makes no host copy and waits for nothing, so it can be captured as
one CUDA graph (``utils/cuda_graph.graphed``). The JAX package computes DDP
with no Pallas kernel, so this module has none either. Each iteration's
stages (``ddp.linearize``, ``ddp.hessian``, ``ddp.riccati``,
``ddp.line_search``) are ``utils/timing.stage`` marks: a graphed solve's
replays time them on the device (``chip_smoke.py``, phase ``legged_ddp``),
and an eager solve under a profiler shows them as ranges.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from cheeta_mpc_tpu_torch.core.types import DynamicsLin
from cheeta_mpc_tpu_torch.ops.linalg_small import sym_inverse
from cheeta_mpc_tpu_torch.ops.riccati import (bmv, riccati_factorize,
                                              riccati_vector)
from cheeta_mpc_tpu_torch.solvers.scp import matmul_precision
from cheeta_mpc_tpu_torch.utils.timing import stage


class DdpSettings(NamedTuple):
    iterations: int = 5  # reference ddp maxNumIterations (1 in task.info)
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)
    reg: float = 1e-6  # Levenberg-style G regularization
    # Convergence classification threshold (reference ddp.minRelCost: stop
    # when the cost improvement of an iteration falls below it; here the
    # fixed-iteration solver *classifies* the final iteration instead).
    min_rel_cost: float = 1e-1
    # Quadratic-penalty weight for the equality families in penalty-mode
    # problems (reference ddp.constraintPenaltyInitialValue; the reference
    # grows it by constraintPenaltyIncreaseRate across AL iterations — the
    # fixed-iteration solver uses the flat initial value).
    constraint_penalty: float = 20.0
    algorithm: str = "SLQ"  # reference ddp.algorithm (SLQ == Gauss-Newton)

    @classmethod
    def from_task_info(cls, path: str, **overrides) -> "DdpSettings":
        """Ingest the ``ddp`` block of a reference task.info
        (ocs2_legged_robot/config/mpc/task.info:50-99): maxNumIterations,
        minRelCost, the lineSearch min/max step lengths (expanded into the
        parallel alpha ladder with the solver's 0.5 decay),
        hessianCorrectionMultiple as the G regularization, and
        constraintPenaltyInitialValue."""
        from cheeta_mpc_tpu_torch.utils.info_config import load_info
        info = load_info(path)
        ddp = info.get("ddp", {})
        ls = ddp.get("lineSearch", {})
        a_max = float(ls.get("maxStepLength", 1.0))
        a_min = float(ls.get("minStepLength", 1e-2))
        alphas = []
        a = a_max
        while a >= a_min and len(alphas) < 8:
            alphas.append(a)
            a *= 0.5
        kw = dict(
            iterations=int(ddp.get("maxNumIterations", 5)),
            alphas=tuple(alphas) or (1.0,),
            reg=float(ls.get("hessianCorrectionMultiple", 1e-6)),
            min_rel_cost=float(ddp.get("minRelCost", 1e-1)),
            constraint_penalty=float(
                ddp.get("constraintPenaltyInitialValue", 20.0)),
            algorithm=str(ddp.get("algorithm", "SLQ")),
        )
        kw.update(overrides)
        return cls(**kw)


class DdpResult(NamedTuple):
    x: torch.Tensor  # (N+1, nx)
    u: torch.Tensor  # (N, nu)
    K: torch.Tensor  # (N, nu, nx) feedback gains of the last backward pass
    cost: torch.Tensor
    # Value-function quadratic model of the last backward pass — the DDP
    # analogue of the SQP path's Riccati cost-to-go surface (reference
    # extracts the same {P, p} from HPIPM, HpipmInterface.cpp:400-455;
    # ocs2_ddp exposes it as getValueFunction).
    P: torch.Tensor  # (N+1, nx, nx)
    p: torch.Tensor  # (N+1, nx)
    converged: torch.Tensor  # bool: final improvement < min_rel_cost


def relaxed_barrier(h, mu: float, delta: float):
    """The reference's RelaxedBarrierPenalty: -mu ln(h) for h > delta,
    quadratic extension below (ocs2_core penalty used for the DDP friction
    cone; parameters task.info:220-222)."""
    quad = mu * (0.5 * ((h - 2.0 * delta) / delta) ** 2 - 0.5
                 - math.log(delta))
    return torch.where(h > delta, -mu * torch.log(torch.clamp(h, min=1e-30)),
                       quad)


def solve_ddp(step: Callable, stage_cost: Callable, terminal_cost: Callable,
              x0: torch.Tensor, u_init: torch.Tensor,
              settings: DdpSettings = DdpSettings()) -> DdpResult:
    """Gauss-Newton DDP over a generic discrete system.

    Args:
        step(k, x, u) -> x_next                (nonlinear dynamics)
        stage_cost(k, x, u) -> scalar          (includes penalties)
        terminal_cost(x) -> scalar
        x0: (nx,), u_init: (N, nu) warm start, on one device and dtype.

    ``step`` and ``stage_cost`` are written for one sample: ``x`` (nx,),
    ``u`` (nu,), and ``k`` the stage, a Python int or (under ``vmap`` over
    the stages) a 0-d integer tensor; both must be ``torch.func``
    transformable.
    """
    # f32 matmul precision: full f32 for the solve, as the JAX package
    # requests 'highest' (TF32 would compound over the Riccati recursion).
    with matmul_precision("highest"):
        return _solve_ddp(step, stage_cost, terminal_cost, x0, u_init,
                          settings)


def _solve_ddp(step, stage_cost, terminal_cost, x0, u_init,
               settings: DdpSettings) -> DdpResult:
    N, nu = u_init.shape
    nx = x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device)
    vmap = torch.func.vmap
    ks = torch.arange(N, device=x0.device)
    # The ladder, filled on the device entry by entry: a tensor made from
    # the Python tuple would be a copy from the host (see solvers/scp.py).
    n_alpha = len(settings.alphas)
    alphas = torch.empty(n_alpha, **kw)
    for i, a in enumerate(settings.alphas):
        alphas[i:i + 1].fill_(a)

    def rollout_open(u_traj):
        xs = [x0]
        for k in range(N):
            xs.append(step(k, xs[-1], u_traj[k]))
        return torch.stack(xs)

    def total_cost(x_traj, u_traj):
        cs = vmap(stage_cost)(ks, x_traj[:-1], u_traj)
        return torch.sum(cs) + terminal_cost(x_traj[-1])

    def rollout_closed(x_ref, u_ref, K, kff):
        """Closed-loop rollouts for every step size at once (leading axis):
        u = u_ref + alpha*kff + K (x - x_ref)."""
        a_col = alphas[:, None]
        x = x0.expand(n_alpha, nx)
        xs, us = [], []
        for k in range(N):
            u = u_ref[k] + a_col * kff[k] + bmv(K[k], x - x_ref[k])
            xs.append(x)
            us.append(u)
            x = vmap(lambda xx, uu, k=k: step(k, xx, uu))(x, u)
        xs.append(x)
        return torch.stack(xs, dim=1), torch.stack(us, dim=1)

    def lin(k, x, u):
        return torch.func.jacfwd(lambda xx, uu: step(k, xx, uu),
                                 argnums=(0, 1))(x, u)

    def quad(k, x, u):
        def fn(xu):
            return stage_cost(k, xu[:nx], xu[nx:])

        def grad_twice(xu):
            g = torch.func.grad(fn)(xu)
            return g, g

        H, g = torch.func.jacfwd(grad_twice, has_aux=True)(
            torch.cat([x, u]))
        return (H[:nx, :nx], g[:nx], H[nx:, nx:], g[nx:], H[nx:, :nx])

    def terminal_quad(x):
        def grad_twice(xx):
            g = torch.func.grad(terminal_cost)(xx)
            return g, g

        return torch.func.jacfwd(grad_twice, has_aux=True)(x)

    def iteration(x_traj, u_traj):
        # Linearize dynamics and quadratize cost along the nominal.
        with stage("ddp.linearize"):
            A, B = vmap(lin)(ks, x_traj[:-1], u_traj)
            dyn = DynamicsLin(A=A, B=B, b=torch.zeros((N, nx), **kw))
        with stage("ddp.hessian"):
            Qs, qs, Rs, rs, Ss = vmap(quad)(ks, x_traj[:-1], u_traj)
            QN, qN = terminal_quad(x_traj[-1])
            Q = torch.cat([Qs, QN[None]])
            q = torch.cat([qs, qN[None]])
        with stage("ddp.riccati"):
            # Gauss-Newton: project out potential indefiniteness via G
            # reg. G need not be positive definite here (the JAX
            # package's Schur inverse inverts it regardless): invert it by
            # LU.
            factors = riccati_factorize(dyn, Q, Rs, Ss, reg=settings.reg,
                                        inverse=sym_inverse)
            kff, pvec = riccati_vector(dyn, q, rs, factors)

        # Parallel line-search ladder of closed-loop rollouts.
        with stage("ddp.line_search"):
            xts, uts = rollout_closed(x_traj, u_traj, factors.K, kff)
            costs = vmap(total_cost)(xts, uts)
            base = total_cost(x_traj, u_traj)
            # Picked on the device: indexing with a 0-d tensor would read
            # the index on the host.
            best = torch.argmin(costs, dim=0, keepdim=True)

            def pick(a):
                return torch.index_select(a, 0, best)[0]

            improved = pick(costs) < base
            x_new = torch.where(improved, pick(xts), x_traj)
            u_new = torch.where(improved, pick(uts), u_traj)
            cost_new = torch.where(improved, pick(costs), base)
        return (x_new, u_new, (factors.K, factors.P, pvec),
                cost_new, base - cost_new)

    x, u = rollout_open(u_init), u_init
    gains = (torch.zeros((N, nu, nx), **kw),
             torch.zeros((N + 1, nx, nx), **kw),
             torch.zeros((N + 1, nx), **kw))
    cost = drop = torch.zeros((), **kw)
    for _ in range(settings.iterations):
        x, u, gains, cost, drop = iteration(x, u)
    K, P, pvec = gains
    # Convergence classification (reference ddp.minRelCost exit criterion,
    # applied to the final iteration of the fixed budget).
    converged = drop < settings.min_rel_cost
    return DdpResult(x=x, u=u, K=K, cost=cost, P=P, p=pvec,
                     converged=converged)
