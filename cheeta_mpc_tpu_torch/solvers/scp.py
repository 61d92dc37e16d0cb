"""Sequential convex programming (SQP) over the structured IPM, batched torch.

Counterpart of ``cheeta_mpc_tpu/solvers/scp.py``: per iteration
{linearize all shooting nodes -> solve the OCP-QP -> filter line search}.

- The backtracking filter line search is a **parallel ladder**: the fixed
  geometric step-size ladder is evaluated at once and the largest step that
  passes the three-regime acceptance rule is selected (the ZERO step when
  every candidate is rejected). The regimes, keyed on the candidate's
  constraint violation:
    viol_new > g_max                       -> CONSTRAINT: require violation
                                              decrease by factor (1-gamma_c)
    viol_new < g_min and viol_base < g_min
      and armijo descent metric < 0        -> COST: Armijo condition on merit
    otherwise                              -> DUAL: merit decrease by
                                              gamma_c*viol_base OR violation
                                              decrease
- A fixed iteration count replaces convergence exits; convergence is still
  classified and reported.
- Each iteration's three parts are stages (``utils/timing.stage``):
  ``sqp.linearize``, ``sqp.qp`` and ``sqp.line_search``, timed on the
  device inside a captured CUDA graph and profiler ranges when run eagerly
  under a profiler.
- Trajectories may carry leading batch dimensions. Regime, step size, step
  type and convergence code are chosen per batch element with
  ``torch.where`` / gathers — what ``jax.vmap`` makes of the JAX package's
  scalar code.

The problem is supplied functionally: ``linearize(x, u)`` returns the
stage-stacked LQ data at an iterate, ``performance(x, u)`` a
:class:`PerformanceIndex`; both must accept extra leading dimensions.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from cheeta_mpc_tpu_torch.core.types import OcpQpData, PerformanceIndex
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings, solve_ocp_qp
from cheeta_mpc_tpu_torch.utils.timing import stage

# Step types.
STEP_ZERO = 0
STEP_CONSTRAINT = 1
STEP_DUAL = 2
STEP_COST = 3

# Convergence codes: the solver always runs a fixed iteration count and
# classifies the FINAL step, so STEPSIZE/METRICS/PRIMAL take precedence and
# ITERATIONS is the fallback ("budget exhausted without any other
# convergence signal").
CONV_FALSE = 0
CONV_ITERATIONS = 1
CONV_STEPSIZE = 2
CONV_METRICS = 3
CONV_PRIMAL = 4


class ScpSettings(NamedTuple):
    """Solver knobs (the JAX package's ``ScpSettings``)."""

    iterations: int = 4
    ipm: IpmSettings = IpmSettings()
    # Parallel line-search ladder.
    alphas: tuple = (1.0, 0.5, 0.25, 0.125)
    # QP backend: 'riccati_kernel' — the hand-written CUDA kernels
    # (ops/cuda_ipm_riccati.py for one problem, ops/cuda_ipm_batch.py for a
    # batch; their plain versions on CPU tensors), the counterpart of the
    # JAX package's 'riccati_pallas' and the port's default, so the normal
    # entry points go through the kernels; 'riccati' — the plain torch
    # executor (ops/ocpqp.py), any dtype and device; 'condensed' — states
    # eliminated, a dense IPM in the inputs (ops/condensed.py, plain torch:
    # batched matrix products and Cholesky; HPIPM's condensing mode
    # analogue, kept for cross-checks and as the dense oracle).
    qp_backend: str = 'riccati_kernel'
    # Stage-equality handling: 'riccati' = masked eq-Riccati elimination
    # (handles mode-dependent masks); 'projected' = null-space projection +
    # change of input variables (ops/projection.py, the reference's
    # projectStateInputEqualityConstraints=true mode; every row active, D of
    # full row rank), whose reduced problem goes to the backend above. Both
    # must agree (tests/test_torch_projection.py).
    eq_mode: str = 'riccati'
    # Filter-acceptance thresholds.
    g_max: float = 1e6
    g_min: float = 1e-6
    gamma_c: float = 1e-6
    armijo_factor: float = 1e-4
    # Convergence classification tolerances.
    cost_tol: float = 1e-4
    delta_tol: float = 1e-6
    # f32 matmul precision of the solve, by the names torch and JAX share:
    # 'highest' (full f32), 'high' (TF32), 'medium' (bf16 where the backend
    # has it). Scoped to the solve (see matmul_precision below).
    matmul_precision: str = 'highest'


MATMUL_PRECISIONS = ("highest", "high", "medium")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run the body at one f32 matmul precision and give the caller's back
    on exit, errors included — the counterpart of
    ``jax.default_matmul_precision``. A capture of the body (a CUDA graph)
    records the cuBLAS algorithms picked under this precision. The
    caller's ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.get_float32_matmul_precision()`` are what is saved."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"unknown matmul_precision {precision!r}; expected "
                         f"one of {MATMUL_PRECISIONS}")
    cuda_mm = torch.backends.cuda.matmul
    allow_tf32, saved = (cuda_mm.allow_tf32,
                         torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
        if cuda_mm.allow_tf32 != allow_tf32:
            cuda_mm.allow_tf32 = allow_tf32


class StepInfo(NamedTuple):
    """Per-iteration step record, stacked over SQP iterations on the last
    axis of each (batch-shaped) entry."""

    step_size: torch.Tensor  # (..., iters)
    step_type: torch.Tensor  # (..., iters) int32 STEP_* codes
    dx_norm: torch.Tensor
    du_norm: torch.Tensor
    performance: PerformanceIndex  # components per iteration (..., iters)


class ScpResult(NamedTuple):
    x: torch.Tensor  # (..., N+1, nx) final state trajectory iterate
    u: torch.Tensor  # (..., N, nu)
    merit: torch.Tensor
    qp_mu: torch.Tensor  # last QP complementarity (solver health)
    gains_K: torch.Tensor  # (..., N, nu, nx) Riccati feedback of the last QP
    gains_k: torch.Tensor
    gains_P: torch.Tensor
    gains_p: torch.Tensor
    lam_l: torch.Tensor  # (..., N+1, ng) inequality duals of the last QP
    lam_u: torch.Tensor
    performance: PerformanceIndex  # at the final iterate
    step_info: StepInfo
    convergence: torch.Tensor  # int32 CONV_* classification


def _traj_norm(v: torch.Tensor) -> torch.Tensor:
    """sqrt of the total SSE over a stacked trajectory."""
    return torch.sqrt(torch.sum(v * v, dim=(-2, -1)))


def _total_violation(p: PerformanceIndex) -> torch.Tensor:
    return torch.sqrt(p.dyn_violation_sse + p.eq_constraint_sse)


def _map_perf(fn, *perfs: PerformanceIndex) -> PerformanceIndex:
    return PerformanceIndex(*(fn(*(getattr(p, f) for p in perfs))
                              for f in PerformanceIndex.__dataclass_fields__))


def solve_nonlinear_ocp(
    linearize: Callable[[torch.Tensor, torch.Tensor], OcpQpData],
    performance: Callable[[torch.Tensor, torch.Tensor], PerformanceIndex],
    x_init: torch.Tensor,
    u_init: torch.Tensor,
    settings: ScpSettings = ScpSettings(),
) -> ScpResult:
    """Iterate {linearize -> IPM QP -> filter line search} a fixed number of
    times from the warm-start trajectory ``(x_init, u_init)``.

    ``linearize(x, u)`` returns the full :class:`OcpQpData` in deviation
    coordinates around (x, u); ``performance(x, u)`` the
    :class:`PerformanceIndex` with ``merit`` already combined.
    """
    # f32 matmul precision: TF32 (10-bit mantissa) is on this card what the
    # one-pass-bf16 matmul is on the JAX package's target — over a long
    # Riccati recursion at barrier conditioning ~1/mu it compounds to
    # newtons of force error. The settings' precision ('highest' by
    # default) holds for the solve and the caller's comes back after it.
    with matmul_precision(settings.matmul_precision):
        return _solve_nonlinear_ocp(linearize, performance, x_init, u_init,
                                    settings)


def _solve_nonlinear_ocp(linearize, performance, x_init, u_init,
                         settings: ScpSettings) -> ScpResult:
    if settings.qp_backend == 'riccati_kernel':
        from cheeta_mpc_tpu_torch.ops.cuda_ipm_batch import \
            make_fleet_qp_solver
        qp_solve = make_fleet_qp_solver(settings.ipm)
    elif settings.qp_backend == 'riccati':
        def qp_solve(data):
            return solve_ocp_qp(data, settings.ipm)
    elif settings.qp_backend == 'condensed':
        from cheeta_mpc_tpu_torch.ops.condensed import solve_ocp_qp_condensed

        def qp_solve(data):
            return solve_ocp_qp_condensed(data, settings.ipm)
    else:
        raise ValueError(f"unknown qp_backend {settings.qp_backend!r}")
    if settings.eq_mode == 'projected':
        from cheeta_mpc_tpu_torch.ops.projection import \
            solve_ocp_qp_projected
        reduced_solve = qp_solve

        def qp_solve(data):
            return solve_ocp_qp_projected(
                data, settings.ipm, inner=lambda d, _: reduced_solve(d))
    elif settings.eq_mode != 'riccati':
        raise ValueError(f"unknown eq_mode {settings.eq_mode!r}")

    # The ladder, filled on the device entry by entry: a tensor made from the
    # Python tuple would be a copy from the host, which makes the host wait
    # for everything queued so far.
    n_alpha = len(settings.alphas)
    alphas = torch.empty(n_alpha, dtype=x_init.dtype, device=x_init.device)
    for i, step in enumerate(settings.alphas):
        alphas[i:i + 1].fill_(step)

    def iteration(x, u):
        with stage("sqp.linearize"):
            data = linearize(x, u)
        with stage("sqp.qp"):
            sol = qp_solve(data)
        with stage("sqp.line_search"):
            return line_search(x, u, data, sol)

    def line_search(x, u, data, sol):
        base = performance(x, u)
        base_viol = _total_violation(base)
        # Armijo descent metric: cost-gradient . direction from the LQ data.
        armijo_metric = (torch.sum(data.cost.q * sol.dx, dim=(-2, -1))
                         + torch.sum(data.cost.r * sol.du, dim=(-2, -1)))

        # The whole ladder at once: candidates on a new leading axis.
        a_x = alphas.reshape((n_alpha,) + (1,) * x.dim())
        a_b = alphas.reshape((n_alpha,) + (1,) * base_viol.dim())
        p = performance(x + a_x * sol.dx, u + a_x * sol.du)
        viol = _total_violation(p)
        acc_constraint = viol < (1.0 - settings.gamma_c) * base_viol
        acc_cost = p.merit < (base.merit
                              + settings.armijo_factor * a_b * armijo_metric)
        acc_dual = ((p.merit < base.merit - settings.gamma_c * base_viol)
                    | acc_constraint)
        high = viol > settings.g_max
        low = ((viol < settings.g_min) & (base_viol < settings.g_min)
               & (armijo_metric < 0.0))
        accs = torch.where(high, acc_constraint,
                           torch.where(low, acc_cost, acc_dual))
        stypes = torch.where(
            high, STEP_CONSTRAINT,
            torch.where(low, STEP_COST, STEP_DUAL)).to(torch.int32)

        # Per batch element: the first (largest) accepted step, else ZERO.
        any_acc = torch.any(accs, dim=0)
        best = torch.argmax(accs.to(torch.int32), dim=0, keepdim=True)

        def pick(arr):
            return torch.take_along_dim(arr, best, dim=0)[0]

        a = torch.where(any_acc, pick(a_b.expand(accs.shape)),
                        torch.zeros_like(base_viol))
        a_t = a[..., None, None]
        x_new = x + a_t * sol.dx
        u_new = u + a_t * sol.du
        perf_after = _map_perf(
            lambda pc, b: torch.where(any_acc, pick(pc), b), p, base)
        step = StepInfo(
            step_size=a,
            step_type=torch.where(any_acc, pick(stypes),
                                  STEP_ZERO).to(torch.int32),
            dx_norm=a * _traj_norm(sol.dx),
            du_norm=a * _traj_norm(sol.du),
            performance=perf_after)
        return (x_new, u_new), (step, base.merit, sol)

    x, u = x_init, u_init
    per_iter = []
    for _ in range(settings.iterations):
        (x, u), rec = iteration(x, u)
        per_iter.append(rec)
    recs = [r[0] for r in per_iter]
    steps = StepInfo(
        step_size=torch.stack([r.step_size for r in recs], dim=-1),
        step_type=torch.stack([r.step_type for r in recs], dim=-1),
        dx_norm=torch.stack([r.dx_norm for r in recs], dim=-1),
        du_norm=torch.stack([r.du_norm for r in recs], dim=-1),
        performance=_map_perf(lambda *xs: torch.stack(xs, dim=-1),
                              *[r.performance for r in recs]))
    last, base_merit, sol = per_iter[-1]

    # Convergence classification, evaluated on the final step.
    alpha_min = settings.alphas[-1]

    def code(c):
        return torch.full_like(last.step_type, c)

    conv = torch.where(
        last.step_size < alpha_min, code(CONV_STEPSIZE),
        torch.where(
            (torch.abs(last.performance.merit - base_merit)
             < settings.cost_tol)
            & (_total_violation(last.performance) < settings.g_min),
            code(CONV_METRICS),
            torch.where((last.dx_norm < settings.delta_tol)
                        & (last.du_norm < settings.delta_tol),
                        code(CONV_PRIMAL), code(CONV_ITERATIONS))))

    return ScpResult(x=x, u=u, merit=last.performance.merit, qp_mu=sol.mu,
                     gains_K=sol.gains.K, gains_k=sol.gains.k,
                     gains_P=sol.gains.P, gains_p=sol.gains.p,
                     lam_l=sol.lam_l, lam_u=sol.lam_u,
                     performance=last.performance, step_info=steps,
                     convergence=conv)


def make_performance(total_cost: Callable[..., torch.Tensor],
                     dyn_defects: Callable[..., torch.Tensor],
                     eq_values: Optional[Callable[..., torch.Tensor]] = None,
                     ineq_violations: Optional[Callable[...,
                                                        torch.Tensor]] = None,
                     rho: float = 1e3) -> Callable[..., PerformanceIndex]:
    """Assemble a ``performance(x, u) -> PerformanceIndex`` callback from
    component callbacks.

    ``dyn_defects(x, u) -> (..., N, nx)`` shooting defects; ``eq_values``
    masked stage-equality values; ``ineq_violations`` nonnegative violation
    amounts (both ``(..., rows, cols)``). merit = cost + rho * L1(violations)
    — the exact-penalty metric.
    """

    def performance(x, u) -> PerformanceIndex:
        cost = total_cost(x, u)
        d = dyn_defects(x, u)
        dyn_sse = torch.sum(d * d, dim=(-2, -1))
        l1 = torch.sum(torch.abs(d), dim=(-2, -1))
        eq_sse = torch.zeros_like(dyn_sse)
        ineq_sse = torch.zeros_like(dyn_sse)
        if eq_values is not None:
            e = eq_values(x, u)
            eq_sse = torch.sum(e * e, dim=(-2, -1))
            l1 = l1 + torch.sum(torch.abs(e), dim=(-2, -1))
        if ineq_violations is not None:
            v = ineq_violations(x, u)
            ineq_sse = torch.sum(v * v, dim=(-2, -1))
            l1 = l1 + torch.sum(v, dim=(-2, -1))
        return PerformanceIndex(merit=cost + rho * l1, cost=cost,
                                dyn_violation_sse=dyn_sse,
                                eq_constraint_sse=eq_sse,
                                ineq_constraint_sse=ineq_sse)

    return performance
