"""Device time per call, and the work of a call counted from its shapes.

The host's clock around one solve measures the host as much as the card:
input copies, the graph launch, the wait for the result and whatever else
shares the host. This module measures the seconds the card spends per call.
It chains calls so that each call's output nudges the next call's first
argument (a real data dependency: the calls run strictly in turn and none
can be dropped), captures a chain of ``k_small`` and one of ``k_big`` calls
as one CUDA graph each (``utils.cuda_graph.graphed``, the port's ``jit``),
and takes the per-call slope ``(t_big - t_small) / (k_big - k_small)`` over
their replays. What a replay costs once (input copies, output copies)
cancels in the difference.

Each timed replay is timed by CUDA events and issued behind another replay
of the same graph. Launching a graph costs the host time in proportion to
its nodes, and the device starts a graph only once it is launched; on the
host's clock that cost grows with k and does not cancel. Issued behind a
replay that keeps the device busy, the launch overlaps the device's work.
The host then reads the chain's first output, as the JAX package's loop
ends in ``np.asarray``.

Two counts of work, for two purposes:

- ``riccati_ipm_flops``, ``centroidal_solve_flops``, ``eq_riccati_flops``
  and ``qp_data_bytes`` are the JAX package's counts of a solve's useful
  work (2 operations per multiply-add, ~2 n^3 per inverse), whatever
  executes it. ``centroidal_solve_flops`` over the device seconds of a
  solve, over ``F32_FLOPS``, is ``mfu_pct`` as the JAX package's benchmark
  reports it.
- ``ipm_flops`` and ``eq_flops`` count what the port's kernels compute
  (Gauss-Jordan inverses, residual passes, stage equalities). With the
  bytes of a launch's inputs and outputs they give a kernel's bound
  (``bound``): the least time the card could take for the launch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from cheeta_mpc_tpu_torch.core.types import resolve_device
from cheeta_mpc_tpu_torch.utils.cuda_graph import _flatten, graphed

# Published peaks of one H100 SXM (NVIDIA data sheet, at 700 W): HBM
# bytes/s and f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

_clock = time.perf_counter  # the CPU path's clock (the card's: CUDA events)


def _first_tensor(tree) -> torch.Tensor:
    """The first tensor leaf of a nest (tuples, NamedTuples, dataclasses,
    dicts), in the order ``jax.tree.leaves`` takes the same nest."""
    leaves: list = []
    _flatten(tree, leaves, (torch.Tensor,))
    return leaves[0]


def _chained_loop(fn: Callable, n_iters: int) -> Callable:
    """``args -> (args', out)``: ``fn`` called ``n_iters`` times, each call
    adding ``1e-30 * tanh(mean(first output tensor))`` to the first
    argument of the next. That changes nothing a solve can see but makes
    each call wait for the one before. ``args'`` are the arguments after the
    last nudge (what the JAX package's chained loop returns), ``out`` the
    last call's output."""

    def run(*args):
        out = None
        for _ in range(n_iters):
            out = fn(*args)
            nudge = 1e-30 * torch.tanh(torch.mean(_first_tensor(out)))
            args = (args[0] + nudge.to(args[0].dtype),) + tuple(args[1:])
        return args, out

    return run


class ChainTiming(NamedTuple):
    """What :func:`time_chain` measured."""

    seconds: float  # median over the repetitions of the per-call slope
    slopes: list  # each repetition's slope, seconds
    chain_s: dict  # {k: each repetition's seconds of one k-chain call}
    issue_s: dict  # {k: each repetition's host seconds to issue that call}
    output: object  # the last call's output in the k_big chain
    graphs: dict  # {k: the stats of the chain's graph}; {} on the CPU


def time_chain(fn: Callable, args: Sequence, k_small: int = 4,
               k_big: int = 20, reps: int = 3,
               device="cuda") -> ChainTiming:
    """:func:`device_time_per_call` with each timed call's seconds, the
    host's seconds to issue it, the k_big chain's last output and the
    chains' graph stats (capture and instantiation seconds, nodes, private
    pool bytes). On the card each chain is one CUDA graph, and its first
    call (two warm-up calls, then the capture) makes the constants that a
    solver keeps after its first call; a timed call is issued behind
    another call of the same chain and timed by CUDA events (module
    docstring), so it measures the device's time only where the host
    issued it before the call ahead of it ended (``issue_s`` below
    ``chain_s``). On ``device="cpu"`` the chains run as they are, timed by
    the host clock (for tests)."""
    dev = resolve_device(device)
    chains = {k: graphed(_chained_loop(fn, k), dev) for k in (k_small, k_big)}

    def timed(k):
        """(seconds, host seconds to issue, result) of one call."""
        if dev.type == "cpu":
            t0 = _clock()
            result = chains[k](*args)
            return _clock() - t0, 0.0, result
        chains[k](*args)  # keeps the device busy while the next is issued
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        result = chains[k](*args)
        issue = time.perf_counter() - t0
        end.record()
        _first_tensor(result).cpu()  # the host reads the chain's output
        return start.elapsed_time(end) / 1e3, issue, result

    timed(k_small)
    _, _, (_, output) = timed(k_big)
    chain_s = {k_small: [], k_big: []}
    issue_s = {k_small: [], k_big: []}
    for _ in range(reps):
        for k in (k_small, k_big):
            t, issue, _ = timed(k)
            chain_s[k].append(t)
            issue_s[k].append(issue)
    slopes = [(b - a) / (k_big - k_small)
              for a, b in zip(chain_s[k_small], chain_s[k_big])]
    if dev.type == "cpu":
        issue_s = {}
    graphs = {k: next(iter(c.graphs.values())).stats
              for k, c in chains.items() if hasattr(c, "graphs")}
    return ChainTiming(float(np.median(slopes)), slopes, chain_s, issue_s,
                       output, graphs)


def device_time_per_call(fn: Callable, args: Sequence, k_small: int = 4,
                         k_big: int = 20, reps: int = 3,
                         device="cuda") -> float:
    """Device seconds per ``fn(*args)`` call: the median over ``reps`` of
    ``(t_big - t_small) / (k_big - k_small)``, each ``t`` the time of one
    replay of a chain of ``k`` calls (one CUDA graph) by CUDA events,
    issued behind another replay (module docstring) and ending in a host
    read of its first output. ``args`` are tensors on ``device``."""
    return time_chain(fn, args, k_small, k_big, reps, device).seconds


# ---------------------------------------------------------------------------
# The JAX package's counts of a solve's work (2*m*n*k per (m,n)x(n,k)
# product; inverses ~2n^3): the structured mathematics the solver performs,
# independent of how an executor pads or tiles it.
# ---------------------------------------------------------------------------

def riccati_ipm_flops(N: int, nx: int, nu: int, ng: int,
                      ipm_iters: int) -> float:
    """One inequality-IPM OCP-QP solve via Riccati: per iteration one
    factorization, two vector and forward passes and one stationarity
    pass."""
    mm = lambda m, n, k: 2.0 * m * n * k
    # Factorization per stage: barrier blocks + Riccati update + SPD inverse.
    fact = (mm(nx, ng, nx) + mm(nu, ng, nu) + mm(nu, ng, nx)  # C'WC,D'WD,D'WC
            + mm(nx, nx, nx + nu)  # P [A B]
            + mm(nx + nu, nx, nx + nu)  # [A B]' P[A B]
            + 2.0 * nu ** 3  # SPD inverse of G
            + mm(nu, nu, nu) * 2  # refinement / K = -Gi H
            + mm(nx, nu, nx))  # H'K
    # Vector pass per stage (matvecs): qbar/rbar grads + recursion.
    vec = 2.0 * (mm(1, nx, nx) * 2 + mm(1, nu, nu) + mm(1, nu, nx) * 2
                 + mm(1, ng, nx) + mm(1, ng, nu)
                 + mm(1, nx, nx) * 2 + mm(1, nx, nu) * 2)
    # Forward rollout + constraint evaluation per stage.
    fwd = (mm(1, nx, nu) + mm(1, nx, nx) + mm(1, nu, nx)
           + mm(1, ng, nx) + mm(1, ng, nu))
    # Stationarity adjoint per stage.
    stat = mm(1, nx, nx) + mm(1, nu, nu) + mm(1, nu, nx) * 2 + mm(1, ng, nx)
    per_iter = N * (fact + 2 * (vec + fwd) + stat)
    return ipm_iters * per_iter


def centroidal_solve_flops(N: int, nx: int, nu: int, ng: int,
                           sqp_iters: int, ipm_iters: int,
                           n_alphas: int = 4) -> float:
    """One full centroidal-MPC solve: SQP iterations of {linearize (dynamics
    Jacobian + cost Hessians), QP solve, line-search ladder}. Linearization
    and line-search costs are rough (elementwise-dominated) and small next
    to the QP; the QP dominates."""
    qp = riccati_ipm_flops(N, nx, nu, ng, ipm_iters)
    # Linearization: the (nx -> nx) step's Jacobian over nx+nu tangents per
    # stage + (nx+nu)^2 cost Hessian rows.
    lin = N * (2.0 * nx * (nx + nu) * nx + 2.0 * (nx + nu) ** 2 * 4)
    ls = n_alphas * N * 2.0 * (nx * nx + ng * (nx + nu))
    return sqp_iters * (qp + lin + ls)


def eq_riccati_flops(N: int, nx: int, nu: int, nc: int) -> float:
    """One equality-constrained LQR solve (the legged real-time iteration's
    QP, ``ops.riccati.solve_eq_lqr`` or K3/K4)."""
    mm = lambda m, n, k: 2.0 * m * n * k
    fact = (mm(nx, nx, nx + nu) + mm(nx + nu, nx, nx + nu)
            + 2.0 * nu ** 3 + mm(nu, nu, nc) + mm(nc, nu, nc)
            + 2.0 * nc ** 3 + mm(nu, nc, nc) + mm(nu, nc, nu)
            + mm(nu, nu, nx) + mm(nu, nc, nx) + mm(nx, nu, nx)
            + mm(nc, nu, nx) + mm(nx, nc, nx))
    vec = (mm(1, nx, nx) * 2 + mm(1, nu, nx) + mm(1, nu, nu)
           + mm(1, nu, nc) * 2 + mm(1, nc, nc) + mm(1, nx, nu)
           + mm(1, nx, nc))
    fwd = mm(1, nu, nx) + mm(1, nx, nx) + mm(1, nx, nu)
    return N * (fact + vec + fwd)


def qp_data_bytes(N: int, nx: int, nu: int, ng: int, nc: int = 0,
                  dtype_bytes: int = 4) -> float:
    """Device-memory footprint of one solve's QP data (the least traffic per
    solve for a batched solver whose working set exceeds on-chip memory):
    dynamics + cost + constraint arrays + iterate/slack/dual state."""
    dyn = N * (nx * nx + nx * nu + nx)
    cost = (N + 1) * (nx * nx + nx) + N * (nu * nu + nu + nu * nx)
    con = (N + 1) * (ng * nx + ng * nu + 3 * ng)
    eq = N * (nc * nx + nc * nu + 2 * nc)
    state = (N + 1) * nx + N * nu + 4 * (N + 1) * ng
    factors = N * (nu * nx + nu * nu) + (N + 1) * nx * nx
    return dtype_bytes * float(dyn + cost + con + eq + state + factors)


# ---------------------------------------------------------------------------
# The port's kernels' own counts, and the bound of a launch.
# ---------------------------------------------------------------------------

def ipm_flops(N, nx, nu, ng, nc, iters) -> float:
    """f32 operations (2 per multiply-add) of one fixed-iteration solve,
    counted from the shapes: per iteration one residual pass, one
    factorization, two Newton passes and one stationarity pass."""

    def inv(n):  # Gauss-Jordan on an n x 2n augmented matrix
        return 2.0 * n * n * (n + 1)

    grads = ((N + 1) * 2 * nx * (nx + ng)
             + N * 2 * nu * (2 * nx + nu + ng))
    residuals = ((N + 1) * 2 * ng * nx + N * 2 * ng * nu
                 + N * 2 * nx * (nx + nu) + N * 2 * nc * (nx + nu))
    stage = (2 * nx ** 3 + 2 * nx * nx * nu  # P A, P B
             + 2 * nu * nu * (ng + nx) + 2 * nu * nx * (ng + nx)  # G, H
             + 2 * nx * nx * (ng + nx) + inv(nu)  # Q + A'PA, G^-1
             + 2 * nu * nu * nx + 2 * nx * nx * nu)  # K, P += H'K
    if nc:
        stage += (4 * nu * nu * nc + 4 * nu * nc * nc + inv(nc)
                  + 4 * nc * nu * nx + 2 * nc * nc * nx + 2 * nx * nx * nc)
    factorize = N * stage + 2 * nx * nx * ng + N * 2 * nx * nx
    back = 2 * nx * nu + 2 * nu * nu + 2 * nx * nx + 2 * nu * nx
    if nc:
        back += 4 * nu * nc + 2 * nc * nc + 2 * nc * nx
    fwd = 4 * nu * nx + 2 * nx * nx
    newton = (grads + N * (back + fwd) + (N + 1) * 2 * ng * nx
              + N * 2 * ng * nu + 30 * (N + 1) * ng)
    stat = grads + N * (2 * nx * nu + 2 * nx * nx + 2 * nc * (2 * nu + nx))
    lid = N * (2 * nc * nc * nu * 2 + inv(nc)) if nc else 0
    return float(lid + stat
                 + iters * (residuals + factorize + 2 * newton + stat))


def eq_flops(N, nx, nu, nc) -> float:
    """f32 operations (2 per multiply-add) of one equality-constrained
    Riccati solve, counted from the shapes: factorization, vector pass and
    rollout."""

    def inv(n):
        return 2.0 * n * n * (n + 1)

    stage = (4 * nx ** 3 + 2 * nx * nx * nu  # P A, A'PA, P B
             + 2 * nu * nu * nx + 2 * nu * nx * nx + inv(nu)  # G, H, G^-1
             + 4 * nu * nu * nc + 4 * nu * nc * nc + inv(nc)  # Y, Lam, YLi, W
             + 4 * nc * nu * nx + 2 * nu * nu * nx + 2 * nc * nc * nx  # T, K
             + 2 * nx * nx * (nu + nc))  # P += H'K + C'T2
    vec = (4 * nx * nx + 2 * nx * nu + 2 * nu * nu + 4 * nu * nc
           + 2 * nc * nc + 2 * nu * nx + 2 * nc * nx)
    fwd = 4 * nu * nx + 2 * nx * nx
    return float(N * (stage + vec + fwd))


def tensors_of(obj):
    """Every tensor of a (nested) container dataclass."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            out += tensors_of(getattr(obj, f.name))
        return out
    return []


def bound(data, out_tensors, flops: float):
    """(bound_ms, bound_by), bytes: every input read once, every output
    written once, and ``flops`` operations, at the card's peaks."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors_of(data))
    nbytes += sum(t.numel() * t.element_size() for t in out_tensors)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS
    return ((t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations"),
            nbytes)
