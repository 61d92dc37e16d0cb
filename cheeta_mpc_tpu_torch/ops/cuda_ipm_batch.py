"""Batched (fleet-scale) Riccati-IPM solve: one CUDA kernel over the batch,
one thread block per problem — counterpart of
``cheeta_mpc_tpu/ops/pallas_ipm_batch.py``.

Source note.
  Replaces: ``ops/pallas_ipm_batch.py::_fleet_kernel`` (launched by
  ``solve_ocp_qp_fleet``; dispatch by ``make_fleet_qp_solver``) of the JAX
  package.
  Kernel: ``csrc/ipm_riccati_fleet.cu`` (entry, ``grid = batch``) +
  ``csrc/ipm_riccati.cuh`` (device code shared with the batch-1 kernel).
  What bounds it on this card: on paper operations (a problem needs ~65
  MFLOP of f32 FMA work against ~0.15 MB of data read once, ~400 FLOP per
  byte, far above the card's f32 ridge of ~20 FLOP/byte); in practice the
  latency of each block's serial chain of barrier phases.
  What the design does about it: the TPU kernel puts 128 problems on the
  vector lanes of one core with the whole tile resident in its large fast
  memory; a Hopper SM has 227 KB, so here the batch is spread over the
  grid instead, one block per problem, and two blocks share each SM: the
  kernel is built for at most 128 registers a thread, and the Riccati
  factors go to a global scratch buffer (L2-resident, streamed back into
  shared memory by ``cp.async`` stage by stage) so that a block needs ~110
  KB of shared memory. While one block waits at a barrier the other
  issues. Any batch size >= 1
  works; there is no lane multiple to pad to. Plain f32 throughout: the
  Pallas module records NaN by IPM iteration ~8 with bf16 factors.
  Problems with masked stage equalities (the legged pyramid mode) take the
  instantiation that eliminates them: K1's block of 384 threads, one block
  per SM (at N=67, nx=nu=24 the iterate and work arrays fill an SM's shared
  memory), so problem i runs K1's instructions on problem i.

Scope (the centroidal fleet, the convex SRB MPC's scenario batch, the
batched legged pyramid mode and the projected mode's reduced batch):
inequality-constrained f32 problems, with or without masked stage
equalities. Every input, the constraint matrices C/D included, is either
shared by the batch or the problem's own (a block reads each input through
its own per-problem stride; the Pallas kernel takes shared C/D only, and
the JAX package falls back to a vmapped scan for the rest). Riccati gains
are not produced (the fleet path consumes trajectories only); the returned
gains are NaN so that consuming them by accident is loud. What is out of
scope raises with the reason — it is never solved silently by another
executor.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains, StageEquality,
                                             tree_map)
from cheeta_mpc_tpu_torch.ops.cuda_ipm_riccati import (FLEET_ENTRY,
                                                       _masked_eq,
                                                       launch_ipm_kernel,
                                                       solve_ocp_qp_kernel,
                                                       solve_ocp_qp_plain)
from cheeta_mpc_tpu_torch.ops.ocpqp import (IpmSettings, _constraint_values,
                                            _dyn_residual)


def out_of_scope_reason(data: OcpQpData) -> Optional[str]:
    """Why a batched problem cannot go to the fleet kernel, or None."""
    if data.con is None:
        return "the problem has no inequality rows (data.con is None)"
    if data.dx0.dim() != 2:
        return (f"dx0 has {data.dx0.dim() - 1} batch dimensions; the fleet "
                "kernel takes exactly one")
    return None


def _nan_gains(batch, N, nx, nu, like: torch.Tensor) -> RiccatiGains:
    def nan(*shape):
        return torch.full(batch + shape, float("nan"), dtype=like.dtype,
                          device=like.device)

    return RiccatiGains(K=nan(N, nu, nx), k=nan(N, nu), P=nan(N + 1, nx, nx),
                        p=nan(N + 1, nx))


def solve_ocp_qp_fleet_plain(data: OcpQpData,
                             settings: IpmSettings) -> OcpQpSolution:
    """Plain PyTorch version of the fleet kernel: the batch-1 kernel's plain
    version run over the batch dimension (the two kernels share their
    device code, so they share their arithmetic; masked stage equalities
    are zeroed and eliminated as there), gains replaced by NaN. The
    kernel's scope (:func:`out_of_scope_reason`) is checked by
    :func:`solve_ocp_qp_fleet` before either runs."""
    sol = solve_ocp_qp_plain(data, settings)
    dyn = data.dyn
    return sol.replace(gains=_nan_gains(
        sol.dx.shape[:-2], dyn.horizon, dyn.nx, dyn.nu, sol.dx))


def solve_ocp_qp_fleet(data: OcpQpData,
                       settings: Optional[IpmSettings] = None
                       ) -> OcpQpSolution:
    """Batched QP solve on batch-leading data: ``dx0`` carries one leading
    batch dimension of any size >= 1, every other tensor of ``data`` the
    same or none (shared by the batch). See the module docstring for scope;
    the gains of the result are NaN by design.

    CUDA tensors go through the kernel (float32 only, anything else
    raises); CPU tensors through the plain version. The launch counter
    ``solve_ocp_qp_fleet.launches`` rises by one per kernel launch."""
    if settings is None:
        settings = IpmSettings()
    reason = out_of_scope_reason(data)
    if reason is not None:
        raise NotImplementedError(f"solve_ocp_qp_fleet: {reason}")
    if data.dx0.device.type == "cpu":
        return solve_ocp_qp_fleet_plain(data, settings)
    batch = data.dx0.shape[0]
    out = launch_ipm_kernel(FLEET_ENTRY, _masked_eq(data), settings,
                            batch=batch, gains=False)
    solve_ocp_qp_fleet.launches += 1
    dx, du = out["dx"], out["du"]
    # Cheap per-problem diagnostics, all elementwise (the stationarity
    # residual is the kernel's own final guard evaluation).
    con, dyn = data.con, data.dyn
    g = _constraint_values(con, dx, du)
    viol = torch.maximum(con.lg - g, g - con.ug)
    ineq_res = torch.amax(
        torch.where(con.mask > 0, viol, torch.zeros_like(viol)), dim=(-2, -1))
    eq_res = torch.amax(torch.abs(_dyn_residual(dyn, dx, du)), dim=(-2, -1))
    return OcpQpSolution(
        dx=dx, du=du,
        gains=_nan_gains((batch,), dyn.horizon, dyn.nx, dyn.nu, dx),
        lam_l=out["lam_l"], lam_u=out["lam_u"], s_l=out["s_l"],
        s_u=out["s_u"],
        iterations=torch.full((batch,), int(settings.iters),
                              dtype=torch.int32, device=dx.device),
        mu=out["diag"][:, 0], stat_res=out["diag"][:, 1], ineq_res=ineq_res,
        eq_res=eq_res)


solve_ocp_qp_fleet.launches = 0


def with_masked_equality_row(data: OcpQpData) -> OcpQpData:
    """``data`` (no inequality rows, no stage equalities) with one stage
    equality row that is masked off at every stage: zero C, D and e. The
    equality-Riccati elimination then drops it exactly (its multiplier's
    block is the inactive-row regularization alone), so the solve is the
    unconstrained LQR solve, and the problem is one the equality-Riccati
    kernels take. The row carries the batch dimensions of ``dx0``."""
    dyn = data.dyn
    lead = data.dx0.shape[:-1]
    kw = dict(dtype=data.dx0.dtype, device=data.dx0.device)
    N, nx, nu = dyn.horizon, dyn.nx, dyn.nu
    return data.replace(eq=StageEquality(
        C=torch.zeros(lead + (N, 1, nx), **kw),
        D=torch.zeros(lead + (N, 1, nu), **kw),
        e=torch.zeros(lead + (N, 1), **kw),
        mask=torch.zeros(lead + (N, 1), **kw)))


def make_fleet_qp_solver(
        settings: IpmSettings) -> Callable[[OcpQpData], OcpQpSolution]:
    """One QP solver for every path of ``qp_backend='riccati_kernel'``.

    With inequality rows (``data.con``): the batch-1 interior-point kernel
    for an unbatched problem (real gains), the fleet interior-point kernel
    for a batched one (NaN gains), either with or without masked stage
    equalities. Without them but with stage equalities (``data.eq``): the
    batch-1 equality-Riccati kernel (ops/cuda_eq_riccati.py) for an
    unbatched problem, the fleet one (ops/cuda_eq_batch.py, NaN P/p) for a
    batched one. With neither (the reduced problem of a projected solve
    without inequality rows), the same equality-Riccati kernels on the
    problem with one all-masked equality row
    (:func:`with_masked_equality_row`). Inequality matrices C/D of their own
    per problem (the projected mode's reduced rows, where the equalities
    differ between problems) go to the fleet kernel as well; the JAX
    package falls back to a vmapped scan there. A problem outside its
    kernel's scope raises ``NotImplementedError`` naming the reason."""
    from cheeta_mpc_tpu_torch.ops.cuda_eq_batch import solve_eq_lqr_fleet
    from cheeta_mpc_tpu_torch.ops.cuda_eq_riccati import (EQ_EPS,
                                                          solve_eq_lqr_kernel)

    def qp_solve(data: OcpQpData) -> OcpQpSolution:
        data = tree_map(lambda t: t.contiguous(), data)
        batched = data.dx0.dim() != 1
        if data.con is None:
            if data.eq is None or data.eq.nc == 0:
                data = with_masked_equality_row(data)
            solve = solve_eq_lqr_fleet if batched else solve_eq_lqr_kernel
            return solve(data, reg=settings.reg, eps=EQ_EPS)
        if batched:
            return solve_ocp_qp_fleet(data, settings)
        return solve_ocp_qp_kernel(data, settings)

    return qp_solve
