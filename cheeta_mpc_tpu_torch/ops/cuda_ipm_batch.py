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

Scope (the centroidal fleet workload): inequality-constrained f32 problems
whose constraint matrices C/D are shared by the batch, no stage equalities.
Riccati gains are not produced (the fleet path consumes trajectories only);
the returned gains are NaN so that consuming them by accident is loud. What
is out of scope raises with the reason — it is never solved silently by
another executor.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains, tree_map)
from cheeta_mpc_tpu_torch.ops.cuda_ipm_riccati import (launch_ipm_kernel,
                                                       solve_ocp_qp_kernel,
                                                       solve_ocp_qp_plain)
from cheeta_mpc_tpu_torch.ops.ocpqp import (IpmSettings, _constraint_values,
                                            _dyn_residual)


def out_of_scope_reason(data: OcpQpData) -> Optional[str]:
    """Why a batched problem cannot go to the fleet kernel, or None."""
    if data.con is None:
        return "the problem has no inequality rows (data.con is None)"
    if data.eq is not None:
        return ("the problem has stage equalities (data.eq), which the "
                "fleet kernel does not eliminate")
    if data.con.C.dim() != 3 or data.con.D.dim() != 3:
        return ("the constraint matrices con.C/con.D carry a batch "
                "dimension; the fleet kernel takes one C/D shared by the "
                "batch")
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
    device code, so they share their arithmetic), gains replaced by NaN."""
    sol = solve_ocp_qp_plain(data, settings)
    dyn = data.dyn
    return sol.replace(gains=_nan_gains(
        sol.dx.shape[:-2], dyn.horizon, dyn.nx, dyn.nu, sol.dx))


def solve_ocp_qp_fleet(data: OcpQpData,
                       settings: Optional[IpmSettings] = None
                       ) -> OcpQpSolution:
    """Batched QP solve on batch-leading data: every tensor of ``data``
    except ``con.C``/``con.D`` carries one leading batch dimension of any
    size >= 1. See the module docstring for scope; the gains of the result
    are NaN by design.

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
    out = launch_ipm_kernel("cheeta_ipm_riccati_fleet", data, settings,
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


def make_fleet_qp_solver(
        settings: IpmSettings) -> Callable[[OcpQpData], OcpQpSolution]:
    """One QP solver for every path of ``qp_backend='riccati_kernel'``.

    With inequality rows (``data.con``): the batch-1 interior-point kernel
    for an unbatched problem (real gains, stage equalities allowed), the
    fleet interior-point kernel for a batched one (NaN gains). Without
    them but with stage equalities (``data.eq``): the batch-1
    equality-Riccati kernel (ops/cuda_eq_riccati.py) for an unbatched
    problem, the fleet one (ops/cuda_eq_batch.py, NaN P/p) for a batched
    one. A problem outside its kernel's scope raises ``NotImplementedError``
    naming the reason — a batched problem with inequalities *and*
    equalities, or one with neither; the JAX package falls back to a
    vmapped scan there, the port does not."""
    from cheeta_mpc_tpu_torch.ops.cuda_eq_batch import solve_eq_lqr_fleet
    from cheeta_mpc_tpu_torch.ops.cuda_eq_riccati import (EQ_EPS,
                                                          solve_eq_lqr_kernel)

    def qp_solve(data: OcpQpData) -> OcpQpSolution:
        data = tree_map(lambda t: t.contiguous(), data)
        batched = data.dx0.dim() != 1
        if data.con is None:
            solve = solve_eq_lqr_fleet if batched else solve_eq_lqr_kernel
            return solve(data, reg=settings.reg, eps=EQ_EPS)
        if batched:
            return solve_ocp_qp_fleet(data, settings)
        return solve_ocp_qp_kernel(data, settings)

    return qp_solve
