"""Batched (fleet-scale) equality-constrained Riccati solve: one CUDA kernel
over the batch, one thread block per problem — counterpart of
``cheeta_mpc_tpu/ops/pallas_eq_batch.py``.

Source note.
  Replaces: ``ops/pallas_eq_batch.py::_eq_fleet_kernel`` (launched by
  ``solve_eq_lqr_fleet``; dispatch by ``make_fleet_eq_solver``) of the JAX
  package.
  Kernel: ``csrc/eq_riccati_fleet.cu`` (entry, ``grid = batch``) +
  ``csrc/eq_riccati.cuh`` (device code shared with the batch-1 kernel).
  What bounds it on this card: on paper bytes and operations are nearly
  level (a legged problem reads ~1.0 MB once and writes ~0.17 MB against
  ~25 MFLOP of f32 FMA work: about 0.2 ms at batch 512 either way); in
  practice the latency of each problem's stage-serial chain, hidden only
  as far as several problems share an SM.
  What the design does about it: the TPU kernel puts 128 problems on the
  vector lanes of one core and streams the stage data through a double
  buffer; here the batch is spread over the grid, one team of four warps
  (one thread block) per problem, any batch size >= 1 with no lane
  multiple to pad to. The device code is the batch-1 kernel's
  (``ops.cuda_eq_riccati``); a team's ~40 KB of shared memory and 128
  registers per thread let four problems share an SM, so a fleet of 512
  legged problems is resident at once on 132 SMs (one wave) and one
  problem's inverse overlaps the others' products.

Scope: f32, masked stage equalities, no inequality rows, exactly one batch
dimension; every tensor of the problem either carries the batch dimension or
is shared by the batch. The value function (P, p) is not produced: the
returned P/p are NaN so that consuming them by accident is loud; K/k are
real. What is out of scope raises with the reason.
"""

from __future__ import annotations

from typing import Optional

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains)
from cheeta_mpc_tpu_torch.ops.cuda_eq_riccati import (EQ_EPS, FLEET_ENTRY,
                                                      eq_out_of_scope_reason,
                                                      launch_eq_kernel,
                                                      solve_eq_lqr_plain)
from cheeta_mpc_tpu_torch.ops.ocpqp import _dyn_residual
from cheeta_mpc_tpu_torch.ops.riccati import _no_inequality_solution


def out_of_scope_reason(data: OcpQpData) -> Optional[str]:
    """Why a batched problem cannot go to the fleet kernel, or None."""
    reason = eq_out_of_scope_reason(data)
    if reason is not None:
        return reason
    if data.dx0.dim() != 2:
        return (f"dx0 has {data.dx0.dim() - 1} batch dimensions; the fleet "
                "kernel takes exactly one")
    return None


def _finish(data: OcpQpData, dx, du, K, k) -> OcpQpSolution:
    """NaN value function, dynamics residual per problem as ``eq_res``."""
    batch = dx.shape[:-2]
    N, nx = data.dyn.horizon, data.dyn.nx

    def nan(*shape):
        return torch.full(batch + shape, float("nan"), dtype=dx.dtype,
                          device=dx.device)

    sol = _no_inequality_solution(
        data, dx, du, RiccatiGains(K=K, k=k, P=nan(N + 1, nx, nx),
                                   p=nan(N + 1, nx)))
    return sol.replace(eq_res=torch.amax(
        torch.abs(_dyn_residual(data.dyn, dx, du)), dim=(-2, -1)))


def solve_eq_lqr_fleet_plain(data: OcpQpData, reg: float = 1e-9,
                             eps: float = EQ_EPS) -> OcpQpSolution:
    """Plain PyTorch version of the fleet kernel: the batch-1 kernel's plain
    version run over the batch dimension (the two kernels share their
    device code, so they share their arithmetic), P/p replaced by NaN."""
    sol = solve_eq_lqr_plain(data, reg, eps)
    return _finish(data, sol.dx, sol.du, sol.gains.K, sol.gains.k)


def solve_eq_lqr_fleet(data: OcpQpData, reg: float = 1e-9,
                       eps: float = EQ_EPS) -> OcpQpSolution:
    """Batched exact solve of equality-constrained, inequality-free OCP-QPs
    on batch-leading data (``dx0`` is ``(batch, nx)``, any batch >= 1). See
    the module docstring for scope; P/p of the result are NaN by design.

    CUDA tensors go through the kernel (float32 only, anything else
    raises); CPU tensors through the plain version. The launch counter
    ``solve_eq_lqr_fleet.launches`` rises by one per kernel launch."""
    reason = out_of_scope_reason(data)
    if reason is not None:
        raise NotImplementedError(f"solve_eq_lqr_fleet: {reason}")
    if data.dx0.device.type == "cpu":
        return solve_eq_lqr_fleet_plain(data, reg, eps)
    out = launch_eq_kernel(FLEET_ENTRY, data, reg, eps,
                           batch=data.dx0.shape[0], value_function=False)
    solve_eq_lqr_fleet.launches += 1
    return _finish(data, out["dx"], out["du"], out["K"], out["k"])


solve_eq_lqr_fleet.launches = 0
