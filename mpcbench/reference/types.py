"""Problem/solution containers: dataclasses of tensors.

Counterpart of ``cheeta_mpc_tpu/core/types.py``. All stages are stacked on a
leading stage axis; any number of batch dimensions may precede it (written
``...`` in the shape comments) — the batch that ``jax.vmap`` supplies in the
JAX package is an explicit leading dimension here. Variable per-stage
constraint counts are a fixed ``ng`` with an activity ``mask``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


class _Replace:
    """``obj.replace(field=value)`` as on the JAX package's pytree classes."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class DynamicsLin(_Replace):
    """``dx_{k+1} = A[k] dx_k + B[k] du_k + b[k]``, k = 0..N-1; ``b`` is the
    shooting defect of the current iterate in an SQP context."""

    A: torch.Tensor  # (..., N, nx, nx)
    B: torch.Tensor  # (..., N, nx, nu)
    b: torch.Tensor  # (..., N, nx)

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


@dataclass
class CostApprox(_Replace):
    """Stage cost ``1/2 dz' [Q S'; S R] dz + [q; r]' dz`` with
    ``dz = (dx_k, du_k)``, ``S`` of shape (nu, nx); terminal ``Q[N], q[N]``."""

    Q: torch.Tensor  # (..., N+1, nx, nx)
    q: torch.Tensor  # (..., N+1, nx)
    R: torch.Tensor  # (..., N, nu, nu)
    r: torch.Tensor  # (..., N, nu)
    S: torch.Tensor  # (..., N, nu, nx)


@dataclass
class StageConstraint(_Replace):
    """``lg[k] <= C[k] dx_k + D[k] du_k <= ug[k]`` on rows where ``mask[k]``
    is 1. ``C``/``D`` may lack the batch dimensions the bounds carry (one
    set of constraint matrices shared by the whole batch). Node N ignores
    ``D``."""

    C: torch.Tensor  # (..., N+1, ng, nx)
    D: torch.Tensor  # (..., N+1, ng, nu)
    lg: torch.Tensor  # (..., N+1, ng)
    ug: torch.Tensor  # (..., N+1, ng)
    mask: torch.Tensor  # (..., N+1, ng)  1.0 = active row

    @property
    def ng(self) -> int:
        return self.C.shape[-2]


@dataclass
class StageEquality(_Replace):
    """Masked per-stage equalities ``C dx + D du + e = 0`` (k = 0..N-1);
    inactive rows are zero in C/D/e."""

    C: torch.Tensor  # (..., N, nc, nx)
    D: torch.Tensor  # (..., N, nc, nu)
    e: torch.Tensor  # (..., N, nc)
    mask: torch.Tensor  # (..., N, nc)

    @property
    def nc(self) -> int:
        return self.C.shape[-2]


@dataclass
class OcpQpData(_Replace):
    """A full OCP-structured QP; ``dx0`` is the given initial deviation."""

    dyn: DynamicsLin
    cost: CostApprox
    con: Optional[StageConstraint]
    dx0: torch.Tensor  # (..., nx)
    eq: Optional[StageEquality] = None


@dataclass
class RiccatiGains(_Replace):
    """Feedback ``K``, feedforward ``k`` and cost-to-go ``{P, p}``."""

    K: torch.Tensor  # (..., N, nu, nx)
    k: torch.Tensor  # (..., N, nu)
    P: torch.Tensor  # (..., N+1, nx, nx)
    p: torch.Tensor  # (..., N+1, nx)


@dataclass
class OcpQpSolution(_Replace):
    """Primal/dual solution of an OCP-QP plus per-problem diagnostics."""

    dx: torch.Tensor  # (..., N+1, nx)
    du: torch.Tensor  # (..., N, nu)
    gains: RiccatiGains
    lam_l: torch.Tensor  # (..., N+1, ng)
    lam_u: torch.Tensor
    s_l: torch.Tensor
    s_u: torch.Tensor
    iterations: torch.Tensor  # (...)
    mu: torch.Tensor  # final complementarity measure
    stat_res: torch.Tensor  # stationarity residual inf-norm
    ineq_res: torch.Tensor  # inequality violation inf-norm
    eq_res: torch.Tensor  # dynamics defect inf-norm


@dataclass
class PerformanceIndex(_Replace):
    """Merit-function components of one iterate (batch-shaped scalars)."""

    merit: torch.Tensor
    cost: torch.Tensor
    dyn_violation_sse: torch.Tensor
    eq_constraint_sse: torch.Tensor
    ineq_constraint_sse: torch.Tensor

    @classmethod
    def zeros(cls, dtype=torch.float32, device="cpu") -> "PerformanceIndex":
        z = torch.zeros((), dtype=dtype, device=device)
        return cls(merit=z, cost=z, dyn_violation_sse=z,
                   eq_constraint_sse=z, ineq_constraint_sse=z)


def symmetrize(M: torch.Tensor) -> torch.Tensor:
    """Numerical symmetrization of (batched) square matrices."""
    return 0.5 * (M + M.transpose(-1, -2))


def tree_map(fn, obj):
    """Apply ``fn`` to every tensor of a (nested) container dataclass;
    ``None`` fields stay ``None``."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    raises: the port never carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the torch executors on "
            "the CPU")
    return dev
