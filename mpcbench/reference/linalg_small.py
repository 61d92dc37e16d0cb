"""Small-matrix linear algebra of the torch executor.

Counterpart of ``cheeta_mpc_tpu/ops/linalg_small.py``. The JAX package
unrolls a recursive Schur-complement inverse with one Newton refinement
because XLA lowers small Cholesky factorizations badly on its target; a
batched ``torch.linalg`` call has no such problem, so the explicit SPD
inverse here is a Cholesky inverse. In f64 the two agree to roundoff. The
CUDA kernels do not use this: they carry their own equilibrated Gauss-Jordan
inverse (``ops/cuda_ipm_riccati.py``).

The DDP solver's Riccati pass meets symmetric matrices that are not
positive definite (the exact Hessian of a penalty cost), which the JAX
package's Schur-complement inverse inverts all the same and a Cholesky
factorization refuses: :func:`sym_inverse` inverts them by LU.
"""

from __future__ import annotations

import torch


def spd_inverse(G: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of (batched) SPD matrices, symmetrized.

    An indefinite input (a diverged IPM iterate) yields NaN rather than an
    exception, so a batch element that blows up is rejected by the
    stationarity guard exactly as in the JAX package."""
    n = G.shape[-1]
    if n == 0:
        return G
    L, info = torch.linalg.cholesky_ex(G)
    # L^-1 by a triangular solve, then X = L^-T L^-1: on a card a batched
    # torch.cholesky_inverse goes through MAGMA, which aborts the process
    # when it runs inside a CUDA graph capture (the condensed backend's
    # gains at batch 1024); the triangular solve is cuBLAS's and captures.
    eye = torch.eye(n, dtype=G.dtype, device=G.device).expand(G.shape)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    X = Li.transpose(-1, -2) @ Li
    bad = (info != 0)[..., None, None]
    X = torch.where(bad, torch.full_like(X, float("nan")), X)
    return 0.5 * (X + X.transpose(-1, -2))


def sym_inverse(G: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of (batched) symmetric matrices that need not be
    positive definite (LU with partial pivoting), symmetrized. ``inv_ex``
    checks nothing on the host, so the call waits for nothing; a singular
    input yields inf or NaN."""
    X = torch.linalg.inv_ex(G).inverse
    return 0.5 * (X + X.transpose(-1, -2))
