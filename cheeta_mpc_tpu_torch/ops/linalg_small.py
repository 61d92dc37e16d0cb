"""Small-matrix linear algebra of the torch executor.

Counterpart of ``cheeta_mpc_tpu/ops/linalg_small.py``. The JAX package
unrolls a recursive Schur-complement inverse with one Newton refinement
because XLA lowers small Cholesky factorizations badly on its target; a
batched ``torch.linalg`` call has no such problem, so the explicit SPD
inverse here is a Cholesky inverse. In f64 the two agree to roundoff. The
CUDA kernels do not use this: they carry their own equilibrated Gauss-Jordan
inverse (``ops/cuda_ipm_riccati.py``).
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
    X = torch.cholesky_inverse(L)
    bad = (info != 0)[..., None, None]
    X = torch.where(bad, torch.full_like(X, float("nan")), X)
    return 0.5 * (X + X.transpose(-1, -2))
