"""Operation and byte counts from shapes: frozen copies of the port's
``utils/device_timing.py`` counts (``riccati_ipm_flops`` and
``centroidal_solve_flops``, the JAX package's counts of a solve's
structured work; ``ipm_flops`` and ``eq_flops``, what the QP kernels'
algorithms compute), and the bytes of a QP's inputs and outputs."""

from __future__ import annotations


def _mm(m, n, k):
    return 2.0 * m * n * k


def riccati_ipm_flops(N, nx, nu, ng, ipm_iters) -> float:
    """One inequality-IPM OCP-QP solve via Riccati: per iteration one
    factorization, two vector and forward passes and one stationarity
    pass."""
    mm = _mm
    fact = (mm(nx, ng, nx) + mm(nu, ng, nu) + mm(nu, ng, nx)
            + mm(nx, nx, nx + nu) + mm(nx + nu, nx, nx + nu)
            + 2.0 * nu ** 3 + mm(nu, nu, nu) * 2 + mm(nx, nu, nx))
    vec = 2.0 * (mm(1, nx, nx) * 2 + mm(1, nu, nu) + mm(1, nu, nx) * 2
                 + mm(1, ng, nx) + mm(1, ng, nu)
                 + mm(1, nx, nx) * 2 + mm(1, nx, nu) * 2)
    fwd = (mm(1, nx, nu) + mm(1, nx, nx) + mm(1, nu, nx)
           + mm(1, ng, nx) + mm(1, ng, nu))
    stat = mm(1, nx, nx) + mm(1, nu, nu) + mm(1, nu, nx) * 2 + mm(1, ng, nx)
    return ipm_iters * N * (fact + 2 * (vec + fwd) + stat)


def solve_flops(qp: float, N, nx, nu, nrows, sqp_iters,
                n_alphas: int = 4) -> float:
    """One SQP solve: per iteration the QP, the linearisation (the step's
    Jacobian over nx + nu tangents per stage and the cost Hessian rows) and
    the line-search ladder; ``nrows`` constraint rows per stage
    (``centroidal_solve_flops`` with the QP's count passed in)."""
    lin = N * (2.0 * nx * (nx + nu) * nx + 2.0 * (nx + nu) ** 2 * 4)
    ls = n_alphas * N * 2.0 * (nx * nx + nrows * (nx + nu))
    return sqp_iters * (qp + lin + ls)


def _inv(n):  # Gauss-Jordan on an n x 2n augmented matrix
    return 2.0 * n * n * (n + 1)


def ipm_flops(N, nx, nu, ng, nc, iters) -> float:
    """One fixed-iteration interior-point solve of the IPM kernels: per
    iteration one residual pass, one factorization, two Newton passes and
    one stationarity pass."""
    grads = ((N + 1) * 2 * nx * (nx + ng) + N * 2 * nu * (2 * nx + nu + ng))
    residuals = ((N + 1) * 2 * ng * nx + N * 2 * ng * nu
                 + N * 2 * nx * (nx + nu) + N * 2 * nc * (nx + nu))
    stage = (2 * nx ** 3 + 2 * nx * nx * nu
             + 2 * nu * nu * (ng + nx) + 2 * nu * nx * (ng + nx)
             + 2 * nx * nx * (ng + nx) + _inv(nu)
             + 2 * nu * nu * nx + 2 * nx * nx * nu)
    if nc:
        stage += (4 * nu * nu * nc + 4 * nu * nc * nc + _inv(nc)
                  + 4 * nc * nu * nx + 2 * nc * nc * nx + 2 * nx * nx * nc)
    factorize = N * stage + 2 * nx * nx * ng + N * 2 * nx * nx
    back = 2 * nx * nu + 2 * nu * nu + 2 * nx * nx + 2 * nu * nx
    if nc:
        back += 4 * nu * nc + 2 * nc * nc + 2 * nc * nx
    fwd = 4 * nu * nx + 2 * nx * nx
    newton = (grads + N * (back + fwd) + (N + 1) * 2 * ng * nx
              + N * 2 * ng * nu + 30 * (N + 1) * ng)
    stat = grads + N * (2 * nx * nu + 2 * nx * nx + 2 * nc * (2 * nu + nx))
    lid = N * (2 * nc * nc * nu * 2 + _inv(nc)) if nc else 0
    return float(lid + stat
                 + iters * (residuals + factorize + 2 * newton + stat))


def eq_flops(N, nx, nu, nc) -> float:
    """One equality-constrained Riccati solve of the equality kernels:
    factorization, vector pass and rollout."""
    stage = (4 * nx ** 3 + 2 * nx * nx * nu
             + 2 * nu * nu * nx + 2 * nu * nx * nx + _inv(nu)
             + 4 * nu * nu * nc + 4 * nu * nc * nc + _inv(nc)
             + 4 * nc * nu * nx + 2 * nu * nu * nx + 2 * nc * nc * nx
             + 2 * nx * nx * (nu + nc))
    vec = (4 * nx * nx + 2 * nx * nu + 2 * nu * nu + 4 * nu * nc
           + 2 * nc * nc + 2 * nu * nx + 2 * nc * nx)
    fwd = 4 * nu * nx + 2 * nx * nx
    return float(N * (stage + vec + fwd))


def qp_bytes(shape: dict, outputs: tuple, dtype_bytes: int = 4) -> float:
    """Bytes of one OCP-QP's inputs, each read once, and of ``outputs``
    (names below), each written once, from the problem's shapes."""
    N, nx, nu, ng, nc = (shape[k] for k in ("N", "nx", "nu", "ng", "nc"))
    inputs = (N * (nx * nx + nx * nu + nx)  # A, B, b
              + (N + 1) * (nx * nx + nx) + N * (nu * nu + nu + nu * nx)
              + (N + 1) * ng * (nx + nu + 3)  # C, D, lg, ug, mask
              + N * nc * (nx + nu + 2)  # equality C, D, e, mask
              + nx)  # dx0
    sizes = {"dx": (N + 1) * nx, "du": N * nu,
             "slacks": 4 * (N + 1) * ng,  # s_l, s_u, lam_l, lam_u
             "K": N * nu * nx, "k": N * nu,
             "P": (N + 1) * nx * nx, "p": (N + 1) * nx}
    return float(dtype_bytes * (inputs + sum(sizes[o] for o in outputs)))
