"""One centroidal MPC solve: ``centroidal_solve_flops`` (SQP iterations of
linearisation, the inequality-IPM QP and the line-search ladder)."""

from mpcbench.counts._work import riccati_ipm_flops, solve_flops


def flops(config: dict) -> float:
    q, s = config["qp_shape"], config["solver"]
    qp = riccati_ipm_flops(q["N"], q["nx"], q["nu"], q["ng"],
                           s["ipm_iterations"])
    return solve_flops(qp, q["N"], q["nx"], q["nu"], q["ng"],
                       s["sqp_iterations"], len(s["alphas"]))
