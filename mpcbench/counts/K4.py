"""K4, the fleet equality-Riccati kernel: one launch per SQP iteration
solves the whole batch."""

from mpcbench.counts._work import eq_flops, qp_bytes

KERNEL = "eq_riccati_fleet_kernel"
OUTPUTS = ("dx", "du", "K", "k")


def work(config: dict, workload: dict):
    q = config["qp_shape"]
    b = workload["params"]["batch"]
    return (b * eq_flops(q["N"], q["nx"], q["nu"], q["nc"]),
            b * qp_bytes(q, OUTPUTS))
