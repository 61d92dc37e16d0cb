"""K2, the fleet interior-point kernel: one launch per SQP iteration solves
the whole batch."""

from mpcbench.counts._work import ipm_flops, qp_bytes

KERNEL = "ipm_riccati_fleet_kernel"
OUTPUTS = ("dx", "du", "slacks")


def work(config: dict, workload: dict):
    q, s = config["qp_shape"], config["solver"]
    b = workload["params"]["batch"]
    flops = ipm_flops(q["N"], q["nx"], q["nu"], q["ng"], q["nc"],
                      s["ipm_iterations"])
    return b * flops, b * qp_bytes(q, OUTPUTS)
