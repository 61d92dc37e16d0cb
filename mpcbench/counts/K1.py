"""K1, the batch-1 interior-point kernel: one launch per SQP iteration of
one problem."""

from mpcbench.counts._work import ipm_flops, qp_bytes

KERNEL = "ipm_riccati_single_kernel"
OUTPUTS = ("dx", "du", "slacks", "K", "k", "P", "p")


def work(config: dict, workload: dict):
    q, s = config["qp_shape"], config["solver"]
    flops = ipm_flops(q["N"], q["nx"], q["nu"], q["ng"], q["nc"],
                      s["ipm_iterations"])
    return flops, qp_bytes(q, OUTPUTS)
