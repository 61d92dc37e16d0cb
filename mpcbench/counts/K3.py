"""K3, the batch-1 equality-Riccati kernel: one launch per SQP iteration of
one problem with stage equalities and no inequality row."""

from mpcbench.counts._work import eq_flops, qp_bytes

KERNEL = "eq_riccati_single_kernel"
OUTPUTS = ("dx", "du", "K", "k", "P", "p")


def work(config: dict, workload: dict):
    q = config["qp_shape"]
    return (eq_flops(q["N"], q["nx"], q["nu"], q["nc"]),
            qp_bytes(q, OUTPUTS))
