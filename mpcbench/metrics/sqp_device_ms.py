"""Device ms per call in kernels other than the cell's QP kernels (the SQP,
model, cost and constraint layer), by kernel name in the profiler's trace.
The workload file names its QP kernels under ``qp_kernels`` by their count
modules (``mpcbench/counts/<K>.py``), so a count added later changes no
cell that does not name it."""

from mpcbench.counts import load


def read(ctx, arg):
    if ctx.trace is None or not ctx.trace.kernels():
        return None
    qp = [load(k).KERNEL for k in ctx.workload.get("qp_kernels", ())]
    rest = ctx.trace.kernels(lambda n: not any(k in n for k in qp))
    return sum(dur for _, _, dur, _ in rest) * 1e-3 / ctx.trace.calls
