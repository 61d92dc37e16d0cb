"""A QP kernel's share of its roofline: the least time the card could take
for one launch, the larger of its operations over the f32 peak and its
bytes over the HBM bandwidth (``mpcbench/counts/<kernel>.py``, from the
problem's shapes), over the profiled time per launch."""

from mpcbench.counts import load
from mpcbench.metrics import F32_FLOPS, HBM_BYTES_PER_S


def read(ctx, arg):
    if ctx.trace is None:
        return None
    count = load(arg)
    launches = ctx.trace.kernels(lambda n: count.KERNEL in n)
    if not launches:
        return None
    per_launch_s = sum(d for _, _, d, _ in launches) * 1e-6 / len(launches)
    flops, nbytes = count.work(ctx.config, ctx.workload)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"# roofline_pct.{arg}: {count.KERNEL} {len(launches)} launches, "
          f"{per_launch_s * 1e3:.4f} ms each; bound {max(t_ops, t_bytes)
          * 1e3:.6f} ms by {by} ({flops:.4g} operations, {nbytes:.4g} "
          "bytes)", flush=True)
    return 100.0 * max(t_ops, t_bytes) / per_launch_s
