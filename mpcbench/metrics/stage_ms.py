"""Device ms per call of one stage of the solve, timed inside the replayed
CUDA graph by the program's own events (the ``stage_ms`` record in the
``utils.cuda_graph`` entry stats): ``start`` (before the first SQP stage),
``linearize``, ``qp``, ``line_search`` (summed over the SQP iterations)
and ``finish`` (after the first stage, outside every stage). They are
read from the window's last call, the one replay before the profiler's
session: the program folds an unprofiled replay's events in at the first
profiled call, so the profiler's own cost on the replays it records is
not in them.

``stage_ms.<stage>.<cell kind>``; the kind only tells the cells apart."""

import numpy as np


def read(ctx, arg):
    stage = arg.partition(".")[0]
    rec = (ctx.graph_stats or {}).get("stage_ms")
    if not rec or not rec.get("folded"):
        return None
    ms = rec["ms"]
    name = next((n for n in ms if n == stage or n.endswith("." + stage)),
                None)
    if name is None:
        return None
    if name == next(iter(ms)):  # one line per run, beside the first stage
        kernels = (sum(d for _, _, d, _ in ctx.trace.kernels()) * 1e-3
                   / ctx.trace.calls if ctx.trace is not None else None)
        span = (float(np.median(ctx.device_ms)) if ctx.device_ms
                else None)
        print(f"# stage_ms: replays folded {rec['folded']}, skipped "
              f"{rec['skipped']}; the {len(ms)} stages sum to "
              f"{sum(ms.values()):.4f} ms per call; profiled kernels "
              f"{kernels} ms per call; median event-timed device span "
              f"{span} ms", flush=True)
    return ms[name]
