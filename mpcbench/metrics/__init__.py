"""Metric readers, one module per metric name up to its first dot.

``read(ctx, arg) -> float | None`` takes the metric from the run's
:class:`mpcbench.harness.Ctx` (host clock, CUDA events, the profiler's
trace, the graph's counters); ``arg`` is the part of the name after the
first dot (``K1`` of ``roofline_pct.K1``; ``latency`` of
``graph_nodes.latency``, which only tells the cells apart). A reader that
finds nothing to read returns None and the metric is left out of the line;
a share of a roofline or a peak is never given as 0 for want of a reading.
"""

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): f32
# outside the tensor cores, and HBM3.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
