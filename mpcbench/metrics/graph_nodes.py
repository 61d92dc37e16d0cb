"""Nodes of the CUDA graph that the window's calls replay (the port's
``utils.cuda_graph`` entry stats; a count, exact)."""


def read(ctx, arg):
    if not ctx.graph_stats or "nodes" not in ctx.graph_stats:
        return None
    return float(ctx.graph_stats["nodes"])
