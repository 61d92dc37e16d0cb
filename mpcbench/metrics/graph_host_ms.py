"""Host ms of one phase of the graphed entry point's call, the program's
own timers over the replays made while no profiler recorded (the
``host_ms`` counters of the ``utils.cuda_graph`` entry stats): ``inputs``
(from the call to the graph's launch: the call's signature, the staging
copy into pinned memory and the copies to the card issued) and
``launch`` (the graph's launch).

``graph_host_ms.<phase>.<cell kind>``; the kind only tells the cells
apart."""


def read(ctx, arg):
    host = (ctx.graph_stats or {}).get("host_ms")
    phase = arg.partition(".")[0]
    if not host or phase not in host:
        return None
    return float(host[phase])
