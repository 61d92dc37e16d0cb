"""What launching a CUDA graph costs the host, against the graph's size, and
whether a ``torch.profiler`` session in the process changes it (run on a
card; not a test):

    PYTHONPATH=. python3 tests/torch_graph_launch_probe.py

For the legged soft solve at N=67 and the centroidal solve at batch 1 (at
``chip_smoke.py``'s widths and iterations), the graph of one solve and the
chained graphs of 1, 4 and 20 solves (``utils.device_timing``'s
``_chained_loop``): the host ms of one call ending in a host read, the host
ms of the replay call alone (the launch), and the device ms of one replay
by CUDA events around five replays issued back to back; first in a process
where no profiler has run, then again after a ``torch.profiler`` session
(``chip_smoke.py`` starts one before it captures any graph). One JSON line
per path and reading, each figure per solve.
"""

import json
import statistics
import time

import torch

from cheeta_mpc_tpu_torch.examples import (LEGGED_TEST_WEIGHTS, TEST_WEIGHTS,
                                           make_example_inputs,
                                           make_legged_example_inputs)
from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import (CentroidalMpcConfig,
                                                     build_centroidal_solver)
from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                 build_legged_solver)
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
from cheeta_mpc_tpu_torch.utils.cuda_graph import graphed
from cheeta_mpc_tpu_torch.utils.device_timing import (_chained_loop,
                                                      _first_tensor)

CHAINS = (1, 4, 20)


def events_ms(replay, n: int = 5) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_ms(call, n: int) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _first_tensor(call()).cpu()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def launch_ms(graph, n: int = 5) -> float:
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        ts.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(ts)


def probe(name, solve, args, when):
    """Per-solve readings of one graphed solve and of chains of it."""
    out = {"path": name, "when": when}
    for k in (0,) + CHAINS:  # 0: the solve's own graph, not chained
        fn = graphed(solve if k == 0 else _chained_loop(solve, k), "cuda")
        fn(*args)
        graph = next(iter(fn.graphs.values())).graph
        per = max(k, 1)
        out[f"chain{k}"] = {
            "nodes": next(iter(fn.graphs.values())).stats["nodes"],
            "host_ms": host_ms(lambda: fn(*args), 20 if k < 20 else 5) / per,
            "launch_ms": launch_ms(graph) / per,
            "device_ms": events_ms(graph.replay) / per}
    print(json.dumps(out), flush=True)


def main() -> None:
    from torch.profiler import ProfilerActivity, profile
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    lcfg = LeggedMpcConfig(horizon=67, cone_mode="soft", **LEGGED_TEST_WEIGHTS)
    legged = build_legged_solver(lcfg, ScpSettings(iterations=1))
    ccfg = CentroidalMpcConfig(horizon=10, weights=TEST_WEIGHTS)
    scp = ScpSettings(iterations=2, ipm=IpmSettings(iters=10))
    centroidal = build_centroidal_solver(ccfg, scp)
    paths = (("legged_soft_batch1", legged,
              make_legged_example_inputs(lcfg).args),
             ("centroidal_batch1", centroidal, make_example_inputs(ccfg)))
    for when in ("before_profiler", "after_profiler"):
        if when == "after_profiler":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                torch.ones(1, device="cuda").sum()
                torch.cuda.synchronize()
        for name, solve, inputs in paths:
            args = tuple(torch.as_tensor(a, dtype=torch.float32,
                                         device="cuda") for a in inputs)
            probe(name, solve, args, when)


if __name__ == "__main__":
    main()
