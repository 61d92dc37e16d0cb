"""Run one cell of the benchmark once, on the machine it is started on.

    python3 mpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m mpcbench.run`` from the checkout's root is the same.) The
cell is an entry of ``workloads`` in ``BENCHMARK.json``; its workload file
``mpcbench/workloads/<name>.json`` names the traffic ``kind``
(``mpcbench/traffic/<kind>.py``) and its parameters, its configuration file
names the entry ``family`` (``mpcbench/entries/<family>.py``), and each
metric is read by ``mpcbench/metrics/<name before the first dot>.py``.

One process on one card:

1. set-up: the traffic from ``--seed``, the port's entry point, and the
   calls of the traffic's warm-up, which build the kernels (first run in a
   checkout only) and capture every CUDA graph the window replays;
   ``setup_s`` runs from the process's start to the first timed call;
2. a closed loop with one call in flight for ``--seconds``: each call's
   host time runs from the numpy inputs handed to the entry point to the
   outputs the caller reads, as numpy on the host;
3. with ``--trace 1``, CUDA events around every call of the same window,
   then one ``torch.profiler`` session over the cell's last calls (a
   profiler session raises the host's cost of a graph launch for the rest
   of the process, so it comes last);
4. the check: a sample of the window's answers, drawn from the seed, is
   solved again by the frozen reference (``mpcbench/reference``) in
   float64 on the same inputs; a tick stream's first calls are also
   replayed by the reference from the stream's cold start, each from its
   own previous answer (``replay_*``); each number of ``gaps`` is held
   against the workload's limit.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``), and last ``checks``, each compared number beside its
limit; the same numbers are the last lines of standard error. Progress
lines start with ``#``. Without a card (``torch.cuda.is_available()``
false, or fewer cards than the cell asks for) it exits 1 and prints no
result; ``--device cpu`` runs the same on the CPU, for the tests only.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def fixed_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernels into ``cheeta_mpc_tpu_torch/_build/`` itself)."""
    cache = HERE / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mpcbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help=argparse.SUPPRESS)  # cpu: the tests only
    ap.add_argument("--benchmark", default=str(ROOT / "BENCHMARK.json"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    fixed_cache_dirs()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("run: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from mpcbench import harness
    cell = harness.Cell(args.workload, Path(args.benchmark))
    if args.device == "cuda" and torch.cuda.device_count() < cell.chips:
        print(f"run: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device(args.device),
                              T_START)
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
