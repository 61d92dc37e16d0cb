"""Readings that a cell's limits are set from, on the card, in one process:

    python3 mpcbench/calibrate.py --workload <name> --seconds <s> \
        --seeds 1,2,... --control-seeds 101,102,... [--out FILE]

For each of ``--seeds`` a run of the program as ``run.py`` makes it, with a
short window, and for each of ``--control-seeds`` the same run with the
control in the program's place: the frozen reference computed in float32
with every matrix product at TF32 (``reference/tf32.py``), the nearest
precision below the configuration's float32 with TF32 off. Each run's compared numbers
(``gaps``) are printed as one JSON line; the last line gives, per number,
the largest that the program read (the lower reading) and the smallest
that the control read (the upper one). The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(family):
    """The control as an entry: the reference in float32 with its matrix
    products at TF32, eager."""
    import torch
    from mpcbench.entries import Entry
    from mpcbench.reference.tf32 import Tf32Products

    def make(config, device):
        ref = family.reference(config, device, torch.float32)

        def call(inputs):
            with Tf32Products():
                return ref(inputs)

        return Entry(call=call, graph_stats=lambda inputs: None)

    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mpcbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--benchmark", default=str(ROOT / "BENCHMARK.json"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from mpcbench.run import fixed_cache_dirs
    fixed_cache_dirs()
    import torch
    from mpcbench import entries, harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.Cell(args.workload, Path(args.benchmark))
    family = entries.load(cell.config["family"])
    dev = torch.device(args.device)
    spec = cell.workload["check"]
    # As many answers to compare as a run of the cell compares.
    min_calls = spec.get("sample_calls", spec["sample"])
    lines = []
    runs = ([("program", int(s), None) for s in args.seeds.split(",") if s]
            + [("control", int(s), control(family))
               for s in args.control_seeds.split(",") if s])
    for side, seed, program in runs:
        t0 = time.perf_counter()
        gaps: dict = {}
        res = harness.run_cell(cell, seed, args.seconds, False, dev, t0,
                               program=program, readings=gaps,
                               min_calls=min_calls)
        line = {"side": side, "seed": seed, "correct": res["correct"],
                "attempted": res["attempted"],
                "gaps": gaps,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()
                            if k != "setup_s"},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    names = sorted({k for ln in lines for k in ln["gaps"]})
    summary = {"workload": args.workload, "card": harness.card_line()
               if args.device == "cuda" else "cpu"}
    for name in names:
        prog = [ln["gaps"][name] for ln in lines if ln["side"] == "program"]
        ctrl = [ln["gaps"][name] for ln in lines if ln["side"] == "control"]
        summary[name] = {"lower": max(prog) if prog else None,
                         "upper": min(ctrl) if ctrl else None,
                         "program": prog, "control": ctrl}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in
                                            lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
