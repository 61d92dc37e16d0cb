"""Throwaway cells at sizes a CPU test run holds: the real configurations
and traffic with shorter horizons, smaller batches, streams and samples,
written with a BENCHMARK.json of their own into a temporary directory, as
a later change adds a cell: files and entries only."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

SMALL = {  # name: (source cell, config changes, params changes, check)
    "csmall.tick": ("centroidal.tick", {"horizon": 4},
                    {"stream_ticks": 16, "warmup": 3},
                    {"sample": 4}),
    "csmall.fleet4": ("centroidal.fleet1024", {"horizon": 4},
                      {"batch": 4, "pool": 2, "warmup": 2},
                      {"sample": 6, "sample_calls": 2}),
    "lsmall.tick": ("legged_soft.tick", {"horizon": 8},
                    {"stream_ticks": 16, "warmup": 3},
                    {"sample": 4}),
    "lsmall.fleet3": ("legged_soft.fleet512", {"horizon": 8},
                      {"batch": 3, "pool": 2, "warmup": 2},
                      {"sample": 4, "sample_calls": 2}),
}


def _shape(config):
    q = dict(config["qp_shape"], N=config["horizon"])
    return q


def write(tmp: Path, full_horizon: bool = False) -> Path:
    """The throwaway benchmark in ``tmp``; returns its BENCHMARK.json. With
    ``full_horizon`` the configurations keep their own horizons (N=10 and
    67), at which the control parts from the program as on the card."""
    bench = json.loads(json.dumps(BENCH))
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    (tmp / "mpcbench/configs").mkdir(parents=True, exist_ok=True)
    (tmp / "mpcbench/workloads").mkdir(parents=True, exist_ok=True)
    for name, (src, cfg_changes, params, check) in SMALL.items():
        cell = dict(cells[src], name=name)
        cfg_name = cell["config"] + "_small"
        if cfg_name not in configs:
            entry = dict(configs[cell["config"]], name=cfg_name,
                         file=f"mpcbench/configs/{cfg_name}.json")
            config = json.loads((ROOT / configs[cell["config"]]["file"])
                                .read_text())
            config.update({} if full_horizon else cfg_changes,
                          name=cfg_name)
            config["qp_shape"] = _shape(config)
            (tmp / entry["file"]).write_text(json.dumps(config))
            configs[cfg_name] = entry
            bench["configs"].append(entry)
        cell["config"] = cfg_name
        bench["workloads"].append(cell)
        wl = json.loads((ROOT / f"mpcbench/workloads/{src}.json").read_text())
        wl.update(config=cfg_name)
        wl["params"].update(params)
        wl["check"].update(check)
        (tmp / f"mpcbench/workloads/{name}.json").write_text(json.dumps(wl))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if src in m.get("workloads", ()):
                m["workloads"].append(name)
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
