"""BENCHMARK.json and the harness's data files hold together: names and
units, every workload file and configuration file, a reader for every
metric, a count for every kernel roofline, and what each cell reports."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok")


def _one_line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and \
        "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mpcbench"]
    assert all(_one_line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in BENCH["end_to_end"] else {"layer",
                                                                 "moves"}
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}, m


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["source"].startswith("https://")
    assert _one_line(config["source"]) and _one_line(config["why"])
    assert config["file"].startswith("mpcbench/configs/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert data["dtype"] == "float32" and data["tf32"] is False
    for key in config["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
        assert not any(w in key for w in WIDTH_WORDS)
    importlib.import_module(f"mpcbench.entries.{data['family']}")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert _one_line(cell["why"])
    data = json.loads(
        (ROOT / f"mpcbench/workloads/{cell['name']}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert data[key] == cell[key], key
    importlib.import_module(f"mpcbench.traffic.{data['kind']}")
    assert set(data["check"]["limits"]) and all(
        v > 0 for v in data["check"]["limits"].values())
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_bounds():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = [m for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert _one_line(metric["layer"])
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert _reports(moved, cell), (metric["name"], cell)
    base, _, arg = metric["name"].partition(".")
    reader = importlib.import_module(f"mpcbench.metrics.{base}")
    assert callable(reader.read)
    if base == "roofline_pct":
        count = importlib.import_module(f"mpcbench.counts.{arg}")
        assert count.KERNEL and callable(count.work)
    if "mfu" in base or base.endswith("roofline_pct"):
        assert metric["unit"] == "%"


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_run_seconds_fit_a_full_check():
    """With the full 24 cells a check has to fit into 12 hours."""
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
