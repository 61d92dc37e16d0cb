"""The command end to end on the CPU (``--device cpu``, the tests' flag) on
throwaway cells that a later change could add as files alone; without the
flag and without a card it fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mpcbench.tests import small_cells

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(args, cwd=ROOT, timeout=600):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "mpcbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_cells.write(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,trace", [
    ("csmall.tick", 0), ("csmall.fleet4", 0), ("lsmall.tick", 0),
    ("lsmall.fleet3", 0), ("csmall.tick", 1), ("lsmall.fleet3", 1)])
def test_cpu_run_prints_one_result_line(bench, cell, trace):
    p = _run(["--workload", cell, "--seed", str(2 ** 31 + 12345),
              "--seconds", "2", "--trace", str(trace), "--device", "cpu",
              "--benchmark", str(bench)])
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    assert all(ln.startswith("#") for ln in lines[:-1])
    out = json.loads(lines[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert out["device"]["platform"] == "cpu"
    checks = out["checks"]
    err = p.stderr.strip().splitlines()[-len(checks):]
    assert [ln.split()[0] for ln in err] == list(checks)
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        names = set(out["metrics"])
        assert "setup_s" in names and len(names) >= 2
        for m in out["metrics"].values():
            assert set(m) == {"value", "unit"}


def test_same_seed_same_inputs(bench):
    from mpcbench import harness, traffic
    for name in small_cells.SMALL:
        cell = harness.Cell(name, bench)
        make = traffic.load(cell.workload["kind"]).make
        a = make(cell.config, cell.workload["params"], 2 ** 31 + 7)
        b = make(cell.config, cell.workload["params"], 2 ** 31 + 7)
        c = make(cell.config, cell.workload["params"], 3)
        for k in (0, 5):
            for x, y, z in zip(a.inputs(k, None).args, b.inputs(k, None).args,
                               c.inputs(k, None).args):
                assert (x == y).all() and x.shape == z.shape


def test_no_card_no_result():
    p = _run(["--workload", "centroidal.tick", "--seed", "1", "--seconds",
              "1", "--trace", "0"], timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "mpcbench", tmp_path / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = _run(["--workload", "centroidal.tick", "--seed", "1", "--seconds",
              "1", "--trace", "0", "--device", "cpu"], cwd=tmp_path,
             timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout
