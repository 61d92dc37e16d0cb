"""Nothing that the harness loads is JAX or the JAX package, by top-level
module name compared whole (``cheeta_mpc_tpu_torch``, the port, begins
with ``cheeta_mpc_tpu``); the yardstick (reference, traffic, counts,
metrics) imports nothing of the port; a run refuses to print a result when
one of those modules is loaded."""

import ast
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from mpcbench import harness
from mpcbench.tests import small_cells

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cheeta_mpc_tpu"}
PORT = "cheeta_mpc_tpu_torch"


def _imports(path: Path, top_level_only=False):
    tree = ast.parse(path.read_text())
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in PKG.rglob("*.py") if "_cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    PKG)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("part", ["reference", "traffic", "counts",
                                  "metrics"])
def test_yardstick_imports_nothing_of_the_port(part):
    for path in (PKG / part).rglob("*.py"):
        assert PORT not in set(_imports(path)), path


def test_the_port_is_imported_inside_entry_functions_only():
    for path in [PKG / "harness.py", PKG / "run.py", PKG / "calibrate.py",
                 *(PKG / "entries").glob("*.py")]:
        assert PORT not in set(_imports(path, top_level_only=True)), path


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cheeta_mpc_tpu_torch_x",
                        types.ModuleType("cheeta_mpc_tpu_torch_x"))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.version",
                        types.ModuleType("jaxlib.version"))
    assert harness.loaded_forbidden() == ["jaxlib"]


def test_run_refuses_with_jax_loaded(monkeypatch, tmp_path, capsys):
    bench = small_cells.write(tmp_path)
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    cell = harness.Cell("csmall.tick", bench)
    res = harness.run_cell(cell, 1, 0.2, False, torch.device("cpu"),
                           time.perf_counter())
    assert res is None
    assert "flax" in capsys.readouterr().err


def test_a_run_loads_no_forbidden_module(tmp_path):
    bench = small_cells.write(tmp_path)
    code = ("import sys, time, torch; sys.path.insert(0, %r);"
            "from mpcbench import harness;"
            "c = harness.Cell('lsmall.fleet3', %r);"
            "r = harness.run_cell(c, 5, 0.5, True, torch.device('cpu'),"
            " time.perf_counter());"
            "names = {m.split('.')[0] for m in sys.modules};"
            "print('FORBIDDEN', sorted(names & %r), r['correct'])"
            % (str(ROOT), str(bench), FORBIDDEN))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN [] True" in p.stdout
