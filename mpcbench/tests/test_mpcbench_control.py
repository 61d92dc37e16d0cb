"""The control comes out not correct: the frozen reference in float32 with
its matrix products at TF32 (``calibrate.control``), put in the program's
place and driven through the whole harness, fails at least one of the
cell's limits, while the program passes them. On the CPU at the cells'
horizons with small batches; on the card (marker ``card``) at the cells'
own sizes, with fewer answers than a run compares."""

import json
import time
from pathlib import Path

import pytest
import torch

from mpcbench import entries, harness
from mpcbench.calibrate import control
from mpcbench.tests import small_cells

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_cells.write(tmp_path_factory.mktemp("control"),
                             full_horizon=True)


def _both(cell, device, seconds, min_calls, seed):
    family = entries.load(cell.config["family"])
    runs = {}
    for side, program in (("program", None), ("control", control(family))):
        runs[side] = harness.run_cell(cell, seed, seconds, False, device,
                                      time.perf_counter(), program=program,
                                      min_calls=min_calls)
    return runs


@pytest.mark.parametrize("name", list(small_cells.SMALL))
def test_control_fails_on_the_cpu(bench, name):
    runs = _both(harness.Cell(name, bench), torch.device("cpu"), 0.5, 4,
                 2 ** 31 + 3)
    assert runs["program"]["correct"] is True, runs["program"]["checks"]
    assert runs["control"]["correct"] is False, runs["control"]["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    cell = harness.Cell(name, ROOT / "BENCHMARK.json")
    runs = _both(cell, card, 1.0, 16, 2 ** 31 + 5)
    assert runs["program"]["correct"] is True, runs["program"]["checks"]
    assert runs["control"]["correct"] is False, runs["control"]["checks"]
