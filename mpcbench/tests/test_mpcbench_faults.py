"""The check catches a broken timed path: each run below drives the whole
harness on the CPU (it skips only the look for a card) with the program's
entry point broken underneath, once for each fault that the cells can
have, and sees ``correct`` come out false; the unbroken entry passes. The
exchange between cards does not exist in these one-card cells."""

import time

import pytest
import torch

from mpcbench import entries, harness
from mpcbench.tests import small_cells

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_cells.write(tmp_path_factory.mktemp("faults"))


def _broken(fault):
    """The family's program with ``fault`` applied to every call's
    outputs."""

    def wrap(family):
        def make(config, device):
            real = family.program(config, device)
            last = {}

            def call(inputs):
                outs = real.call(inputs)
                if fault == "stale":  # the solve hands back its old state
                    stale = last.get("outs", outs)
                    last["outs"] = outs
                    return stale
                outs = {k: v.clone() for k, v in outs.items()}
                force = "contact_force" if "contact_force" in outs else \
                    "forces"
                if fault == "half_batch":  # rows B/2: the mean of the rest
                    for v in outs.values():
                        h = v.shape[0] // 2
                        v[h:] = v[:h].mean(dim=0, keepdim=True)
                elif fault == "altered":  # one force per answer off by 1 N
                    outs[force][..., 0, 0, 0] += 1.0
                return outs

            return entries.Entry(call, real.graph_stats)
        return make
    return wrap


def _run(bench, cell, fault=None, seed=2 ** 31 + 99):
    c = harness.Cell(cell, bench)
    family = entries.load(c.config["family"])
    program = None if fault is None else _broken(fault)(family)
    return harness.run_cell(c, seed, 1.0, False, CPU, time.perf_counter(),
                            program=program)


@pytest.mark.parametrize("cell,fault", [
    ("csmall.tick", None), ("csmall.tick", "stale"),
    ("csmall.tick", "altered"),
    ("csmall.fleet4", None), ("csmall.fleet4", "stale"),
    ("csmall.fleet4", "half_batch"), ("csmall.fleet4", "altered"),
    ("lsmall.tick", None), ("lsmall.tick", "stale"),
    ("lsmall.tick", "altered"),
    ("lsmall.fleet3", None), ("lsmall.fleet3", "stale"),
    ("lsmall.fleet3", "half_batch"), ("lsmall.fleet3", "altered")])
def test_fault_makes_the_run_incorrect(bench, cell, fault):
    res = _run(bench, cell, fault)
    assert res["correct"] is (fault is None), res["checks"]
