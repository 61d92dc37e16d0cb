"""The legged pyramid cells (config ``legged_pyramid_n67``, family
``legged_ipm``) on the CPU, at horizon 8 and, for the faults, at 67: the
frozen reference against the port's pyramid path, both small cells through
``run.py``, two faults that the check must catch, the entry's
section-timer record and its reader."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from mpcbench import entries, harness, traffic
from mpcbench.entries import Entry, legged, legged_ipm
from mpcbench.harness import Ctx
from mpcbench.metrics import ipm_section_pct
from mpcbench.tests import small_cells

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
F64 = torch.float64
SEED = 2 ** 31 + 4242
CLASSES = ("inverse", "products", "sweeps", "gradients", "bulk",
           "stage_loads", "elementwise")
PYRAMID = {  # as small_cells.SMALL: source cell, config, params, check
    "psmall.tick": ("legged_pyramid.tick", {"horizon": 8},
                    {"stream_ticks": 16, "warmup": 3}, {"sample": 4}),
    "psmall.fleet3": ("legged_pyramid.fleet512", {"horizon": 8},
                      {"batch": 3, "pool": 2, "warmup": 2},
                      {"sample": 4, "sample_calls": 2}),
}


def _write(tmp, full_horizon=False):
    with mock.patch.dict(small_cells.SMALL, PYRAMID, clear=True):
        return small_cells.write(tmp, full_horizon=full_horizon)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("pyramid"))


@pytest.fixture(scope="module")
def bench67(tmp_path_factory):
    """The small cells at the configuration's own horizon, N=67."""
    return _write(tmp_path_factory.mktemp("pyramid67"), full_horizon=True)


def _port(config, dtype=F64):
    """The port's solver of the configuration on the CPU, where the QP
    backend of the cells (``riccati_kernel``) runs the kernels' plain
    versions: K1's for one problem, K2's for a batch."""
    from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
        QuadrupedDescription
    from cheeta_mpc_tpu_torch.models.srbd_legged import SrbdParams
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                     build_legged_solver)
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    cfg = legged._cfg(config, LeggedMpcConfig, QuadrupedDescription,
                      SrbdParams, dtype)
    return build_legged_solver(
        cfg, legged._settings(config, ScpSettings, IpmSettings),
        device="cpu")


def _outputs(sol):
    return {n: getattr(sol, n).numpy() for n in legged.OUTPUTS}


# The kernels' plain versions invert by equilibrated Gauss-Jordan, the
# reference by Cholesky; in float64 the two inverses part by ~1e-16 of the
# IPM's condition (up to ~1/mu_tol = 1e4 at the last iterate, times the
# force scale of ~1e2 N), so 1e-9 leaves two orders of room; a departure
# of the algorithm moves the answers by 1e-3 or more (the faults below).
ATOL = 1e-9


def test_reference_equals_the_ports_pyramid_tick(bench):
    """A tick stream: the cold first tick, then three ticks each
    warm-started from the port's previous answer, as the harness makes
    them."""
    cell = harness.Cell("psmall.tick", bench)
    ref = legged.reference(cell.config, CPU, F64)
    port = _port(cell.config)
    tr = traffic.load(cell.workload["kind"]).make(
        cell.config, cell.workload["params"], SEED)
    prev = None
    for k in range(4):
        inputs = tr.inputs(k, prev)
        assert (inputs.warm is None) is (k == 0)
        want = {n: v.numpy() for n, v in ref(inputs).items()}
        got = _outputs(port(*inputs.args, warm=inputs.warm))
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=ATOL)
        prev = got
    assert np.abs(prev["forces"]).max() > 1.0  # stance legs carry weight


def test_reference_equals_the_ports_pyramid_fleet(bench):
    cell = harness.Cell("psmall.fleet3", bench)
    ref = legged.reference(cell.config, CPU, F64)
    port = _port(cell.config)
    tr = traffic.load(cell.workload["kind"]).make(
        cell.config, cell.workload["params"], SEED)
    for k in range(2):
        inputs = tr.inputs(k, None)
        assert inputs.args[0].shape[0] == 3
        want = {n: v.numpy() for n, v in ref(inputs).items()}
        got = _outputs(port(*inputs.args))
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=ATOL)


def test_qp_shape_is_the_ports():
    """The configuration's ``qp_shape`` at N=67 is the QP the port builds:
    20 pyramid rows and 16 stage-equality rows per node."""
    config = json.loads(
        (ROOT / "mpcbench/configs/legged_pyramid_n67.json").read_text())
    params = json.loads((ROOT / "mpcbench/workloads/legged_pyramid.tick.json")
                        .read_text())["params"]
    tr = traffic.load("legged_ticks").make(config, params, 1)
    qp = _port(config).initial_qp(*tr.inputs(0, None).args)
    q = config["qp_shape"]
    assert (qp.dyn.horizon, qp.dyn.nx, qp.dyn.nu, qp.con.ng, qp.eq.nc) == (
        q["N"], q["nx"], q["nu"], q["ng"], q["nc"])


def _run(args, timeout=600):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "mpcbench/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.mark.parametrize("cell,trace", [("psmall.tick", 0),
                                        ("psmall.fleet3", 0),
                                        ("psmall.tick", 1)])
def test_small_cell_runs_correct(bench, cell, trace):
    p = _run(["--workload", cell, "--seed", str(SEED), "--seconds", "2",
              "--trace", str(trace), "--device", "cpu", "--benchmark",
              str(bench)])
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] > 0
    names = set(out["checks"]) - {"failed"}
    assert names == set(json.loads((ROOT / "mpcbench/workloads" / (
        PYRAMID[cell][0] + ".json")).read_text())["check"]["limits"])
    # The CPU has no kernel to time: the section shares are left out.
    assert not any(n.startswith("ipm_section_pct") for n in out["metrics"])


def _faulty(change):
    """The family's program built from the configuration with ``change``
    applied; the reference keeps the configuration as it is."""

    def make(config, device):
        return legged_ipm.program(change(json.loads(json.dumps(config))),
                                  device)

    return make


def _ipm_iterations(n):
    def change(config):
        config["solver"]["ipm_iterations"] = n
        return config

    return change


def _soft_cone(config):
    config["cone_mode"] = "soft"
    return config


# At N=67 (the f64 reference on seed SEED, on a CPU): a cold problem's IPM
# reaches its tolerance within 3 iterations, where it stops moving, and its
# answer lies 7.3e-4 N from the soft cone's; a warm tick's needs 5-6
# iterations, lies ~4 N from its 3-iteration answer and 0.11 N from the
# soft cone's. At N=8 even the warm ticks converge within 3 iterations, so
# the faults run at the cells' own horizon. The fleet's problems are cold:
# its IPM fault is a cut to 1 iteration (0.018 N), and its check cannot
# tell the soft cone (7.3e-4 N) from the pyramid under its limit of 2e-3 N.
@pytest.mark.parametrize("cell,fault", [
    ("psmall.tick", None), ("psmall.tick", _ipm_iterations(3)),
    ("psmall.tick", _soft_cone),
    ("psmall.fleet3", None), ("psmall.fleet3", _ipm_iterations(1))],
    ids=["tick", "tick-ipm_3_iterations", "tick-soft_cone", "fleet",
         "fleet-ipm_1_iteration"])
def test_fault_makes_the_run_incorrect(bench67, cell, fault):
    c = harness.Cell(cell, bench67)
    program = None if fault is None else _faulty(fault)
    res = harness.run_cell(c, SEED, 1.0, False, CPU, time.perf_counter(),
                           program=program)
    assert res["correct"] is (fault is None), res["checks"]


def _ctx(graph_stats):
    return Ctx(config={}, workload={}, batch=1, host_ms=[1.0],
               device_ms=None, window_s=1.0, setup_s=1.0,
               graph_stats=graph_stats, trace=None)


RECORD = {"cycles": {c: 10 * (i + 1) for i, c in enumerate(CLASSES)},
          "share": {"inverse": 0.4012, "products": 0.2, "sweeps": 0.15,
                    "gradients": 0.1, "bulk": 0.05, "stage_loads": 0.04,
                    "elementwise": 0.03},
          "kernel_cycles_max_block": 1000, "blocks": 1, "timed_ms": 34.0,
          "untimed_ms": 33.8, "entry": "cheeta_ipm_riccati_single"}


def test_ipm_section_pct_reads_each_class(capsys):
    ctx = _ctx({"nodes": 10, "ipm_sections": RECORD})
    got = {c: ipm_section_pct.read(ctx, f"{c}.latency") for c in CLASSES}
    assert got == pytest.approx({c: 100.0 * v
                                 for c, v in RECORD["share"].items()})
    assert sum(got.values()) == pytest.approx(97.12)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("# ipm_section_pct")]
    assert len(lines) == 1 and "sum to 97.12 %" in lines[0]


@pytest.mark.parametrize("stats", [None, {}, {"nodes": 10},
                                   {"ipm_sections": None},
                                   {"ipm_sections": {"share": {}}}])
def test_ipm_section_pct_none_without_a_record(stats):
    assert ipm_section_pct.read(_ctx(stats), "inverse.throughput") is None


@pytest.mark.parametrize("cell,want", [
    ("psmall.tick", legged_ipm.SINGLE_ENTRY),
    ("psmall.fleet3", legged_ipm.FLEET_ENTRY)])
def test_entry_times_the_calls_kernel_at_first_reading(bench, cell, want):
    """The record is computed once, at its first reading, from the QP that
    the call solves first; the stats stay a live view of the program's."""
    from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati
    c = harness.Cell(cell, bench)
    stats = {"nodes": 7}
    calls = []

    def fake_phase_cycles(entry, qp, settings):
        calls.append((entry, qp, settings))
        return dict(RECORD)

    def graphed(config, device):
        real = legged.program(config, device)
        return Entry(real.call, lambda inputs: stats)

    tr = traffic.load(c.workload["kind"]).make(c.config,
                                               c.workload["params"], SEED)
    with mock.patch.object(legged_ipm, "_graphed_program", graphed), \
            mock.patch.object(cuda_ipm_riccati, "phase_cycles",
                              fake_phase_cycles):
        entry = entries.load("legged_ipm").program(c.config, CPU)
        view = entry.graph_stats(tr.inputs(0, None))
        assert view["nodes"] == 7 and "stage_ms" not in view
        assert calls == []
        stats["stage_ms"] = {"folded": 1}  # the program's later fold
        assert view.get("stage_ms") == {"folded": 1}
        assert calls == []
        assert view["ipm_sections"]["entry"] == want
        assert view.get("ipm_sections")["share"] == RECORD["share"]
    assert len(calls) == 1
    entry_name, qp, settings = calls[0]
    assert entry_name == want
    assert settings.iters == c.config["solver"]["ipm_iterations"]
    assert qp.con.ng == 20 and qp.eq.nc == 16
    assert all(t.is_contiguous() for t in (qp.dyn.A, qp.con.D, qp.eq.C))


def test_entry_without_a_graph_has_no_stats(bench):
    """On the CPU nothing is graphed, so there are no stats to extend."""
    c = harness.Cell("psmall.tick", bench)
    tr = traffic.load(c.workload["kind"]).make(c.config,
                                               c.workload["params"], SEED)
    entry = legged_ipm.program(c.config, CPU)
    assert entry.graph_stats(tr.inputs(0, None)) is None
