"""The convex SRB cells (config ``convex_srb_n10``, family ``convex``) on the
CPU: the frozen reference against the port's convex MPC, the traffic kinds,
both small cells through ``run.py``, the faults that the check must catch
and the entry's section-timer record."""

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
from mpcbench.entries import Entry, convex
from mpcbench.tests import small_cells
from mpcbench.tests.test_mpcbench_faults import _broken
from mpcbench.traffic import Inputs
from mpcbench.traffic._frozen import convex_inputs
from mpcbench.traffic.convex_fleet import grid

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
F64 = torch.float64
SEED = 2 ** 31 + 5151
CONFIG = json.loads((ROOT / "mpcbench/configs/convex_srb_n10.json")
                    .read_text())
SMALL_GRID = {"grid": {"vx": 2, "vy": 1, "yaw_rate": 1, "phases": 2},
              "slopes": [0.0, 0.3], "batch": 8, "pool": 2, "warmup": 2}
CONVEX = {  # as small_cells.SMALL: source cell, config, params, check
    "xsmall.tick": ("convex_srb.tick", {}, {"stream_ticks": 16,
                                            "segment_s": 0.15,
                                            "warmup": 2}, {"sample": 3}),
    "xsmall.fleet8": ("convex_srb.fleet4096", {}, SMALL_GRID,
                      {"sample": 6, "sample_calls": 2}),
}


def _workload(name):
    return json.loads((ROOT / f"mpcbench/workloads/{name}.json")
                      .read_text())


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    with mock.patch.dict(small_cells.SMALL, CONVEX, clear=True):
        return small_cells.write(tmp_path_factory.mktemp("convex"))


def _port(config, dtype=F64):
    """The port's convex MPC on the CPU: the plain versions of K1 (one
    scenario) and K2 (a batch)."""
    from cheeta_mpc_tpu_torch.models.srb import SrbParams
    from cheeta_mpc_tpu_torch.mpc.convex_mpc import (ConvexMpcConfig,
                                                     build_convex_mpc)
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    return build_convex_mpc(
        convex._cfg(config, ConvexMpcConfig, SrbParams, dtype),
        convex._settings(config, IpmSettings), device="cpu")


def _tick_inputs(n, seed=SEED):
    tr = traffic.load("convex_ticks").make(
        CONFIG, _workload("convex_srb.tick")["params"], seed)
    return [tr.inputs(k, None) for k in range(n)]


def _fleet_inputs(seed=SEED, **params):
    p = dict(_workload("convex_srb.fleet4096")["params"], **params)
    return traffic.load("convex_fleet").make(CONFIG, p, seed)


# The plain versions of K1/K2 invert by equilibrated Gauss-Jordan, the
# reference by Cholesky; in float64 the two part by ~1e-16 of the IPM's
# condition (~1/mu_tol = 1e6 at the last iterate, times forces of ~1e2 N),
# so 1e-8 N leaves two orders of room; a departure of the algorithm moves
# the answers by 1e-3 N or more (the faults below).
ATOL = 1e-8


def _compare(got_forces, got_sol, want):
    np.testing.assert_allclose(got_forces.numpy(), want["forces"].numpy(),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_sol.dx.numpy(), want["dx"].numpy(),
                               rtol=0, atol=ATOL)


def test_reference_equals_the_ports_convex_tick():
    """Ticks of the stream one by one, a velocity step among them (each
    segment's first tick follows the previous command)."""
    ref = convex.reference(CONFIG, CPU, F64)
    port = _port(CONFIG)
    for inputs in _tick_inputs(34)[31:34]:
        assert inputs.warm is None and inputs.args[0].shape == (13,)
        f, sol = port(*inputs.args)
        _compare(f, sol, ref(inputs))
    assert float(f[..., 2].sum(-1).mean()) > 50.0  # the stance legs carry it


def test_reference_equals_the_ports_convex_fleet():
    tr = _fleet_inputs(pool=1)
    args = tuple(a[:8] for a in tr.inputs(0, None).args)
    assert args[0].shape == (8, 13) and args[3].shape == (8, 10, 4)
    f, sol = _port(CONFIG)(*args)
    _compare(f, sol, convex.reference(CONFIG, CPU, F64)(Inputs(args, None)))


def test_qp_shape_is_the_ports():
    """The configuration's ``qp_shape`` is the QP that
    ``build_convex_mpc(...).initial_qp`` builds: 20 pyramid rows, no stage
    equality."""
    qp = _port(CONFIG, torch.float32).initial_qp(*_tick_inputs(1)[0].args)
    q = CONFIG["qp_shape"]
    assert (qp.dyn.horizon, qp.dyn.nx, qp.dyn.nu, qp.con.ng) == (
        q["N"], q["nx"], q["nu"], q["ng"])
    assert qp.eq is None and q["nc"] == 0


def test_tick_traffic_is_deterministic_in_the_seed():
    a, b = _tick_inputs(40), _tick_inputs(40)
    c = _tick_inputs(40, SEED + 1)
    for x, y, z in zip(a, b, c):
        for u, v in zip(x.args, y.args):
            np.testing.assert_array_equal(u, v)
    assert any(not np.array_equal(x.args[0], z.args[0]) for x, z in zip(a, c))
    # One node per tick: tick k's table is tick k-1's shifted by one node.
    for x, y in zip(a, a[1:]):
        np.testing.assert_array_equal(y.args[3][:-1], x.args[3][1:])
    # A trot: two diagonal legs stand at every node.
    for x in a:
        assert (x.args[3].sum(-1) == 2).all()


def test_trot_table_equals_the_ports():
    from cheeta_mpc_tpu_torch import examples
    for j in range(10):
        np.testing.assert_array_equal(
            convex_inputs.trot_table(10, 10, j / 10),
            examples.trot_table(10, phase=j))
    np.testing.assert_array_equal(convex_inputs.NOMINAL_FEET,
                                  examples.NOMINAL_FEET)


def test_fleet_holds_every_grid_point_once_per_call():
    params = _workload("convex_srb.fleet4096")["params"]
    points = grid(params)
    assert len(points) == params["batch"] == 4096
    tr, again = _fleet_inputs(pool=2), _fleet_inputs(pool=2)
    seen = []
    for k in range(2):
        x0, x_ref, feet, enable = tr.inputs(k, None).args
        for u, v in zip(tr.inputs(k, None).args, again.inputs(k, None).args):
            np.testing.assert_array_equal(u, v)
        dt = CONFIG["dt"]
        # The grid's axes, read back from each scenario's inputs.
        cmd_w = x_ref[:, 0, 9:11]
        yaw = x_ref[:, 0, 2]
        c, s = np.cos(yaw), np.sin(yaw)
        vx, vy = c * cmd_w[:, 0] + s * cmd_w[:, 1], -s * cmd_w[:, 0] + \
            c * cmd_w[:, 1]
        wz = (x_ref[:, 1, 2] - x_ref[:, 0, 2]) / dt
        slope = -x_ref[:, 0, 1]
        first = enable[:, :, 0]  # LF stands over the cycle's first half
        phase = [next(j for j in range(8) if np.array_equal(
            row, convex_inputs.trot_table(10, 10, j / 8)[:, 0]))
            for row in first]
        got = np.round(np.stack([vx, vy, wz, slope,
                                 np.asarray(phase) / 8], -1), 9)
        want = np.round(points, 9)
        assert len({tuple(r) for r in got}) == len(got) == len(want)
        assert {tuple(r) for r in got} == {tuple(r) for r in want}
        seen.append(got)
    assert not np.array_equal(seen[0], seen[1])  # each call its own order


def _run(args, timeout=900):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "mpcbench/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.mark.parametrize("cell,trace", [("xsmall.tick", 0),
                                        ("xsmall.fleet8", 0),
                                        ("xsmall.tick", 1)])
def test_small_cell_runs_correct(bench, cell, trace):
    p = _run(["--workload", cell, "--seed", str(SEED), "--seconds", "1",
              "--trace", str(trace), "--device", "cpu", "--benchmark",
              str(bench)])
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] > 0
    names = set(out["checks"]) - {"failed"}
    assert names == set(_workload(CONVEX[cell][0])["check"]["limits"])
    # The CPU has no kernel to time: the section shares are left out.
    assert not any(n.startswith("ipm_section_pct") for n in out["metrics"])


def _last_stage_off(family):
    """The family's program with one force of the plan's last stage off by
    1 N in every answer."""
    def make(config, device):
        real = family.program(config, device)

        def call(inputs):
            outs = {k: v.clone() for k, v in real.call(inputs).items()}
            outs["forces"][..., -1, 0, 0] += 1.0
            return outs

        return Entry(call, real.graph_stats)
    return make


@pytest.mark.parametrize("cell,fault", [
    ("xsmall.tick", None), ("xsmall.tick", "stale"),
    ("xsmall.tick", "altered"), ("xsmall.tick", "last_stage"),
    ("xsmall.fleet8", None), ("xsmall.fleet8", "stale"),
    ("xsmall.fleet8", "half_batch"), ("xsmall.fleet8", "altered"),
    ("xsmall.fleet8", "last_stage")])
def test_fault_makes_the_run_incorrect(bench, cell, fault):
    c = harness.Cell(cell, bench)
    program = (None if fault is None else _last_stage_off(convex)
               if fault == "last_stage" else _broken(fault)(convex))
    res = harness.run_cell(c, SEED, 0.5, False, CPU, time.perf_counter(),
                           program=program)
    assert res["correct"] is (fault is None), res["checks"]


def test_gaps_read_the_wrench_and_the_whole_horizon():
    """A force moved between the two stance legs of a trot along their
    diagonal changes no wrench; one moved on a single leg does, in the
    last stage as in the first."""
    want = convex.reference(CONFIG, CPU, F64)(_tick_inputs(1)[0])
    want = {k: v.numpy() for k, v in want.items()}
    base = convex.gaps({"forces": want["forces"], "dx": want["dx"]}, want)
    assert all(v == 0.0 for v in base.values())
    on = np.flatnonzero(want["enable"][0])
    diag = want["arms"][on[1]] - want["arms"][on[0]]
    f = want["forces"].copy()
    f[0, on[0]] -= 0.5 * diag / np.linalg.norm(diag)
    f[0, on[1]] += 0.5 * diag / np.linalg.norm(diag)
    g = convex.gaps({"forces": f, "dx": want["dx"]}, want)
    assert g["force_p99_N"] == g["force_gap_N"] == pytest.approx(
        0.5 * np.abs(diag / np.linalg.norm(diag)).max())
    assert g["wrench_p99"] < 1e-12 and g["wrench_gap"] < 1e-12
    f = want["forces"].copy()
    f[-1, np.flatnonzero(want["enable"][-1])[0], 0] += 1.0
    g = convex.gaps({"forces": f, "dx": want["dx"]}, want)
    assert (g["force_gap_N"], g["force_p99_N"]) == (pytest.approx(1.0),
                                                    pytest.approx(1.0))
    assert g["wrench_p99"] >= 1.0 - 1e-12
    dx = want["dx"].copy()
    dx[-1, 9] += 1e-3  # the last node's velocity
    g = convex.gaps({"forces": want["forces"], "dx": dx}, want)
    assert g["state_p99"] == g["state_gap"] == pytest.approx(1e-3)
    swing = np.flatnonzero(want["enable"][0] == 0)[0]
    f = want["forces"].copy()
    f[0, swing, 2] = 2.0
    g = convex.gaps({"forces": f, "dx": want["dx"]}, want)
    assert (g["force_p99_N"], g["cone_gap_N"], g["wrench_p99"]) == (
        2.0, 2.0, 0.0)


def test_gaps_take_a_high_percentile_and_the_widest_of_a_block():
    """Over a block of answers the ``*_p99`` gaps read their 99th
    percentile: one answer in 200 off by 0.5 N moves them by a fraction of
    that, three in 200 move them by all of it; the widest gaps read the one
    answer."""
    one = {k: v.numpy() for k, v in convex.reference(CONFIG, CPU, F64)(
        _tick_inputs(1)[0]).items()}
    want = {k: np.repeat(v[None], 200, axis=0) for k, v in one.items()}
    stance = np.flatnonzero(one["enable"][-1])[0]
    for bad, low in ((1, True), (3, False)):
        f, dx = want["forces"].copy(), want["dx"].copy()
        f[:bad, -1, stance, 2] += 0.5
        dx[:bad, -1, 5] += 1e-3
        g = convex.gaps({"forces": f, "dx": dx}, want)
        assert (g["force_gap_N"], g["wrench_gap"], g["state_gap"]) == (
            pytest.approx(0.5), pytest.approx(0.5), pytest.approx(1e-3))
        assert (g["force_p99_N"] < 0.5) is low
        assert (g["wrench_p99"] < 0.5) is low
        assert (g["state_p99"] < 1e-3) is low


def test_counts_at_the_srb_shape():
    """PERF.md's SRB figures (K1 8.33 MFLOP per launch, K2 34.1 GFLOP at
    4096), taken at BASELINE config 2's 12 IPM iterations, are what the
    counts give at the convex configuration's ``qp_shape`` and settings:
    one QP per solve, so one launch per call. The pyramid rows count with
    nc = 0: no equality term enters."""
    from mpcbench.counts import K1, K2, _work
    fleet = _workload("convex_srb.fleet4096")
    assert (CONFIG["qp_shape"], CONFIG["solver"]["ipm_iterations"]) == (
        dict(N=10, nx=13, nu=12, ng=20, nc=0), 12)
    assert K1.work(CONFIG, None)[0] / 1e6 == pytest.approx(8.33, abs=0.005)
    assert K2.work(CONFIG, fleet)[0] / 1e9 == pytest.approx(34.1, abs=0.05)
    assert K2.work(CONFIG, fleet)[0] == 4096 * K1.work(CONFIG, None)[0]
    assert _work.ipm_flops(10, 13, 12, 20, 0, 12) < _work.ipm_flops(
        10, 13, 12, 20, 1, 12)
    no_rows = _work.ipm_flops(10, 13, 12, 0, 0, 12)
    assert 0 < no_rows < _work.ipm_flops(10, 13, 12, 20, 0, 12)


RECORD = {"cycles": {}, "share": {"inverse": 0.2, "products": 0.5},
          "kernel_cycles_max_block": 1000, "blocks": 1, "timed_ms": 3.5,
          "untimed_ms": 3.4, "entry": "cheeta_ipm_riccati_single"}


@pytest.mark.parametrize("batch,want", [
    (None, convex.SINGLE_ENTRY), (8, convex.FLEET_ENTRY)])
def test_entry_times_the_calls_kernel_at_first_reading(batch, want):
    """The record is computed once, at its first reading, from the QP of the
    call's inputs; the stats stay a live view of the program's."""
    from cheeta_mpc_tpu_torch.mpc import convex_mpc
    from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati
    stats = {"nodes": 5}
    calls = []

    class _Graphed:  # what ``graphed`` hands back on a card
        def __init__(self, fn):
            self.fn, self.initial_qp = fn, fn.initial_qp

        def __call__(self, *args):
            return self.fn(*args)

        def entry_of(self, *args):
            return mock.Mock(stats=stats)

    real_build = convex_mpc.build_convex_mpc

    def build(cfg, ipm, device):
        return _Graphed(real_build(cfg, ipm, device="cpu"))

    def fake_phase_cycles(entry, qp, settings):
        calls.append((entry, qp, settings))
        return dict(RECORD)

    args = (_tick_inputs(1)[0].args if batch is None else
            tuple(a[:batch] for a in _fleet_inputs(pool=1).inputs(
                0, None).args))
    with mock.patch.object(convex_mpc, "build_convex_mpc", build), \
            mock.patch.object(cuda_ipm_riccati, "phase_cycles",
                              fake_phase_cycles):
        entry = entries.load("convex").program(CONFIG, CPU)
        assert isinstance(entry, Entry)
        view = entry.graph_stats(Inputs(args, None))
        assert view["nodes"] == 5 and calls == []
        stats["stage_ms"] = {"folded": 1}  # the program's later fold
        assert view.get("stage_ms") == {"folded": 1} and calls == []
        assert view["ipm_sections"]["entry"] == want
        assert view["ipm_sections"]["share"] == RECORD["share"]
    assert len(calls) == 1
    entry_name, qp, settings = calls[0]
    assert entry_name == want
    assert (settings.iters, settings.mu_tol) == (12, 1e-6)
    assert qp.con.ng == 20 and qp.eq is None
    assert all(t.is_contiguous() for t in (qp.dyn.A, qp.con.D, qp.dx0))


def test_entry_without_a_graph_has_no_stats():
    """On the CPU nothing is graphed, so there are no stats to extend."""
    entry = convex.program(CONFIG, CPU)
    assert entry.graph_stats(_tick_inputs(1)[0]) is None
