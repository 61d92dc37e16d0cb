"""The readers of the program's own stage and host timers
(``stage_ms``, ``graph_host_ms``): a value from a hand-made context, None
where the graph's stats lack the key (as on the CPU, or with a program
that has no such timers). On the card (marker ``card``): the five stages
of one replay of the legged tick's graph against CUDA events around
``graph.replay()``."""

import json
from pathlib import Path

import pytest

from mpcbench.harness import Ctx, Trace
from mpcbench.metrics import graph_host_ms, stage_ms

ROOT = Path(__file__).resolve().parents[2]
STAGES = {"start": 0.5, "sqp.linearize": 1.0, "sqp.qp": 2.0,
          "sqp.line_search": 0.75, "finish": 0.25}


def _ctx(graph_stats, trace=None, device_ms=None):
    return Ctx(config={}, workload={}, batch=1, host_ms=[1.0, 1.0],
               device_ms=device_ms, window_s=1.0, setup_s=1.0,
               graph_stats=graph_stats, trace=trace)


def test_stage_ms_reads_each_stage(capsys):
    trace = Trace(ops=[("k", 0.0, 3000.0, True), ("k", 3000.0, 1000.0, True),
                       ("copy", 4000.0, 50.0, False)],
                  spans=[], window=(0.0, 5000.0), calls=2)
    stats = {"nodes": 10, "stage_ms": {"folded": 1, "skipped": 0,
                                       "ms": dict(STAGES)}}
    ctx = _ctx(stats, trace, [4.5, 4.6, 4.4])
    got = {s: stage_ms.read(ctx, f"{s}.latency")
           for s in ("start", "linearize", "qp", "line_search", "finish")}
    assert got == {"start": 0.5, "linearize": 1.0, "qp": 2.0,
                   "line_search": 0.75, "finish": 0.25}
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("# stage_ms")]
    assert len(lines) == 1
    assert "replays folded 1, skipped 0" in lines[0]
    assert "sum to 4.5000 ms" in lines[0]
    assert "profiled kernels 2.0 ms" in lines[0]
    assert "device span 4.5 ms" in lines[0]


@pytest.mark.parametrize("stats", [
    None, {}, {"nodes": 10},
    {"stage_ms": {"folded": 0, "skipped": 3, "ms": {}}},
    {"stage_ms": {"folded": 2, "skipped": 0, "ms": {"start": 1.0}}}])
def test_stage_ms_none_without_a_reading(stats):
    assert stage_ms.read(_ctx(stats), "qp.throughput") is None


def test_graph_host_ms_reads_each_phase():
    stats = {"host_ms": {"inputs": 0.061, "launch": 0.024, "replays": 900}}
    json.dumps(stats)
    assert graph_host_ms.read(_ctx(stats), "inputs.latency") == 0.061
    assert graph_host_ms.read(_ctx(stats), "launch.throughput") == 0.024


@pytest.mark.parametrize("stats", [None, {}, {"nodes": 10},
                                   {"host_ms": {"inputs": 0.06}}])
def test_graph_host_ms_none_without_a_reading(stats):
    assert graph_host_ms.read(_ctx(stats), "launch.latency") is None


@pytest.mark.card
def test_stages_of_one_replay_against_events_around_it(card):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
        QuadrupedDescription
    from cheeta_mpc_tpu_torch.models.srbd_legged import SrbdParams
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                     build_legged_solver)
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    from cheeta_mpc_tpu_torch.utils.cuda_graph import graphed
    from mpcbench import harness, traffic
    from mpcbench.entries import legged

    cell = harness.Cell("legged_soft.tick", ROOT / "BENCHMARK.json")
    cfg = legged._cfg(cell.config, LeggedMpcConfig, QuadrupedDescription,
                      SrbdParams, torch.float32)
    solve = graphed(build_legged_solver(
        cfg, legged._settings(cell.config, ScpSettings, IpmSettings),
        device=card), card)
    inputs = traffic.load(cell.workload["kind"]).make(
        cell.config, cell.workload["params"], 2 ** 31 + 11).inputs(0, None)
    solve(*inputs.args, warm=inputs.warm)
    entry = solve.entry_of(*inputs.args, warm=inputs.warm)
    for _ in range(5):
        torch.cuda.synchronize(card)
        before, after = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
        before.record()
        entry.graph.replay()
        after.record()
        entry.stages.replayed()
        torch.cuda.synchronize(card)
        with profile(activities=[ProfilerActivity.CPU]):
            times = entry.stages.fold()
        span = before.elapsed_time(after)
        assert list(times) == ["start", "sqp.linearize", "sqp.qp",
                               "sqp.line_search", "finish"]
        assert all(ms > 0 for ms in times.values()), times
        assert 0.9 * span <= sum(times.values()) <= span, (times, span)
    assert entry.stats["stage_ms"]["folded"] == 5
