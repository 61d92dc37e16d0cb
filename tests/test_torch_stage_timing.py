"""PyTorch port: the stage timers of utils/timing.py and where the solvers
mark them.

``timing.stage(name)`` is a profiler range in an eager solve under
``torch.profiler``, nothing without one, and a pair of timing events while
``graphed`` captures a graph. The events are CUDA events on a card; here a
stand-in event class with ``record`` / ``query`` / ``elapsed_time`` holds
the record's arithmetic: completed replays folded, unfinished ones
skipped, a stage summed over the iterations, ``stats`` plain JSON, and
only a replay made outside a profiler session read, once a session
records. The host timers' gate drops what a profiler session would
inflate.
"""

import itertools
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cheeta_mpc_tpu_torch import examples
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers import scp
from cheeta_mpc_tpu_torch.solvers.ddp import DdpSettings, solve_ddp
from cheeta_mpc_tpu_torch.utils import cuda_graph, timing

SQP = ("sqp.linearize", "sqp.qp", "sqp.line_search")
DDP = ("ddp.linearize", "ddp.hessian", "ddp.riccati", "ddp.line_search")


def _sqp_solve():
    """A small centroidal solve, two SQP iterations, plain QP executor."""
    cfg = tm.CentroidalMpcConfig(horizon=4, weights=examples.TEST_WEIGHTS)
    settings = scp.ScpSettings(iterations=2, ipm=IpmSettings(iters=4),
                               qp_backend="riccati")
    return tm.build_centroidal_solver(cfg, settings, device="cpu")(
        *examples.make_example_inputs(cfg))


def _ddp_solve(iterations=2):
    def step(k, x, u):
        return x + 0.1 * u

    def cost(k, x, u):
        return torch.sum(x * x) + torch.sum(u * u)

    return solve_ddp(step, cost, lambda x: torch.sum(x * x),
                     torch.ones(2, dtype=torch.float64),
                     torch.zeros((3, 2), dtype=torch.float64),
                     DdpSettings(iterations=iterations))


def _ranges(call, names):
    """``call()`` under a CPU profiler: its result and the ranges among
    ``names`` in the order they opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    seen = sorted((e.time_range.start, e.name) for e in prof.events()
                  if e.name in names)
    return out, [name for _, name in seen]


def _leaves(obj):
    leaves = []
    cuda_graph._flatten(obj, leaves, (torch.Tensor,))
    return leaves


@pytest.mark.parametrize("solve,names,iterations", [
    (_sqp_solve, SQP, 2), (_ddp_solve, DDP, 2)], ids=["sqp", "ddp"])
def test_stages_are_profiler_ranges_in_order(solve, names, iterations):
    _, seen = _ranges(solve, names)
    assert seen == list(names) * iterations


@pytest.mark.parametrize("solve", [_sqp_solve, _ddp_solve],
                         ids=["sqp", "ddp"])
def test_without_a_profiler_no_range_and_the_same_bits(solve, monkeypatch):
    traced, _ = _ranges(solve, SQP + DDP)

    def no_range(*args, **kwargs):
        raise AssertionError("a range was opened without a profiler")

    monkeypatch.setattr(timing, "record_function", no_range)
    assert not timing.profiling()
    assert timing.stage("sqp.qp") is timing._NOTHING
    plain = solve()
    a, b = _leaves(traced), _leaves(plain)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


class _Clock:
    """Stand-in CUDA events: ``record`` takes the next time of a clock,
    ``elapsed_time`` is the difference in ms, ``query`` says whether the
    replay has finished."""

    def __init__(self):
        self.ticks = itertools.count()
        self.done = True
        self.events = []
        clock = self

        class Event:
            def __init__(self):
                self.t = None
                clock.events.append(self)

            def record(self):
                # Uneven steps, so that every difference is distinct.
                k = next(clock.ticks)
                self.t = 0.5 * k * k + k

            def query(self):
                return clock.done

            def elapsed_time(self, other):
                return other.t - self.t

        self.Event = Event


def _captured(clock, body):
    stats = {}
    record = timing.StageRecord(stats, event=clock.Event)
    with record.capturing():
        body()
    return record, stats


def test_stage_record_folds_finished_replays_and_sums_iterations():
    clock = _Clock()
    record, stats = _captured(clock, _sqp_solve)
    # 2 boundaries and 2 events per stage per iteration: 14 on a card.
    assert len(clock.events) == 2 + 2 * len(SQP) * 2
    assert [m[0] for m in record.marks] == list(SQP) * 2

    def fold_profiled():
        with profile(activities=[ProfilerActivity.CPU]):
            return record.fold()

    assert record.fold() is None  # no replay yet
    record.replayed()  # a replay made while no profiler records
    assert record.fold() is None and "stage_ms" not in stats  # none now
    clock.done = False  # its last event has not completed
    assert fold_profiled() is None
    assert stats["stage_ms"] == {"folded": 0, "skipped": 1, "ms": {}}
    assert fold_profiled() is None  # nothing pending any more
    record.replayed()
    clock.done = True
    times = fold_profiled()

    total = record.begin.elapsed_time(record.end)
    assert list(times) == ["start", *SQP, "finish"]
    assert times["start"] == record.begin.elapsed_time(record.marks[0][1])
    for name in SQP:
        assert times[name] == sum(a.elapsed_time(b)
                                  for n, a, b in record.marks if n == name)
    assert sum(times.values()) == pytest.approx(total)
    assert all(ms > 0 for ms in times.values())
    record.replayed()
    fold_profiled()
    rec = json.loads(json.dumps(stats))["stage_ms"]
    assert rec["folded"] == 2 and rec["skipped"] == 1
    assert rec["ms"] == pytest.approx(times)


def test_stage_record_reads_no_replay_made_under_a_profiler():
    clock = _Clock()
    record, stats = _captured(clock, _sqp_solve)
    record.replayed()
    with profile(activities=[ProfilerActivity.CPU]):
        assert record.fold() is not None  # the replay before the session
        record.replayed()  # a replay the profiler records
        assert record.fold() is None
        record.replayed()
    assert record.fold() is None  # read only once a profiler records
    record.replayed()
    with profile(activities=[ProfilerActivity.CPU]):
        assert record.fold() is not None
    assert stats["stage_ms"]["folded"] == 2
    assert stats["stage_ms"]["skipped"] == 0

def test_stages_mark_only_while_the_capture_lasts():
    clock = _Clock()

    def body():
        with timing.stage("first"):
            pass
        raise RuntimeError("inside the capture")

    stats = {}
    record = timing.StageRecord(stats, event=clock.Event)
    with pytest.raises(RuntimeError, match="inside the capture"):
        with record.capturing():
            body()
    assert [m[0] for m in record.marks] == ["first"]
    assert record.end is None  # a failed capture records no last event
    assert timing.stage("first") is timing._NOTHING


def test_host_timer_gate_drops_samples_under_a_profiler():
    timer = timing.RepeatedTimer()
    assert timing.add_unprofiled(timer, 2.0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.profiling()
        assert not timing.add_unprofiled(timer, 50.0)
    assert not timing.profiling()
    assert timing.add_unprofiled(timer, 4.0)
    assert timer.count == 2 and timer.avg_ms == 3.0 and timer.max_ms == 4.0


def test_graph_host_phases_fold_into_stats_outside_a_profiler():
    entry = types.SimpleNamespace(
        stats={}, host={"inputs": timing.RepeatedTimer(),
                        "launch": timing.RepeatedTimer()})
    cuda_graph._Entry.time_host(entry, 1e-4, 3e-5)
    with profile(activities=[ProfilerActivity.CPU]):
        cuda_graph._Entry.time_host(entry, 1.0, 1.0)
    cuda_graph._Entry.time_host(entry, 3e-4, 5e-5)
    host = json.loads(json.dumps(entry.stats))["host_ms"]
    assert host["replays"] == 2
    assert host["inputs"] == pytest.approx(0.2)
    assert host["launch"] == pytest.approx(0.04)
