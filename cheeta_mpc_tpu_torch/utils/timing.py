"""Timing / profiling instrumentation.

The analogue of the reference's ``benchmark::RepeatedTimer`` wired through
every layer (per-phase SQP timers printed as avg ms + %%, reference
MultipleShootingSolver.cpp:91-115; MPC-loop max/avg/latest timers,
MPC_BASE.cpp:64-87). Host-side wall timing here; device-accurate profiles
come from ``torch.profiler`` traces and CUDA events.

Stages of a solve (``stage(name)``, e.g. ``sqp.linearize``) are timed on
the device from inside the CUDA graph that replays them: while
``utils.cuda_graph.graphed`` captures a graph, each stage records a timing
event into it at its entry and at its exit (:class:`StageRecord`), so a
replay times its stages without any host code. Run eagerly under a
``torch.profiler`` session, a stage is a ``record_function`` range of the
same name (``span``). Otherwise it costs one test of the profiler's flag.

The profiler's own state is the one switch, and what it would inflate is
read from outside its sessions: host timers keep a sample only while no
profiler records (``add_unprofiled``), and a graph's stage times come from
the last replay made before a session, read once the session has begun.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function


class RepeatedTimer:
    """avg / max / latest milliseconds over repeated timed sections."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0
        self.max_ms = 0.0
        self.latest_ms = 0.0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        return self.add((time.perf_counter() - self._t0) * 1e3)

    def add(self, dt_ms: float) -> float:
        """Fold in one section timed by the caller's own clock."""
        self.total += dt_ms
        self.count += 1
        self.max_ms = max(self.max_ms, dt_ms)
        self.latest_ms = dt_ms
        return dt_ms

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def avg_ms(self) -> float:
        return self.total / max(self.count, 1)

    def summary(self) -> str:
        return (f"avg {self.avg_ms:.3f} ms, max {self.max_ms:.3f} ms, "
                f"latest {self.latest_ms:.3f} ms over {self.count} calls")


class Benchmarker:
    """Named phase timers + percentile latency tracking (solves/s, p50/p99)."""

    def __init__(self) -> None:
        self.timers: Dict[str, RepeatedTimer] = {}
        self.samples_ms: List[float] = []

    def phase(self, name: str) -> RepeatedTimer:
        if name not in self.timers:
            self.timers[name] = RepeatedTimer()
        return self.timers[name]

    def record_solve_ms(self, ms: float) -> None:
        self.samples_ms.append(ms)

    def percentile_ms(self, pct: float) -> float:
        if not self.samples_ms:
            return float("nan")
        s = sorted(self.samples_ms)
        idx = min(len(s) - 1, int(round(pct / 100.0 * (len(s) - 1))))
        return s[idx]

    def report(self) -> str:
        lines = [f"  {n}: {t.summary()}" for n, t in self.timers.items()]
        if self.samples_ms:
            lines.append(f"  p50 {self.percentile_ms(50):.3f} ms, "
                         f"p99 {self.percentile_ms(99):.3f} ms")
        return "\n".join(lines)


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records now (the profiler's own
    flag: one attribute read)."""
    return _profiler._is_profiler_enabled


def add_unprofiled(timer: RepeatedTimer, dt_ms: float) -> bool:
    """Fold ``dt_ms`` into ``timer`` unless a profiler records now, and say
    whether it was kept. A profiler session raises host costs (a graph
    launch's by 0.2-0.5 ms on an H100), so its samples are dropped."""
    if profiling():
        return False
    timer.add(dt_ms)
    return True


# The stage record of the graph being captured; ``graphed`` sets it around
# ``torch.cuda.graph(...)`` only, so warm-up and eager calls see None.
_CAPTURING: contextvars.ContextVar = contextvars.ContextVar(
    "stage_record", default=None)
_NOTHING = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    context manager that does nothing."""
    return record_function(name) if profiling() else _NOTHING


def stage(name: str):
    """A context manager around one stage of a solve (module docstring):
    timing events into the graph being captured, else ``span(name)``."""
    record = _CAPTURING.get()
    return span(name) if record is None else record.mark(name)


def _timing_event():
    # external: the record becomes a node of the graph being captured.
    return torch.cuda.Event(enable_timing=True, external=True)


class StageRecord:
    """Device ms by stage of one captured CUDA graph.

    The capture records an event at the graph's start (``capturing``), one
    at each marked stage's entry and exit (``stage``), and one at its end.
    A marked stage's time runs from its entry to its exit event, summed
    over the stage's marks (one per solver iteration); what lies outside
    every mark goes to ``start`` (before the first mark) or ``finish``
    (after it, gaps between marks included). Stages do not nest.

    Only a replay made while no profiler recorded is folded in, since a
    profiler session slows the replays it records, and unevenly by stage;
    and it is read only once a profiler records, so that reading costs
    nothing outside a session. The owner calls ``replayed()`` after each
    replay and ``fold()`` before the next one re-records the events. At
    the first call of a session the last replay before it is folded in if
    its last event has completed, else counted as skipped; nothing waits
    for the card. Each fold rewrites ``stats["stage_ms"]`` (plain
    numbers): ``folded`` and ``skipped`` replays and ``ms``, the mean ms
    per stage over the folded ones, in the order of the graph."""

    def __init__(self, stats: dict,
                 event: Callable[[], object] = _timing_event):
        self.stats = stats
        self._event = event
        self.begin = self.end = None
        self.marks: list = []  # (name, entry event, exit event)
        self._sums: Dict[str, float] = {}
        self.folded = self.skipped = 0
        self.pending = False  # the last replay ran unprofiled, unread

    def _record(self):
        event = self._event()
        event.record()
        return event

    @contextlib.contextmanager
    def capturing(self):
        """Record the graph's first event, let ``stage`` mark into this
        record for the body, then record the graph's last event."""
        self.begin = self._record()
        token = _CAPTURING.set(self)
        try:
            yield self
        finally:
            _CAPTURING.reset(token)
        self.end = self._record()

    @contextlib.contextmanager
    def mark(self, name: str):
        entry = self._record()
        yield
        self.marks.append((name, entry, self._record()))

    def replayed(self) -> None:
        """Note a replay: its events are read at the next ``fold`` if no
        profiler records now."""
        self.pending = not profiling()

    def fold(self) -> Optional[Dict[str, float]]:
        """Fold in the last replay if it ran while no profiler recorded and
        one records now (class docstring); returns its ms by stage, or
        None."""
        if not (self.pending and profiling()):
            return None
        self.pending = False
        times = None
        if not self.end.query():
            self.skipped += 1
        else:
            first = self.marks[0][1] if self.marks else self.end
            times = {"start": self.begin.elapsed_time(first)}
            for name, entry, exit_ in self.marks:
                times[name] = (times.get(name, 0.0)
                               + entry.elapsed_time(exit_))
            times["finish"] = (self.begin.elapsed_time(self.end)
                               - sum(times.values()))
            for name, ms in times.items():
                self._sums[name] = self._sums.get(name, 0.0) + ms
            self.folded += 1
        self.stats["stage_ms"] = {
            "folded": self.folded, "skipped": self.skipped,
            "ms": {name: total / self.folded
                   for name, total in self._sums.items()}}
        return times
