"""Timing / profiling instrumentation.

The analogue of the reference's ``benchmark::RepeatedTimer`` wired through
every layer (per-phase SQP timers printed as avg ms + %%, reference
MultipleShootingSolver.cpp:91-115; MPC-loop max/avg/latest timers,
MPC_BASE.cpp:64-87). Host-side wall timing here; device-accurate profiles
come from ``torch.profiler`` traces and CUDA events.
"""

from __future__ import annotations

import time
from typing import Dict, List


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
        dt_ms = (time.perf_counter() - self._t0) * 1e3
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
