"""The harness behind ``run.py``: set-up, the measured window, the traced
stage, the check against the reference, and the result line.

Nothing here knows a configuration, a traffic mix or a metric by name: the
cell's files name the traffic kind, the entry family and the metric
readers, which are found by those names.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names that may not be loaded in the process that prints
# the result, compared whole (``cheeta_mpc_tpu_torch`` is the port).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cheeta_mpc_tpu")
SPAN = "mpcbench."  # prefix of the benchmark's own profiler spans
TRACE_SECONDS = 1.0  # the profiled stage: about this long, after the window
TRACE_MAX_CALLS = 40  # and no more calls (a legged tick's graph has ~3,000)
CHECK_BLOCK = 512  # answers solved by the reference in one batch
REPLAY_TICKS = 16  # a tick stream's first calls, replayed by the reference


class Cell:
    """One cell: its ``BENCHMARK.json`` entry, its configuration file and
    its workload file."""

    def __init__(self, name: str, bench_path: Path):
        self.bench = json.loads(Path(bench_path).read_text())
        self.base = Path(bench_path).resolve().parent
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"run: no workload {name!r} in {bench_path}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads(self.find(
            configs[self.entry["config"]]["file"]).read_text())
        self.workload = json.loads(self.find(
            f"mpcbench/workloads/{name}.json").read_text())
        self.chips = int(self.entry["chips"])

    def find(self, rel: str) -> Path:
        """``rel`` beside the benchmark file, else in this checkout."""
        for base in (self.base, ROOT):
            if (base / rel).is_file():
                return base / rel
        raise FileNotFoundError(rel)

    def metrics(self, trace: bool) -> list:
        """The metric entries that this cell reports in a run of this
        kind: its end-to-end metrics, or with ``trace`` its per-layer
        ones."""
        e2e = [m for m in self.bench["end_to_end"]
               if "workloads" not in m or self.name in m["workloads"]]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream of unknown
    length, drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            self.items[j] = item


class Trace(NamedTuple):
    """What the profiler saw over the traced calls, in microseconds of one
    clock: device operations ``(name, start, duration, is_kernel)``, the
    benchmark's spans ``(name, start, duration)`` and the traced window."""

    ops: list
    spans: list
    window: tuple
    calls: int

    def kernels(self, match: Optional[Callable[[str], bool]] = None):
        return [o for o in self.ops
                if o[3] and (match is None or match(o[0]))]


class Ctx(NamedTuple):
    """What a metric reader reads."""

    config: dict
    workload: dict
    batch: int  # problems per call
    host_ms: list  # per call of the window
    device_ms: Optional[list]  # per call, CUDA events (traced run)
    window_s: float
    setup_s: float
    graph_stats: Optional[dict]
    trace: Optional[Trace]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def log(t_start: float, msg: str) -> None:
    print(f"# t={time.perf_counter() - t_start:.2f}s {msg}", flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read: {exc}"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def read_trace(prof, calls: int) -> Trace:
    """The profiler's chrome trace, reduced to device operations, the
    benchmark's spans and the window of the traced calls."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    ops, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append((name, ts, dur, cat == "kernel"))
        elif name.startswith(SPAN) and not cat.startswith("gpu"):
            if name == SPAN + "traced":
                window = (ts, ts + dur)
            else:
                spans.append((name, ts, dur))
    if window is None:
        raise RuntimeError("the profiler's trace has no traced window")
    return Trace(ops, spans, window, calls)


def device_intervals(trace: Trace) -> list:
    """The union of the device operations' intervals inside the window,
    as sorted disjoint ``(start, end)`` pairs."""
    lo, hi = trace.window
    cuts = sorted((max(ts, lo), min(ts + dur, hi))
                  for _, ts, dur, _ in trace.ops if ts < hi and ts + dur > lo)
    merged: list = []
    for s, e in cuts:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without ``void`` and its argument list, cut to
    ``limit`` characters; a copy's or fill's name as it is."""
    if not name.startswith("void "):
        return name[:limit]
    name = name.removeprefix("void ").replace("(anonymous namespace)",
                                              "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name if len(name) <= limit else name[:limit - 3] + "..."


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the benchmark's innermost span that the host
    was in when it began."""
    by_name: dict = {}
    for name, _, dur, _ in trace.ops:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = trace.window
    busy = device_intervals(trace)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

    def host_span(t):
        inside = [(dur, name) for name, ts, dur in trace.spans
                  if ts <= t < ts + dur]
        return min(inside)[1] if inside else "outside the spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[host_span(s), (e - s) * 1e-6]
                          for s, e in longest]}


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def read_metrics(entries: list, ctx: Ctx, t_start: float) -> dict:
    """Each metric by its reader ``mpcbench.metrics.<base>``; a reader that
    finds nothing to read returns None, and the metric is left out."""
    import importlib
    out = {}
    for m in entries:
        base, _, arg = m["name"].partition(".")
        reader = importlib.import_module(f"mpcbench.metrics.{base}")
        value = reader.read(ctx, arg)
        if value is None:
            log(t_start, f"{m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _row(inputs, row):
    """The inputs of one problem of a call (``row`` None: unbatched)."""
    from mpcbench.traffic import Inputs
    if row is None:
        return inputs
    pick = (lambda t: None if t is None else tuple(a[row] for a in t))
    return Inputs(pick(inputs.args), pick(inputs.warm))


def _stack(rows):
    from mpcbench.traffic import Inputs
    args = tuple(np.stack(a) for a in zip(*(r.args for r in rows)))
    warm = (None if rows[0].warm is None else
            tuple(np.stack(w) for w in zip(*(r.warm for r in rows))))
    return Inputs(args, warm)


def check(cell: Cell, family, answers: list, device, t_start: float):
    """Solve each sampled answer's inputs again with the frozen reference
    in float64, in blocks, and return ``{name: widest gap}``."""
    import torch
    ref = family.reference(cell.config, device, torch.float64)
    worst: dict = {}
    for i in range(0, len(answers), CHECK_BLOCK):
        part = answers[i:i + CHECK_BLOCK]
        want = ref(_stack([inp for inp, _ in part]))
        want = {k: v.detach().cpu().numpy() for k, v in want.items()}
        got = {k: np.stack([g[k] for _, g in part]) for k in part[0][1]}
        for name, v in family.gaps(got, want).items():
            if v is not None:
                worst[name] = max(worst.get(name, 0.0), v)
    log(t_start, f"checked {len(answers)} answers against the reference")
    return worst


def replay(cell: Cell, family, tr, head: list, t_start: float) -> dict:
    """The reference's own run of a tick stream's first calls, on the CPU in
    float64: from the stream's cold start, each tick warm-started from the
    reference's previous answer, as the program's was from its own. Returns
    ``{"replay_<name>": gap}`` against the program's answers ``head``, the
    median over the ticks of each tick's widest gap: a stream can amplify
    rounding from tick to tick (the reference's own chain does), so the
    last ticks' gaps swing from seed to seed, and the median does not."""
    import torch
    ref = family.reference(cell.config, torch.device("cpu"), torch.float64)
    gaps: dict = {}
    prev = None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the fastest for its small eager operations
    try:
        for k, (_, got) in enumerate(head):
            out = ref(tr.inputs(k, prev))
            prev = {n: out[n].detach().numpy() for n in out}
            for name, v in family.gaps(got, prev).items():
                if v is not None:
                    gaps.setdefault("replay_" + name, []).append(v)
    finally:
        torch.set_num_threads(threads)
    log(t_start, f"replayed the stream's first {len(head)} ticks")
    return {name: float(np.median(v)) for name, v in gaps.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, program: Optional[Callable] = None,
             readings: Optional[dict] = None, min_calls: int = 0):
    """One run of ``cell``; returns the result line's object, or None after
    naming on standard error a module that may not be loaded. ``program``
    replaces the family's entry point (the control of ``calibrate.py``);
    ``readings``, where given, receives every gap that the family
    computes, compared or not; the window runs on until ``min_calls``
    calls have completed."""
    import torch
    from mpcbench import entries, traffic as traffic_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    on_card = device.type == "cuda"
    cfg, wl = cell.config, cell.workload
    family = entries.load(cfg["family"])
    if on_card:
        log(t_start, f"card: {card_line()}")
    tr = traffic_mod.load(wl["kind"]).make(cfg, wl["params"], seed)
    log(t_start, "traffic made")
    entry = (program or family.program)(cfg, device)
    log(t_start, "entry point built")
    reads = tuple(tr.reads)
    batch = tr.batch or 1

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def read(outs):
        return {n: outs[n].cpu().numpy() for n in reads}

    # Set-up: the warm-up calls capture every graph the window replays.
    # A tick stream's first calls are kept for the reference's replay.
    head_len = REPLAY_TICKS if tr.batch is None else 0
    head: list = []
    prev, k = None, 0
    for _ in range(tr.warmup):
        inputs = tr.inputs(k, prev)
        prev = read(entry.call(inputs))
        if k < head_len:
            head.append((inputs, prev))
        k += 1
        if k <= 2:
            log(t_start, f"warm-up call {k} done")
    sync()
    setup_s = time.perf_counter() - t_start
    log(t_start, f"set-up {setup_s:.3f} s, {tr.warmup} warm-up calls")

    # The window: a closed loop, one call in flight.
    spec = wl["check"]
    rng = np.random.default_rng([seed, 0x5EED])
    kept = Reservoir(spec["sample"] if tr.batch is None
                     else spec["sample_calls"], rng)
    timed = trace and on_card  # CUDA events around every call
    host_ms, events = [], []
    failed = attempted = 0
    t_w0 = time.perf_counter()
    t1 = t_w0
    while t1 - t_w0 < seconds or len(host_ms) < min_calls:
        inputs = tr.inputs(k, prev)
        if timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        outs = entry.call(inputs)
        if timed:
            ev[1].record()
            events.append(ev)
        got = read(outs)
        t1 = time.perf_counter()
        host_ms.append(1e3 * (t1 - t0))
        ok = np.ones(batch, bool)
        for v in got.values():
            ok &= np.isfinite(v.reshape(batch, -1)).all(axis=1)
        failed += int((~ok).sum())
        attempted += batch
        kept.offer((inputs, got))
        if k < head_len:
            head.append((inputs, got))
        prev, k = got, k + 1
    window_s = t1 - t_w0
    sync()
    half = len(host_ms) // 2
    log(t_start, f"window {window_s:.3f} s, {len(host_ms)} calls, "
        f"{attempted} problems; host ms p50 of the first and second "
        f"halves {percentile(host_ms[:max(half, 1)], 50):.4f} / "
        f"{percentile(host_ms[half:], 50):.4f}")
    device_ms = ([a.elapsed_time(b) for a, b in events] if timed
                 else None)
    graph_stats = entry.graph_stats(tr.inputs(k, prev))

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        per_call = float(np.median(host_ms)) * 1e-3
        n = min(TRACE_MAX_CALLS, math.ceil(TRACE_SECONDS / per_call))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(SPAN + "traced"):
                for _ in range(n):
                    with record_function(SPAN + "next"):
                        inputs = tr.inputs(k, prev)
                    with record_function(SPAN + "call"):
                        outs = entry.call(inputs)
                    with record_function(SPAN + "read"):
                        prev = read(outs)
                    k += 1
                sync()
        traced = read_trace(prof, n)
        log(t_start, f"traced {n} calls: {len(traced.ops)} device ops")

    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"run: loaded in this process: {', '.join(forbidden)}",
              file=sys.stderr)
        return None

    ctx = Ctx(cfg, wl, batch, host_ms, device_ms, window_s, setup_s,
              graph_stats, traced)
    metrics = read_metrics(cell.metrics(trace), ctx, t_start)
    log(t_start, f"{len(host_ms)} timed calls")

    # The check: the program's state goes first, then the reference runs.
    items = kept.items
    del entry, outs, prev, kept
    if on_card:
        torch.cuda.empty_cache()
    if tr.batch is None:
        answers = [(_row(inp, None), got) for inp, got in items]
    else:
        picks = rng.choice(len(items) * tr.batch,
                           size=min(spec["sample"], len(items) * tr.batch),
                           replace=False)
        answers = [(_row(items[p // tr.batch][0], p % tr.batch),
                    {n: v[p % tr.batch] for n, v in
                     items[p // tr.batch][1].items()}) for p in picks]
    worst = check(cell, family, answers, device, t_start)
    if head:
        worst.update(replay(cell, family, tr, head, t_start))
    if readings is not None:
        readings.update(worst)
    checks = {"failed": {"value": failed, "limit": 0}}
    checks.update({name: {"value": worst.get(name, math.nan), "limit": lim}
                   for name, lim in spec["limits"].items()})
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"),
                "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if traced is not None:
        busy = sum(e - s for s, e in device_intervals(traced))
        dev_info["busy_s"] = busy * 1e-6
        dev_info["window_s"] = (traced.window[1] - traced.window[0]) * 1e-6
        result["breakdown"] = breakdown(traced)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return result
