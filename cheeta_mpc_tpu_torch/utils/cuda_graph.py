"""One CUDA graph per call signature: the port's counterpart of ``jax.jit``.

An eager solve is a stream of small launches (~1,300 for the centroidal
MPC, ~3,000 for the legged one) that the host issues more slowly than the
card runs them. :func:`graphed` captures a function once per call signature
into a ``torch.cuda.CUDAGraph`` and replays it afterwards, so a solve costs
the host one graph launch.

- The signature is what ``jax.jit`` keys its cache on: the shape and dtype of
  every array argument (numpy arrays, tensors, tuples of them such as
  ``warm``), the value of every other argument, and which keyword arguments
  are given (``None`` counts as not given). A Python ``float`` is staged
  like an array, as a 0-d float64 input, so its value is not part of the
  signature (``jax.jit`` traces it too); ``int``, ``bool``, ``str`` and
  ``None`` are, since solvers branch and size on them.
- A callable captures at most ``MAX_CAPTURES`` signatures. A call past
  that raises :class:`RecaptureError`, naming the part of the signature
  that keeps changing, rather than capturing (and holding a private memory
  pool for) one graph per call.
- Before a capture, two warm-up calls run on a side stream: they load the
  kernels' library, make the constants a solver keeps after its first call,
  create the cuBLAS handles and load CUDA modules lazily.
- The capture goes into a private memory pool.
- Each call copies its inputs into the graph's static input tensors
  (numpy arrays and CPU tensors through one pinned staging buffer per dtype
  and one non-blocking copy, CUDA tensors by device copies), replays the
  graph and returns copies of its outputs, so that a later call never
  changes an earlier result. The graph packs its outputs into one buffer
  per dtype, so a call issues copies and one graph launch, no kernel.
- A numpy input is read once, by numpy on the calling thread, straight
  into its staging view whatever its strides; its signature is read off
  the array without a copy. A copy split over the intra-op threads waits
  for the slowest of them, and on a host whose cores are shared that wait
  is long and uneven.
- A replay calls no kernel wrapper, so the wrappers' launch counters count
  the warm-up calls and the capture only; a replay's kernels are counted by
  name in a profiler trace (``chip_smoke.py``).
- Timing, switched by the profiler's own state (``utils/timing.py``). The
  capture records timing events at the graph's start and end and around
  each ``timing.stage`` of the solve; the last replay made before a
  profiler session is folded into ``stats["stage_ms"]`` (device ms by
  stage) at the session's first call. The host's phases of a call,
  ``inputs`` (from the call to the launch: signature, staging, input
  copies) and ``launch`` (``graph.replay()``), are timed on every replay
  made while no profiler records, their means in ``stats["host_ms"]``;
  while one records they are profiler ranges ``graphed.inputs``,
  ``graphed.launch`` and ``graphed.result`` (the output copies), nested
  in the caller's ranges.

On ``device="cpu"`` nothing is captured and the function runs as it is. On
a CUDA device a failed capture raises; nothing runs eagerly in its place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from cheeta_mpc_tpu_torch.core.types import resolve_device
from cheeta_mpc_tpu_torch.utils.timing import (RepeatedTimer, StageRecord,
                                               add_unprofiled, span)

WARMUP_CALLS = 2
MAX_CAPTURES = 16  # call signatures one graphed callable captures at most

_ARRAYS = (torch.Tensor, np.ndarray)
_INPUT_LEAVES = _ARRAYS + (float,)  # Python floats are staged as 0-d inputs


class RecaptureError(RuntimeError):
    """A graphed callable was called with more signatures than it may
    capture."""


def _flatten(obj, leaves: list, leaf_types=_INPUT_LEAVES):
    """The structure of ``obj`` (a nest of tuples, NamedTuples, lists,
    dicts and dataclasses) with each instance of ``leaf_types`` replaced by
    its index in ``leaves``, to which it is appended; hashable where the
    nest's other values are."""
    if isinstance(obj, leaf_types):
        leaves.append(obj)
        return ("leaf", len(leaves) - 1)
    if isinstance(obj, dict):
        return ("dict", tuple((k, _flatten(v, leaves, leaf_types))
                              for k, v in sorted(obj.items())))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj), tuple((f.name, _flatten(getattr(obj, f.name),
                                                   leaves, leaf_types))
                                 for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_flatten(v, leaves, leaf_types)
                                 for v in obj))
    return ("value", obj)


def _unflatten(struct, leaves):
    kind, body = struct
    if kind == "leaf":
        return leaves[body]
    if kind == "value":
        return body
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in body}
    if dataclasses.is_dataclass(kind):
        return kind(**{k: _unflatten(v, leaves) for k, v in body})
    items = [_unflatten(v, leaves) for v in body]
    return kind._make(items) if hasattr(kind, "_make") else kind(items)


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, np.ndarray):  # ascontiguousarray makes 0-d arrays 1-d
        return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    if isinstance(a, float):
        return torch.tensor(a, dtype=torch.float64)
    return a


@functools.lru_cache(maxsize=None)
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _leaf_signature(a):
    """A leaf's shape and torch dtype, read without copying the leaf."""
    if isinstance(a, np.ndarray):
        return tuple(a.shape), _torch_dtype(a.dtype)
    t = _host_tensor(a)
    return tuple(t.shape), t.dtype


def _stage(src, stage: torch.Tensor) -> None:
    """Copy a host leaf into its staging view (module docstring)."""
    if isinstance(src, np.ndarray):
        np.copyto(stage.numpy(), src)
    else:
        stage.copy_(_host_tensor(src))


def _signature(args, kwargs):
    """The call signature (``(structure, leaf shapes and dtypes)``) of a
    call, and the call's leaves."""
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    leaves: list = []
    struct = _flatten((args, kwargs), leaves)
    return (struct, tuple(_leaf_signature(a) for a in leaves)), leaves


def _signature_parts(key) -> dict:
    """``{path: what the signature holds there}`` of a call signature, with
    paths such as ``args[1]`` or ``kwargs['warm'][0]``."""
    (_, (args, kwargs)), leaf_sigs = key
    parts = {}

    def walk(node, path):
        kind, body = node
        if kind == "leaf":
            shape, dtype = leaf_sigs[body]
            parts[path] = f"array of shape {shape}, {dtype}"
        elif kind == "value":
            parts[path] = f"value {body!r}"
        else:
            name = kind if isinstance(kind, str) else kind.__name__
            parts[path] = f"{name} of {len(body)}"
            keyed = kind == "dict" or dataclasses.is_dataclass(kind)
            for i, item in enumerate(body):
                k, child = item if keyed else (i, item)
                walk(child, f"{path}[{k!r}]" if kind == "dict"
                     else f"{path}.{k}" if keyed else f"{path}[{k}]")

    for i, child in enumerate(args[1]):
        walk(child, f"args[{i}]")
    for k, child in kwargs[1]:
        walk(child, f"kwargs[{k!r}]")
    return parts


def _check_capture_bound(graphs: dict, key, name: str) -> None:
    """Raise :class:`RecaptureError` if ``graphs`` is full; the message
    names what differs between ``key`` and the last captured signature."""
    if len(graphs) < MAX_CAPTURES:
        return
    new = _signature_parts(key)
    last = _signature_parts(next(reversed(graphs)))
    changed = [f"{path}: {last.get(path, 'absent')} -> "
               f"{new.get(path, 'absent')}"
               for path in sorted(set(new) | set(last))
               if new.get(path) != last.get(path)]
    raise RecaptureError(
        f"{name}: a new call signature past the bound of {MAX_CAPTURES} "
        f"captures; against the last one captured, {'; '.join(changed)}. "
        "An int, bool, str or None argument is part of the signature (an "
        "array's value or a float's is not): pass a value that changes from "
        "call to call as an array or a float.")


class _Layout:
    """Tensors of given shapes and dtypes as views of one flat buffer per
    dtype, so that a whole nest moves in one copy per dtype."""

    def __init__(self, signatures):
        self.slots, self.sizes = [], {}
        for shape, dtype in signatures:
            offset = self.sizes.get(dtype, 0)
            self.slots.append((dtype, offset, shape))
            self.sizes[dtype] = offset + math.prod(shape)

    def buffers(self, **kw) -> dict:
        return {dtype: torch.empty(n, dtype=dtype, **kw)
                for dtype, n in self.sizes.items()}

    def views(self, buffers: dict) -> list:
        return [buffers[dtype][offset:offset + math.prod(shape)].view(shape)
                for dtype, offset, shape in self.slots]

    def pack(self, tensors) -> dict:
        """One flat tensor per dtype holding ``tensors`` in slot order."""
        return {dtype: torch.cat([t.reshape(-1) for t, (d, _, _)
                                  in zip(tensors, self.slots) if d == dtype])
                for dtype in self.sizes}


def graph_node_count(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a graph captured with ``keep_graph=True`` (the driver's
    ``cuGraphGetNodes``)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    code = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                   None, ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {code}")
    return int(n.value)


class _Entry:
    """One call signature: the static inputs (views of one device buffer
    per dtype), the pinned staging buffers of the same layout that host
    inputs pass through, and, once captured, the graph and its outputs
    packed into one device buffer per dtype."""

    def __init__(self, struct, leaves, device):
        self.struct = struct
        layout = _Layout([_leaf_signature(a) for a in leaves])
        self.inputs = layout.buffers(device=device)
        self.static = layout.views(self.inputs)
        self.staging = layout.buffers(pin_memory=True)
        self.staging_views = layout.views(self.staging)
        self.copied = torch.cuda.Event()  # the staging buffers' last copy
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out_struct = self.out_layout = self.packed = None
        self.stats: dict = {}  # updated in place: readers keep the object
        self.stages = StageRecord(self.stats)
        self.host = {"inputs": RepeatedTimer(), "launch": RepeatedTimer()}

    def load(self, leaves) -> None:
        """Copy the call's inputs into the static tensors: host arrays in
        one non-blocking copy per dtype from the staging buffers, then CUDA
        tensors one by one."""
        self.copied.synchronize()  # the last copy out of staging is done
        on_card, from_host = [], set()
        for src, dst, stage in zip(leaves, self.static, self.staging_views):
            if isinstance(src, torch.Tensor) and src.is_cuda:
                on_card.append((src, dst))
            else:
                _stage(src, stage)
                from_host.add(dst.dtype)
        for dtype in from_host:
            self.inputs[dtype].copy_(self.staging[dtype], non_blocking=True)
        self.copied.record()
        for src, dst in on_card:
            dst.copy_(src)

    def result(self):
        """Fresh tensors of the last replay's outputs."""
        fresh = {dtype: buf.clone() for dtype, buf in self.packed.items()}
        return _unflatten(self.out_struct, self.out_layout.views(fresh))

    def time_host(self, inputs_s: float, launch_s: float) -> None:
        """Fold one replay's host phases into ``stats["host_ms"]``; dropped
        while a profiler records."""
        inputs, launch = self.host["inputs"], self.host["launch"]
        if add_unprofiled(inputs, inputs_s * 1e3):
            launch.add(launch_s * 1e3)
            self.stats["host_ms"] = {"inputs": inputs.avg_ms,
                                     "launch": launch.avg_ms,
                                     "replays": inputs.count}


def graphed(fn: Callable, device="cuda") -> Callable:
    """``fn`` as a callable with its signature that captures one CUDA graph
    per call signature and replays it (module docstring). ``device`` is the
    card the graph runs on; ``"cpu"`` returns ``fn`` itself.

    The returned callable carries ``graphs``, a dict from call signature to
    the captured entry, and ``entry_of(*args, **kwargs)``, the entry of a
    call's signature; an entry's ``stats`` hold the capture's and the
    instantiation's seconds, the graph's nodes, the bytes that the
    capture added to the reserved device memory (its private pool), and
    once measured ``stage_ms`` and ``host_ms`` (module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return fn
    graphs: dict = {}

    def capture(entry: _Entry) -> None:
        args, kwargs = _unflatten(entry.struct, entry.static)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*args, **kwargs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        # torch.cuda.graph empties the allocator's cache before the capture;
        # emptied here first, what the capture reserves is its pool.
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph), entry.stages.capturing():
            out_leaves: list = []
            entry.out_struct = _flatten(fn(*args, **kwargs), out_leaves,
                                        _ARRAYS)
            entry.out_layout = _Layout(
                [(tuple(t.shape), t.dtype) for t in out_leaves])
            entry.packed = entry.out_layout.pack(out_leaves)
        t1 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        entry.stats.update(
            capture_s=t1 - t0, instantiate_s=time.perf_counter() - t1,
            nodes=graph_node_count(graph),
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved)
        entry.graph = graph

    name = getattr(fn, "__qualname__", repr(fn))

    def prepare(args, kwargs):
        """The call's entry with its inputs loaded, and whether this call
        captured it; the entry's last replay is folded first if it is due
        (``timing.StageRecord``)."""
        key, leaves = _signature(args, kwargs)
        entry = graphs.get(key)
        if entry is None:
            _check_capture_bound(graphs, key, name)
            entry = _Entry(key[0], leaves, dev)
            entry.load(leaves)
            capture(entry)
            graphs[key] = entry
            return entry, True
        entry.stages.fold()
        entry.load(leaves)
        return entry, False

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            with span("graphed.inputs"):
                entry, captured = prepare(args, kwargs)
            t1 = time.perf_counter()
            with span("graphed.launch"):
                entry.graph.replay()
            t2 = time.perf_counter()
            entry.stages.replayed()
            if not captured:
                entry.time_host(t1 - t0, t2 - t1)
            with span("graphed.result"):
                return entry.result()

    def entry_of(*args, **kwargs) -> Optional[_Entry]:
        """The captured entry of this call's signature, or None."""
        return graphs.get(_signature(args, kwargs)[0])

    call.graphs = graphs
    call.entry_of = entry_of
    call.__wrapped__ = fn
    call.__doc__ = fn.__doc__
    return call
