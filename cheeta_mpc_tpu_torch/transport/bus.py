"""Topic bus facade over the native seqlock transport.

Counterpart of ``cheeta_mpc_tpu/transport/bus.py``: named topics on top of
the C++ double-buffer bus (``native/policy_bus.cpp``) — the framework's
replacement for the reference's ROS pub/sub topics (``_mpc_observation``,
``_mpc_policy``, ``_mpc_reset`` ...; SURVEY.md §5 "Distributed
communication backend"). ``native=False`` selects a pure-Python
implementation of the same interface; with ``native=True`` (the default) a
failed build of the C++ bus raises instead of falling back to it.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, Optional, Tuple

from cheeta_mpc_tpu_torch.native.build import load_policy_bus


class _PyTopic:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.seq = 0
        self.data = b""


class MessageBus:
    """publish / consume_latest / wait_for over named topics."""

    def __init__(self, topics, native: bool = True, capacity: int = 1 << 20):
        self._names: Dict[str, int] = {n: i for i, n in enumerate(topics)}
        self._cap = capacity
        self._native = native
        if native:
            self._lib = load_policy_bus()
            self._handle = self._lib.bus_create(len(topics))
            if not self._handle:
                raise OSError("bus_create failed")
        else:
            self._py = [_PyTopic() for _ in topics]

    @property
    def is_native(self) -> bool:
        return self._native

    def _tid(self, topic: str) -> int:
        return self._names[topic]

    def publish(self, topic: str, payload: bytes) -> int:
        tid = self._tid(topic)
        if self._native:
            return int(self._lib.bus_publish(self._handle, tid, payload,
                                             len(payload)))
        t = self._py[tid]
        with t.cv:
            t.data = bytes(payload)
            t.seq += 1
            t.cv.notify_all()
            return t.seq

    def consume_latest(self, topic: str) -> Tuple[int, Optional[bytes]]:
        """(seq, payload) of the newest message; (0, None) when empty."""
        tid = self._tid(topic)
        if self._native:
            buf = ctypes.create_string_buffer(self._cap)
            out_len = ctypes.c_uint32(0)
            seq = int(self._lib.bus_consume(self._handle, tid, buf,
                                            self._cap,
                                            ctypes.byref(out_len)))
            if seq <= 0:
                return 0, None
            return seq, buf.raw[:out_len.value]
        t = self._py[tid]
        with t.lock:
            if t.seq == 0:
                return 0, None
            return t.seq, t.data

    def wait_for(self, topic: str, last_seq: int,
                 timeout_s: float = 1.0) -> int:
        """Block until a message with seq > last_seq exists; returns the
        current seq (may be <= last_seq on timeout)."""
        tid = self._tid(topic)
        if self._native:
            return int(self._lib.bus_wait(self._handle, tid, last_seq,
                                          int(timeout_s * 1e3)))
        t = self._py[tid]
        deadline = time.monotonic() + timeout_s
        with t.cv:
            while t.seq <= last_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                t.cv.wait(remaining)
            return t.seq

    def seq(self, topic: str) -> int:
        tid = self._tid(topic)
        if self._native:
            return int(self._lib.bus_seq(self._handle, tid))
        with self._py[tid].lock:
            return self._py[tid].seq

    def close(self) -> None:
        if self._native and self._handle:
            self._lib.bus_destroy(self._handle)
            self._handle = None
