"""Cross-process shared-memory topic bus (Python facade).

A copy of ``cheeta_mpc_tpu/transport/shm.py`` on the port's loader: the
segment's layout is the C++ source's, the same in both packages.

Same ``publish / consume_latest / wait_for / seq`` interface as
:class:`cheeta_mpc_tpu_torch.transport.bus.MessageBus`, but backed by the POSIX
shared-memory seqlock segment in ``native/shm_bus.cpp`` — so
:class:`~cheeta_mpc_tpu_torch.transport.mpc_mrt.MpcNode` and ``MrtNode`` run
unchanged with the planner and the tracker in SEPARATE PROCESSES, the
reference's deployment topology (MPC node + dummy/MRT node launched as
distinct ROS processes, reference
``ocs2_legged_robot_ros/launch/legged_robot_sqp.launch`` +
``MPC_ROS_Interface.cpp:330-352`` / ``MRT_ROS_Interface.cpp:246-281``).

Topic names must be identical (same order) in every attached process; the
name->index map is the implicit topology contract, like ROS topic names.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, Optional, Tuple

from cheeta_mpc_tpu_torch.native.build import load_shm_bus


class ShmMessageBus:
    """Named-topic bus over a POSIX shared-memory segment.

    One process calls ``create=True`` (the launcher/MPC side); the others
    attach. ``capacity`` is the per-topic message-size bound (bytes).
    """

    def __init__(self, topics, name: str, create: bool = False,
                 capacity: int = 1 << 20, attach_timeout_s: float = 10.0):
        self._names: Dict[str, int] = {n: i for i, n in enumerate(topics)}
        self._name = name.encode()
        self._lib = load_shm_bus()
        self._owner = create
        if create:
            self._handle = self._lib.shm_bus_create(self._name, len(topics),
                                                    capacity)
            if not self._handle:
                raise OSError(f"shm_bus_create({name!r}) failed")
        else:
            deadline = time.monotonic() + attach_timeout_s
            self._handle = self._lib.shm_bus_attach(self._name)
            while not self._handle and time.monotonic() < deadline:
                time.sleep(0.01)
                self._handle = self._lib.shm_bus_attach(self._name)
            if not self._handle:
                raise OSError(f"shm_bus_attach({name!r}) timed out")
            if self._lib.shm_bus_ntopics(self._handle) != len(topics):
                raise ValueError("topic count mismatch with the segment")
        self._cap = int(self._lib.shm_bus_capacity(self._handle))

    @property
    def is_native(self) -> bool:
        return True

    def _tid(self, topic: str) -> int:
        return self._names[topic]

    def publish(self, topic: str, payload: bytes) -> int:
        return int(self._lib.shm_bus_publish(self._handle, self._tid(topic),
                                             payload, len(payload)))

    def consume_latest(self, topic: str) -> Tuple[int, Optional[bytes]]:
        buf = ctypes.create_string_buffer(self._cap)
        out_len = ctypes.c_uint32(0)
        seq = int(self._lib.shm_bus_consume(self._handle, self._tid(topic),
                                            buf, self._cap,
                                            ctypes.byref(out_len)))
        if seq <= 0:
            return 0, None
        return seq, buf.raw[:out_len.value]

    def wait_for(self, topic: str, last_seq: int,
                 timeout_s: float = 1.0) -> int:
        return int(self._lib.shm_bus_wait(self._handle, self._tid(topic),
                                          last_seq, int(timeout_s * 1e3)))

    def seq(self, topic: str) -> int:
        return int(self._lib.shm_bus_seq(self._handle, self._tid(topic)))

    def close(self) -> None:
        if self._handle:
            self._lib.shm_bus_close(self._handle)
            self._handle = None
            if self._owner:
                self._lib.shm_bus_unlink(self._name)

    def __enter__(self) -> "ShmMessageBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
