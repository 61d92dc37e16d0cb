"""MPC / MRT node split over the topic bus.

A copy of ``cheeta_mpc_tpu/transport/mpc_mrt.py`` on the port's gait
schedule and runtime (numpy); the solve behind :class:`MpcNode` is the
caller's, for example the port's legged planning node on the card.

The two-process pattern of the reference (MPC_ROS_Interface planning node at
~50 Hz + MRT_ROS_Interface tracking side at ~400 Hz over ROS topics,
reference §2.6) as bus-connected nodes:

- :class:`MpcNode` — subscribes observations, runs one solve per new
  observation (synchronously, like the reference's subscriber callback,
  MPC_ROS_Interface.cpp:237-290), publishes the float32-wire policy; serves
  the reset handshake (reference ``_mpc_reset`` service :64-94).
- :class:`MrtNode` — publishes observations, drains at most one policy per
  tick into the double-buffered :class:`MrtBase` (the reference's custom
  callback queue ``spinMRT``/``callOne``, MRT_ROS_Interface.cpp:233-235),
  blocking initial-policy handshake (MRT_ROS_Dummy_Loop.cpp:51-71).
- :class:`CommandClient` — gait / target command publishers (the reference's
  `_mpc_mode_schedule` and `_mpc_target` topics: GaitKeyboardPublisher,
  TargetTrajectoriesRosPublisher). `MpcNode` polls both topics in its spin
  loop and hands fresh commands to caller-supplied callbacks — the
  solver-synchronized injection point (GaitReceiver.preSolverRun role).

Nodes run over any bus with the publish/consume_latest/wait_for/seq
interface: the in-process
:class:`~cheeta_mpc_tpu_torch.transport.bus.MessageBus`
(threads of one process) or the cross-process
:class:`~cheeta_mpc_tpu_torch.transport.shm.ShmMessageBus` (the reference's
separate-process deployment, see cli/launch.py).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from cheeta_mpc_tpu_torch.gait.schedule import ModeSequenceTemplate
from cheeta_mpc_tpu_torch.mpc.runtime import (MrtBase, PolicyData,
                                              SystemObservation)
from cheeta_mpc_tpu_torch.transport.bus import MessageBus
from cheeta_mpc_tpu_torch.transport.wire import (decode_gait_command,
                                           decode_observation, decode_policy,
                                           decode_target_command,
                                           encode_gait_command,
                                           encode_observation, encode_policy,
                                           encode_target_command)

TOPICS = ("mpc_observation", "mpc_policy", "mpc_reset_req", "mpc_reset_ack",
          "mpc_mode_schedule", "mpc_target")


def make_bus(native: bool = True) -> MessageBus:
    return MessageBus(TOPICS, native=native)


class MpcNode:
    """Planning-side node: one solve per fresh observation."""

    def __init__(self, bus: MessageBus,
                 solve_fn: Callable[[SystemObservation], PolicyData],
                 on_gait_command: Optional[Callable[
                     [str, ModeSequenceTemplate], None]] = None,
                 on_target_command: Optional[Callable[
                     [np.ndarray], None]] = None):
        self._bus = bus
        self._solve_fn = solve_fn
        self._on_gait = on_gait_command
        self._on_target = on_target_command
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.solve_count = 0
        self._last_gait_seq = 0
        self._last_target_seq = 0
        # Snapshot the reset baseline NOW, before any client can publish a
        # request: snapshotting inside the spin thread raced with an early
        # reset_mpc() (the request landed before the thread's first poll and
        # was absorbed into the baseline, never acked). The reference avoids
        # the class of bug with a blocking ROS service
        # (MRT_ROS_Interface.cpp:61-74).
        self._reset_baseline = bus.seq("mpc_reset_req")

    def launch(self) -> None:
        """Start the spin thread (reference launchNodes,
        MPC_ROS_Interface.cpp:330-352)."""
        self._thread = threading.Thread(target=self._spin, daemon=True)
        self._thread.start()

    def _poll_commands(self) -> None:
        """Drain fresh gait/target commands into the caller's callbacks —
        the solver-synchronized injection point (reference
        GaitReceiver.mpcModeSequenceCallback buffers, preSolverRun applies;
        RosReferenceManager's `_mpc_target` subscriber)."""
        if self._on_gait is not None:
            gseq = self._bus.seq("mpc_mode_schedule")
            if gseq > self._last_gait_seq:
                gseq, payload = self._bus.consume_latest("mpc_mode_schedule")
                if payload is not None and gseq > self._last_gait_seq:
                    self._last_gait_seq = gseq
                    self._on_gait(*decode_gait_command(payload))
        if self._on_target is not None:
            tseq = self._bus.seq("mpc_target")
            if tseq > self._last_target_seq:
                tseq, payload = self._bus.consume_latest("mpc_target")
                if payload is not None and tseq > self._last_target_seq:
                    self._last_target_seq = tseq
                    self._on_target(decode_target_command(payload))

    def _spin(self) -> None:
        last_obs_seq = 0
        last_reset_seq = self._reset_baseline
        self._last_gait_seq = 0
        self._last_target_seq = 0
        while not self._stop.is_set():
            # Reset service: ack immediately (solver state is functional).
            rseq = self._bus.seq("mpc_reset_req")
            if rseq > last_reset_seq:
                last_reset_seq = rseq
                self._bus.publish("mpc_reset_ack", b"ok")
            self._poll_commands()
            seq = self._bus.wait_for("mpc_observation", last_obs_seq,
                                     timeout_s=0.05)
            if seq <= last_obs_seq:
                continue
            seq, payload = self._bus.consume_latest("mpc_observation")
            if payload is None:
                continue
            last_obs_seq = seq
            obs = decode_observation(payload)
            # Commands published before this observation must be visible to
            # this solve (lock-step determinism): a command-then-observation
            # pair can wake the wait_for above on the observation alone.
            self._poll_commands()
            policy = self._solve_fn(obs)
            self._bus.publish("mpc_policy", encode_policy(policy))
            self.solve_count += 1

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class MrtNode(MrtBase):
    """Tracking-side node: observation out, at most one policy in per tick."""

    def __init__(self, bus: MessageBus):
        super().__init__()
        self._bus = bus
        self._last_policy_seq = 0

    def reset_mpc(self, timeout_s: float = 2.0,
                  retry_period_s: float = 0.5) -> bool:
        """Blocking reset handshake (reference MRT_ROS_Interface.cpp:61-74).

        Re-publishes the request periodically until acked: in a
        multi-process launch the planning node may still be starting up
        when the first request lands (its baseline snapshot absorbs it) —
        the reference's ROS service call blocks on service existence for
        the same reason."""
        import time
        deadline = time.monotonic() + timeout_s
        ack0 = self._bus.seq("mpc_reset_ack")
        while True:
            self._bus.publish("mpc_reset_req", b"reset")
            wait = min(retry_period_s, deadline - time.monotonic())
            if wait <= 0:
                return False
            if self._bus.wait_for("mpc_reset_ack", ack0, wait) > ack0:
                return True

    def set_current_observation(self, obs: SystemObservation) -> None:
        self._bus.publish("mpc_observation", encode_observation(obs))

    def spin_once(self) -> bool:
        """Drain at most one fresh policy into the buffer (the reference's
        callOne custom queue). Returns True if one arrived."""
        seq = self._bus.seq("mpc_policy")
        if seq <= self._last_policy_seq:
            return False
        seq, payload = self._bus.consume_latest("mpc_policy")
        if payload is None or seq <= self._last_policy_seq:
            return False
        self._last_policy_seq = seq
        self.move_to_buffer(decode_policy(payload))
        return True

    def wait_for_initial_policy(self, obs: SystemObservation,
                                timeout_s: float = 10.0) -> bool:
        """Initial handshake: publish observations until a policy arrives
        (reference MRT_ROS_Dummy_Loop.cpp:51-71)."""
        import time
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.set_current_observation(obs)
            self._bus.wait_for("mpc_policy", self._last_policy_seq,
                               timeout_s=0.1)
            if self.spin_once():
                self.update_policy()
                return True
        return False


class CommandClient:
    """Gait / target command publisher over the bus — the role of the
    reference's command nodes (`GaitKeyboardPublisher` publishing
    ModeSequenceTemplate on `_mpc_mode_schedule`,
    GaitKeyboardPublisher.cpp:62-74, and `TargetTrajectoriesRosPublisher`
    publishing on `_mpc_target`, TargetTrajectoriesRosPublisher.cpp:40-60).
    Usable from any process attached to the same bus segment."""

    def __init__(self, bus: MessageBus):
        self._bus = bus

    def publish_gait(self, name: str,
                     template: ModeSequenceTemplate) -> int:
        return self._bus.publish("mpc_mode_schedule",
                                 encode_gait_command(name, template))

    def publish_target(self, target: np.ndarray) -> int:
        return self._bus.publish("mpc_target",
                                 encode_target_command(target))
