"""Solver-synchronized gait receiver.

The capability equivalent of the reference's ``GaitReceiver``
(`/root/reference/ocs2_legged_robot_ros/src/gait/GaitReceiver.cpp:40-67`):
gait commands arrive asynchronously (keyboard node / topic) and are applied
*between* solves in the solver-synchronized pre-solve hook — inserted into
the GaitSchedule at the current solve's ``finalTime`` so the running horizon
is never mutated mid-plan.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule, ModeSequenceTemplate


class GaitReceiver:
    """Buffers the latest commanded template; ``pre_solver_run`` applies it
    (reference: mpcModeSequenceCallback buffers under an atomic flag,
    preSolverRun inserts at finalTime, GaitReceiver.cpp:49-67)."""

    def __init__(self, gait_schedule: GaitSchedule,
                 on_applied: Optional[Callable] = None):
        self._gs = gait_schedule
        self._lock = threading.Lock()
        self._pending: Optional[ModeSequenceTemplate] = None
        self._pending_name: Optional[str] = None
        self.applied: List[tuple] = []  # (name, insert_time) log
        self._on_applied = on_applied

    def on_command(self, name: str, template: ModeSequenceTemplate) -> None:
        """Async command entry (the keyboard/topic side)."""
        with self._lock:
            self._pending = template
            self._pending_name = name

    def pre_solver_run(self, init_time: float, final_time: float) -> bool:
        """Apply the buffered template at final_time (the reference inserts
        at finalTime so the change lands beyond the current horizon,
        GaitReceiver.cpp:49-57). Returns True if a template was applied."""
        with self._lock:
            template, name = self._pending, self._pending_name
            self._pending = self._pending_name = None
        if template is None:
            return False
        self._gs.insert_template(template, insert_time=final_time)
        self.applied.append((name, final_time))
        if self._on_applied is not None:
            self._on_applied(name, final_time)
        return True
