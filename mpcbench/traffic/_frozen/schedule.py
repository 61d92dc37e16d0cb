"""Gait scheduling: mode sequences, templates, tiling.

Host-side planning utilities re-creating the reference's gait layer:
- ``ModeSequenceTemplate`` — phase-based gait {duration, eventPhases in (0,1),
  modeSequence} with validity checks (reference ``Gait.cpp:44-124`` /
  ``ModeSequenceTemplate.cpp:41-114``).
- ``GaitSchedule`` — mode-sequence state machine: template insertion at a
  time (with a stance transition), history trimming, periodic template tiling
  out to the horizon (reference ``GaitSchedule.cpp:46-137``).
- ``ModeSchedule`` — {eventTimes, modeSequence} with mode lookup.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from mpcbench.traffic._frozen.motion_phase import contact_flags_of_mode

STANCE_MODE = 15


@dataclass
class ModeSequenceTemplate:
    """One gait cycle: switchingTimes (len M+1, starts at 0) and modeSequence
    (len M). Reference ModeSequenceTemplate.cpp:41-68 stores the same."""

    switching_times: List[float]
    mode_sequence: List[int]

    def __post_init__(self):
        assert len(self.switching_times) == len(self.mode_sequence) + 1
        assert all(b > a for a, b in zip(self.switching_times,
                                         self.switching_times[1:]))
        assert abs(self.switching_times[0]) < 1e-12

    @property
    def duration(self) -> float:
        return self.switching_times[-1]


@dataclass
class ModeSchedule:
    """{event_times (len E), mode_sequence (len E+1)}: mode_sequence[i]
    active on (event_times[i-1], event_times[i])."""

    event_times: List[float]
    mode_sequence: List[int]

    def mode_at(self, t: float) -> int:
        idx = bisect.bisect_right(self.event_times, t)
        return self.mode_sequence[idx]


@dataclass
class GaitSchedule:
    """Template-driven schedule with insertion + tiling.

    ``phase_transition_stance_time`` inserts a full-stance buffer before a
    newly commanded gait (reference GaitSchedule.cpp:52-66, default 0.4 s
    from ModelSettings).
    """

    mode_schedule: ModeSchedule
    template: ModeSequenceTemplate
    phase_transition_stance_time: float = 0.4

    @classmethod
    def stance(cls, template: ModeSequenceTemplate,
               t0: float = 0.0) -> "GaitSchedule":
        return cls(ModeSchedule([t0], [STANCE_MODE, STANCE_MODE]), template)

    def insert_template(self, template: ModeSequenceTemplate,
                        insert_time: float) -> None:
        """Switch to a new gait at ``insert_time`` (with stance buffer).
        Reference GaitSchedule.cpp:46-73."""
        ms = self.mode_schedule
        # Drop everything scheduled after the insertion point.
        keep = bisect.bisect_left(ms.event_times, insert_time)
        ms.event_times = ms.event_times[:keep]
        ms.mode_sequence = ms.mode_sequence[:keep + 1]
        t = insert_time
        if self.phase_transition_stance_time > 0:
            ms.event_times.append(t)
            ms.mode_sequence.append(STANCE_MODE)
            t += self.phase_transition_stance_time
        ms.event_times.append(t)
        ms.mode_sequence.append(template.mode_sequence[0])
        self.template = template
        self._tile_to(t, t + template.duration)

    def _tile_to(self, start: float, final: float) -> None:
        """Append periodic template cycles until ``final`` is covered
        (reference tileModeSequenceTemplate, GaitSchedule.cpp:107-137)."""
        ms = self.mode_schedule
        tmpl = self.template
        t = ms.event_times[-1] if ms.event_times else start
        while t < final:
            base = t
            for i, mode in enumerate(tmpl.mode_sequence):
                if i == 0 and ms.mode_sequence[-1] == mode:
                    pass  # mode continues; only add the *next* event
                seg_end = base + tmpl.switching_times[i + 1]
                ms.event_times.append(seg_end)
                ms.mode_sequence.append(
                    tmpl.mode_sequence[(i + 1) % len(tmpl.mode_sequence)])
            t = base + tmpl.duration

    def get_mode_schedule(self, lower: float, upper: float) -> ModeSchedule:
        """Trim history below ``lower`` and tile out beyond ``upper``
        (reference GaitSchedule.cpp:78-101, called with [t0-T, tf+T])."""
        self._tile_to(lower, upper)
        ms = self.mode_schedule
        keep = bisect.bisect_left(ms.event_times, lower)
        ms.event_times = ms.event_times[keep:]
        ms.mode_sequence = ms.mode_sequence[keep:]
        return ModeSchedule(list(ms.event_times), list(ms.mode_sequence))


def trot_template(cycle: float = 0.7) -> ModeSequenceTemplate:
    """The gait.info 'trot': two diagonal pairs, 50/50 split
    (reference config/command/gait.info)."""
    from mpcbench.traffic._frozen.motion_phase import mode_from_name
    return ModeSequenceTemplate(
        switching_times=[0.0, cycle / 2, cycle],
        mode_sequence=[mode_from_name("LF_RH"), mode_from_name("RF_LH")])
