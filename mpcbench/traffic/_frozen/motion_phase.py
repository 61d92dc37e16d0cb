"""Motion phase definitions: mode number <-> contact flags.

The reference's 16-mode enum over {LF, RF, LH, RH}
(``ocs2_legged_robot/include/.../gait/MotionPhaseDefinition.h:46-150``).
Leg order matches the reference: [LF, RF, LH, RH]; the mode number packs the
contact flags as bits with LF the most significant:
    mode = 8*LF + 4*RF + 2*LH + 1*RH  (STANCE = 15, FLY = 0).
"""

from __future__ import annotations

import numpy as np

LEG_NAMES = ("LF", "RF", "LH", "RH")

_MODE_NAMES = {
    0: "FLY", 1: "RH", 2: "LH", 3: "LH_RH", 4: "RF", 5: "RF_RH",
    6: "RF_LH", 7: "RF_LH_RH", 8: "LF", 9: "LF_RH", 10: "LF_LH",
    11: "LF_LH_RH", 12: "LF_RF", 13: "LF_RF_RH", 14: "LF_RF_LH",
    15: "STANCE",
}
_NAME_TO_MODE = {v: k for k, v in _MODE_NAMES.items()}


def contact_flags_of_mode(mode) -> np.ndarray:
    """(..., 4) flags in leg order [LF, RF, LH, RH] for integer mode(s)."""
    mode = np.asarray(mode)
    return np.stack([(mode >> 3) & 1, (mode >> 2) & 1,
                     (mode >> 1) & 1, mode & 1], axis=-1).astype(np.float64)


def mode_from_name(name: str) -> int:
    return _NAME_TO_MODE[name.upper()]
