"""Gait layer (numpy only): copies of the JAX package's modules of the same
names, so that the port imports nothing of that package."""

from cheeta_mpc_tpu_torch.gait.motion_phase import (  # noqa: F401
    contact_flags_of_mode,
    mode_number,
    mode_name,
)
from cheeta_mpc_tpu_torch.gait.receiver import GaitReceiver  # noqa: F401
from cheeta_mpc_tpu_torch.gait.schedule import (  # noqa: F401
    GaitSchedule,
    ModeSchedule,
    ModeSequenceTemplate,
)
from cheeta_mpc_tpu_torch.gait.swing import (  # noqa: F401
    CubicSpline,
    SplineCpg,
    SwingTrajectoryPlanner,
)
