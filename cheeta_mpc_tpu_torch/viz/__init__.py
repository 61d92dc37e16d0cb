"""Visualization data products and their rendering (numpy)."""

from cheeta_mpc_tpu_torch.viz.helpers import (  # noqa: F401
    LeggedVisualizer,
    center_of_pressure,
    support_polygon,
)
