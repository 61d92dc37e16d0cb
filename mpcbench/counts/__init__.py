"""Work counts of the yardstick, frozen here so that a change to the
program cannot change them.

- ``<K>.py`` per QP kernel: ``KERNEL``, the name the profiler's trace gives
  the kernel, and ``work(config, workload) -> (operations, bytes)`` of one
  launch at the cell's shapes: the operations the kernel's algorithm needs
  (2 per multiply-add) and the bytes of the problem's inputs read once and
  outputs written once, from the problem's shapes alone.
- ``solve_<family>.py``: ``flops(config)``, one whole solve of the family,
  counted as the JAX package counts a solve's structured mathematics
  (the centroidal family only: the legged solve has no such count yet).
"""

from __future__ import annotations

import importlib


def load(name: str):
    """The count module ``mpcbench.counts.<name>``."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad count name {name!r}")
    return importlib.import_module(f"mpcbench.counts.{name}")

