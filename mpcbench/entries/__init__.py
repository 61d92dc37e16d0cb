"""Adapters to the program's entry points, one module per configuration
``family``.

A family module has:

- ``program(config, device) -> Entry``: the port's entry point built from
  the configuration file, as a user builds it. This is the only place the
  harness imports the port, and it does so inside the function.
- ``reference(config, device, dtype) -> callable``: the same solve through
  ``mpcbench.reference`` (no import of the port), called as ``fn(inputs)``
  with :class:`mpcbench.traffic.Inputs` and returning the outputs by name
  as tensors.
- ``gaps(got, want) -> dict``: the numbers that ``correct`` compares, from
  the outputs the caller read (numpy) and the reference's.
"""

from __future__ import annotations

import importlib
from typing import Callable, NamedTuple, Optional


class Entry(NamedTuple):
    """``call(inputs)`` runs one call and returns its outputs by name as
    tensors (still on the device); ``graph_stats(inputs)`` the stats of the
    CUDA graph that the call's signature replays (None where nothing is
    graphed)."""

    call: Callable
    graph_stats: Callable[..., Optional[dict]]


def load(family: str):
    """The family module ``mpcbench.entries.<family>``."""
    if not family.replace("_", "").isalnum():
        raise ValueError(f"bad entry family {family!r}")
    return importlib.import_module(f"mpcbench.entries.{family}")
