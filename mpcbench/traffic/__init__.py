"""Traffic generators, one module per ``kind`` of a workload file.

A kind module has ``make(config, params, seed) -> Traffic``: it reads the
configuration's sizes and the workload's ``params`` and makes every input
of the run from ``seed`` in numpy, in set-up. The harness then asks it for
the inputs of call ``k`` (:meth:`Traffic.inputs`), handing it the outputs
of call ``k - 1`` that the caller read, so that a tick can be warm-started
from the previous solution. A new cell of a known kind is a workload file
alone.
"""

from __future__ import annotations

import importlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np


class Inputs(NamedTuple):
    """One call's inputs: the entry's positional arrays and the warm start
    ``(x_traj, u_traj)`` or None (a cold start)."""

    args: tuple
    warm: Optional[tuple]


class Traffic(NamedTuple):
    """What a kind module makes.

    ``batch`` is None for calls of one unbatched problem, else the leading
    batch size of every call. ``reads`` names the outputs the caller uses:
    the clock stops once they are numpy arrays on the host. ``warmup`` is
    the number of calls set-up makes before the window (they capture every
    call signature the window uses); ``inputs(k, prev)`` gives call ``k``,
    with ``prev`` the outputs that call ``k - 1`` read (None for ``k = 0``).
    """

    batch: Optional[int]
    reads: Sequence[str]
    warmup: int
    inputs: Callable[[int, Optional[dict]], Inputs]


def load(kind: str):
    """The kind module ``mpcbench.traffic.<kind>``."""
    if not kind.replace("_", "").isalnum():
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"mpcbench.traffic.{kind}")


def shift(x_traj: np.ndarray, u_traj: np.ndarray) -> tuple:
    """A solution shifted one node forward, its last node repeated: the warm
    start of the next tick."""
    return (np.concatenate([x_traj[..., 1:, :], x_traj[..., -1:, :]], -2),
            np.concatenate([u_traj[..., 1:, :], u_traj[..., -1:, :]], -2))
