"""The legged SRBD MPC with the hard friction pyramid: the entry point, the
reference and the gaps of :mod:`mpcbench.entries.legged` (K1 at batch 1
and K2 for a batch, each with the 16 stage-equality rows), whose graph
stats gain ``ipm_sections``: the section timers of the interior-point
kernel that the call launches, at the call's QP and the configuration's
IPM settings (``ops/cuda_ipm_riccati.phase_cycles``).

The timed launches run when a reader first asks for the record, after the
measured window and the profiler's session, and only on the card."""

from __future__ import annotations

from collections import ChainMap
from collections.abc import Mapping

import numpy as np
import torch

from mpcbench.entries import Entry
from mpcbench.entries.legged import (_cfg, _settings, gaps, program as
                                     _graphed_program, reference)

__all__ = ["program", "reference", "gaps"]

SINGLE_ENTRY = "cheeta_ipm_riccati_single"
FLEET_ENTRY = "cheeta_ipm_riccati_fleet"


class _Lazy(Mapping):
    """One key whose value ``make()`` computes at its first reading."""

    def __init__(self, key: str, make):
        self.key, self.make, self.value = key, make, None

    def __getitem__(self, key):
        if key != self.key:
            raise KeyError(key)
        if self.value is None:
            self.value = self.make()
        return self.value

    def __iter__(self):
        yield self.key

    def __len__(self):
        return 1


def program(config: dict, device) -> Entry:
    from cheeta_mpc_tpu_torch.core.types import tree_map
    from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
        QuadrupedDescription
    from cheeta_mpc_tpu_torch.models.srbd_legged import SrbdParams
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                     build_legged_solver)
    from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    graphed = _graphed_program(config, device)
    settings = _settings(config, ScpSettings, IpmSettings)
    # The unwrapped solve, for the QP that a call's graph solves first.
    solve = build_legged_solver(
        _cfg(config, LeggedMpcConfig, QuadrupedDescription, SrbdParams,
             torch.float32), settings, device=device)

    def sections(inputs):
        # Dense copies: a solve called outside its graph hands the rows to
        # L1 as they come, and versions of the port before the solver made
        # them dense itself refuse strided ones.
        args = tuple(np.ascontiguousarray(a) for a in inputs.args)
        qp = tree_map(lambda t: t.contiguous(),
                      solve.initial_qp(*args, warm=inputs.warm))
        entry = FLEET_ENTRY if qp.dx0.dim() > 1 else SINGLE_ENTRY
        rec = cuda_ipm_riccati.phase_cycles(entry, qp, settings.ipm)
        return dict(rec, entry=entry)

    def graph_stats(inputs):
        stats = graphed.graph_stats(inputs)
        if stats is None:
            return None
        # A live view: the program folds its stage timers into ``stats``
        # at the profiler's first call, after this is taken.
        return ChainMap(_Lazy("ipm_sections", lambda: sections(inputs)),
                        stats)

    return Entry(graphed.call, graph_stats)
