"""The convex SRB MPC: the port's ``build_convex_mpc`` (one CUDA graph per
call signature, K1 at batch 1 and K2 for a batch of scenarios), and the
same solve through the frozen reference. The graph stats gain
``ipm_sections``, the section timers of the interior-point kernel that the
call launches, at the call's QP (``ops/cuda_ipm_riccati.phase_cycles``),
timed when a reader first asks for them, as :mod:`legged_ipm` does.

What ``correct`` compares (``gaps``). The forces between stance legs that
add up to no net force and no net moment are nearly free in this QP (the
stance force regularization is 1e-6), so float32 does not pin them down
(ROADMAP queue 3); the gaps read each answer's forces, the wrench they
exert and the predicted state trajectory over the whole horizon, the
widest over a block of answers and the widest in all but rare answers
(``QUANTILE``). The gaps are computed from the forces and the state
trajectory the caller reads, never from the gains (the fleet kernel
returns NaN gains by design)."""

from __future__ import annotations

from collections import ChainMap

import numpy as np
import torch

from mpcbench.entries import Entry
from mpcbench.entries.legged_ipm import FLEET_ENTRY, SINGLE_ENTRY, _Lazy

__all__ = ["program", "reference", "gaps"]

# The ``*_p99`` gaps: this percentile of the answers' widest gaps over the
# answers that the reference solves at once (a block of at most 512, the
# widest over the blocks). After the fixed 12 iterations most answers have not reached the
# freeze, and in about one answer in 10^3-10^4 the interior point's step
# decisions part between float32 and float64 (the plain version on the CPU
# and K1/K2 on the card alike), which moves that answer's forces by up to
# ~1 N and its states by up to ~0.06.
QUANTILE = 99.0


def _cfg(config: dict, cfg_cls, params_cls, dtype):
    m = config["model"]
    params = params_cls(mass=m["mass"], inertia=tuple(m["inertia"]),
                        num_legs=m["num_legs"], mu=m["mu"],
                        fz_min=m["fz_min"], fz_max=m["fz_max"])
    return cfg_cls(params=params, horizon=config["horizon"],
                   dt=config["dt"], q_diag=tuple(config["q_diag"]),
                   r_force=config["r_force"], dtype=dtype)


def _settings(config: dict, ipm_cls):
    s = config["solver"]
    return ipm_cls(iters=s["ipm_iterations"], tau=s["tau"], mu0=s["mu0"],
                   s0_min=s["s0_min"], reg=s["reg"], w_max=s["w_max"],
                   mu_tol=s["mu_tol"])


def program(config: dict, device) -> Entry:
    from cheeta_mpc_tpu_torch.core.types import tree_map
    from cheeta_mpc_tpu_torch.models.srb import SrbParams
    from cheeta_mpc_tpu_torch.mpc.convex_mpc import (ConvexMpcConfig,
                                                     build_convex_mpc)
    from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    ipm = _settings(config, IpmSettings)
    solve = build_convex_mpc(
        _cfg(config, ConvexMpcConfig, SrbParams, torch.float32), ipm,
        device=device)

    def call(inputs):
        forces, sol = solve(*inputs.args)
        return {"forces": forces, "dx": sol.dx}

    def sections(inputs):
        qp = tree_map(lambda t: t.contiguous(),
                      solve.initial_qp(*inputs.args))
        entry = FLEET_ENTRY if qp.dx0.dim() > 1 else SINGLE_ENTRY
        rec = cuda_ipm_riccati.phase_cycles(entry, qp, ipm)
        return dict(rec, entry=entry)

    def graph_stats(inputs):
        entry_of = getattr(solve, "entry_of", None)
        entry = None if entry_of is None else entry_of(*inputs.args)
        if entry is None:
            return None
        # A live view: the program folds its stage timers into ``stats``
        # at the profiler's first call, after this is taken.
        return ChainMap(_Lazy("ipm_sections", lambda: sections(inputs)),
                        entry.stats)

    return Entry(call, graph_stats)


def reference(config: dict, device, dtype):
    from mpcbench.reference.convex_mpc import (ConvexMpcConfig,
                                               build_convex_mpc)
    from mpcbench.reference.ocpqp import IpmSettings
    from mpcbench.reference.srb import SrbParams
    cfg = _cfg(config, ConvexMpcConfig, SrbParams, dtype)
    solve = build_convex_mpc(cfg, _settings(config, IpmSettings),
                             device=device)
    m = config["model"]
    kw = dict(dtype=dtype, device=device)
    cone = torch.tensor([m["mu"], m["fz_min"], m["fz_max"]], **kw)

    def call(inputs):
        x0, feet, enable = (torch.as_tensor(inputs.args[i], **kw)
                            for i in (0, 2, 3))
        forces, sol = solve(*inputs.args)
        lead = x0.shape[:-1]
        # What the gaps read beside the answer: each foot's arm about the
        # CoM (the model's, held over the horizon), the contact flags and
        # the pyramid's (mu, fz_min, fz_max).
        return {"forces": forces, "dx": sol.dx,
                "arms": (feet - x0[..., None, 3:6]).expand(lead + (4, 3)),
                "enable": enable.expand(lead + enable.shape[-2:]),
                "cone": cone.expand(lead + (3,))}

    return call


def _wrench(forces, arms, enable):
    """(..., N, 6): per stage the net force (N) and the net moment about the
    CoM (N m) of the stance legs' forces."""
    f = forces * enable[..., None]
    moment = np.cross(arms[..., None, :, :], f)
    return np.concatenate([f.sum(-2), moment.sum(-2)], -1)


def _outside(forces, cone, enable):
    """(..., N, 4): how far each force lies outside its feasible set (N): a
    stance force's pyramid (0 inside it), a swing force's zero."""
    mu, lo, hi = (cone[..., i, None, None] for i in range(3))
    fx, fy, fz = forces[..., 0], forces[..., 1], forces[..., 2]
    rows = np.stack([np.abs(fx) - mu * fz, np.abs(fy) - mu * fz, lo - fz,
                     fz - hi], -1)
    pyramid = np.maximum(rows.max(-1), 0.0)
    return np.where(enable > 0, pyramid, np.abs(forces).max(-1))


def gaps(got: dict, want: dict) -> dict:
    """The numbers that ``correct`` compares, from a block of answers (or
    one), in float64, each over the whole horizon. The reference's
    swing-leg forces are exactly 0, so a swing force of the program's
    counts in every force gap and in ``cone_gap_N``.

    Per answer: the widest gap of a force (N), of the stance legs' wrench
    per stage (net force in N, net moment about the CoM in N m) and of the
    predicted state trajectory (``dx`` = x - x_ref, with the reference's
    x_ref on both sides, whatever each state's unit). Each is read as the
    widest over the block (``force_gap_N``, ``wrench_gap``, ``state_gap``)
    and at the ``QUANTILE``-th percentile over the block's answers
    (``force_p99_N``, ``wrench_p99``, ``state_p99``). Beside them, how far
    a force leaves its feasible set (a stance leg's pyramid, a swing leg's
    zero) beyond the reference's own, the widest over the block
    (``cone_gap_N``, N)."""
    f, f_ref = (np.asarray(d["forces"], np.float64) for d in (got, want))
    arms, enable, cone = (np.asarray(want[k], np.float64)
                          for k in ("arms", "enable", "cone"))
    N = f.shape[-3]
    widest = {  # each answer's
        "force": np.abs(f - f_ref).reshape(-1, N * 12).max(-1),
        "wrench": np.abs(_wrench(f, arms, enable) - _wrench(
            f_ref, arms, enable)).reshape(-1, N * 6).max(-1),
        "state": np.abs(np.asarray(got["dx"], np.float64)
                        - np.asarray(want["dx"], np.float64)
                        ).reshape(-1, (N + 1) * 13).max(-1)}
    out = {"cone_gap_N": float(np.max(_outside(f, cone, enable)
                                      - _outside(f_ref, cone, enable),
                                      initial=0.0))}
    for k, unit in (("force", "_N"), ("wrench", ""), ("state", "")):
        out[f"{k}_gap{unit}"] = float(widest[k].max())
        out[f"{k}_p99{unit}"] = float(np.percentile(widest[k], QUANTILE))
    return out
