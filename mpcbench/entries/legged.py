"""The legged SRBD MPC: the port's ``build_legged_solver`` graphed by
``utils.cuda_graph.graphed``, as the planning node holds it (K3 at batch 1
and K4 for a batch on the soft cone), and the same solve through the
frozen reference."""

from __future__ import annotations

import numpy as np
import torch

from mpcbench.entries import Entry

OUTPUTS = ("forces", "u_traj", "x_traj")


def _model(config: dict, desc_cls, params_cls):
    m = config["model"]
    desc = desc_cls(hip_offsets=tuple(tuple(h) for h in m["hip_offsets"]),
                    hip_length=m["hip_length"],
                    thigh_length=m["thigh_length"],
                    shank_length=m["shank_length"], mass=m["mass"],
                    inertia=tuple(m["inertia"]),
                    com_offset=tuple(m["com_offset"]))
    return params_cls(desc=desc, dt=m["dt"], integrator=m["integrator"])


def _cfg(config: dict, cfg_cls, desc_cls, params_cls, dtype):
    return cfg_cls(params=_model(config, desc_cls, params_cls),
                   horizon=config["horizon"],
                   q_diag=tuple(config["q_diag"]),
                   r_diag=tuple(config["r_diag"]),
                   friction_mu=config["friction_mu"],
                   position_error_gain=config["position_error_gain"],
                   force_max=config["force_max"],
                   cone_mode=config["cone_mode"],
                   barrier_mu=config["barrier_mu"],
                   barrier_delta=config["barrier_delta"], dtype=dtype)


def _settings(config: dict, scp_cls, ipm_cls):
    s = config["solver"]
    ipm = ipm_cls(iters=s["ipm_iterations"], reg=s["reg"],
                  mu_tol=s["mu_tol"], w_max=s["w_max"])
    return scp_cls(iterations=s["sqp_iterations"], ipm=ipm,
                   alphas=tuple(s["alphas"]))


def _outputs(sol) -> dict:
    return {name: getattr(sol, name) for name in OUTPUTS}


def program(config: dict, device) -> Entry:
    from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
        QuadrupedDescription
    from cheeta_mpc_tpu_torch.models.srbd_legged import SrbdParams
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                     build_legged_solver)
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    from cheeta_mpc_tpu_torch.utils.cuda_graph import graphed
    cfg = _cfg(config, LeggedMpcConfig, QuadrupedDescription, SrbdParams,
               torch.float32)
    solve = graphed(build_legged_solver(
        cfg, _settings(config, ScpSettings, IpmSettings),
        device=device), device)

    def call(inputs):
        return _outputs(solve(*inputs.args, warm=inputs.warm))

    def graph_stats(inputs):
        entry_of = getattr(solve, "entry_of", None)
        if entry_of is None:
            return None
        entry = entry_of(*inputs.args, warm=inputs.warm)
        return None if entry is None else entry.stats

    return Entry(call, graph_stats)


def reference(config: dict, device, dtype):
    from mpcbench.reference.legged_mpc import (LeggedMpcConfig,
                                               build_legged_solver)
    from mpcbench.reference.ocpqp import IpmSettings
    from mpcbench.reference.quadruped_kinematics import QuadrupedDescription
    from mpcbench.reference.scp import ScpSettings
    from mpcbench.reference.srbd_legged import SrbdParams
    cfg = _cfg(config, LeggedMpcConfig, QuadrupedDescription, SrbdParams,
               dtype)
    solve = build_legged_solver(
        cfg, _settings(config, ScpSettings, IpmSettings),
        device=device)

    def call(inputs):
        return _outputs(solve(*inputs.args, warm=inputs.warm))

    return call


def gaps(got: dict, want: dict) -> dict:
    """The widest gap of a contact force (N), of a joint velocity (rad/s,
    the last 12 inputs) and of a state (the trajectory the solve returns,
    whatever its unit)."""
    return {"force_gap_N": _widest(got["forces"], want["forces"]),
            "vel_gap": _widest(got["u_traj"][..., 12:],
                               want["u_traj"][..., 12:]),
            "state_gap": _widest(got["x_traj"], want["x_traj"])
            if "x_traj" in got else None}


def _widest(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))
