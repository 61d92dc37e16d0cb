"""The centroidal MPC: ``CentroidalMPC.update_mpc`` of the port (one CUDA
graph per call signature, K1 at batch 1 and K2 for a batch), and the same
solve through the frozen reference."""

from __future__ import annotations

import numpy as np
import torch

from mpcbench.entries import Entry

OUTPUTS = ("contact_force", "u_traj", "x_traj")


def _cfg_kwargs(config: dict) -> dict:
    return dict(mass=config["mass"], num_legs=config["num_legs"],
                horizon=config["horizon"], dt=config["dt"],
                weights=tuple(config["weights"]), mu=tuple(config["mu"]),
                foot_step_lb=tuple(config["foot_step_lb"]),
                foot_step_ub=tuple(config["foot_step_ub"]),
                force_max=config["force_max"], reg_eps=config["reg_eps"])


def _settings(config: dict, scp_cls, ipm_cls):
    s = config["solver"]
    ipm = ipm_cls(iters=s["ipm_iterations"], tau=s["tau"], mu0=s["mu0"],
                  s0_min=s["s0_min"], reg=s["reg"], w_max=s["w_max"],
                  mu_tol=s["mu_tol"])
    return scp_cls(iterations=s["sqp_iterations"], ipm=ipm,
                   alphas=tuple(s["alphas"]))


def _outputs(sol) -> dict:
    return {name: getattr(sol, name) for name in OUTPUTS}


def program(config: dict, device) -> Entry:
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import CentroidalMPC
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    kw = _cfg_kwargs(config)
    scp = _settings(config, ScpSettings, IpmSettings)
    mpc = CentroidalMPC(kw["mass"], kw["num_legs"], kw["horizon"], kw["dt"],
                        kw["weights"], kw["mu"], dtype=torch.float32,
                        scp=scp, device=device)
    # The facade takes the model's settings; the configuration's further
    # constraint settings go in as the config it keeps.
    mpc.config = mpc.config._replace(
        foot_step_lb=kw["foot_step_lb"], foot_step_ub=kw["foot_step_ub"],
        force_max=kw["force_max"], reg_eps=kw["reg_eps"])
    mpc.setup_mpc()

    def call(inputs):
        return _outputs(mpc.update_mpc(*inputs.args, warm=inputs.warm))

    def graph_stats(inputs):
        graphs = getattr(mpc.solver, "entry_of", None)
        if graphs is None:
            return None
        entry = graphs(*inputs.args, warm=inputs.warm)
        return None if entry is None else entry.stats

    return Entry(call, graph_stats)


def reference(config: dict, device, dtype):
    from mpcbench.reference.centroidal_mpc import (CentroidalMpcConfig,
                                                   build_centroidal_solver)
    from mpcbench.reference.ocpqp import IpmSettings
    from mpcbench.reference.scp import ScpSettings
    cfg = CentroidalMpcConfig(dtype=dtype, **_cfg_kwargs(config))
    solve = build_centroidal_solver(
        cfg, _settings(config, ScpSettings, IpmSettings),
        device=device)

    def call(inputs):
        return _outputs(solve(*inputs.args, warm=inputs.warm))

    return call


def gaps(got: dict, want: dict) -> dict:
    """The widest gap of a contact force (N), of a foot velocity (m/s, the
    first 3 x legs inputs) and of a state (the trajectory the solve
    returns, whatever its unit)."""
    nf = got["u_traj"].shape[-1] // 2
    return {"force_gap_N": _widest(got["contact_force"],
                                   want["contact_force"]),
            "vel_gap": _widest(got["u_traj"][..., :nf],
                               want["u_traj"][..., :nf]),
            "state_gap": _widest(got["x_traj"], want["x_traj"])
            if "x_traj" in got else None}


def _widest(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))
