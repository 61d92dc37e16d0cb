"""State carried across packages: numpy / plain dicts in, port objects out.

The port has no weights; what it shares with the JAX package in a
cross-package test is configuration, problem data and warm starts. This
module is the port-side half of that exchange and imports no JAX: the JAX
side (pytree -> dict of numpy) lives with the tests, which alone may import
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from cheeta_mpc_tpu_torch.core.types import (CostApprox, DynamicsLin,
                                             OcpQpData, StageConstraint,
                                             StageEquality, resolve_device)
from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
    QuadrupedDescription
from cheeta_mpc_tpu_torch.models.srb import SrbParams
from cheeta_mpc_tpu_torch.models.srbd_legged import SrbdParams
from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import CentroidalMpcConfig
from cheeta_mpc_tpu_torch.mpc.convex_mpc import ConvexMpcConfig
from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# Names of the JAX package's kernel backend -> the port's.
_QP_BACKENDS = {"riccati_pallas": "riccati_kernel"}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name such as
    ``'float32'`` / ``"<class 'jax.numpy.float64'>"``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    for key, val in _DTYPES.items():
        if key in name:
            return val
    raise ValueError(f"unsupported dtype {dtype!r}: expected float32/float64")


def _known(cls, d: Mapping) -> dict:
    unknown = set(d) - set(cls._fields)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return dict(d)


def ipm_settings_from_dict(d: Mapping) -> IpmSettings:
    """From the ``_asdict()`` of the JAX package's ``IpmSettings``."""
    return IpmSettings(**_known(IpmSettings, d))


def scp_settings_from_dict(d: Mapping) -> ScpSettings:
    """From the ``_asdict()`` of the JAX package's ``ScpSettings``; the
    nested ``ipm`` may be a dict or an ``_asdict()``-able tuple, and
    ``'riccati_pallas'`` becomes ``'riccati_kernel'``."""
    d = _known(ScpSettings, d)
    ipm = d.get("ipm", IpmSettings())
    if not isinstance(ipm, Mapping):
        ipm = ipm._asdict()
    d["ipm"] = ipm_settings_from_dict(ipm)
    if "alphas" in d:
        d["alphas"] = tuple(float(a) for a in d["alphas"])
    if "qp_backend" in d:
        d["qp_backend"] = _QP_BACKENDS.get(d["qp_backend"], d["qp_backend"])
    return ScpSettings(**d)


def config_from_dict(d: Mapping) -> CentroidalMpcConfig:
    """From the ``_asdict()`` of the JAX package's ``CentroidalMpcConfig``
    (``dtype`` as a name or a numpy dtype)."""
    d = _known(CentroidalMpcConfig, d)
    if "dtype" in d:
        d["dtype"] = torch_dtype(d["dtype"])
    for key in ("weights", "mu", "foot_step_lb", "foot_step_ub"):
        if key in d:
            d[key] = tuple(float(v) for v in d[key])
    return CentroidalMpcConfig(**d)


def _tuples(v):
    """Nested sequences -> nested tuples of floats (hashable config)."""
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_tuples(x) for x in v)
    return float(v)


def legged_config_from_dict(d: Mapping) -> LeggedMpcConfig:
    """From the ``_asdict()`` of the JAX package's ``LeggedMpcConfig``
    (``dtype`` as a name or a numpy dtype; ``params`` and its ``desc`` as
    NamedTuples, ``_asdict()``s or dicts)."""
    d = _known(LeggedMpcConfig, d)
    if "dtype" in d:
        d["dtype"] = torch_dtype(d["dtype"])
    for key in ("q_diag", "r_diag"):
        if key in d:
            d[key] = _tuples(d[key])
    if "params" in d:
        prm = d["params"]
        prm = dict(prm if isinstance(prm, Mapping) else prm._asdict())
        desc = prm.get("desc", QuadrupedDescription())
        desc = dict(desc if isinstance(desc, Mapping) else desc._asdict())
        for key in ("hip_offsets", "inertia", "com_offset"):
            if key in desc:
                desc[key] = _tuples(desc[key])
        prm["desc"] = QuadrupedDescription(
            **_known(QuadrupedDescription, desc))
        d["params"] = SrbdParams(**_known(SrbdParams, prm))
    return LeggedMpcConfig(**d)


def convex_config_from_dict(d: Mapping) -> ConvexMpcConfig:
    """From the ``_asdict()`` of the JAX package's ``ConvexMpcConfig``
    (``dtype`` as a name or a numpy dtype; ``params`` as an ``SrbParams``
    NamedTuple of either package, its ``_asdict()`` or a dict)."""
    d = _known(ConvexMpcConfig, d)
    if "dtype" in d:
        d["dtype"] = torch_dtype(d["dtype"])
    if "q_diag" in d:
        d["q_diag"] = _tuples(d["q_diag"])
    if "params" in d:
        prm = d["params"]
        prm = dict(prm if isinstance(prm, Mapping) else prm._asdict())
        if "inertia" in prm:
            prm["inertia"] = _tuples(prm["inertia"])
        d["params"] = SrbParams(**_known(SrbParams, prm))
    return ConvexMpcConfig(**d)


def qp_data_from_numpy(d: Mapping, dtype=None, device="cuda") -> OcpQpData:
    """``{A, B, b, Q, q, R, r, S, dx0[, C, D, lg, ug, mask][, eq: {C, D, e,
    mask}]}`` of numpy arrays -> :class:`OcpQpData`. ``dtype`` defaults to
    the arrays' own. The tensors go to the card unless the caller asks for
    ``device="cpu"``; without a card the default raises."""
    dt: Optional[torch.dtype] = None if dtype is None else torch_dtype(dtype)
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    con = None
    if d.get("C") is not None:
        con = StageConstraint(C=t(d["C"]), D=t(d["D"]), lg=t(d["lg"]),
                              ug=t(d["ug"]), mask=t(d["mask"]))
    eq = None
    if d.get("eq") is not None:
        e = d["eq"]
        eq = StageEquality(C=t(e["C"]), D=t(e["D"]), e=t(e["e"]),
                           mask=t(e["mask"]))
    return OcpQpData(
        dyn=DynamicsLin(A=t(d["A"]), B=t(d["B"]), b=t(d["b"])),
        cost=CostApprox(Q=t(d["Q"]), q=t(d["q"]), R=t(d["R"]), r=t(d["r"]),
                        S=t(d["S"])),
        con=con, dx0=t(d["dx0"]), eq=eq)


def warm_from_numpy(x_traj, u_traj, dtype=torch.float32, device="cuda"):
    """A warm start ``(x_traj, u_traj)`` for ``solve(..., warm=...)`` of the
    centroidal or the legged solver, on the card unless the caller asks for
    ``device="cpu"``."""
    dt = torch_dtype(dtype)
    device = resolve_device(device)
    return (torch.as_tensor(np.asarray(x_traj), dtype=dt, device=device),
            torch.as_tensor(np.asarray(u_traj), dtype=dt, device=device))


def solution_to_numpy(sol):
    """Any of the port's containers (dataclass, NamedTuple, tensor, nested)
    -> the same nesting of dicts of numpy arrays."""
    if sol is None:
        return None
    if isinstance(sol, torch.Tensor):
        return sol.detach().cpu().numpy()
    if dataclasses.is_dataclass(sol):
        return {f.name: solution_to_numpy(getattr(sol, f.name))
                for f in dataclasses.fields(sol)}
    if hasattr(sol, "_asdict"):
        return {k: solution_to_numpy(v) for k, v in sol._asdict().items()}
    if isinstance(sol, Mapping):
        return {k: solution_to_numpy(v) for k, v in sol.items()}
    return sol
