"""The frozen work counts equal what they were copied from, at the cells'
shapes: the port's ``utils/device_timing.py`` functions and PERF.md's
figures (150.9 MFLOP per centroidal solve; K1 64.99 MFLOP, K2 66.5 GFLOP
at 1024, K3 24.93 MFLOP, K4 12.8 GFLOP at 512). The configurations'
``qp_shape`` is the shape of the QP that the port builds."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cheeta_mpc_tpu_torch.utils import device_timing as dt
from mpcbench.counts import K1, K2, K3, K4, _work, load, solve_centroidal

ROOT = Path(__file__).resolve().parents[2]


def _load(kind, name):
    return json.loads((ROOT / f"mpcbench/{kind}/{name}.json").read_text())


CEN, LEG = _load("configs", "centroidal_n10"), _load("configs",
                                                     "legged_soft_n67")
FLEET_C = _load("workloads", "centroidal.fleet1024")
FLEET_L = _load("workloads", "legged_soft.fleet512")


def test_figures():
    assert solve_centroidal.flops(CEN) / 1e6 == pytest.approx(150.9, abs=0.05)
    assert K1.work(CEN, None)[0] / 1e6 == pytest.approx(64.99, abs=0.005)
    assert K2.work(CEN, FLEET_C)[0] / 1e9 == pytest.approx(66.5, abs=0.05)
    assert K3.work(LEG, None)[0] / 1e6 == pytest.approx(24.93, abs=0.005)
    assert K4.work(LEG, FLEET_L)[0] / 1e9 == pytest.approx(12.8, abs=0.05)


@pytest.mark.parametrize("shape", [(10, 33, 24, 32, 0, 10), (67, 24, 24, 20,
                                                             16, 10),
                                   (10, 13, 12, 20, 0, 12)])
def test_equal_to_the_port(shape):
    N, nx, nu, ng, nc, it = shape
    assert _work.ipm_flops(N, nx, nu, ng, nc, it) == dt.ipm_flops(
        N, nx, nu, ng, nc, it)
    assert _work.eq_flops(N, nx, nu, nc or 16) == dt.eq_flops(N, nx, nu,
                                                              nc or 16)
    qp = _work.riccati_ipm_flops(N, nx, nu, ng, it)
    assert qp == dt.riccati_ipm_flops(N, nx, nu, ng, it)
    assert _work.solve_flops(qp, N, nx, nu, ng, 2) == \
        dt.centroidal_solve_flops(N, nx, nu, ng, 2, it)


def test_cells_name_their_qp_kernels():
    """Each cell names its QP kernels by count module, and each kernel whose
    roofline the cell reports is among them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        names = _load("workloads", w["name"])["qp_kernels"]
        assert names and all(load(k).KERNEL for k in names)
        for m in bench["per_layer"]:
            if m["name"].startswith("roofline_pct.") and \
                    w["name"] in m["workloads"]:
                assert m["name"].partition(".")[2] in names


def test_bytes_from_shapes():
    q = dict(N=2, nx=3, nu=1, ng=1, nc=0)
    inputs = 2 * (9 + 3 + 3) + 3 * (9 + 3) + 2 * (1 + 1 + 3) + 3 * 7 + 3
    assert _work.qp_bytes(q, ("dx", "du")) == 4 * (inputs + 9 + 2)


def test_qp_shapes_are_the_ports():
    from mpcbench.entries import centroidal, legged
    from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import \
        build_centroidal_solver, CentroidalMpcConfig
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import build_legged_solver
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    from mpcbench.traffic import centroidal_ticks, legged_ticks
    cfg = CentroidalMpcConfig(dtype=torch.float64,
                              **centroidal._cfg_kwargs(CEN))
    solve = build_centroidal_solver(cfg, ScpSettings(), device="cpu")
    tick = _load("workloads", "centroidal.tick")["params"]
    qp = solve.initial_qp(*centroidal_ticks.make(CEN, tick, 1)
                          .inputs(0, None).args)
    q = CEN["qp_shape"]
    assert (qp.dyn.horizon, qp.dyn.nx, qp.dyn.nu, qp.con.ng) == (
        q["N"], q["nx"], q["nu"], q["ng"])
    assert qp.eq is None and q["nc"] == 0
    from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
        QuadrupedDescription
    from cheeta_mpc_tpu_torch.models.srbd_legged import SrbdParams
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
    lcfg = legged._cfg(LEG, LeggedMpcConfig, QuadrupedDescription,
                       SrbdParams, torch.float64)
    lsolve = build_legged_solver(
        lcfg, legged._settings(LEG, ScpSettings, IpmSettings), device="cpu")
    ltick = _load("workloads", "legged_soft.tick")["params"]
    lqp = lsolve.initial_qp(*legged_ticks.make(LEG, ltick, 1)
                            .inputs(0, None).args)
    q = LEG["qp_shape"]
    assert (lqp.dyn.horizon, lqp.dyn.nx, lqp.dyn.nu, lqp.eq.nc) == (
        q["N"], q["nx"], q["nu"], q["nc"])
    assert lqp.con is None and q["ng"] == 0
    assert np.isfinite(lqp.dyn.A.numpy()).all()
