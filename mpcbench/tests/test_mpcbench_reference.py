"""The frozen reference agrees with the port's plain executor in float64 on
the CPU at small sizes, cold and warm-started, batched and not: it is a
copy of that path. This is the only place the port's plain code is
imported; it checks the copy, not the card."""

import numpy as np
import pytest
import torch

from mpcbench.entries import centroidal, legged
from mpcbench.tests import small_cells
from mpcbench.traffic import Inputs, shift
from mpcbench import harness, traffic

F64 = torch.float64


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_cells.write(tmp_path_factory.mktemp("ref"))


def _port_plain(cell):
    """The port's own solver of the cell, f64, plain executor."""
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
    cfg = cell.config
    if cfg["family"] == "centroidal":
        from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import (
            CentroidalMpcConfig, build_centroidal_solver)
        c = CentroidalMpcConfig(dtype=F64, **centroidal._cfg_kwargs(cfg))
        scp = centroidal._settings(cfg, ScpSettings, IpmSettings)
        solve = build_centroidal_solver(c, scp._replace(qp_backend="riccati"),
                                        device="cpu")
        names = centroidal.OUTPUTS
    else:
        from cheeta_mpc_tpu_torch.models.quadruped_kinematics import \
            QuadrupedDescription
        from cheeta_mpc_tpu_torch.models.srbd_legged import SrbdParams
        from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                         build_legged_solver)
        c = legged._cfg(cfg, LeggedMpcConfig, QuadrupedDescription,
                        SrbdParams, F64)
        scp = legged._settings(cfg, ScpSettings, IpmSettings)
        solve = build_legged_solver(c, scp._replace(qp_backend="riccati"),
                                    device="cpu")
        names = legged.OUTPUTS

    def call(inputs):
        sol = solve(*inputs.args, warm=inputs.warm)
        return {n: getattr(sol, n) for n in names}

    return call


@pytest.mark.parametrize("name", list(small_cells.SMALL))
def test_reference_equals_the_ports_plain_path(bench, name):
    cell = harness.Cell(name, bench)
    family = __import__(f"mpcbench.entries.{cell.config['family']}",
                        fromlist=["x"])
    ref = family.reference(cell.config, torch.device("cpu"), F64)
    port = _port_plain(cell)
    tr = traffic.load(cell.workload["kind"]).make(
        cell.config, cell.workload["params"], 11)
    first = tr.inputs(0, None)
    a, b = ref(first), port(first)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=1e-9)
    prev = {k: v.numpy() for k, v in a.items()}
    nxt = tr.inputs(1, prev)
    if tr.batch is None:
        assert nxt.warm is not None
        warm = shift(prev["x_traj"], prev["u_traj"])
        np.testing.assert_array_equal(nxt.warm[0], warm[0])
        a, b = ref(nxt), port(nxt)
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                       atol=1e-9)


def test_reference_solves_rows_alone(bench):
    """A block of rows from different calls gives what each row gives
    alone, so the check may stack any sample of answers."""
    cell = harness.Cell("csmall.fleet4", bench)
    ref = centroidal.reference(cell.config, torch.device("cpu"), F64)
    tr = traffic.load(cell.workload["kind"]).make(
        cell.config, cell.workload["params"], 5)
    full = ref(tr.inputs(0, None))["contact_force"].numpy()
    row = Inputs(tuple(x[2:3] for x in tr.inputs(0, None).args), None)
    np.testing.assert_allclose(ref(row)["contact_force"].numpy()[0],
                               full[2], rtol=0, atol=1e-9)
