"""PyTorch port, ``parallel/mesh.py`` against the JAX package's
tests/test_parallel.py and tests/test_multihost.py, on the CPU.

- In one process, a mesh of two stand-in CPU devices: the convex SRB MPC's
  batch of 16 scenarios sharded, solved per device and gathered, equal to
  the unsharded solve (1e-12: the same plain arithmetic on half the batch)
  and to the JAX package's sharded solve on its 8-device virtual mesh
  (1e-6, as there).
- ``aggregate_fleet_health`` against the JAX package's ``FleetHealth`` of
  the same inputs (counts exact, moments 1e-9 relative).
- Two processes joined by a gloo process group (a TCP store on localhost,
  each child with a timeout of its own): each solves its half of the batch
  with ``sharded_batch_solver``, ``host_local_batch_to_global`` gathers the
  forces, ``aggregate_fleet_health`` reduces over both processes; held
  against the JAX package's solve and ``FleetHealth`` of the whole batch.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.examples import NOMINAL_FEET, trot_table
from cheeta_mpc_tpu.models.srb import SrbParams as JSrb
from cheeta_mpc_tpu.mpc.convex_mpc import ConvexMpcConfig as JCfg
from cheeta_mpc_tpu.mpc.convex_mpc import build_convex_mpc as jbuild
from cheeta_mpc_tpu.ops.ocpqp import IpmSettings as JIpm
from cheeta_mpc_tpu.parallel import mesh as jmesh
from cheeta_mpc_tpu.solvers.scp import (CONV_FALSE, CONV_ITERATIONS,
                                        CONV_METRICS, CONV_STEPSIZE)
from cheeta_mpc_tpu_torch.parallel import mesh as tmesh
from tests.torch_port_util import max_err

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, HORIZON, ITERS = 16, 6, 15
PARAMS = dict(mass=9.0, inertia=(0.07, 0.26, 0.24), mu=0.5, fz_max=250.0)
CHILD_TIMEOUT_S = 180


def scenarios():
    """The batch of tests/test_parallel.py (initial heights 0.3 + 5 mm k)."""
    x0 = np.zeros((B, 13))
    x0[:, 5] = 0.3 + 0.005 * np.arange(B)
    x0[:, 12] = 1.0
    ref = np.tile(x0[:, None, :], (1, HORIZON + 1, 1))
    feet = np.tile(NOMINAL_FEET[None], (B, 1, 1))
    enable = np.tile(trot_table(HORIZON)[None], (B, 1, 1))
    return x0, ref, feet, enable


def health_inputs(mu):
    """tests/test_parallel.py's convergence codes and merits (one NaN)
    beside the given complementarities."""
    rng = np.random.default_rng(7)
    conv = np.full(B, CONV_STEPSIZE, np.int32)
    conv[3], conv[5], conv[9] = CONV_FALSE, CONV_ITERATIONS, CONV_METRICS
    merit = rng.uniform(10.0, 20.0, B)
    merit[7] = np.nan
    return np.asarray(mu, np.float64), conv, merit


def _jax_config():
    return JCfg(params=JSrb(**PARAMS), horizon=HORIZON, dt=0.03,
                dtype=jnp.float64)


def _port_build(device):
    from cheeta_mpc_tpu_torch.convert import convex_config_from_dict
    from cheeta_mpc_tpu_torch.mpc.convex_mpc import build_convex_mpc
    from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
    d = _jax_config()._asdict()
    d["dtype"] = "float64"
    return build_convex_mpc(convex_config_from_dict(d),
                            IpmSettings(iters=ITERS), device=device)


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded solve over its 8-device virtual mesh."""
    mesh = jmesh.make_mesh()
    solve = jmesh.sharded_batch_solver(
        jbuild(_jax_config(), JIpm(iters=ITERS)), mesh)
    args = jmesh.shard_batch(mesh, tuple(jnp.asarray(a)
                                         for a in scenarios()))
    with mesh:
        forces, sols = solve(*args)
    return np.asarray(forces), np.asarray(sols.mu)


def _jax_health(mu, conv, merit):
    mesh = jmesh.make_mesh()
    args = jmesh.shard_batch(mesh, (jnp.asarray(mu), jnp.asarray(conv),
                                    jnp.asarray(merit)))
    with mesh:
        return jmesh.aggregate_fleet_health(mesh, *args)


def _assert_health(h, ref):
    for name in ("n_solves", "n_converged", "n_nonfinite"):
        assert int(getattr(h, name)) == int(getattr(ref, name)), name
    for name in ("mu_mean", "mu_max", "merit_mean"):
        np.testing.assert_allclose(float(getattr(h, name)),
                                   float(getattr(ref, name)), rtol=1e-9)


def test_shard_solve_gather_over_two_cpu_devices(jax_sharded):
    mesh = tmesh.make_mesh(devices=["cpu", "cpu"])
    assert len(mesh.devices) == 2 and mesh.process_count == 1
    solve = tmesh.sharded_batch_solver(_port_build, mesh)
    forces, sols = solve(*scenarios())
    assert tuple(forces.shape) == (B, HORIZON, 4, 3)
    assert tuple(sols.mu.shape) == (B,)
    whole, whole_sols = _port_build("cpu")(*scenarios())
    assert max_err(forces, whole) <= 1e-12
    assert max_err(sols.dx, whole_sols.dx) <= 1e-12
    jforces, jmu = jax_sharded
    assert max_err(forces, jforces) <= 1e-6
    assert max_err(sols.mu, jmu) <= 1e-9
    one, _ = _port_build("cpu")(*(a[3] for a in scenarios()))
    assert max_err(forces[3], one) <= 1e-6
    shards = tmesh.shard_batch(mesh, scenarios())
    assert len(shards) == 2 and tuple(shards[1][0].shape) == (B // 2, 13)
    assert max_err(shards[1][0], scenarios()[0][B // 2:]) == 0.0
    with pytest.raises(ValueError, match="split evenly"):
        tmesh.shard_batch(tmesh.make_mesh(devices=["cpu"] * 3), scenarios())


def test_aggregate_fleet_health_against_jax():
    rng = np.random.default_rng(7)
    mu = rng.uniform(1e-6, 1e-4, B)
    _, conv, merit = health_inputs(mu)
    mesh = tmesh.make_mesh(devices=["cpu"])
    h = tmesh.aggregate_fleet_health(mesh, mu, conv, merit)
    assert int(h.n_solves) == B and int(h.n_converged) == B - 2
    assert int(h.n_nonfinite) == 1
    _assert_health(h, _jax_health(mu, conv, merit))


def test_single_process_defaults():
    """Without arguments ``initialize_distributed`` joins nothing; the
    global mesh is this process alone; the default mesh is the cards and
    raises without one."""
    assert tmesh.initialize_distributed() == 0
    mesh = tmesh.make_global_mesh()
    assert (mesh.process_count, mesh.process_index) == (1, 0)
    tree = (np.arange(4.0),)
    assert tmesh.host_local_batch_to_global(mesh, tree) is tree
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


WORKER = r"""
import sys
import numpy as np
import torch

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from cheeta_mpc_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_parallel import (B, _port_build, health_inputs,
                                       scenarios)

assert tmesh.initialize_distributed(f"localhost:{port}", 2, rank,
                                    backend="gloo") == rank
mesh = tmesh.make_global_mesh()
assert (mesh.process_count, mesh.process_index) == (2, rank)
lo, hi = rank * B // 2, (rank + 1) * B // 2
local = tuple(a[lo:hi] for a in scenarios())
forces, sols = tmesh.sharded_batch_solver(_port_build, mesh)(*local)
glob = tmesh.host_local_batch_to_global(mesh, (forces, sols.mu))
_, conv, merit = health_inputs(np.zeros(B))
h = tmesh.aggregate_fleet_health(mesh, sols.mu, conv[lo:hi], merit[lo:hi])
torch.save({"forces": glob[0], "mu": glob[1], "health": tuple(h)}, out)
torch.distributed.destroy_process_group()
print(f"proc {rank}: ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group(tmp_path, jax_sharded):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = [tmp_path / f"rank{i}.pt" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port, str(outs[i]), str(ROOT)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT)) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {i} failed:\n{log[-3000:]}"
        assert f"proc {i}: ok" in log
    res = [torch.load(o) for o in outs]
    jforces, _ = jax_sharded
    for r in res:  # every process holds the whole batch after the gather
        assert tuple(r["forces"].shape) == (B, HORIZON, 4, 3)
        assert max_err(r["forces"], jforces) <= 1e-6
    assert max_err(res[0]["mu"], res[1]["mu"]) == 0.0
    ref = _jax_health(*health_inputs(res[0]["mu"].numpy()))
    for r in res:  # the reduced record is the same on both processes
        _assert_health(tmesh.FleetHealth(*r["health"]), ref)
