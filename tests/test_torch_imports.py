"""PyTorch port: the package and ``chip_smoke.py`` import nothing of JAX,
flax or the JAX package; the default device is the card and raises without
one; and from ``device="cpu"`` no code path reaches a kernel launch.

The import check reads the sources with ``ast`` rather than looking at
``sys.modules``, which proves nothing in a process whose start-up files may
import jax before any test runs.
"""

import ast
import importlib
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import cheeta_mpc_tpu_torch
from cheeta_mpc_tpu_torch import convert, examples
from cheeta_mpc_tpu_torch.core.types import resolve_device
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from cheeta_mpc_tpu_torch.native import build
from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch as tb
from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati as tk
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "cheeta_mpc_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "cheeta_mpc_tpu"}
# The package's own sources: what the kernels' build directory holds is not
# part of it.
PORT_FILES = sorted(p for p in PORT.rglob("*.py")
                    if "_build" not in p.relative_to(PORT).parts
                    ) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_import(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"
    # Dynamic imports by name would slip past the walk above.
    text = path.read_text()
    for name in ("jax", "flax"):
        assert f'import_module("{name}' not in text
        assert f"__import__('{name}" not in text


@pytest.mark.parametrize("sub", ["transport", "viz", "cli", "native",
                                 "parallel"])
def test_runtime_edges_are_held_to_the_same_rule(sub):
    """The deployed runtime's subpackages are among the files checked
    above, and their C++ sources name nothing of the JAX package."""
    files = [p for p in PORT_FILES if p.parent.name == sub]
    assert files and PORT / sub / "__init__.py" in files
    for cpp in (PORT / sub).glob("*.cpp"):
        text = cpp.read_text()
        assert "jax" not in text.lower() and "cheeta_mpc_tpu." not in text


LAST_SLICE = ("models/srb.py", "mpc/convex_mpc.py", "ops/projection.py",
              "ops/condensed.py", "ops/riccati.py", "parallel/__init__.py",
              "parallel/mesh.py")


@pytest.mark.parametrize("rel", LAST_SLICE)
def test_last_slice_modules_are_held_to_the_rule(rel):
    """The modules of the convex MPC, the projected and condensed QP modes,
    terminal equalities and the mesh are among the files checked above;
    they exist under the JAX module's name and place."""
    assert PORT / rel in PORT_FILES
    assert (ROOT / "cheeta_mpc_tpu" / rel).is_file()


def test_last_slice_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    from cheeta_mpc_tpu_torch.models.srb import SrbParams
    from cheeta_mpc_tpu_torch.mpc.convex_mpc import (ConvexMpcConfig,
                                                     build_convex_mpc)
    from cheeta_mpc_tpu_torch.parallel.mesh import make_mesh
    cfg = ConvexMpcConfig(params=SrbParams(mass=9.0, inertia=(0.07, 0.26,
                                                              0.24)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_convex_mpc(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert build_convex_mpc(cfg, device="cpu").initial_qp is not None


def test_chip_smoke_fails_at_once_without_a_card():
    """``python3 chip_smoke.py`` on a machine without a card exits non-zero
    before any phase: nothing on its standard output, so no ``"ok"``
    line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_every_module_imports_without_a_compiler_or_a_card():
    """Importing builds nothing and needs neither nvcc nor triton."""
    assert len(PORT_FILES) > 15
    for path in PORT_FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts).removesuffix(".__init__")
        importlib.import_module(name)
    assert build._lib is None  # nothing was built or loaded by importing
    assert not build._buses  # nor the transport's buses
    assert cheeta_mpc_tpu_torch.__version__


def _inputs(cfg):
    return examples.make_example_inputs(cfg)


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    cfg = tm.CentroidalMpcConfig(weights=examples.TEST_WEIGHTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.build_centroidal_solver(cfg)
    mpc = tm.CentroidalMPC(8.0, 4, 6, 0.01, examples.TEST_WEIGHTS, [0.8] * 4)
    assert mpc.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpc.setup_mpc()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")


def test_real_time_path_defaults_to_the_card_and_raises_without_one():
    """The graphed callable, the n-tick loop and the legged planning node
    take ``device="cuda"`` by default and raise without a card; on
    ``device="cpu"`` the graphed callable is the function itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule, trot_template
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
    from cheeta_mpc_tpu_torch.mpc.legged_node import LeggedPlannerAssembly
    from cheeta_mpc_tpu_torch.utils.cuda_graph import graphed

    def fn(x):
        return x

    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphed(fn)
    assert graphed(fn, "cpu") is fn
    cfg = tm.CentroidalMpcConfig(horizon=4, weights=examples.TEST_WEIGHTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.build_centroidal_mpc_loop(cfg)
    lcfg = LeggedMpcConfig(horizon=4, **examples.LEGGED_TEST_WEIGHTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeggedPlannerAssembly(lcfg, GaitSchedule.stance(trot_template()),
                              examples.default_stance_state(lcfg),
                              np.zeros(3))


def test_runtime_edges_default_to_the_card_and_raise_without_one(tmp_path):
    """The DDP solver, the DDP node and the command-line nodes take the card
    by default and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    from cheeta_mpc_tpu_torch.cli import launch, legged_demo
    from cheeta_mpc_tpu_torch.gait.schedule import GaitSchedule, trot_template
    from cheeta_mpc_tpu_torch.mpc.legged_ddp import build_legged_ddp_solver
    from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedMpcConfig
    from cheeta_mpc_tpu_torch.mpc.legged_node import (LeggedPlannerAssembly,
                                                      PlannerSettings)
    from tests.torch_port_util import write_info_files

    lcfg = LeggedMpcConfig(horizon=4, **examples.LEGGED_TEST_WEIGHTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_legged_ddp_solver(lcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeggedPlannerAssembly(lcfg, GaitSchedule.stance(trot_template()),
                              examples.default_stance_state(lcfg),
                              np.zeros(3),
                              settings=PlannerSettings(solver="ddp"))
    task, gait = write_info_files(tmp_path)
    files = ["--task-info", task, "--gait-info", gait, "--horizon", "4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        legged_demo.main(files + ["--out", str(tmp_path / "demo")])
    for role in ("mpc", "dummy"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main(files + ["--role", role, "--bus", "/unused"])


def test_converters_default_to_the_card_and_raise_without_one():
    """``convert`` is an entry point like the others: no CPU by default, so
    ``solve_ocp_qp_kernel(qp_data_from_numpy(d))`` cannot end up in the
    plain version unasked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.qp_data_from_numpy({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.warm_from_numpy(np.zeros((2, 3)), np.zeros((1, 2)))
    x, u = convert.warm_from_numpy(np.zeros((2, 3)), np.zeros((1, 2)),
                                   device="cpu")
    assert x.device.type == u.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_solve_never_reaches_a_kernel_launch(monkeypatch):
    """From ``device="cpu"`` the wrappers take the plain versions: the
    launcher and the build are not called and no counter moves."""

    def boom(*a, **k):
        raise AssertionError("kernel launch path reached from the CPU")

    monkeypatch.setattr(tk, "launch_ipm_kernel", boom)
    monkeypatch.setattr(tb, "launch_ipm_kernel", boom)
    monkeypatch.setattr(build, "load_library", boom)
    counts = (tk.solve_ocp_qp_kernel.launches, tb.solve_ocp_qp_fleet.launches)
    cfg = tm.CentroidalMpcConfig(horizon=4, weights=examples.TEST_WEIGHTS)
    scp = ScpSettings(iterations=1, ipm=IpmSettings(iters=4))
    assert scp.qp_backend == "riccati_kernel"
    solve = tm.build_centroidal_solver(cfg, scp, device="cpu")
    one = solve(*_inputs(cfg))
    many = solve(*(np.stack([a, a, a]) for a in _inputs(cfg)))
    assert one.contact_force.device.type == "cpu"
    assert many.contact_force.shape[0] == 3
    assert counts == (tk.solve_ocp_qp_kernel.launches,
                      tb.solve_ocp_qp_fleet.launches)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA launch would run, exercised on their own: wrong
    dtype, shape and layout raise before any pointer is taken."""
    cfg = tm.CentroidalMpcConfig(horizon=4, weights=examples.TEST_WEIGHTS,
                                 dtype=torch.float64)
    solve = tm.build_centroidal_solver(cfg, ScpSettings(), device="cpu")
    qp = solve.initial_qp(*_inputs(cfg))
    # f64 is an error for the kernel (the JAX package warns and falls back).
    with pytest.raises(TypeError, match="float32 only"):
        tk.launch_ipm_kernel("cheeta_ipm_riccati_single", qp, IpmSettings(),
                             batch=None, gains=True)
    qp32 = solve.initial_qp(*_inputs(cfg))
    from cheeta_mpc_tpu_torch.core.types import tree_map
    qp32 = tree_map(lambda t: t.float(), qp32)
    bad = qp32.replace(dyn=qp32.dyn.replace(A=qp32.dyn.A[:, :, :-1]))
    with pytest.raises(ValueError, match="A has shape|not contiguous"):
        tk.launch_ipm_kernel("cheeta_ipm_riccati_single", bad, IpmSettings(),
                             batch=None, gains=True)
    bad = qp32.replace(dyn=qp32.dyn.replace(
        B=qp32.dyn.B.transpose(-1, -2).contiguous().transpose(-1, -2)))
    with pytest.raises(ValueError, match="not contiguous"):
        tk.launch_ipm_kernel("cheeta_ipm_riccati_single", bad, IpmSettings(),
                             batch=None, gains=True)


class _StubLibrary:
    """Answers what the wrappers ask the kernels' library before a launch,
    with the numbers that ``csrc/ipm_launch.inl`` builds for; launches
    nothing. ``floats`` is the shared memory of a block with the factors
    in it and without them."""

    LIMITS = {0: (384, 1, 8), 1: (256, 2, 8)}  # threads, blocks/SM, entries

    def __init__(self, floats=(41272, 28384)):
        self.floats = floats

    def cheeta_ipm_launch_limits(self, fleet, out):
        out[:] = self.LIMITS[fleet]

    def cheeta_ipm_smem_floats(self, dims, factors_in_smem):
        return self.floats[0 if factors_in_smem else 1]


@pytest.mark.parametrize("nu, nc", [(56, 0), (8, 56)])
def test_wrappers_refuse_inverses_wider_than_the_block_holds(nu, nc,
                                                             monkeypatch):
    """The kernels' SPD inverse keeps its n x n tableau in the registers of
    the block's threads (8 entries each, 384 threads, as the library
    reports them): a wider nu or nc raises before anything is allocated or
    launched."""
    monkeypatch.setattr(build, "load_library", _StubLibrary)
    N, nx, ng = 2, 3, 2
    z = np.zeros
    d = {"A": z((N, nx, nx)), "B": z((N, nx, nu)), "b": z((N, nx)),
         "Q": z((N + 1, nx, nx)), "q": z((N + 1, nx)), "R": z((N, nu, nu)),
         "r": z((N, nu)), "S": z((N, nu, nx)), "dx0": z(nx),
         "C": z((N + 1, ng, nx)), "D": z((N + 1, ng, nu)),
         "lg": z((N + 1, ng)), "ug": z((N + 1, ng)), "mask": z((N + 1, ng))}
    if nc:
        d["eq"] = {"C": z((N, nc, nx)), "D": z((N, nc, nu)), "e": z((N, nc)),
                   "mask": z((N, nc))}
    qp = convert.qp_data_from_numpy(d, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="tableau entries per thread"):
        tk.launch_ipm_kernel("cheeta_ipm_riccati_single", qp, IpmSettings(),
                             batch=None, gains=True)


@pytest.mark.parametrize("entry, floats, placement", [
    ("cheeta_ipm_riccati_single", (41272, 28384), "factors"),
    ("cheeta_ipm_riccati_fleet", (41272, 28384), "none"),
    ("cheeta_ipm_riccati_fleet", (41272, 30000), None),
])
def test_shared_memory_plan_fits_the_blocks_per_sm_the_kernel_is_built_for(
        entry, floats, placement, monkeypatch):
    """One rule for both kernels: the first placement whose block fits the
    SM's shared memory divided by the blocks per SM that the library
    builds the kernel for. K1 (one block) keeps the centroidal factors in
    shared memory; K2 (two blocks) keeps them in the scratch buffer at any
    batch, and a shape whose block overflows half an SM raises."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            shared_memory_per_block_optin=232448,
                            shared_memory_per_multiprocessor=233472))
    shape = (10, 33, 24, 32, 0)
    lib = _StubLibrary(floats)
    if placement is None:
        with pytest.raises(RuntimeError, match="2 block.s. per SM leave 115712"):
            tk.shared_memory_plan(lib, entry, shape, 10, "cuda")
        return
    name, dims, nbytes = tk.shared_memory_plan(lib, entry, shape, 10, "cuda")
    assert (name, nbytes) == (placement, 4 * floats[name == "none"])
    assert list(dims) == [*shape, 10]


def test_build_reports_a_missing_compiler(monkeypatch, tmp_path):
    """No nvcc: the build raises with the reason; nothing falls back."""
    monkeypatch.setenv("NVCC", str(tmp_path / "no-such-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(build.KernelCompileError, match="nvcc not found"):
        build.load_library()
    assert len(build._sources_hash()) == 16
