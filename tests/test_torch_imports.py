"""PyTorch port: the package and ``chip_smoke.py`` import nothing of JAX,
flax or the JAX package; the default device is the card and raises without
one; and from ``device="cpu"`` no code path reaches a kernel launch.

The import check reads the sources with ``ast`` rather than looking at
``sys.modules``, which proves nothing in a process whose start-up files may
import jax before any test runs.
"""

import ast
import importlib
import pathlib

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


def test_every_module_imports_without_a_compiler_or_a_card():
    """Importing builds nothing and needs neither nvcc nor triton."""
    assert len(PORT_FILES) > 15
    for path in PORT_FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts).removesuffix(".__init__")
        importlib.import_module(name)
    assert build._lib is None  # nothing was built or loaded by importing
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
