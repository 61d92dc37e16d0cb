"""PyTorch port: the f32 matmul precision of a solve (solvers/scp.py).

The JAX package scopes ``jax.default_matmul_precision(settings.
matmul_precision)`` to the solve. The port's ``matmul_precision`` context
does the same with torch's flags: the settings' precision holds inside the
solve (a capture included), the caller's flags come back after it, on an
error too, and a name torch and JAX do not share raises. Host-side flags:
the CPU shows all of it.
"""

import pytest
import torch

from cheeta_mpc_tpu_torch import examples
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers import scp
from cheeta_mpc_tpu_torch.solvers.ddp import DdpSettings, solve_ddp

MM = torch.backends.cuda.matmul


def _legacy():
    return MM.allow_tf32, torch.get_float32_matmul_precision()


@pytest.fixture(autouse=True)
def default_flags():
    """Every test starts and ends at torch's defaults."""
    yield
    torch.set_float32_matmul_precision("highest")
    assert _legacy() == (False, "highest")


def _solve(precision, spy=None, monkeypatch=None):
    """A small centroidal CPU solve at ``precision``; ``spy`` sees the
    flags inside the solve."""
    if spy is not None:
        real = scp._solve_nonlinear_ocp

        def inside(*args, **kwargs):
            spy()
            return real(*args, **kwargs)

        monkeypatch.setattr(scp, "_solve_nonlinear_ocp", inside)
    cfg = tm.CentroidalMpcConfig(horizon=4, weights=examples.TEST_WEIGHTS)
    settings = scp.ScpSettings(iterations=1, ipm=IpmSettings(iters=4),
                               matmul_precision=precision)
    return tm.build_centroidal_solver(cfg, settings, device="cpu")(
        *examples.make_example_inputs(cfg))


@pytest.mark.parametrize("caller", ["medium", "high", "highest"])
@pytest.mark.parametrize("precision", scp.MATMUL_PRECISIONS)
def test_solve_runs_at_its_precision_and_restores_the_callers(
        caller, precision, monkeypatch):
    torch.set_float32_matmul_precision(caller)
    before = _legacy()
    assert before == (caller != "highest", caller)
    seen = []
    sol = _solve(precision, lambda: seen.append(_legacy()), monkeypatch)
    assert seen == [(precision != "highest", precision)]
    assert bool(torch.isfinite(sol.contact_force).all())
    assert _legacy() == before


def test_flags_come_back_after_an_error(monkeypatch):
    MM.allow_tf32 = True  # a caller's TF32 through the legacy flag
    before = _legacy()

    def boom():
        assert _legacy() == (False, "highest")
        raise RuntimeError("inside the solve")

    with pytest.raises(RuntimeError, match="inside the solve"):
        _solve("highest", boom, monkeypatch)
    assert _legacy() == before == (True, "high")


def test_unknown_precision_raises_and_changes_nothing():
    torch.set_float32_matmul_precision("medium")
    with pytest.raises(ValueError, match="unknown matmul_precision 'fast'"):
        _solve("fast")
    assert _legacy() == (True, "medium")


def test_ddp_solves_at_highest_and_restores_the_callers():
    torch.set_float32_matmul_precision("medium")
    seen = []

    def step(k, x, u):
        seen.append(_legacy())
        return x + u

    def cost(k, x, u):
        return torch.sum(x * x) + torch.sum(u * u)

    res = solve_ddp(step, cost, lambda x: torch.sum(x * x),
                    torch.ones(2, dtype=torch.float64),
                    torch.zeros((3, 2), dtype=torch.float64),
                    DdpSettings(iterations=1))
    assert seen and set(seen) == {(False, "highest")}
    assert bool(torch.isfinite(res.x).all())
    assert _legacy() == (True, "medium")
