"""PyTorch port, utils/device_timing.py, against the JAX package's module.

- The JAX package's work counts, copied, equal its functions to the float
  over a grid of shapes (the centroidal, legged and SRB widths among them).
- The kernels' own counts keep the values that ``PERF.md``'s bounds were
  computed from.
- The chained loop equals the JAX one in f64 (the nudge is visible in the
  first argument's zero entries).
- The slope arithmetic, on a stand-in clock that advances by a fixed cost
  per call and a constant per loop, gives that cost per call exactly; no
  test reads the real clock.
- On ``device="cpu"`` a chain reaches no kernel and captures no graph.

The timing on the card, each chain one CUDA graph, is ``chip_smoke.py``'s
phase ``device_timing``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.core import types as jt
from cheeta_mpc_tpu.ops import riccati as jr
from cheeta_mpc_tpu.utils import device_timing as jdt
from cheeta_mpc_tpu_torch import examples
from cheeta_mpc_tpu_torch.core import types as tt
from cheeta_mpc_tpu_torch.mpc import centroidal_mpc as tm
from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                 build_legged_solver)
from cheeta_mpc_tpu_torch.native import build
from cheeta_mpc_tpu_torch.ops import cuda_eq_batch, cuda_eq_riccati
from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch, cuda_ipm_riccati
from cheeta_mpc_tpu_torch.ops import riccati as tr
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.solvers.scp import ScpSettings
from cheeta_mpc_tpu_torch.utils import device_timing as tdt
from tests.problem_gen import random_lq_problem
from tests.torch_port_util import assert_close

# (N, nx, nu, ng, nc): centroidal, legged pyramid, SRB, and small shapes.
SHAPES = [(10, 33, 24, 32, 0), (67, 24, 24, 20, 16), (10, 13, 12, 20, 0),
          (4, 5, 3, 2, 1), (1, 1, 1, 0, 0)]
COUNTS = {
    "riccati_ipm_flops": lambda m, N, nx, nu, ng, nc:
        m.riccati_ipm_flops(N, nx, nu, ng, 10),
    "centroidal_solve_flops": lambda m, N, nx, nu, ng, nc:
        m.centroidal_solve_flops(N, nx, nu, ng, 2, 10),
    "centroidal_solve_flops_alphas": lambda m, N, nx, nu, ng, nc:
        m.centroidal_solve_flops(N, nx, nu, ng, 3, 12, n_alphas=7),
    "eq_riccati_flops": lambda m, N, nx, nu, ng, nc:
        m.eq_riccati_flops(N, nx, nu, nc),
    "qp_data_bytes": lambda m, N, nx, nu, ng, nc:
        m.qp_data_bytes(N, nx, nu, ng, nc),
    "qp_data_bytes_f64": lambda m, N, nx, nu, ng, nc:
        m.qp_data_bytes(N, nx, nu, ng, nc, dtype_bytes=8),
}


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
@pytest.mark.parametrize("count", sorted(COUNTS))
def test_copied_counts_equal_the_jax_package(count, shape):
    port = COUNTS[count](tdt, *shape)
    ref = COUNTS[count](jdt, *shape)
    assert isinstance(port, float) and port == ref


# The kernels' counts at the shapes of PERF.md's bound column: K1/K2 at the
# centroidal shape (10 iterations), the legged pyramid shape (16 stage
# equalities) and the SRB shape (12 iterations); K3/K4 at the legged shape.
@pytest.mark.parametrize("count,args,mflop", [
    ("ipm_flops", (10, 33, 24, 32, 0, 10), 64.98519),
    ("ipm_flops", (67, 24, 24, 20, 16, 10), 329.661504),
    ("ipm_flops", (10, 13, 12, 20, 0, 12), 8.330186),
    ("eq_flops", (67, 24, 24, 16), 24.930432),
])
def test_kernel_counts_keep_their_values(count, args, mflop):
    assert getattr(tdt, count)(*args) == pytest.approx(mflop * 1e6,
                                                       rel=1e-15, abs=0)


@pytest.mark.parametrize("flops,by", [(1e3, "bytes"), (1e12, "operations")])
def test_bound_is_the_larger_of_bytes_and_operations(flops, by):
    """Inputs read once (every tensor of the dataclass nest, ``None``
    skipped), outputs written once, at the card's peaks."""
    dyn = tt.DynamicsLin(A=torch.zeros(4, 3, 3), B=torch.zeros(4, 3, 2),
                         b=torch.zeros(4, 3, dtype=torch.float64))
    data = tt.OcpQpData(dyn=dyn, cost=None, con=None, dx0=torch.zeros(3))
    out = [torch.zeros(5, 3)]
    (ms, got_by), nbytes = tdt.bound(data, out, flops)
    assert nbytes == 4 * (36 + 24 + 3 + 15) + 8 * 12
    assert got_by == by
    assert ms == max(1e3 * nbytes / tdt.HBM_BYTES_PER_S,
                     1e3 * flops / tdt.F32_FLOPS)


def _lq_fns():
    """The same LQR solve in both packages as a function of arrays, the
    initial state first (the argument the chain nudges)."""

    def jax_fn(dx0, A, B, b, Q, q, R, r, S):
        return jr.solve_lqr(jt.OcpQpData(
            dyn=jt.DynamicsLin(A=A, B=B, b=b),
            cost=jt.CostApprox(Q=Q, q=q, R=R, r=r, S=S), con=None, dx0=dx0),
            reg=1e-9)

    def port_fn(dx0, A, B, b, Q, q, R, r, S):
        return tr.solve_lqr(tt.OcpQpData(
            dyn=tt.DynamicsLin(A=A, B=B, b=b),
            cost=tt.CostApprox(Q=Q, q=q, R=R, r=r, S=S), con=None, dx0=dx0),
            reg=1e-9)

    return jax_fn, port_fn


@pytest.mark.parametrize("seed", [0, 1])
def test_chained_loop_matches_jax_in_f64(seed):
    rng = np.random.default_rng(seed)
    d = random_lq_problem(rng, 6, 4, 3)
    dx0 = np.array(d.dx0)
    dx0[::2] = 0.0  # entries that hold nothing but the nudges
    arrays = [dx0] + [np.array(a) for a in (
        d.dyn.A, d.dyn.B, d.dyn.b, d.cost.Q, d.cost.q, d.cost.R, d.cost.r,
        d.cost.S)]
    jax_fn, port_fn = _lq_fns()
    ref = jdt._chained_loop(jax_fn, 3)(*(jnp.asarray(a) for a in arrays))
    args, out = tdt._chained_loop(port_fn, 3)(
        *(torch.as_tensor(a) for a in arrays))
    assert len(args) == len(ref)
    nudged = args[0][::2]
    assert bool((nudged != 0).all()) and float(nudged.abs().max()) < 4e-30
    for a, r in zip(args, ref):
        assert a.dtype == torch.float64
        assert_close(a, r, atol=0.0, rtol=1e-9)
    last = jax_fn(*ref)  # the last call's inputs up to one more nudge
    assert_close(out.dx, last.dx, atol=1e-12, rtol=1e-9)
    assert_close(out.du, last.du, atol=1e-12, rtol=1e-9)


@pytest.mark.parametrize("k_small,k_big,reps", [(4, 20, 3), (2, 8, 1)])
def test_slope_is_the_cost_per_call_on_a_stand_in_clock(monkeypatch, k_small,
                                                        k_big, reps):
    """On the CPU path each call advances the clock by ``per_call``, each
    read of it by ``per_read`` (a constant per loop): the slope is
    ``per_call`` exactly, in every repetition (binary fractions, so no
    rounding)."""
    now = [0.0]
    per_call, per_read = 2.0 ** -7, 0.375

    def clock():
        now[0] += per_read
        return now[0]

    def fn(x, y):
        now[0] += per_call
        return (0.5 * x + y, y)

    monkeypatch.setattr(tdt, "_clock", clock)
    args = (torch.ones(3), torch.zeros(3))
    t = tdt.time_chain(fn, args, k_small, k_big, reps, device="cpu")
    assert t.seconds == per_call and t.slopes == [per_call] * reps
    assert t.chain_s == {k: [k * per_call + per_read] * reps
                         for k in (k_small, k_big)}
    assert t.graphs == {} and t.issue_s == {}
    assert torch.equal(t.output[0], 0.5 * torch.ones(3))
    assert tdt.device_time_per_call(fn, args, k_small, k_big, reps,
                                    device="cpu") == per_call


WRAPPERS = (cuda_ipm_riccati.solve_ocp_qp_kernel,
            cuda_ipm_batch.solve_ocp_qp_fleet,
            cuda_eq_riccati.solve_eq_lqr_kernel,
            cuda_eq_batch.solve_eq_lqr_fleet)


def _centroidal(batch):
    cfg = tm.CentroidalMpcConfig(horizon=4, weights=examples.TEST_WEIGHTS)
    solve = tm.build_centroidal_solver(
        cfg, ScpSettings(iterations=1, ipm=IpmSettings(iters=4)),
        device="cpu")
    inputs = examples.make_example_inputs(cfg, batch=batch)
    return solve, inputs, "contact_force"


def _legged(batch):
    cfg = LeggedMpcConfig(horizon=6, **examples.LEGGED_TEST_WEIGHTS)
    solve = build_legged_solver(cfg, ScpSettings(iterations=1), device="cpu")
    inputs = examples.make_legged_example_inputs(cfg, batch=batch).args
    return solve, inputs, "forces"


@pytest.mark.parametrize("make,batch", [(_centroidal, None), (_legged, 3)],
                         ids=["centroidal_batch1", "legged_fleet3"])
def test_cpu_chain_reaches_no_kernel_and_no_graph(monkeypatch, make, batch):
    """The chains run as they are on the CPU: no build, no kernel launch,
    no CUDA graph, and the last output is the solve's (the nudges of
    1e-30 change nothing a solve can see)."""

    def boom(*a, **k):
        raise AssertionError("the card's path was reached from the CPU")

    monkeypatch.setattr(build, "load_library", boom)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", boom)
    monkeypatch.setattr(torch.cuda, "graph", boom)
    counts = [w.launches for w in WRAPPERS]
    solve, inputs, name = make(batch)
    args = tuple(torch.as_tensor(a, dtype=torch.float32) for a in inputs)
    t = tdt.time_chain(solve, args, 1, 2, reps=1, device="cpu")
    assert [w.launches for w in WRAPPERS] == counts
    assert t.graphs == {} and len(t.slopes) == 1
    want = getattr(solve(*args), name)
    got = getattr(t.output, name)
    assert got.device.type == "cpu" and got.shape == want.shape
    assert_close(got, want.numpy(), atol=1e-6)
