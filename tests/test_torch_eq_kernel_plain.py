"""PyTorch port, ops/cuda_eq_riccati.py and ops/cuda_eq_batch.py: the plain
versions of the two equality-Riccati CUDA kernels (what the wrappers run
for CPU tensors, and what the kernels are held against on the card) versus
the JAX package.

K3's plain version against the Pallas kernel it replaces, run in interpret
mode, f32, on the random equality instances of the JAX package's own kernel
test: the same recursion and the same plain Gauss-Jordan inverse, differing
in summation order and in the pivot row (scaled by the reciprocal here,
divided there). At the two small shapes dx/du agree to 1e-4 of their scale
and the gains to 1e-3 of theirs. The instance at the legged widths (nx = nu
= 24, nc = 16) is near-singular by construction: any two f32 executors
differ there by some 1e-3 (the plain version itself moves by 2e-3 between a
batched and an unbatched matrix product), and the JAX package's own test
allows its kernel 5e-3 of scale against the f64 solve. The same bound is
held here, against the Pallas kernel and against f64; gains to 2e-2. In f64
the plain version agrees with the JAX scan solver to 1e-8.

K4's plain version against ``jax.vmap`` of the JAX scan solver on a batch
of 3 (the JAX fleet kernel needs a multiple of 128 problems and belongs to
the JAX package's slow tier in interpret mode).

The kernels' inverse runs on a compact n x n tableau (one column per lane
of a warp); ``gj_inverse_compact``, which follows its order of operations
in torch (but not its fused multiply-add rounding), equals the augmented
``gj_inverse_plain`` bit for bit, in f32 and f64, near-singular and badly
scaled matrices included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.ops.pallas_riccati import _gj_inverse, pallas_solve_eq_lqr
from cheeta_mpc_tpu.ops.riccati import solve_eq_lqr as j_solve_eq_lqr
from cheeta_mpc_tpu_torch.core.types import StageConstraint, tree_map
from cheeta_mpc_tpu_torch.ops import cuda_eq_batch as tb
from cheeta_mpc_tpu_torch.ops import cuda_eq_riccati as tk
from cheeta_mpc_tpu_torch.ops.cuda_ipm_batch import make_fleet_qp_solver
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.ops.riccati import solve_eq_lqr as t_solve_eq_lqr
from cheeta_mpc_tpu_torch.ops.riccati import solve_lqr
from tests.problem_gen import random_lq_problem
from tests.test_pallas_riccati import _stabilize, _to_f32, _to_f64, _with_eq
from tests.torch_port_util import max_err, qp_data_to_torch

SHAPES = [(0, 5, 4, 3, 2), (1, 8, 6, 5, 3), (2, 12, 24, 24, 16)]
REG = 1e-7


def _instance(seed, N, nx, nu, nc):
    rng = np.random.default_rng(seed)
    data = _to_f32(random_lq_problem(rng, N=N, nx=nx, nu=nu,
                                     dtype=np.float32))
    return _with_eq(_stabilize(data, rng), rng, nc)


def _scale(a):
    return max(1.0, float(np.abs(np.asarray(a)).max()))


@pytest.mark.parametrize("seed,N,nx,nu,nc", SHAPES)
def test_k3_plain_matches_pallas_kernel(seed, N, nx, nu, nc):
    data = _instance(seed, N, nx, nu, nc)
    ref = pallas_solve_eq_lqr(data, reg=REG, interpret=True)
    sol = tk.solve_eq_lqr_kernel(qp_data_to_torch(data), reg=REG)
    assert sol.du.dtype == torch.float32
    errs = {n: max_err(getattr(sol, n), getattr(ref, n)) / _scale(
        getattr(ref, n)) for n in ("dx", "du")}
    errs.update({n: max_err(getattr(sol.gains, n), getattr(ref.gains, n))
                 / _scale(getattr(ref.gains, n)) for n in "KkPp"})
    print(f"K3 plain vs Pallas interpret {N, nx, nu, nc}: {errs}")
    tol, tol_gain = (5e-3, 2e-2) if nx == 24 else (1e-4, 1e-3)
    assert errs["dx"] <= tol and errs["du"] <= tol, errs
    assert max(errs[n] for n in "KkPp") <= tol_gain, errs
    truth = j_solve_eq_lqr(_to_f64(data), reg=REG)
    for n in ("dx", "du"):
        assert max_err(getattr(sol, n), getattr(truth, n)) <= 5e-3 * _scale(
            getattr(truth, n)), n
    # the solution record is filled as the Pallas wrapper fills it
    assert tuple(sol.lam_l.shape) == (N + 1, 0)
    assert int(sol.iterations) == 0 and float(sol.mu) == 0.0


@pytest.mark.parametrize("seed,N,nx,nu,nc", SHAPES)
def test_k3_plain_matches_jax_scan_in_f64(seed, N, nx, nu, nc):
    data = _to_f64(_instance(seed, N, nx, nu, nc))
    ref = j_solve_eq_lqr(data, reg=REG)
    sol = tk.solve_eq_lqr_plain(qp_data_to_torch(data), reg=REG)
    assert sol.du.dtype == torch.float64
    for n in ("dx", "du"):
        assert max_err(getattr(sol, n), getattr(ref, n)) <= 1e-8 * _scale(
            getattr(ref, n)), n
    for n in "KkPp":
        assert max_err(getattr(sol.gains, n), getattr(ref.gains, n)) <= \
            1e-8 * _scale(getattr(ref.gains, n)), n


@pytest.mark.parametrize("n", [3, 16, 24])
def test_plain_gauss_jordan_matches_the_pallas_one(n):
    """Same elimination in the same order with the separate add-back; the
    pivot row is scaled by the reciprocal instead of divided, so f32
    roundoff only (1e-5 of the largest entry at condition ~10)."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n)).astype(np.float32)
    M = M @ M.T + n * np.eye(n, dtype=np.float32)
    ref = np.asarray(_gj_inverse(jnp.asarray(M)))
    got = tk.gj_inverse_plain(torch.as_tensor(M)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # batched: each matrix is inverted on its own
    Mb = np.stack([M, 2.0 * M])
    gotb = tk.gj_inverse_plain(torch.as_tensor(Mb)).numpy()
    assert np.array_equal(gotb[0], got)
    assert np.abs(gotb[1] @ Mb[1] - np.eye(n)).max() <= 5e-4


def _inverse_case(kind, n, dtype):
    rng = np.random.default_rng(100 + n)
    A = rng.standard_normal((n, n))
    if kind == "spd":
        M = A @ A.T + n * np.eye(n)
    elif kind == "near_singular":  # condition 1e6
        U, _ = np.linalg.qr(A)
        M = U @ np.diag(np.logspace(0.0, -6.0, n)) @ U.T
    else:  # joint-velocity weights in the thousands beside O(1) rows
        d = np.where(np.arange(n) % 2 == 0, 5000.0, 20.0)
        M = np.diag(d) + 0.1 * (A @ A.T)
    return torch.as_tensor(M, dtype=dtype)


@pytest.mark.parametrize("kind", ["spd", "near_singular", "r_diag_5000"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 16, 24])
def test_compact_tableau_equals_plain_gauss_jordan_bit_for_bit(n, dtype,
                                                              kind):
    """The kernels' compact n x n tableau (one column per lane) applies to
    each entry the operations of the augmented [M | I] elimination in the
    same order: the two agree in every bit, near-singular and badly scaled
    matrices included, one at a time and batched."""
    M = _inverse_case(kind, n, dtype)
    ref, got = tk.gj_inverse_plain(M), tk.gj_inverse_compact(M)
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got.view(ints), ref.view(ints))
    assert bool(torch.isfinite(got).all())
    Mb = torch.stack([M, M.T.contiguous(), 3.0 * M])
    gotb = tk.gj_inverse_compact(Mb)
    for i in range(3):
        assert torch.equal(gotb[i].view(ints),
                           tk.gj_inverse_plain(Mb[i]).view(ints))


def test_solve_eq_lqr_takes_inverse_and_eps():
    """``eps`` reaches the factorization: on a problem with inactive rows
    another eps changes nothing in the primal solution (inactive rows are
    zero), and the default inverse gives the plain version's answer."""
    data = qp_data_to_torch(_to_f64(_instance(1, 8, 6, 5, 3)))
    a = t_solve_eq_lqr(data, reg=REG)
    b = t_solve_eq_lqr(data, reg=REG, eps=7.0)
    c = t_solve_eq_lqr(data, reg=REG, inverse=tk.gj_inverse_plain)
    assert float(data.eq.mask.min()) == 0.0
    assert max_err(a.du, b.du) <= 1e-10 and max_err(a.du, c.du) <= 1e-9


def _batch_of_3(dtype):
    datas = [_instance(10 + i, 8, 6, 5, 3) for i in range(3)]
    conv = _to_f64 if dtype == "float64" else _to_f32
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *map(conv, datas))
    return stacked, qp_data_to_torch(stacked)


def test_k4_plain_matches_vmapped_jax_scan():
    jdata, tdata = _batch_of_3("float64")
    ref = jax.vmap(lambda d: j_solve_eq_lqr(d, reg=REG))(jdata)
    sol = tb.solve_eq_lqr_fleet(tdata, reg=REG)
    for n in ("dx", "du"):
        assert max_err(getattr(sol, n), getattr(ref, n)) <= 1e-8 * _scale(
            getattr(ref, n)), n
    for n in "Kk":  # real gains
        assert max_err(getattr(sol.gains, n), getattr(ref.gains, n)) <= \
            1e-8 * _scale(getattr(ref.gains, n)), n
    # NaN value function by design; eq_res is the dynamics residual
    assert bool(torch.isnan(sol.gains.P).all())
    assert bool(torch.isnan(sol.gains.p).all())
    assert tuple(sol.gains.P.shape) == (3, 9, 6, 6)
    assert tuple(sol.eq_res.shape) == (3,) and float(sol.eq_res.max()) < 1e-9
    assert tuple(sol.iterations.shape) == (3,)


def test_k4_plain_equals_k3_plain_per_problem():
    """The two kernels share their device code, so do their plain versions
    (f64 here: in f32 a batched matrix product sums in another order);
    tensors shared by the batch (no batch dimension) are accepted."""
    _, tdata = _batch_of_3("float64")
    sol = tb.solve_eq_lqr_fleet(tdata, reg=REG)
    for i in range(3):
        one = tk.solve_eq_lqr_kernel(tree_map(lambda t: t[i], tdata), reg=REG)
        assert max_err(sol.du[i], one.du) <= 1e-6 * _scale(one.du)
        assert max_err(sol.gains.K[i], one.gains.K) <= 1e-6 * _scale(
            one.gains.K)
    shared = tdata.replace(cost=tdata.cost.replace(
        Q=tdata.cost.Q[0], S=tdata.cost.S[0]))
    sol_s = tb.solve_eq_lqr_fleet(shared, reg=REG)
    one = tk.solve_eq_lqr_kernel(
        tree_map(lambda t: t[2], tdata).replace(
            cost=tree_map(lambda t: t[2], tdata.cost).replace(
                Q=tdata.cost.Q[0], S=tdata.cost.S[0])), reg=REG)
    assert tuple(sol_s.du.shape) == (3, 8, 5)
    assert max_err(sol_s.du[2], one.du) <= 1e-6 * _scale(one.du)


def _con_like(data, ng):
    N, nx, nu = data.dyn.horizon, data.dyn.nx, data.dyn.nu
    kw = dict(dtype=data.dx0.dtype)
    return StageConstraint(
        C=torch.zeros(N + 1, ng, nx, **kw), D=torch.zeros(N + 1, ng, nu, **kw),
        lg=-torch.ones(N + 1, ng, **kw), ug=torch.ones(N + 1, ng, **kw),
        mask=torch.ones(N + 1, ng, **kw))


@pytest.mark.parametrize("case", ["no_eq", "nc0", "inequalities",
                                  "two_batch_dims", "unbatched_to_fleet"])
def test_out_of_scope_raises_with_its_reason(case):
    _, tdata = _batch_of_3("float32")
    one = tree_map(lambda t: t[0], tdata)
    if case == "no_eq":
        bad, fleet_bad, word = one.replace(eq=None), tdata.replace(eq=None), \
            "no stage-equality rows"
    elif case == "nc0":
        cut = lambda d: d.replace(eq=tree_map(lambda t: t[..., :0, :]
                                              if t.dim() == d.eq.C.dim()
                                              else t[..., :0], d.eq))
        bad, fleet_bad, word = cut(one), cut(tdata), "no stage-equality rows"
    elif case == "inequalities":
        bad = one.replace(con=_con_like(one, 2))
        fleet_bad, word = tdata.replace(con=_con_like(one, 2)), \
            "inequality rows"
    elif case == "two_batch_dims":
        bad = None
        fleet_bad, word = tree_map(lambda t: t[None], tdata), \
            "2 batch dimensions"
    else:
        bad, fleet_bad, word = None, one, "0 batch dimensions"
    if bad is not None:
        with pytest.raises(NotImplementedError, match=word):
            tk.solve_eq_lqr_kernel(bad)
        assert word in tk.eq_out_of_scope_reason(bad)
    with pytest.raises(NotImplementedError, match=word):
        tb.solve_eq_lqr_fleet(fleet_bad)
    assert word in tb.out_of_scope_reason(fleet_bad)
    assert tb.out_of_scope_reason(tdata) is None
    assert tk.eq_out_of_scope_reason(one) is None


def test_dispatch_of_the_kernel_backend():
    """``qp_backend='riccati_kernel'``: an inequality-free problem goes to
    the equality-Riccati family (real P unbatched, NaN P batched), one with
    inequalities to the interior-point family, batched inequalities with
    equalities too (the fleet kernel's instantiation with the elimination:
    NaN gains, element 0 equal to the batch-1 solve to 1e-6 of scale); a
    problem with neither goes to the equality-Riccati family with one
    all-masked row, which is the exact LQR solve (1e-9 of scale). On the
    CPU no kernel is launched, so no count moves."""
    _, tdata = _batch_of_3("float64")
    one = tree_map(lambda t: t[0], tdata)
    qp_solve = make_fleet_qp_solver(IpmSettings(iters=4, reg=REG))
    before = (tk.solve_eq_lqr_kernel.launches, tb.solve_eq_lqr_fleet.launches)
    s1, sb = qp_solve(one), qp_solve(tdata)
    assert bool(torch.isfinite(s1.gains.P).all())
    assert bool(torch.isnan(sb.gains.P).all())
    assert max_err(sb.du[0], s1.du) <= 1e-6 * _scale(s1.du)
    assert before == (tk.solve_eq_lqr_kernel.launches,
                      tb.solve_eq_lqr_fleet.launches)
    with_con = one.replace(con=_con_like(one, 2))
    s1c = qp_solve(with_con)
    assert float(s1c.mu) > 0.0  # the interior-point path ran
    sbc = qp_solve(tdata.replace(con=_con_like(one, 2)))
    assert bool(torch.isnan(sbc.gains.K).all()) and float(sbc.mu[0]) > 0.0
    assert max_err(sbc.du[0], s1c.du) <= 1e-6 * _scale(s1c.du)
    bare = one.replace(eq=None)
    ref = solve_lqr(bare, reg=REG)
    assert max_err(qp_solve(bare).du, ref.du) <= 1e-9 * _scale(ref.du)
