"""PyTorch port, ops/cuda_ipm_riccati.py and ops/cuda_ipm_batch.py: the plain
versions of the two CUDA kernels (what the wrappers run for CPU tensors, and
what the kernels are held against on the card) versus the JAX package.

K1's plain version against the Pallas kernel it replaces, run in interpret
mode, f32, on the instances of the JAX package's own kernel tests. Same
algorithm and the same Gauss-Jordan inverse, so the two differ by summation
order only, compounded over 20 IPM iterations at barrier weights up to 1e6.
The tolerances are the JAX package's executor-against-executor bounds (du/dx
2e-3, duals 5e-3, K 2e-2), not looser; the measured errors are printed.

K2's plain version against ``jax.vmap`` of the JAX scan solver in f32 (the
fleet kernel's interpret mode belongs to the JAX package's slow tier), and
against K1's plain version element by element.

The kernels' SPD inverse runs on one warp up to 32 wide and in the block
form above (csrc/ipm_riccati.cuh); the plain version's ``spd_inverse_gj`` is
held to the JAX one on both sides of that width, and a model of the warp
form's order (``_spd_inverse_rotated``) to ``spd_inverse_gj`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheeta_mpc_tpu.core.types import StageConstraint, StageEquality
from cheeta_mpc_tpu.ops import ocpqp as jo
from cheeta_mpc_tpu.ops.pallas_ipm_riccati import pallas_solve_ocp_qp
from cheeta_mpc_tpu.ops.pallas_riccati import spd_inverse_kernel
from cheeta_mpc_tpu.ops.riccati import solve_eq_lqr as j_solve_eq_lqr
from cheeta_mpc_tpu_torch.core.types import symmetrize, tree_map
from cheeta_mpc_tpu_torch.ops import cuda_ipm_batch as tb
from cheeta_mpc_tpu_torch.ops import cuda_ipm_riccati as tk
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from tests.problem_gen import (add_random_constraints, random_lq_problem,
                               random_psd)
from tests.torch_port_util import max_err, qp_data_to_torch

ITERS = 20
WIDE = "nu36"  # a QP whose G (36 wide) K1 inverts in the block form


def _to_f32(data):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if hasattr(x, 'astype') else x, data)


def _ineq_instances(seed=31, count=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        data = random_lq_problem(rng, N=8, nx=5, nu=3)
        out.append(add_random_constraints(rng, data, ng=4, tight=0.4))
    return out


def _eq_instances(seed=41, count=3, nu=4):
    """Masked stage equalities and inequality rows around the equality
    solution. A wider input shrinks its couplings (B and the equalities'
    D) with the square root of its width, so that the QP is conditioned
    like the narrow ones (as chip_smoke.py's ``random_qp``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        N, nx, nc = 8, 5, 2
        wu = np.sqrt(4 / nu)
        data = random_lq_problem(rng, N=N, nx=nx, nu=nu)
        data = data.replace(dyn=data.dyn.replace(B=data.dyn.B * wu))
        Ceq = rng.normal(size=(N, nc, nx))
        Deq = wu * rng.normal(size=(N, nc, nu)) + 1.5 * np.eye(nc, nu)[None]
        e = rng.normal(size=(N, nc)) * 0.1
        mask = (rng.uniform(size=(N, nc)) < 0.7).astype(np.float64)
        eq = StageEquality(C=jnp.asarray(Ceq * mask[:, :, None]),
                           D=jnp.asarray(Deq * mask[:, :, None]),
                           e=jnp.asarray(e * mask), mask=jnp.asarray(mask))
        eq_sol = j_solve_eq_lqr(data.replace(eq=eq))
        data = add_random_constraints(
            rng, data, ng=3, tight=0.6,
            ref=(np.asarray(eq_sol.dx), np.asarray(eq_sol.du)))
        out.append(data.replace(eq=eq))
    return out


def _against_pallas(data, trial):
    d32 = _to_f32(data)
    ref = pallas_solve_ocp_qp(d32, jo.IpmSettings(iters=ITERS),
                              interpret=True)
    sol = tk.solve_ocp_qp_kernel(qp_data_to_torch(d32),
                                 IpmSettings(iters=ITERS))
    assert sol.du.dtype == torch.float32
    errs = {"du": max_err(sol.du, ref.du), "dx": max_err(sol.dx, ref.dx),
            "lam_l": max_err(sol.lam_l, ref.lam_l),
            "lam_u": max_err(sol.lam_u, ref.lam_u),
            "K": max_err(sol.gains.K, ref.gains.K),
            "mu": max_err(sol.mu, ref.mu)}
    print(f"K1 plain vs Pallas interpret, trial {trial}: {errs}")
    assert errs["du"] <= 2e-3 and errs["dx"] <= 2e-3, errs
    assert errs["lam_l"] <= 5e-3 and errs["lam_u"] <= 5e-3, errs
    assert errs["K"] <= 2e-2, errs
    assert np.all(np.isfinite(sol.gains.P.numpy()))
    return sol


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_k1_plain_matches_pallas_kernel(trial):
    _against_pallas(_ineq_instances()[trial], trial)


@pytest.mark.parametrize("trial", [0, 1, 2, WIDE])
def test_k1_plain_matches_pallas_kernel_with_equalities(trial):
    """Case ``WIDE``: nu = 36, past one warp's tableau, where K1 inverts G
    in the block form. (Without the equalities no f32 reference holds:
    the Pallas kernel in interpret mode returns NaN on most seeds of such a
    QP, and the JAX scan solver in f32 parts from both by 3-4.5 in du.)"""
    data = (_eq_instances(count=1, nu=36)[0] if trial == WIDE
            else _eq_instances()[trial])
    sol = _against_pallas(data, trial)
    eq = data.eq
    r_eq = (np.einsum('kij,kj->ki', np.asarray(eq.C), sol.dx[:-1].numpy())
            + np.einsum('kij,kj->ki', np.asarray(eq.D), sol.du.numpy())
            + np.asarray(eq.e)) * np.asarray(eq.mask)
    assert np.abs(r_eq).max() < 1e-3  # the JAX test's own bound


def test_gauss_jordan_inverse_matches_the_pallas_one():
    """The kernels' SPD inverse (equilibrated, shifted-column Gauss-Jordan,
    no Newton step) against ``spd_inverse_kernel``: the same elimination in
    the same order, so f32 roundoff only (1e-5 relative to the largest
    entry, at condition ~1e2)."""
    rng = np.random.default_rng(5)
    for n in (3, 16, 24):
        M = random_psd(rng, n).astype(np.float32)
        ref = np.asarray(spd_inverse_kernel(jnp.asarray(M), n))
        got = tk.spd_inverse_gj(torch.as_tensor(M)).numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        assert np.abs(got @ M - np.eye(n)).max() < 1e-3
    # Batched, and the identity on an empty matrix.
    Ms = np.stack([random_psd(rng, 6) for _ in range(4)])
    got = tk.spd_inverse_gj(torch.as_tensor(Ms))
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(Ms), atol=1e-9)
    assert tk.spd_inverse_gj(torch.zeros(2, 0, 0)).shape == (2, 0, 0)


def _barrier_like_spd(n):
    """An SPD matrix conditioned like the barrier-weighted Hessian: a
    well-conditioned core S (condition 6-8) scaled by D = diag of 1..1e3,
    so cond(M) ~ 1e6. Returns M and the diagonal of D."""
    rng = np.random.default_rng(100 + n)
    S = random_psd(rng, n, min_eig=0.5)
    d = np.logspace(0, 3, n)
    rng.shuffle(d)
    return d[:, None] * S * d[None, :], d


def _equilibrated_err(got, ref, d):
    """Largest error of D X D relative to the largest entry of D X_ref D:
    the error the elimination itself makes, independent of the scaling."""
    scaled = d[:, None] * (got - ref) * d[None, :]
    return np.abs(scaled).max() / np.abs(d[:, None] * ref * d[None, :]).max()


def _pallas_spd_inverse(M):
    """``spd_inverse_kernel`` inside a ``pallas_call``, interpret mode."""
    from jax.experimental import pallas as pl
    n = M.shape[0]

    def kernel(m_ref, o_ref):
        o_ref[...] = spd_inverse_kernel(m_ref[...], n)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(M.shape, M.dtype),
        interpret=True)(jnp.asarray(M)))


@pytest.mark.parametrize("n", [16, 24, 33, 40, 48])
def test_gauss_jordan_inverse_at_barrier_conditioning_f64(n):
    """The compact-tableau elimination (the kernels' register layout) in f64
    against ``np.linalg.inv`` at cond ~1e6 (nc = 16 and nu = 24 of the
    legged and centroidal shapes, and widths of the block form): 4e-15
    measured, 1e-12 allowed."""
    M, d = _barrier_like_spd(n)
    assert np.linalg.cond(M) > 5e5
    got = tk.spd_inverse_gj(torch.as_tensor(M)).numpy()
    err = _equilibrated_err(got, np.linalg.inv(M), d)
    print(f"n={n}: f64 vs np.linalg.inv {err:.2e}")
    assert err <= 1e-12


@pytest.mark.parametrize("n", [16, 24, 33, 40])
def test_gauss_jordan_inverse_matches_pallas_interpret_at_barrier_conditioning(
        n):
    """The same in f32 against the Pallas kernel's ``spd_inverse_kernel`` run
    in a ``pallas_call`` in interpret mode, at cond ~1e6. The Pallas one
    divides by the pivot where the kernels multiply by its reciprocal, so
    they differ by f32 rounding: 1.6e-7 (n=16) and 2.5e-7 (n=24) measured,
    5e-6 allowed; both stay within the same bound of the f64 inverse."""
    M, d = _barrier_like_spd(n)
    M32 = M.astype(np.float32)
    ref = _pallas_spd_inverse(M32)
    got = tk.spd_inverse_gj(torch.as_tensor(M32)).numpy()
    err = _equilibrated_err(got, ref, d)
    err64 = _equilibrated_err(got, np.linalg.inv(M), d)
    print(f"n={n}: f32 vs Pallas interpret {err:.2e}, vs f64 {err64:.2e}")
    assert err <= 5e-6 and err64 <= 5e-6


def _sparse_g(n):
    """An input Hessian as sparse as the legged G: a diagonal spread over
    1..1e3 with couplings inside blocks of three and exact zeros
    elsewhere."""
    rng = np.random.default_rng(200 + n)
    M = np.diag(rng.uniform(1.0, 1e3, n))
    for b in range(0, n - 1, 3):
        e = min(b + 3, n)
        B = rng.normal(size=(e - b, e - b))
        M[b:e, b:e] += B @ B.T
    return M


def _spd_inverse_rotated(M: torch.Tensor) -> torch.Tensor:
    """``spd_inverse_gj`` in the order of the kernels' one-warp form
    (csrc/ipm_riccati.cuh::warp_spd_inverse), for n <= WARP_INVERSE_MAX:
    the tableau padded with zeros to the instantiation's width k (n itself
    at the widths of WARP_INVERSE_EXACT, else 32), lane c holding column c,
    the rows rotated so that row 0 of the register file is always the
    pivot row. At each pivot the column comes from lane j, the one-hot
    shift falls on its first entry alone, lane c != j takes the pivot row
    times the pivot's reciprocal, lane j the reciprocal itself over e_j,
    and the rows move down by one as they are formed. Every entry of the
    first n rows and lanes sees the operations of ``spd_inverse_gj`` in
    the same order, so the two agree bit for bit; the padding stays zero.
    Like ``spd_inverse_gj`` it rounds each update's product and difference
    separately, where the kernels fuse them into one multiply-add."""
    n = M.shape[-1]
    if n == 0:
        return M
    if n > tk.WARP_INVERSE_MAX:
        raise ValueError(f"n={n}: the one-warp form takes n <= "
                         f"{tk.WARP_INVERSE_MAX}")
    k = n if n in tk.WARP_INVERSE_EXACT else tk.WARP_INVERSE_MAX
    M = symmetrize(M)
    s = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                                min=1e-30))
    U = M.new_zeros(M.shape[:-2] + (k, k))  # (..., row slot t, lane c)
    U[..., :n, :n] = s[..., :, None] * M * s[..., None, :]
    lane_j = torch.eye(k, dtype=torch.bool, device=M.device)
    first = torch.zeros(k, 1, dtype=M.dtype, device=M.device)
    first[0] = 1.0  # the pivot row's place, and e_j in lane j
    for j in range(n):
        mine = lane_j[j]  # (k,): lane j
        ci = U[..., :, j:j + 1]  # lane j's registers: the pivot column
        ipiv = 1.0 / ci[..., :1, :]
        rv = torch.where(mine, ipiv, U[..., :1, :] * ipiv)
        base = torch.where(mine, first, U)
        U = base - (ci - first) * rv
        U = torch.cat([U[..., 1:, :], U[..., :1, :]], dim=-2)
    # Slot t holds row (t + n) mod k; put row i back in slot i.
    U = torch.roll(U, n, dims=-2)[..., :n, :n]
    return s[..., :, None] * U * s[..., None, :]


@pytest.mark.parametrize("kind", ["barrier", "sparse"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 12, 16, 24, 32])
def test_rotated_warp_order_equals_the_compact_inverse_bit_for_bit(n, dtype,
                                                                  kind):
    """The one-warp form's order of operations (rows rotated so that the
    pivot row comes first, the one-hot shift on the pivot row's entry
    alone, lane j's slot turning into e_j, the padding to the 16-, 24- or
    32-wide instance) applies to every entry the operations of
    ``spd_inverse_gj`` in the same order: the two agree in every bit, at
    barrier conditioning (~1e6) and on a sparse G with zero entries, one
    at a time and batched."""
    M = _barrier_like_spd(n)[0] if kind == "barrier" else _sparse_g(n)
    M = torch.as_tensor(M, dtype=dtype)
    if kind == "barrier" and n > 1:
        assert np.linalg.cond(M.double().numpy()) > 1e5
    if kind == "sparse" and n > 2:
        assert int((M == 0).sum()) > n
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    ref, got = tk.spd_inverse_gj(M), _spd_inverse_rotated(M)
    assert torch.equal(got.view(ints), ref.view(ints))
    assert bool(torch.isfinite(got).all())
    Mb = torch.stack([M, 2.0 * M, M + torch.eye(n, dtype=dtype)])
    gotb, refb = _spd_inverse_rotated(Mb), tk.spd_inverse_gj(Mb)
    assert torch.equal(gotb.view(ints), refb.view(ints))


def test_rotated_warp_order_refuses_widths_past_the_warp():
    """Past WARP_INVERSE_MAX the kernels take the block form, whose order
    ``spd_inverse_gj`` is; the warp form's model refuses such a width."""
    M = torch.eye(tk.WARP_INVERSE_MAX + 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="one-warp form"):
        _spd_inverse_rotated(M)
    assert torch.equal(tk.spd_inverse_gj(M), M)


def _shared_cd_batch(seed, batch=4):
    """``batch`` problems with one set of constraint matrices C/D; each
    problem's bounds are placed around its own reference rollout, so every
    element is feasible (as ``add_random_constraints`` does for one)."""
    rng = np.random.default_rng(seed)
    N, nx, nu, ng = 8, 5, 3, 4
    C = rng.normal(size=(N + 1, ng, nx))
    D = rng.normal(size=(N + 1, ng, nu))
    D[-1] = 0.0
    probs = []
    for _ in range(batch):
        d = random_lq_problem(rng, N=N, nx=nx, nu=nu)
        A, B, b = (np.asarray(a) for a in (d.dyn.A, d.dyn.B, d.dyn.b))
        du_ref = rng.normal(size=(N, nu)) * 0.3
        dx_ref = [np.asarray(d.dx0)]
        for k in range(N):
            dx_ref.append(A[k] @ dx_ref[k] + B[k] @ du_ref[k] + b[k])
        g_ref = (np.einsum('nij,nj->ni', C, np.stack(dx_ref))
                 + np.einsum('nij,nj->ni', D,
                             np.concatenate([du_ref, np.zeros((1, nu))])))
        probs.append(d.replace(con=StageConstraint(
            C=jnp.asarray(C), D=jnp.asarray(D),
            lg=jnp.asarray(g_ref - 0.4 * rng.uniform(0.1, 1.0, g_ref.shape)),
            ug=jnp.asarray(g_ref + 0.4 * rng.uniform(0.1, 1.0, g_ref.shape)),
            mask=jnp.asarray(
                (rng.uniform(size=g_ref.shape) < 0.9).astype(np.float64)))))
    stacked = _to_f32(jax.tree.map(lambda *xs: jnp.stack(xs), *probs))
    full = qp_data_to_torch(stacked)
    shared = full.replace(con=full.con.replace(
        C=full.con.C[0].clone(), D=full.con.D[0].clone()))
    return stacked, shared


def test_k2_plain_matches_vmapped_scan_solver():
    """Fleet plain version (batch 4, shared C/D) vs ``jax.vmap`` of the scan
    solver, both f32: two executors of one algorithm with different SPD
    inverses, hence the JAX package's executor tolerances again. (The seed
    is one whose four instances an f32 IPM resolves cleanly; on others a
    single element can differ by 1e-2 between ANY two f32 executors.)"""
    stacked, shared = _shared_cd_batch(54)
    s = jo.IpmSettings(iters=ITERS)
    ref = jax.vmap(lambda d: jo.solve_ocp_qp(d, s))(stacked)
    sol = tb.solve_ocp_qp_fleet(shared, IpmSettings(iters=ITERS))
    errs = {n: max_err(getattr(sol, n), getattr(ref, n))
            for n in ("du", "dx", "lam_l", "lam_u", "mu")}
    print(f"K2 plain vs vmapped scan solver: {errs}")
    assert errs["du"] <= 2e-3 and errs["dx"] <= 2e-3, errs
    assert errs["lam_l"] <= 5e-3 and errs["lam_u"] <= 5e-3, errs
    assert sol.mu.shape == (4,) and sol.stat_res.shape == (4,)
    # Gains are NaN by design, so that using them by accident is loud.
    assert torch.isnan(sol.gains.K).all() and torch.isnan(sol.gains.P).all()
    assert sol.gains.K.shape == (4, 8, 3, 5)


def _element(shared, i, batch=4):
    """Problem ``i`` of a batch whose C/D are shared."""
    con = shared.con
    return tree_map(lambda t: t if t is con.C or t is con.D else t[i], shared)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_k2_plain_matches_k1_plain_element_by_element(dtype, tol):
    """The kernels share their device code and the plain versions their
    arithmetic: each element of the fleet is the batch-1 solve of that
    element. In f64 that holds to 1e-9, which pins the per-element freeze,
    guard and step lengths. In f32 torch sums batched and unbatched
    reductions in another order and 20 iterations at barrier weights up to
    1e6 amplify it: 3e-4 is the most measured on this instance, and the
    f32 bound is that with a factor of three. (The step guard is a threshold: an instance on which one
    executor accepts a step that the other rejects by a hair parts ways for
    good, in any precision. The seed has no such element.)"""
    _, shared = _shared_cd_batch(56)
    shared = tree_map(lambda t: t.to(dtype), shared)
    s = IpmSettings(iters=ITERS)
    fleet = tb.solve_ocp_qp_fleet(shared, s)
    worst = 0.0
    for i in range(4):
        single = tk.solve_ocp_qp_kernel(_element(shared, i), s)
        for name in ("dx", "du", "s_l", "s_u", "mu"):
            err = max_err(getattr(fleet, name)[i], getattr(single, name))
            worst = max(worst, err)
            assert err <= tol, (i, name, err)
    print(f"K2 plain vs K1 plain, {dtype}: {worst}")


def test_make_fleet_qp_solver_dispatch_and_scope():
    """Unbatched -> K1 (real gains); batched -> K2 (NaN gains), with C/D
    shared by the batch or each problem's own (a copy per problem gives the
    shared solve to 1e-6, f32); what the fleet kernel does not take raises
    with the reason."""
    _, shared = _shared_cd_batch(53, batch=2)
    solve = tb.make_fleet_qp_solver(IpmSettings(iters=6))
    fleet = solve(shared)
    assert torch.isnan(fleet.gains.K).all() and fleet.du.shape[0] == 2
    one = _element(shared, 0)
    single = solve(one)
    assert torch.isfinite(single.gains.K).all() and single.du.dim() == 2
    per_problem_cd = shared.replace(con=shared.con.replace(
        C=shared.con.C.expand(2, -1, -1, -1).contiguous(),
        D=shared.con.D.expand(2, -1, -1, -1).contiguous()))
    own = solve(per_problem_cd)
    assert torch.isnan(own.gains.K).all()
    for name in ("dx", "du"):
        assert max_err(getattr(own, name), getattr(fleet, name)) <= 1e-6
    with pytest.raises(NotImplementedError, match="no inequality rows"):
        tb.solve_ocp_qp_fleet(shared.replace(con=None))
    with pytest.raises(ValueError, match="inequality rows"):
        tk.solve_ocp_qp_kernel(one.replace(con=None))
