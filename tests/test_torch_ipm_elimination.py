"""PyTorch port, csrc/ipm_riccati.cuh: the stage-equality elimination of
K1/K2 in the order the kernels compute it, against the plain factorization
``ops/riccati.py::riccati_factorize_eq`` (what the kernels' plain versions
run).

The kernels reassociate the elimination around Z = G^-1 H and
T = Ce - Y'H (W = G^-1 - Y Li Y', Li = Lam^-1):

    K   = -(W H + Y Li Ce)                 = -(Z + Y Li T)
    P_k = sym(Qb + A'PA + H'K + Ce' Li T)  = sym(Qb + A'PA - H'Z + T' Li T)

which is exact in real arithmetic. ``_factorize_eq_kernel_order`` is a
model of that order; the kernels themselves run only on the card
(``chip_smoke.py`` holds them to their plain versions there). Inputs: the
legged pyramid QP of the planner's trot (N=67, nx=nu=24, 16 equality
rows), the seeded equality instances of the kernels' plain-version tests,
and ``chip_smoke.random_qp(7, ...)`` at the legged shape, the near-singular
instance of the card's gates. Barrier weights on the inequality rows are
drawn log-uniform from 1e-2; each stage is held on its own, from the plain
factorization's P_{k+1} in f64, so that no error is carried over stages.

Tolerances, of each factor's largest entry. In f64, with weights up to 1e4
(G's conditioning grows with them), the two orders agree to round-off:
1e-10 (measured at most 3.1e-12 over 12 draws of the weights, 1e-14 on
the legged QP). In f32 both orders run the kernels' Gauss-Jordan inverse
(``spd_inverse_gj``); the kernels' order is held to the f64 plain
factorization within 1e-3, with weights up to 1e2: f32 round-off (6e-8)
grows with the conditioning of G and Lam (highest on the near-singular
instance) and over sums of 16-48 terms. Measured over 12 draws: at most
1.7e-4 (the near-singular instance's K; 2.5e-5 on the others), where the
plain order in f32 reads 1.9e-4 (2.1e-5); a wrong sign or a dropped term
reads O(1).
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from cheeta_mpc_tpu_torch.core.types import symmetrize, tree_map
from cheeta_mpc_tpu_torch.ops.cuda_ipm_riccati import (EQ_EPS, _masked_eq,
                                                       spd_inverse_gj)
from cheeta_mpc_tpu_torch.ops.ocpqp import IpmSettings
from cheeta_mpc_tpu_torch.ops.riccati import riccati_factorize_eq
from tests.test_torch_ipm_kernel_plain import _eq_instances
from tests.torch_port_util import qp_data_to_torch

FACTORS = ("K", "W", "YLi", "Li", "H", "P")
REG = IpmSettings().reg
# Barrier weights 10^U(lo, hi) on the active inequality rows, per dtype.
W_LOG10 = {torch.float64: (-2.0, 4.0), torch.float32: (-2.0, 2.0)}


def _t(x):
    return x.transpose(-1, -2)


def _factorize_eq_kernel_order(dyn, Q, R, S, Ceq, Deq, eq_mask, reg, eps,
                               inverse):
    """The backward pass of ``riccati_factorize_eq`` in the kernels' order
    of one stage (E1-E5 of csrc/ipm_riccati.cuh): Y and Z; Lam; Li beside
    T and P_1 = Qb + A'PA - H'Z; YLi and T2 = Li T; W, K and
    P_k = sym(P_1 + T'T2). Returns the factors by name, stage-major."""
    N, nu = R.shape[-3], R.shape[-1]
    eye_u = torch.eye(nu, dtype=R.dtype)
    P_next = symmetrize(Q[..., N, :, :])
    out = {name: [] for name in FACTORS}
    out["P"].append(P_next)
    for k in range(N - 1, -1, -1):
        A, B = dyn.A[..., k, :, :], dyn.B[..., k, :, :]
        Ce, De = Ceq[..., k, :, :], Deq[..., k, :, :]
        PA, PB = P_next @ A, P_next @ B
        G = R[..., k, :, :] + _t(B) @ PB + reg * eye_u
        H = S[..., k, :, :] + _t(B) @ PA
        Gi = inverse(symmetrize(G))
        Y, Z = Gi @ _t(De), Gi @ H
        Lam = De @ Y + torch.diag_embed(eps * (1.0 - eq_mask[..., k, :]))
        T = Ce - _t(Y) @ H
        Li = inverse(symmetrize(Lam))
        P1 = Q[..., k, :, :] + _t(A) @ PA - _t(H) @ Z
        YLi, T2 = Y @ Li, Li @ T
        W = Gi - YLi @ _t(Y)
        K = -(Z + YLi @ T)
        P_next = symmetrize(P1 + _t(T) @ T2)
        for name, val in zip(FACTORS, (K, W, YLi, Li, H, P_next)):
            out[name].append(val)
    return {name: torch.stack(vals[::-1], dim=-3)
            for name, vals in out.items()}


def _barrier_blocks(qp, seed, log10_range):
    """Qb, Rb, Sb: the cost blocks plus the inequality rows' barrier
    terms, with weights drawn log-uniform over ``log10_range`` on the
    active rows (what the kernels add in their second product phase)."""
    rng = np.random.default_rng(seed)
    con = qp.con
    w = torch.as_tensor(
        10.0 ** rng.uniform(*log10_range, size=con.mask.shape),
        dtype=con.C.dtype) * con.mask
    C, D = con.C, con.D[..., :-1, :, :]
    Cw, Dw = C * w[..., None], D * w[..., :-1, :, None]
    return (qp.cost.Q + _t(C) @ Cw, qp.cost.R + _t(D) @ Dw,
            qp.cost.S + _t(D) @ Cw[..., :-1, :, :])


@functools.lru_cache(maxsize=None)
def _instance(name):
    """One QP in float64, inactive equality rows zeroed as the kernels
    take them (its data are float32 values where the source is float32)."""
    if name == "legged_pyramid":
        from cheeta_mpc_tpu_torch.examples import (LEGGED_TEST_WEIGHTS,
                                                   make_legged_example_inputs)
        from cheeta_mpc_tpu_torch.mpc.legged_mpc import (LeggedMpcConfig,
                                                         build_legged_solver)
        cfg = LeggedMpcConfig(horizon=67, cone_mode="pyramid",
                              **LEGGED_TEST_WEIGHTS)
        qp = build_legged_solver(cfg, device="cpu").initial_qp(
            *make_legged_example_inputs(cfg).args)
    elif name.startswith("eq_instance"):
        qp = qp_data_to_torch(_eq_instances()[int(name[-1])])
    else:
        qp = chip_smoke.random_qp(7, "cpu", **chip_smoke.LEGGED_SHAPE)
    return tree_map(lambda x: x.double() if x.is_floating_point() else x,
                    _masked_eq(qp))


def _stages(qp, dtype, seed, log10_range):
    """Every stage of ``qp`` as a one-stage problem of its own, batched
    over the stages, whose terminal cost is that stage's P_{k+1} from the
    plain factorization in float64: so each order is held to the other
    stage by stage, with no error carried from the stages after it."""
    Qb, Rb, Sb = _barrier_blocks(qp, seed, log10_range)
    eq = qp.eq
    P = riccati_factorize_eq(qp.dyn, Qb, Rb, Sb, eq.C, eq.D, eq.mask,
                             reg=REG, eps=EQ_EPS, inverse=spd_inverse_gj).P
    one = lambda x: x[:, None].to(dtype)  # noqa: E731
    dyn = qp.dyn.replace(A=one(qp.dyn.A), B=one(qp.dyn.B))
    Q = torch.stack([Qb[:-1], P[1:]], dim=1).to(dtype)
    return (dyn, Q, one(Rb), one(Sb), one(eq.C), one(eq.D), one(eq.mask))


def _factor_pair(qp, dtype, seed, log10_range):
    """(plain order, kernels' order) of every stage's factors in
    ``dtype``."""
    args = _stages(qp, dtype, seed, log10_range)
    ref = riccati_factorize_eq(*args, reg=REG, eps=EQ_EPS,
                               inverse=spd_inverse_gj)
    new = _factorize_eq_kernel_order(*args, reg=REG, eps=EQ_EPS,
                                     inverse=spd_inverse_gj)
    return ({name: getattr(ref, name) for name in FACTORS}, new)


INSTANCES = ("legged_pyramid", "eq_instance_0", "eq_instance_1",
             "eq_instance_2", "random_qp_legged")


@pytest.mark.parametrize("name", INSTANCES)
def test_kernel_order_equals_the_plain_factorization_f64(name):
    dt = torch.float64
    ref, new = _factor_pair(_instance(name), dt, 5, W_LOG10[dt])
    errs = {f: float((new[f] - ref[f]).abs().max() / ref[f].abs().max())
            for f in FACTORS}
    print(f"{name}, f64, kernels' order vs plain, relative: {errs}")
    assert all(e <= 1e-10 for e in errs.values()), errs


@pytest.mark.parametrize("name", INSTANCES)
def test_kernel_order_in_f32_against_the_f64_factorization(name):
    qp, dt = _instance(name), torch.float32
    truth, _ = _factor_pair(qp, torch.float64, 5, W_LOG10[dt])
    ref, new = _factor_pair(qp, dt, 5, W_LOG10[dt])
    for f in FACTORS:
        scale = float(truth[f].abs().max())
        err_ref = float((ref[f].double() - truth[f]).abs().max()) / scale
        err_new = float((new[f].double() - truth[f]).abs().max()) / scale
        print(f"{name}, f32 {f}: kernels' order {err_new:.2e}, plain order "
              f"{err_ref:.2e} (of the largest entry, against f64)")
        assert err_new <= 1e-3, (f, err_new, err_ref)
