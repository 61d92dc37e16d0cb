"""The legged SQP linearization: on the CPU the solver keeps its plain
forward-mode version and never reaches the CUDA kernel L1
(``ops/cuda_legged_linearize.py``); on any other device it hands L1 its
inputs, which the wrapper checks and passes on, here to a stub in place of
the kernels' library.

No test here needs a card. Tensors on PyTorch's ``meta`` device stand for
CUDA tensors where only their device, dtype, shape and layout matter: the
solver sends every tensor that is not on the CPU to the kernel.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from cheeta_mpc_tpu_torch import examples
from cheeta_mpc_tpu_torch.models.srbd_legged import (
    srbd_linearize, weight_compensating_input)
from cheeta_mpc_tpu_torch.mpc import legged_mpc as lm
from cheeta_mpc_tpu_torch.native import build
from cheeta_mpc_tpu_torch.ops import cuda_legged_linearize as ll

N = 8
MODES = [("soft", False), ("soft", True), ("pyramid", False),
         ("pyramid", True)]  # (cone mode, event-aligned dts)
INPUT_NAMES = ["x_traj", "u_traj", "enable", "z_pos", "z_vel", "eq_mask",
               "x_ref", "u_ref", "dts"]  # csrc/legged_linearize.cu, In


def _cfg(cone_mode, dtype=torch.float32):
    return lm.LeggedMpcConfig(horizon=N, cone_mode=cone_mode, dtype=dtype,
                              **examples.LEGGED_TEST_WEIGHTS)


def _inputs(cfg, batch, event, seed=4):
    """The example trot with a perturbed warm start, so that every term of
    the linearization is away from its value at rest."""
    inp = examples.make_legged_example_inputs(cfg, batch=batch, seed=seed,
                                              event_aligned=event)
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    xw = (np.asarray(inp.x0)[..., None, :] + np.zeros(lead + (N + 1, 24))
          + 0.05 * rng.standard_normal(lead + (N + 1, 24)))
    uw = rng.standard_normal(lead + (N, 24)) * np.r_[np.full(12, 20.0),
                                                     np.full(12, 0.5)]
    uw[..., 2:12:3] += 70.0
    return inp, (xw, uw)


def _starting_trajectory(cfg, inp, warm):
    """The trajectory the first SQP iteration linearizes at, as the
    solver's ``start`` builds it, in float32 on the CPU."""
    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    x0, enable = f32(inp.args[0]), f32(inp.args[2])
    lead = enable.shape[:-2]
    x0 = x0.expand(lead + (24,))
    if warm is None:
        return (x0[..., None, :].expand(lead + (N + 1, 24)),
                weight_compensating_input(cfg.params, enable))
    return (torch.cat([x0[..., None, :], f32(warm[0])[..., 1:, :]], dim=-2),
            f32(warm[1]))


def _leaves(obj, prefix=""):
    if torch.is_tensor(obj) or obj is None:
        return {prefix: obj}
    fields = obj._fields if hasattr(obj, "_fields") else \
        obj.__dataclass_fields__
    out = {}
    for f in fields:
        out.update(_leaves(getattr(obj, f), f"{prefix}.{f}"))
    return out


@pytest.mark.parametrize("batch, warm", [(None, True), (2, True),
                                         (2, False)])
@pytest.mark.parametrize("cone_mode, event", MODES)
def test_cpu_linearization_is_the_plain_path_bit_for_bit(
        cone_mode, event, batch, warm, monkeypatch):
    """``build_legged_solver(device="cpu")``'s first QP never reaches L1's
    wrapper and equals, leaf by leaf and bit for bit, the plain version's
    QP; its dynamics are ``srbd_linearize`` at the starting trajectory, its
    q is Q (x - x_ref), its R without the soft cone the solver's diag(R),
    and its inactive equality rows are exact zeros."""

    def boom(*a, **k):
        raise AssertionError("L1's wrapper reached from the CPU")

    monkeypatch.setattr(lm, "legged_linearize", boom)
    cfg = _cfg(cone_mode)
    solve = lm.build_legged_solver(cfg, device="cpu")
    inp, warm_traj = _inputs(cfg, batch, event)
    warm_traj = warm_traj if warm else None
    qp = solve.initial_qp(*inp.args, warm=warm_traj, dts=inp.dts)
    plain = solve.initial_qp(*inp.args, warm=warm_traj, dts=inp.dts,
                             plain=True)
    got, ref = _leaves(qp), _leaves(plain)
    assert got.keys() == ref.keys()
    for name, t in ref.items():
        assert (got[name] is None) == (t is None), name
        if t is not None:
            assert got[name].shape == t.shape, name
            assert torch.equal(got[name], t), name

    x, u = _starting_trajectory(cfg, inp, warm_traj)
    enable = torch.as_tensor(inp.enable, dtype=torch.float32)
    dts = None if inp.dts is None else torch.as_tensor(inp.dts,
                                                       dtype=torch.float32)
    A, B, f = srbd_linearize(cfg.params, x[..., :-1, :], u, enable, dts)
    assert torch.equal(qp.dyn.A, A) and torch.equal(qp.dyn.B, B)
    assert torch.equal(qp.dyn.b, f - x[..., 1:, :])
    x_ref = torch.as_tensor(inp.x_ref, dtype=torch.float32)
    assert torch.equal(qp.cost.q, torch.tensor(cfg.q_diag) * (x - x_ref))
    if cone_mode == "pyramid":
        assert torch.equal(qp.cost.R, torch.diag_embed(
            torch.tensor(cfg.r_diag)).repeat(N, 1, 1))
    assert (qp.con is None) == (cone_mode == "soft")
    inactive = qp.eq.mask.expand(qp.eq.e.shape) == 0
    assert bool(inactive.any())
    assert bool((qp.eq.C[inactive] == 0).all())
    assert bool((qp.eq.D[inactive] == 0).all())
    assert bool((qp.eq.e[inactive] == 0).all())


class _StubLibrary:
    """Takes a launch like the kernels' library and records its arguments;
    computes nothing."""

    def __init__(self, num_params):
        self.calls = []
        self.num_params = num_params

    def cheeta_legged_linearize_num_params(self):
        return self.num_params

    def cheeta_legged_linearize(self, ins, strides, outs, dims, params,
                                stream):
        self.calls.append(dict(ins=list(ins[:9]), strides=list(strides[:9]),
                               outs=list(outs[:9]), dims=list(dims[:3]),
                               params=list(params[:self.num_params]),
                               stream=stream))
        return 0


def _stub(monkeypatch, cfg):
    """A stub library, and the wrapper's device scope and stream where
    PyTorch has no CUDA."""
    lib = _StubLibrary(len(_model(cfg)))
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=1234))
    return lib


def _model(cfg):
    return lm.l1_model(
        cfg, lm.FrictionConeConfig(friction_coefficient=cfg.friction_mu),
        lm.RelaxedBarrierConfig(mu=cfg.barrier_mu, delta=cfg.barrier_delta))


def _meta_call(monkeypatch, cfg, batch=2, event=False, integrator="rk2"):
    """What a solver on the ``meta`` device hands L1's wrapper on its first
    QP (the cold start), and the QP."""
    cfg = cfg._replace(params=cfg.params._replace(integrator=integrator))
    solve = lm.build_legged_solver(cfg, device="meta")
    inp = examples.make_legged_example_inputs(cfg, batch=batch,
                                              event_aligned=event)
    cap = {}

    def spy(*args, **kwargs):
        cap.update(args=args, kwargs=kwargs)
        return ll.legged_linearize(*args, **kwargs)

    monkeypatch.setattr(lm, "legged_linearize", spy)
    qp = solve.initial_qp(*inp.args, dts=inp.dts)
    return cap, qp


@pytest.mark.parametrize("cone_mode, event", MODES)
def test_launch_hands_the_kernel_its_arguments(cone_mode, event,
                                               monkeypatch):
    """A solver off the CPU launches L1 once per linearization with its
    inputs in the kernel's order and per-problem strides (0 for a
    reference shared by the batch, a broadcast view included), no dts on
    the uniform grid, dims (N, batch, RK2), the model's floats and the
    current stream; the outputs come in the batch's shape, with no R
    without the soft cone, where the QP carries the solver's shared R;
    the QP holds what the launch wrote."""
    cfg = _cfg(cone_mode)
    lib = _stub(monkeypatch, cfg)
    seen, wrote = [], []

    def record(named, dev, batch):
        seen.append([name for name, _, _ in named])
        return pointers(named, dev, batch)

    def launch(*args, **kwargs):
        wrote.append(ll.legged_linearize(*args, **kwargs))
        return wrote[-1]

    pointers = ll.tensor_pointers
    monkeypatch.setattr(ll, "tensor_pointers", record)
    monkeypatch.setattr(lm, "legged_linearize", launch)
    launches = ll.legged_linearize.launches
    inp = examples.make_legged_example_inputs(cfg, batch=3,
                                              event_aligned=event)
    solve = lm.build_legged_solver(cfg, device="meta")
    qp = solve.initial_qp(inp.x0, inp.x_ref[0], *inp.args[2:], dts=inp.dts)
    assert ll.legged_linearize.launches == launches + 1
    (call,), (out,) = lib.calls, wrote
    assert seen == [INPUT_NAMES if event else INPUT_NAMES[:-1]]
    assert call["strides"] == [(N + 1) * 24, N * 24, N * 4, N * 4, N * 4,
                               N * 16, 0, N * 24, N if event else 0]
    assert [tuple(t.shape) for t in out[:8]] == [
        (3, N, 24, 24), (3, N, 24, 24), (3, N, 24), (3, N, 16, 24),
        (3, N, 16, 24), (3, N, 16), (3, N + 1, 24), (3, N, 24)]
    assert all(t.device.type == "meta" for t in out[:8])
    assert [qp.dyn.A, qp.dyn.B, qp.dyn.b, qp.eq.C, qp.eq.D, qp.eq.e,
            qp.cost.q, qp.cost.r] == list(out[:8])
    if cone_mode == "soft":
        assert qp.cost.R is out.R and tuple(out.R.shape) == (3, N, 24, 24)
        assert qp.con is None
    else:
        assert out.R is None and tuple(qp.cost.R.shape) == (N, 24, 24)
        assert qp.con is not None
    assert tuple(qp.eq.mask.shape) == (3, N, 16)
    assert call["dims"] == [N, 3, 1]
    assert call["params"] == pytest.approx(_model(cfg), rel=1e-7)
    assert call["stream"] == 1234


@pytest.mark.parametrize("batch, integrator", [(None, "rk2"), (4, "euler"),
                                               (None, "euler")])
def test_launch_dims_follow_batch_and_integrator(batch, integrator,
                                                 monkeypatch):
    """``dims`` carries the batch (1 without a batch dimension) and RK2 or
    Euler as the model's ``integrator`` says."""
    cfg = _cfg("soft")
    lib = _stub(monkeypatch, cfg)
    _meta_call(monkeypatch, cfg, batch=batch, integrator=integrator)
    (call,) = lib.calls
    assert call["dims"] == [N, batch or 1, int(integrator == "rk2")]


def _meta_inputs(monkeypatch, cfg):
    cap, _ = _meta_call(monkeypatch, cfg)
    args = list(cap["args"])
    return args, cap["kwargs"]


@pytest.mark.parametrize("fault, exc, match", [
    ("float64", TypeError, "float32 only"),
    ("shape", ValueError, "has shape"),
    ("layout", ValueError, "not contiguous"),
    ("device", ValueError, "is on cpu"),
    ("cpu", ValueError, "tensors on the card"),
    ("batch_dims", NotImplementedError, "at most one batch dimension"),
    ("params", RuntimeError, "Model holds"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault, exc, match,
                                                       monkeypatch):
    """L1's wrapper takes the kernel or raises: float64, a wrong shape, a
    non-contiguous layout, one tensor on another device, tensors on the
    CPU, two batch dimensions, a parameter count the library does not
    build for. Nothing falls back to the plain version."""
    cfg = _cfg("soft")
    lib = _stub(monkeypatch, cfg)
    args, kwargs = _meta_inputs(monkeypatch, cfg)
    lib.calls.clear()
    tensors = [i for i, a in enumerate(args) if torch.is_tensor(a)]
    if fault == "float64":
        for i in tensors:
            args[i] = args[i].double()
    elif fault == "shape":
        args[1] = args[1][:, :-1].contiguous()
    elif fault == "layout":
        args[1] = args[1].transpose(-1, -2).contiguous().transpose(-1, -2)
    elif fault == "device":
        args[3] = torch.zeros(args[3].shape)
    elif fault == "cpu":
        for i in tensors:
            args[i] = torch.zeros(args[i].shape)
    elif fault == "batch_dims":
        args[0], args[1] = args[0][None], args[1][None]
    elif fault == "params":
        lib.num_params += 1
    launches = ll.legged_linearize.launches
    with pytest.raises(exc, match=match):
        ll.legged_linearize(*args, **kwargs)
    assert lib.calls == [] and ll.legged_linearize.launches == launches


def test_launches_count_one_per_kernel_launch(monkeypatch):
    """``legged_linearize.launches`` rises by one per launch, and the CPU
    solver's linearization launches nothing."""
    cfg = _cfg("soft")
    lib = _stub(monkeypatch, cfg)
    args, kwargs = _meta_inputs(monkeypatch, cfg)
    before = ll.legged_linearize.launches
    for i in range(3):
        ll.legged_linearize(*args, **kwargs)
        assert ll.legged_linearize.launches == before + i + 1
    assert len(lib.calls) == 4
    inp = examples.make_legged_example_inputs(cfg)
    lm.build_legged_solver(cfg, device="cpu").initial_qp(*inp.args)
    assert ll.legged_linearize.launches == before + 3 and len(lib.calls) == 4


@pytest.mark.parametrize("batch", [None, 3])
def test_strided_inputs_reach_the_kernel_dense(batch, monkeypatch):
    """Inputs that arrive as strided views (a (N, 4) table read off a
    (4, N) array, as a swing planner's grid may be) reach L1 as dense rows
    with the strides of contiguous inputs, so an eager solve on the card
    takes any numpy layout, as the CPU solve does."""
    cfg = _cfg("pyramid")
    lib = _stub(monkeypatch, cfg)
    solve = lm.build_legged_solver(cfg, device="meta")
    inp = examples.make_legged_example_inputs(cfg, batch=batch)

    def strided(a):
        a = np.asarray(a)
        return np.ascontiguousarray(np.swapaxes(a, -1, -2)).swapaxes(-1, -2)

    args = [strided(a) if np.asarray(a).ndim >= 2 else a for a in inp.args]
    assert not np.asarray(args[3]).flags["C_CONTIGUOUS"]
    solve.initial_qp(*args)
    solve.initial_qp(*inp.args)
    strided_call, dense_call = lib.calls
    assert strided_call["strides"] == dense_call["strides"]
