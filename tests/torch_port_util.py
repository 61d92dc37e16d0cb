"""JAX-side half of the exchange between the JAX package and its PyTorch
port (the port-side half is ``cheeta_mpc_tpu_torch/convert.py``): pytrees of
the JAX package -> nested dicts of numpy arrays, and comparison helpers.
Only tests may import both packages, so this lives with the tests.
"""

import dataclasses

import numpy as np
import torch

from cheeta_mpc_tpu_torch.convert import (qp_data_from_numpy,
                                          solution_to_numpy)


def qp_data_to_numpy(data) -> dict:
    """A JAX ``OcpQpData`` -> the dict ``convert.qp_data_from_numpy`` takes."""
    d = {k: np.asarray(v) for k, v in (
        ("A", data.dyn.A), ("B", data.dyn.B), ("b", data.dyn.b),
        ("Q", data.cost.Q), ("q", data.cost.q), ("R", data.cost.R),
        ("r", data.cost.r), ("S", data.cost.S), ("dx0", data.dx0))}
    if data.con is not None:
        d.update({k: np.asarray(getattr(data.con, k))
                  for k in ("C", "D", "lg", "ug", "mask")})
    if data.eq is not None:
        d["eq"] = {k: np.asarray(getattr(data.eq, k))
                   for k in ("C", "D", "e", "mask")}
    return d


def qp_data_to_torch(data, dtype=None):
    """A JAX ``OcpQpData`` -> the port's, on the CPU."""
    return qp_data_from_numpy(qp_data_to_numpy(data), dtype=dtype,
                              device="cpu")


def tree_to_numpy(tree):
    """Any pytree of the JAX package (flax dataclass, NamedTuple, array) ->
    nested dicts of numpy arrays."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return {f.name: tree_to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if hasattr(tree, "_asdict"):
        return {k: tree_to_numpy(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_err(a, b) -> float:
    a, b = np.broadcast_arrays(to_np(a), to_np(b))
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def assert_close(port, ref, atol, rtol=0.0, what=""):
    """Port tensor vs JAX array, shapes included (after broadcasting the
    port's batch-shared leaves)."""
    p, r = to_np(port), np.asarray(ref)
    assert np.broadcast_shapes(p.shape, r.shape) == r.shape, (
        what, p.shape, r.shape)
    np.testing.assert_allclose(np.broadcast_to(p, r.shape), r, atol=atol,
                               rtol=rtol, err_msg=what)


def assert_qp_data_close(port_data, jax_data, atol, what=""):
    """Every leaf of two OCP-QPs."""
    p = solution_to_numpy(port_data)
    j = tree_to_numpy(jax_data)

    def walk(a, b, path):
        if b is None:
            assert a is None, path
            return
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
            return
        assert_close(a, b, atol=atol, what=f"{what}{path}")

    walk(p, j, "")


def jax_centroidal_solve(cfg, scp, inputs, warm=None, batched=False):
    """Run the JAX package's centroidal solver and also hand out what its
    public result hides: the ``ScpResult`` (line-search steps and types) and
    the OCP-QP of the first SQP iteration. Done by wrapping the solver's
    reference to ``solve_nonlinear_ocp`` for the duration of the call; with
    ``batched`` the solve runs under ``jax.vmap`` over the leading axis of
    ``inputs`` (and of ``warm``).

    Returns ``(solution, step_size, step_type, first_qp)`` as JAX pytrees.
    """
    import jax
    import jax.numpy as jnp
    from cheeta_mpc_tpu.mpc import centroidal_mpc as jm

    real = jm.solve_nonlinear_ocp

    def run(state, des_state, des_inputs, *warm_args):
        seen = {}

        def spy(linearize, performance, x_init, u_init, settings):
            seen["qp"] = linearize(x_init, u_init)
            seen["res"] = real(linearize=linearize, performance=performance,
                               x_init=x_init, u_init=u_init,
                               settings=settings)
            return seen["res"]

        jm.solve_nonlinear_ocp = spy
        try:
            sol = jm.build_centroidal_solver(cfg, scp)(
                state, des_state, des_inputs, warm=warm_args or None)
        finally:
            jm.solve_nonlinear_ocp = real
        info = seen["res"].step_info
        return sol, info.step_size, info.step_type, seen["qp"]

    args = tuple(jnp.asarray(a, cfg.dtype) for a in inputs)
    if warm is not None:
        args += tuple(jnp.asarray(a, cfg.dtype) for a in warm)
    return (jax.vmap(run) if batched else run)(*args)
