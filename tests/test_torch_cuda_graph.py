"""PyTorch port: the host side of utils/cuda_graph.py, which holds no CUDA
call: the call signature a graph is keyed on, the packing of a result nest
into one buffer per dtype and back, the staging of host inputs (Python
floats included) and the bound on captures per callable.
The capture and replay themselves need a card: ``chip_smoke.py`` phases
``graph_vs_eager``, ``closed_loop`` and ``legged_node`` hold every graphed
path against its eager run there."""

import numpy as np
import pytest
import torch

from cheeta_mpc_tpu_torch.core.types import PerformanceIndex
from cheeta_mpc_tpu_torch.mpc.centroidal_mpc import CentroidalSolution
from cheeta_mpc_tpu_torch.mpc.legged_mpc import LeggedSolution
from cheeta_mpc_tpu_torch.utils import cuda_graph as cg


def _nest(rng):
    t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
    z = lambda: t()
    perf = PerformanceIndex(z(), z(), z(), z(), z())
    legged = LeggedSolution(t(3, 2), t(2, 2), t(2, 4, 3), t(2, 1), t(2, 2, 2),
                            z(), z(), t(3, 2, 2), t(3, 2), perf,
                            torch.tensor(3, dtype=torch.int32), t(1))
    cent = CentroidalSolution(*(t(2, 3) for _ in range(7)), z(), z(),
                              t(1, 2, 2), t(2, 2, 2), t(2, 2), perf,
                              torch.tensor(1, dtype=torch.int32), t(2),
                              torch.zeros(2, dtype=torch.int32))
    return {"legged": legged, "loop": (t(4, 33), t(4, 4, 3)), "cent": cent,
            "none": None, "n": 7}


def test_packed_result_round_trips_every_leaf():
    """A result nest -> one flat buffer per dtype -> the same nest of views
    (types, shapes, dtypes and values); views of a copy share nothing with
    the packed buffers."""
    nest = _nest(np.random.default_rng(0))
    leaves = []
    struct = cg._flatten(nest, leaves)
    layout = cg._Layout([(tuple(x.shape), x.dtype) for x in leaves])
    packed = layout.pack(leaves)
    assert sorted(map(str, packed)) == ["torch.float32", "torch.int32"]
    fresh = {d: b.clone() for d, b in packed.items()}
    back = cg._unflatten(struct, layout.views(fresh))
    assert type(back["legged"]) is LeggedSolution
    assert type(back["cent"]) is CentroidalSolution
    assert type(back["legged"].performance) is PerformanceIndex
    assert back["none"] is None and back["n"] == 7
    again = []
    cg._flatten(back, again)
    assert len(again) == len(leaves)
    for a, b in zip(again, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    packed[torch.float32].zero_()
    assert torch.equal(back["loop"][0], nest["loop"][0])


def test_signature_keys_on_shapes_dtypes_and_given_keywords():
    """What jit keys its cache on: array shapes and dtypes, other values,
    and which keyword arguments are given (None = not given)."""
    def key(*args, **kwargs):
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        leaves = []
        struct = cg._flatten((args, kwargs), leaves)
        return struct, tuple(cg._leaf_signature(a) for a in leaves)

    a, b = np.zeros((3, 2)), np.ones((3, 2))
    assert key(a) == key(b) == key(torch.zeros(3, 2, dtype=torch.float64))
    assert key(a) != key(a.astype(np.float32))
    assert key(a) != key(np.zeros((4, 2)))
    assert key(a, warm=None) == key(a)
    assert key(a, warm=(a, a)) != key(a)
    assert key(a, dts=a) != key(a, warm=a)
    assert key(a, 2) != key(a, 3)
    # A Python float is staged as a 0-d input, as jax.jit traces it: its
    # value is not part of the signature (a float that changes per call
    # must not capture a graph per call), its type is.
    assert key(a, 2.0) == key(a, 3.0)
    assert key(a, 2.0) != key(a, 2)
    hash(key(a, warm=(a, b), dts=a))


def test_numpy_signature_is_read_without_a_copy():
    """A numpy leaf's signature, read off the array, is the shape and dtype
    of the tensor that its dense copy makes, at any layout and dtype."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((4, 6))
    arrays = [base, base.T, base[:, ::2], base[1], np.array(1.5),
              np.zeros((0, 3)), base.astype(np.float32).T,
              np.arange(6, dtype=np.int64).reshape(2, 3)[:, ::-1],
              np.arange(5, dtype=np.int32), base > 0, np.uint8([1, 2])]
    for a in arrays:
        dense = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
        assert cg._leaf_signature(a) == (tuple(dense.shape), dense.dtype)


def test_host_inputs_stage_into_one_buffer_per_dtype():
    """Host inputs of any memory layout (transposed, strided, reversed, CPU
    tensors) staged into the views of one staging buffer per dtype arrive
    whole, each in its own slot, and the buffer holds them in slot order."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((4, 6))
    inputs = [base.T, base[:, ::2], np.arange(5, dtype=np.int32),
              torch.as_tensor(rng.standard_normal((2, 3))).t(),
              np.array(rng.standard_normal()), base[::-1, 1:4]]
    layout = cg._Layout([cg._leaf_signature(a) for a in inputs])
    buffers = layout.buffers()
    assert {d: b.numel() for d, b in buffers.items()} == {
        torch.float64: 24 + 12 + 6 + 1 + 12, torch.int32: 5}
    for src, dst in zip(inputs, layout.views(buffers)):
        cg._stage(src, dst)
    for src, view in zip(inputs, layout.views(buffers)):
        assert torch.equal(view, torch.as_tensor(np.array(src)))
    assert torch.equal(buffers[torch.float64][:24],
                       torch.as_tensor(base.T.reshape(-1)))


def test_python_floats_share_a_signature_and_each_call_uses_its_value():
    """Two calls that differ only in a float have one signature; staged
    through the same static input, each computes with its own value."""
    def fn(x, scale, n):
        return x * scale + n

    x = np.arange(3.0)
    key1, leaves1 = cg._signature((x, 0.5, 2), {})
    key2, leaves2 = cg._signature((x, 4.0, 2), {})
    assert key1 == key2
    struct = key1[0]
    layout = cg._Layout(list(key1[1]))
    static = layout.views(layout.buffers())
    assert static[1].shape == () and static[1].dtype == torch.float64
    for leaves, scale in ((leaves1, 0.5), (leaves2, 4.0)):
        for src, dst in zip(leaves, static):
            cg._stage(src, dst)
        args, kwargs = cg._unflatten(struct, static)
        assert args[2] == 2 and kwargs == {}  # the int stays a value
        out = fn(*args, **kwargs)
        assert torch.equal(out, torch.as_tensor(x * scale + 2))
    # np.float64 is a float and is staged too; a bool or None is not.
    sig = cg._signature
    assert sig((x, np.float64(1.5), 2), {})[0] == key1
    assert sig((x, True), {})[0] != sig((x, False), {})[0]


def test_captures_are_bounded_and_the_error_names_what_changes():
    """Past MAX_CAPTURES signatures a graphed callable raises, naming the
    argument whose value keeps changing, instead of capturing one graph
    (and one private memory pool) per call."""
    x = np.zeros((3, 2))
    graphs = {}
    for n in range(cg.MAX_CAPTURES):
        key = cg._signature((x, n), {"warm": (x, x)})[0]
        cg._check_capture_bound(graphs, key, "solve")
        graphs[key] = None
    with pytest.raises(cg.RecaptureError,
                       match=r"solve: .*bound of 16 .*args\[1\]: value 15 "
                             r"-> value 99"):
        cg._check_capture_bound(
            graphs, cg._signature((x, 99), {"warm": (x, x)})[0], "solve")
    with pytest.raises(cg.RecaptureError,
                       match=r"kwargs\['warm'\]\[1\]: array of shape "
                             r"\(3, 2\), torch.float64 -> array of shape "
                             r"\(4, 2\)"):
        cg._check_capture_bound(
            graphs,
            cg._signature((x, 15), {"warm": (x, np.zeros((4, 2)))})[0],
            "solve")
    # A signature already captured is never looked at here; a float that
    # changes does not make new signatures at all.
    assert len({cg._signature((x, 0.1 * n), {})[0] for n in range(50)}) == 1
