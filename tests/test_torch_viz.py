"""PyTorch port: viz/helpers.py and viz/render.py (numpy and matplotlib
copies) against the JAX package's (oracles ``tests/test_viz_observers.py``
and ``tests/test_viz_render.py``): the same centre of pressure, support
polygon, rate-limited captures and saved arrays, and PNGs rendered from a
visualizer and from a demo's ``*_traj.npz``. Tolerance 0: the same numpy
arithmetic on the same inputs.
"""

import os

import matplotlib.image as mpimg
import numpy as np
import pytest

from cheeta_mpc_tpu.viz import helpers as jh
from cheeta_mpc_tpu.viz import render as jr
from cheeta_mpc_tpu_torch.viz import helpers as th
from cheeta_mpc_tpu_torch.viz import render as tr

FEET = np.array([[0.3, 0.2, 0.0], [0.3, -0.2, 0.0],
                 [-0.3, 0.2, 0.0], [-0.3, -0.2, 0.0]])


def _loads(seed):
    rng = np.random.default_rng(seed)
    forces = rng.normal(size=(4, 3))
    forces[:, 2] = np.abs(forces[:, 2]) * 50.0
    forces[rng.uniform(size=4) < 0.3, 2] = 0.0
    return FEET + 0.05 * rng.normal(size=(4, 3)), forces


@pytest.mark.parametrize("seed", range(4))
def test_center_of_pressure_matches(seed):
    feet, forces = _loads(seed)
    assert np.array_equal(th.center_of_pressure(feet, forces),
                          jh.center_of_pressure(feet, forces))
    np.testing.assert_allclose(
        th.center_of_pressure(FEET, np.tile([0.0, 0.0, 10.0], (4, 1))),
        [0.0, 0.0, 0.0], atol=1e-12)
    assert np.array_equal(th.center_of_pressure(FEET, np.zeros((4, 3))),
                          FEET.mean(axis=0))


@pytest.mark.parametrize("flags", [(1, 1, 1, 1), (1, 0, 0, 1), (0, 0, 0, 0),
                                   (1, 1, 1, 0), (0, 1, 0, 0)])
def test_support_polygon_matches(flags):
    flags = np.asarray(flags, float)
    for feet in (FEET, _loads(7)[0]):
        a, b = th.support_polygon(feet, flags), jh.support_polygon(feet,
                                                                   flags)
        assert a.shape == b.shape and np.array_equal(a, b)
    inner = FEET.copy()
    inner[3] = 0.0  # strictly inside the other three: dropped
    assert th.support_polygon(inner, np.ones(4)).shape == (3, 3)


def _capture(mod, n=25):
    """The oracle's capture, made with ``mod``'s visualizer."""
    viz = mod.LeggedVisualizer(max_update_frequency=1e9)
    rng = np.random.default_rng(0)
    feet0 = np.array([[0.35, 0.25, 0.0], [0.35, -0.25, 0.0],
                      [-0.35, -0.25, 0.0], [-0.35, 0.25, 0.0]])
    for k in range(n):
        t = 0.02 * k
        state = np.zeros(24)
        state[6] = 0.25 * t
        state[8] = 0.3 + 0.002 * np.sin(8 * t)
        state[10] = 0.01 * np.sin(5 * t)
        state[11] = 0.01 * np.cos(5 * t)
        feet = feet0 + np.array([0.25 * t, 0.0, 0.0])
        flags = np.array([1.0, k % 2, 1.0, (k + 1) % 2])
        forces = np.zeros((4, 3))
        forces[:, 2] = flags * (80.0 + rng.normal(0, 2, 4))
        viz.update(t, state, feet, forces, flags,
                   desired_com=np.array([0.25 * t, 0.0, 0.3]))
    return viz


def test_visualizer_rate_limit_and_save_match(tmp_path):
    saved = {}
    for name, mod in (("torch", th), ("jax", jh)):
        viz = mod.LeggedVisualizer(max_update_frequency=100.0)
        x, f = np.zeros(24), np.zeros((4, 3))
        got = [viz.update(0.000, x, FEET, f, np.ones(4)),
               viz.update(0.005, x, FEET, f, np.ones(4)),  # < 10 ms later
               viz.update(0.012, x, FEET, f, np.array([1.0, 0, 0, 1.0]))]
        assert got == [True, False, True] and len(viz.frames) == 2
        path = str(tmp_path / f"{name}.npz")
        viz.save(path)
        saved[name] = dict(np.load(path))
    assert list(saved["torch"]) == list(saved["jax"])
    for k in saved["jax"]:
        assert np.array_equal(saved["torch"][k], saved["jax"][k],
                              equal_nan=True), k
    assert saved["torch"]["polygon"].shape[0] == 2
    full = {}
    for name, mod in (("torch", th), ("jax", jh)):
        path = str(tmp_path / f"full_{name}.npz")
        _capture(mod).save(path)
        full[name] = dict(np.load(path))
    for k in full["jax"]:
        assert np.array_equal(full["torch"][k], full["jax"][k],
                              equal_nan=True), k


def test_render_from_visualizer(tmp_path):
    out = str(tmp_path / "run.png")
    manifest = tr.render_run(_capture(th), out, title="test run")
    img = mpimg.imread(out)
    assert img.ndim == 3 and img.shape[0] > 400 and img.shape[1] > 600
    assert manifest == jr.render_run(_capture(jh),
                                     str(tmp_path / "jax.png"),
                                     title="test run")
    flat = [s for series in manifest.values() for s in series]
    for expected in ("foot path LF", "foot path LH", "CoM path", "CoP path",
                     "support polygon", "desired CoM path", "Fz RF",
                     "base z", "pitch", "roll"):
        assert expected in flat, (expected, flat)


def test_render_from_demo_npz(tmp_path):
    """The legged_demo ``*_traj.npz`` format (no contact flags or CoP in
    the file) renders too: flags from the forces, CoP computed."""
    viz = _capture(th, 10)
    npz = str(tmp_path / "traj.npz")
    np.savez(npz,
             times=np.array([f.time for f in viz.frames]),
             states=np.stack([f.state for f in viz.frames]),
             feet=np.stack([f.feet for f in viz.frames]),
             forces=np.stack([f.forces for f in viz.frames]))
    out = str(tmp_path / "demo.png")
    manifest = tr.render_run(npz, out)
    assert manifest == jr.render_run(npz, str(tmp_path / "jax.png"))
    assert "forces" in manifest and "topdown" in manifest
    assert os.path.getsize(out) > 20_000  # a real, non-blank figure
