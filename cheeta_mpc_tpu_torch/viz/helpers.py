"""Visualization data products: CoP, support polygon, trajectory capture.

A copy of ``cheeta_mpc_tpu/viz/helpers.py`` (numpy only).

The capability layer of the reference's visualization stack
(`ocs2_ros_interfaces/src/visualization/VisualizationHelpers.cpp:34-151`
marker factories + `ocs2_legged_robot_ros/src/visualization/
LeggedRobotVisualizer.cpp:75-369`, which publishes feet/force/CoP/support-
polygon/desired-vs-optimized markers to rviz). Without ROS, the deliverable
is the *data*: this module computes the same quantities and the
:class:`LeggedVisualizer` observer captures them per policy update into
arrays + an .npz export that any plotting frontend can consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def center_of_pressure(foot_positions: np.ndarray,
                       forces: np.ndarray) -> np.ndarray:
    """CoP = sum(p_i * Fz_i) / sum(Fz_i) (reference LeggedRobotVisualizer
    CoP marker). foot_positions, forces: (num_feet, 3). Returns (3,); the
    mean foot position when no vertical load."""
    fz = np.maximum(np.asarray(forces)[:, 2], 0.0)
    total = fz.sum()
    p = np.asarray(foot_positions)
    if total <= 1e-9:
        return p.mean(axis=0)
    return (p * fz[:, None]).sum(axis=0) / total


def support_polygon(foot_positions: np.ndarray,
                    contact_flags: np.ndarray) -> np.ndarray:
    """Ordered xy convex hull of the stance feet (reference support-polygon
    line-strip marker, VisualizationHelpers.cpp). Returns (k, 3) vertices in
    counter-clockwise order (k = number of stance feet on the hull; empty
    array in flight phase)."""
    p = np.asarray(foot_positions)
    flags = np.asarray(contact_flags) > 0
    pts = p[flags]
    if len(pts) == 0:
        return np.zeros((0, 3))
    if len(pts) <= 2:
        return pts
    # 2D gift wrapping on xy (at most 4 points for a quadruped).
    center = pts[:, :2].mean(axis=0)
    ang = np.arctan2(pts[:, 1] - center[1], pts[:, 0] - center[0])
    order = np.argsort(ang)
    pts = pts[order]
    # Drop interior points (a point inside the triangle of the others).
    keep = []
    n = len(pts)
    for i in range(n):
        others = np.delete(np.arange(n), i)
        a, b = pts[others[0], :2], pts[others[1], :2]
        inside = False
        if n == 4:
            c = pts[others[2], :2]
            q = pts[i, :2]

            def cross2(u, v):
                return u[0] * v[1] - u[1] * v[0]

            s1 = cross2(b - a, q - a)
            s2 = cross2(c - b, q - b)
            s3 = cross2(a - c, q - c)
            inside = (s1 >= 0 and s2 >= 0 and s3 >= 0) or (
                s1 <= 0 and s2 <= 0 and s3 <= 0)
        if not inside:
            keep.append(i)
    return pts[keep]


@dataclass
class VisFrame:
    """One captured frame (what one rviz update would have drawn)."""

    time: float
    state: np.ndarray  # (24,)
    feet: np.ndarray  # (4, 3) world foot positions
    forces: np.ndarray  # (4, 3) contact forces
    contact_flags: np.ndarray  # (4,)
    cop: np.ndarray  # (3,)
    polygon: np.ndarray  # (k, 3) support polygon vertices
    desired_com: Optional[np.ndarray] = None  # (3,)
    optimized_com: Optional[np.ndarray] = None  # (3,) from the policy


@dataclass
class LeggedVisualizer:
    """Observer capturing visualization frames, rate-limited like the
    reference (`maxUpdateFrequency` 100 Hz,
    LeggedRobotVisualizer.cpp:75-101)."""

    max_update_frequency: float = 100.0
    frames: List[VisFrame] = field(default_factory=list)
    _last_time: float = -np.inf

    def update(self, time: float, state: np.ndarray, feet: np.ndarray,
               forces: np.ndarray, contact_flags: np.ndarray,
               desired_com: Optional[np.ndarray] = None,
               optimized_com: Optional[np.ndarray] = None) -> bool:
        """Capture a frame unless rate-limited. Returns True if captured."""
        if time - self._last_time < 1.0 / self.max_update_frequency - 1e-9:
            return False
        self._last_time = time
        self.frames.append(VisFrame(
            time=float(time), state=np.asarray(state, np.float64).copy(),
            feet=np.asarray(feet, np.float64).copy(),
            forces=np.asarray(forces, np.float64).copy(),
            contact_flags=np.asarray(contact_flags, np.float64).copy(),
            cop=center_of_pressure(feet, forces),
            polygon=support_polygon(feet, contact_flags),
            desired_com=None if desired_com is None else np.asarray(
                desired_com, np.float64).copy(),
            optimized_com=None if optimized_com is None else np.asarray(
                optimized_com, np.float64).copy()))
        return True

    def save(self, path: str) -> None:
        """Export all frames to .npz (ragged polygon padded with NaN)."""
        if not self.frames:
            np.savez(path)
            return
        kmax = max(len(f.polygon) for f in self.frames)
        poly = np.full((len(self.frames), max(kmax, 1), 3), np.nan)
        for i, f in enumerate(self.frames):
            if len(f.polygon):
                poly[i, :len(f.polygon)] = f.polygon
        np.savez(
            path,
            times=np.array([f.time for f in self.frames]),
            states=np.stack([f.state for f in self.frames]),
            feet=np.stack([f.feet for f in self.frames]),
            forces=np.stack([f.forces for f in self.frames]),
            contact_flags=np.stack([f.contact_flags for f in self.frames]),
            cop=np.stack([f.cop for f in self.frames]),
            polygon=poly)
