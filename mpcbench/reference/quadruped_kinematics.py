"""Analytic quadruped kinematics, batched torch.

Counterpart of ``cheeta_mpc_tpu/models/quadruped_kinematics.py``: closed-form
forward kinematics of a generic 3-DoF-per-leg quadruped (HAA/HFE/KFE — hip
abduction, hip flexion, knee flexion), ANYmal-C-like link parameters by
default. Where the JAX package gets foot velocities and Jacobians from
``jax.jvp`` / ``jax.jacfwd`` over the FK chain, the port writes them out:
``d/dt (R p) = omega x (R p)`` with ``omega = E(eul) eul_dot``, and the 3x3
leg Jacobian of :func:`foot_position_body`. Every function takes tensors
with any leading dimensions (``...``).

No function builds a tensor from Python numbers per call (that is a copy
from the host, which waits for the device): constants are made once per
(dtype, device) and rotation matrices are stacked from their entries.

Conventions (the reference's task.info state layout):
- Base pose: position p (world) + euler angles (z-y-x yaw/pitch/roll).
- Leg order [LF, LH, RF, RH] for the *joint vector*, mapped onto contact
  order [LF, RF, LH, RH] for feet and forces.
- Each leg: q = (HAA, HFE, KFE). HAA rotates about x (abduction), HFE and
  KFE about y (flexion) in the leg frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# contact leg [LF, RF, LH, RH] -> block of the joint vector [LF, LH, RF, RH]
JOINT_SLOT = (0, 2, 1, 3)

_CONSTS: dict = {}


def const_tensor(values, like: torch.Tensor) -> torch.Tensor:
    """A constant tensor of ``like``'s dtype and device, made once.

    It is made outside any ``torch.func`` transform that may be running:
    inside ``grad`` or ``jacfwd`` a new tensor is wrapped for that
    transform's level, and a cached wrapper would leak into later calls
    (the DDP solver takes Hessians of the kinematics by ``jacfwd`` over
    ``grad``)."""
    key = (values, like.dtype, like.device)
    out = _CONSTS.get(key)
    if out is None:
        with torch._C._DisableFuncTorch():
            out = torch.tensor(values, dtype=like.dtype, device=like.device)
        _CONSTS[key] = out
    return out


class QuadrupedDescription(NamedTuple):
    """Geometry + inertial description (ANYmal-C-like defaults)."""

    # hip (HAA axis) offsets from base center, per leg [LF, RF, LH, RH]:
    hip_offsets: tuple = ((0.3, 0.1, 0.0), (0.3, -0.1, 0.0),
                          (-0.3, 0.1, 0.0), (-0.3, -0.1, 0.0))
    # lateral offset from HAA to the leg (thigh) plane, signed per side
    hip_length: float = 0.1
    thigh_length: float = 0.285
    shank_length: float = 0.33
    mass: float = 30.0  # total SRBD mass
    inertia: tuple = (0.88, 1.85, 1.97)  # SRBD body-frame diagonal inertia
    com_offset: tuple = (0.0, 0.0, 0.0)  # CoM offset from base origin (body)

    @property
    def num_legs(self) -> int:
        return 4


def _mat3(rows) -> torch.Tensor:
    """(..., 3, 3) from three rows of three (...)-shaped entries."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., m, n) x (..., n) -> (..., m), elementwise (no library GEMM)."""
    return torch.sum(M * v[..., None, :], dim=-1)


def matvec_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., m, n)' x (..., m) -> (..., n)."""
    return torch.sum(M * v[..., :, None], dim=-2)


def euler_zyx_to_rot(eul: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll); eul = (..., 3) = (yaw, pitch, roll)."""
    z, y, x = eul[..., 0], eul[..., 1], eul[..., 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    return _mat3([
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx]])


def euler_zyx_rate_matrix(eul: torch.Tensor) -> torch.Tensor:
    """E(eul) with omega_world = E @ eul_dot for z-y-x euler angles."""
    z, y = eul[..., 0], eul[..., 1]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    return _mat3([[zero, -sz, cz * cy],
                  [zero, cz, sz * cy],
                  [one, zero, -sy]])


def euler_zyx_rate_matrix_inv(eul: torch.Tensor) -> torch.Tensor:
    """E^{-1}(eul): eul_dot = E^{-1} omega_world (singular at pitch +-pi/2)."""
    z, y = eul[..., 0], eul[..., 1]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    ty = sy / cy
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    return _mat3([[cz * ty, sz * ty, one],
                  [-sz, cz, zero],
                  [cz / cy, sz / cy, zero]])


def _leg_side_sign(leg: int) -> float:
    """+1 for left legs (LF=0, LH=2), -1 for right (RF=1, RH=3)."""
    return 1.0 if leg in (0, 2) else -1.0


def _leg_chain(desc: QuadrupedDescription, side, q_leg: torch.Tensor):
    """Foot position relative to the hip and its Jacobian columns for legs
    with joint angles ``q_leg = (..., 3)`` and side sign ``side`` (a float
    or a tensor broadcasting against ``q_leg[..., 0]``).
    Returns ``(p, (dp/dhaa, dp/dhfe, dp/dkfe))``, each (..., 3)."""
    haa, hfe, kfe = q_leg[..., 0], q_leg[..., 1], q_leg[..., 2]
    lt, ls = desc.thigh_length, desc.shank_length
    s1, c1 = torch.sin(hfe), torch.cos(hfe)
    s12, c12 = torch.sin(hfe + kfe), torch.cos(hfe + kfe)
    # In the leg sagittal plane (after HAA rotation about x): thigh at angle
    # hfe from vertical, shank at hfe + kfe.
    px = -(lt * s1 + ls * s12)
    pz_plane = -(lt * c1 + ls * c12)
    py_leg = side * desc.hip_length
    # HAA rotation about x maps the (y, z) leg-plane coordinates.
    ca, sa = torch.cos(haa), torch.sin(haa)
    py = ca * py_leg - sa * pz_plane
    pz = sa * py_leg + ca * pz_plane
    p = torch.stack([px, py, pz], dim=-1)
    dpz_k = ls * s12  # d pz_plane / d kfe
    zero = torch.zeros_like(px)
    d_haa = torch.stack([zero, -pz, py], dim=-1)
    d_hfe = torch.stack([pz_plane, sa * px, -ca * px], dim=-1)
    d_kfe = torch.stack([-ls * c12, -sa * dpz_k, ca * dpz_k], dim=-1)
    return p, (d_haa, d_hfe, d_kfe)


def foot_position_body(desc: QuadrupedDescription, leg: int,
                       q_leg: torch.Tensor) -> torch.Tensor:
    """Foot position in the base frame for one leg (contact order index
    ``leg``). q_leg = (..., 3) = (HAA, HFE, KFE)."""
    p, _ = _leg_chain(desc, _leg_side_sign(leg), q_leg)
    return const_tensor(desc.hip_offsets[leg], q_leg) + p


def _legs_in_contact_order(q_joints: torch.Tensor) -> torch.Tensor:
    """(..., 12) in joint order [LF, LH, RF, RH] -> (..., 4, 3) in contact
    order [LF, RF, LH, RH] (static slices, no index tensor)."""
    return torch.stack([q_joints[..., 3 * s:3 * s + 3] for s in JOINT_SLOT],
                       dim=-2)


def _feet_body(desc: QuadrupedDescription, q_joints: torch.Tensor):
    """All four feet in the base frame, (..., 4, 3), and the leg Jacobian
    columns, contact order."""
    q = _legs_in_contact_order(q_joints)
    side = const_tensor((1.0, -1.0, 1.0, -1.0), q_joints)
    p, cols = _leg_chain(desc, side, q)
    return const_tensor(desc.hip_offsets, q_joints) + p, cols


def _rotate(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) applied to each of (..., L, 3)."""
    return torch.sum(R[..., None, :, :] * p[..., :, None, :], dim=-1)


def foot_positions_world(desc: QuadrupedDescription, base_pos, base_eul,
                         q_joints) -> torch.Tensor:
    """(..., 4, 3) world foot positions.

    q_joints: (..., 12) in leg order [LF, LH, RF, RH] x (HAA, HFE, KFE).
    Returned rows are in contact order [LF, RF, LH, RH].
    """
    R = euler_zyx_to_rot(base_eul)
    p_body, _ = _feet_body(desc, q_joints)
    return base_pos[..., None, :] + _rotate(R, p_body)


def foot_velocities_world(desc: QuadrupedDescription, base_pos, base_eul,
                          q_joints, base_lin_vel, eul_rate,
                          qd_joints) -> torch.Tensor:
    """(..., 4, 3) world foot velocities: the time derivative of the FK
    chain, ``v_base + omega x (R p_body) + R J_leg qd_leg``."""
    del base_pos  # the velocity does not depend on it
    R = euler_zyx_to_rot(base_eul)
    p_body, (d_haa, d_hfe, d_kfe) = _feet_body(desc, q_joints)
    qd = _legs_in_contact_order(qd_joints)
    v_body = (d_haa * qd[..., 0:1] + d_hfe * qd[..., 1:2]
              + d_kfe * qd[..., 2:3])
    omega = matvec(euler_zyx_rate_matrix(base_eul), eul_rate)
    arm = _rotate(R, p_body)
    spin = torch.linalg.cross(omega[..., None, :].expand(arm.shape), arm,
                              dim=-1)
    return base_lin_vel[..., None, :] + spin + _rotate(R, v_body)


def foot_jacobians(desc: QuadrupedDescription, base_pos, base_eul, q_joints):
    """d foot_pos / d (base_pos(3), base_eul(3), q_joints(12)):
    (..., 4, 3, 18)."""
    R = euler_zyx_to_rot(base_eul)
    p_body, cols = _feet_body(desc, q_joints)
    arm = _rotate(R, p_body)  # (..., 4, 3)
    E = euler_zyx_rate_matrix(base_eul)
    # d(R p)/d eul_i = E[:, i] x (R p)
    d_eul = torch.stack([
        torch.linalg.cross(E[..., None, :, i].expand(arm.shape), arm, dim=-1)
        for i in range(3)], dim=-1)  # (..., 4, 3, 3)
    d_q = torch.stack([_rotate(R, c) for c in cols], dim=-1)  # (..., 4, 3, 3)
    eye = const_tensor(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                       q_joints)
    d_pos = (eye + torch.zeros_like(d_eul[..., 0, :, :]))
    zero = torch.zeros_like(d_pos)
    legs = []
    for leg in range(4):
        blocks = [zero] * 4
        blocks[JOINT_SLOT[leg]] = d_q[..., leg, :, :]
        legs.append(torch.cat([d_pos, d_eul[..., leg, :, :]] + blocks,
                              dim=-1))
    return torch.stack(legs, dim=-3)
