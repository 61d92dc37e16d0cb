"""Single-rigid-body (SRB) model of the convex quadruped MPC, plain torch: a
frozen copy of the port's ``models/srb.py``.

The "ConvexMPC" formulation (BASELINE.json config 2; Di Carlo et al., IROS
2018): rigid-body rotational and translational dynamics linearized about
the commanded yaw, with the ground-reaction forces as the only inputs.

State (nx = 13):  [rpy(3), p(3), omega_world(3), v(3), g_const]
Input (nu = 3*num_legs): per-leg ground reaction forces (world frame).
The gravity constant is folded into the state, so the dynamics are strictly
linear: x_{k+1} = A_k x_k + B_k u_k. :func:`srb_discrete_dynamics` takes
any leading dimensions (the stage axis, and a scenario batch before it);
the world inertia is inverted in closed form (``Rz diag(1/I) Rz'``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

GRAVITY = 9.81


class SrbParams(NamedTuple):
    """The JAX package's ``SrbParams``."""

    mass: float
    inertia: tuple  # body-frame diagonal inertia (Ixx, Iyy, Izz)
    num_legs: int = 4
    mu: float = 0.4
    fz_min: float = 0.0
    fz_max: float = 500.0

    @property
    def nx(self) -> int:
        return 13

    @property
    def nu(self) -> int:
        return 3 * self.num_legs


def rotz(yaw: torch.Tensor) -> torch.Tensor:
    """(...,) yaw -> (..., 3, 3) rotations about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([torch.stack([c, -s, z], dim=-1),
                        torch.stack([s, c, z], dim=-1),
                        torch.stack([z, z, o], dim=-1)], dim=-2)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1)], dim=-2)


def _leg_columns(blocks: torch.Tensor) -> torch.Tensor:
    """(..., nl, 3, 3) per-leg blocks -> (..., 3, 3*nl), leg i in columns
    3i..3i+2."""
    nl = blocks.shape[-3]
    return torch.movedim(blocks, -3, -2).reshape(
        blocks.shape[:-3] + (3, 3 * nl))


def srb_discrete_dynamics(params: SrbParams, yaw, com_pos, foot_pos, enable,
                          dt, dtype=torch.float32):
    """(A, B) of one Euler step linearized about the commanded yaw.

    Args (tensors or arrays; leading dimensions broadcast against each
    other, and tensors keep their device):
        yaw: (...,) commanded yaw of the linearization.
        com_pos: (..., 3) CoM position (for foot moment arms).
        foot_pos: (..., num_legs, 3) world foot positions.
        enable: (..., num_legs) contact flags.
    Returns:
        A: (..., 13, 13), B: (..., 13, nu).
    """
    yaw = torch.as_tensor(yaw, dtype=dtype)
    dev = yaw.device

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    com_pos, foot_pos, enable = t(com_pos), t(foot_pos), t(enable)
    lead = torch.broadcast_shapes(yaw.shape, com_pos.shape[:-1],
                                  foot_pos.shape[:-2], enable.shape[:-1])
    kw = dict(dtype=dtype, device=dev)
    Rz = rotz(yaw)
    Rz_t = Rz.transpose(-1, -2)
    # I_world = Rz diag(I) Rz', so its inverse is Rz diag(1/I) Rz'. The
    # entries are filled on the device: a tensor made from host numbers is
    # a copy the host waits for, and one a CUDA graph cannot capture.
    inv_i = torch.empty(3, **kw)
    for i, inertia in enumerate(params.inertia):
        inv_i[i:i + 1].fill_(1.0 / inertia)
    I_world_inv = (Rz * inv_i) @ Rz_t

    A = torch.eye(13, **kw).repeat(lead + (1, 1))
    # rpy_dot ~= Rz(yaw)' omega_world (small roll/pitch approximation)
    A[..., 0:3, 6:9] = Rz_t * dt
    # p_dot = v
    A[..., 3:6, 9:12] = torch.eye(3, **kw) * dt
    # v_dot includes -g via the constant-state column: v_z += -g*dt * 1
    A[..., 11, 12] = -GRAVITY * dt

    e = enable[..., :, None, None]  # (..., nl, 1, 1)
    r = foot_pos - com_pos[..., None, :]  # (..., nl, 3)
    rot = e * (I_world_inv[..., None, :, :] @ _skew(r)) * dt
    lin = e * torch.eye(3, **kw) / params.mass * dt
    nu = 3 * params.num_legs
    zeros = torch.zeros(lead + (6, nu), **kw)
    B = torch.cat([zeros,
                   _leg_columns(rot.expand(lead + rot.shape[-3:])),
                   _leg_columns(lin.expand(lead + lin.shape[-3:])),
                   zeros[..., :1, :]], dim=-2)
    return A, B


def friction_pyramid_rows(mu, dtype=torch.float32, device="cpu"):
    """5x3 pyramid {(-1,0,mu),(1,0,mu),(0,-1,mu),(0,1,mu),(0,0,1)}, the
    convention of the centroidal model (reference CentroidalMPC.cpp:186-190)."""
    return torch.tensor([[-1.0, 0.0, mu], [1.0, 0.0, mu], [0.0, -1.0, mu],
                         [0.0, 1.0, mu], [0.0, 0.0, 1.0]], dtype=dtype,
                        device=device)
