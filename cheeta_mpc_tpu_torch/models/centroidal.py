"""Centroidal dynamics for quadruped MPC, batched torch.

Counterpart of ``cheeta_mpc_tpu/models/centroidal.py``:

    com_pos'  = com_pos + com_vel * dt
    com_vel'  = com_vel + (g + sum_i enable_i / m * F_i) * dt
    L'        = L + sum_i enable_i * cross(foot_pos_i - com_pos, F_i) * dt
    foot_pos' = foot_pos_i + (1 - enable_i) * foot_vel_i * dt

Forces are decision variables ``u_F`` with the effective force
``F_i = enable_i * u_F_i``; the state is augmented with the previous
effective force ``F_prev`` so the force-rate cost is stage-separable.

State layout (nx = 9 + 6*num_legs; 33 for a quadruped):
    [com_pos(3), com_vel(3), ang_momentum(3), foot_pos(3*nl), F_prev(3*nl)]
Input layout (nu = 6*num_legs; 24 for a quadruped):
    [foot_vel(3*nl), u_F(3*nl)]

Every function takes any leading batch dimensions. The step is bilinear
((p - c) x F, gated by ``enable``), so the Jacobians are written in closed
form instead of coming from automatic differentiation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

GRAVITY = 9.81


@dataclass(frozen=True)
class CentroidalParams:
    """Model parameters (python numbers; ``num_legs`` defines shapes)."""

    mass: float
    mu: tuple  # (num_legs,) friction coefficients
    dt: float
    num_legs: int = 4

    @property
    def nx(self) -> int:
        return 9 + 6 * self.num_legs

    @property
    def nu(self) -> int:
        return 6 * self.num_legs

    @property
    def nx_ref(self) -> int:
        """Reference-visible state size (no F_prev augmentation)."""
        return 9 + 3 * self.num_legs

    @classmethod
    def create(cls, mass: float, num_legs: int, dt: float,
               mu) -> "CentroidalParams":
        try:
            mu = tuple(float(m) for m in mu)
        except TypeError:
            mu = (float(mu),) * num_legs
        return cls(mass=float(mass), mu=mu, dt=float(dt), num_legs=num_legs)


def pack_state(com_pos, com_vel, ang_mom, foot_pos, f_prev):
    """foot_pos, f_prev: (..., num_legs, 3)."""
    return torch.cat([com_pos, com_vel, ang_mom, foot_pos.flatten(-2),
                      f_prev.flatten(-2)], dim=-1)


def unpack_state(params: CentroidalParams, x):
    nl = params.num_legs
    lead = x.shape[:-1]
    return (x[..., 0:3], x[..., 3:6], x[..., 6:9],
            x[..., 9:9 + 3 * nl].reshape(*lead, nl, 3),
            x[..., 9 + 3 * nl:9 + 6 * nl].reshape(*lead, nl, 3))


def unpack_input(params: CentroidalParams, u):
    nl = params.num_legs
    lead = u.shape[:-1]
    return (u[..., 0:3 * nl].reshape(*lead, nl, 3),
            u[..., 3 * nl:6 * nl].reshape(*lead, nl, 3))


def centroidal_step(params: CentroidalParams, x, u, enable):
    """One explicit-Euler step. x: (..., nx), u: (..., nu),
    enable: (..., num_legs) contact flags in {0, 1}. Returns (..., nx)."""
    com_pos, com_vel, ang_mom, foot_pos, _ = unpack_state(params, x)
    foot_vel, u_f = unpack_input(params, u)
    dt = params.dt
    e = enable[..., :, None]  # (..., nl, 1)

    f_eff = e * u_f  # (..., nl, 3) effective contact forces
    # Filled on the device (fill_ takes the number as a kernel argument): a
    # tensor made from a Python list, or an indexed assignment of a number,
    # is a copy from the host, and the host then waits for the stream at
    # every step.
    gravity = torch.zeros(3, dtype=x.dtype, device=x.device)
    gravity[2:].fill_(-GRAVITY)
    com_acc = gravity + torch.sum(f_eff, dim=-2) / params.mass
    arm = foot_pos - com_pos[..., None, :]
    l_dot = torch.sum(torch.linalg.cross(arm, f_eff, dim=-1), dim=-2)

    return pack_state(com_pos + com_vel * dt, com_vel + com_acc * dt,
                      ang_mom + l_dot * dt,
                      foot_pos + (1.0 - e) * foot_vel * dt, f_eff)


def _skew(v):
    """(..., 3) -> (..., 3, 3) with skew(v) @ w = cross(v, w)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1)], dim=-2)


def linearize_step(params: CentroidalParams, x, u, enable):
    """(A, B, f) of the step at (x, u), Jacobians in closed form.

    With r_i = p_i - c and F_i = e_i u_F_i:  cross(r_i, F_i) = skew(r_i) F_i
    = -skew(F_i) r_i, so dL'/dc = dt sum_i skew(F_i), dL'/dp_i =
    -dt skew(F_i) and dL'/du_F_i = dt e_i skew(r_i)."""
    nl, nx, nu = params.num_legs, params.nx, params.nu
    dt = params.dt
    f = centroidal_step(params, x, u, enable)
    com_pos, _, _, foot_pos, _ = unpack_state(params, x)
    _, u_f = unpack_input(params, u)
    lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1],
                                  enable.shape[:-1])
    kw = dict(dtype=x.dtype, device=x.device)
    e = enable[..., :, None]
    f_eff = e * u_f
    eye3 = torch.eye(3, **kw)

    A = torch.zeros(lead + (nx, nx), **kw)
    B = torch.zeros(lead + (nx, nu), **kw)
    # com_pos, com_vel, L, foot_pos carry over (fill_ on a view: see
    # centroidal_step on why not an indexed assignment).
    torch.diagonal(A, dim1=-2, dim2=-1)[..., :9 + 3 * nl].fill_(1.0)
    A[..., 0:3, 3:6] = dt * eye3
    skew_f = _skew(f_eff)  # (..., nl, 3, 3)
    A[..., 6:9, 0:3] = dt * torch.sum(skew_f, dim=-3)
    skew_r = _skew(foot_pos - com_pos[..., None, :])
    for i in range(nl):
        ei = e[..., i, :, None]  # (..., 1, 1)
        fp = slice(9 + 3 * i, 12 + 3 * i)
        fprev = slice(9 + 3 * nl + 3 * i, 12 + 3 * nl + 3 * i)
        uv = slice(3 * i, 3 * i + 3)
        uf = slice(3 * nl + 3 * i, 3 * nl + 3 * i + 3)
        A[..., 6:9, fp] = -dt * skew_f[..., i, :, :]
        B[..., 3:6, uf] = (dt / params.mass) * ei * eye3
        B[..., 6:9, uf] = dt * ei * skew_r[..., i, :, :]
        B[..., fp, uv] = dt * (1.0 - ei) * eye3
        B[..., fprev, uf] = ei * eye3
    return A, B, f


def rollout(params: CentroidalParams, x0, u_traj, enable_traj):
    """Forward-simulate the horizon. u_traj: (..., N, nu),
    enable_traj: (..., N, nl). Returns the state trajectory (..., N+1, nx)."""
    xs = [x0]
    for k in range(u_traj.shape[-2]):
        xs.append(centroidal_step(params, xs[-1], u_traj[..., k, :],
                                  enable_traj[..., k, :]))
    return torch.stack(xs, dim=-2)
