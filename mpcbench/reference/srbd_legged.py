"""SRBD kinodynamic model for the legged-robot OCP (nx = 24, nu = 24), torch.

Counterpart of ``cheeta_mpc_tpu/models/srbd_legged.py``: centroidal momentum
dynamics with an SRBD inertia frozen at the default configuration, base
kinematics driven by the momentum, joint kinematics driven directly by the
commanded joint velocities. Values are closed form and take any leading
dimensions; the Jacobians of the discrete step come from one level of
forward-mode differentiation (``torch.func.jacfwd``) where the JAX package
nests ``jax.jvp`` inside ``jax.jacfwd`` — the foot velocity is written out
in ``models/quadruped_kinematics.py`` instead of differentiated.

State layout (task.info:112-147):
    x = [vcom(3), L/m(3), p_base(3), eul_zyx(3), q_joints(12)]
Input layout:
    u = [contact forces (12, contact order LF RF LH RH),
         joint velocities (12, task.info order LF LH RF RH)]

Swing-leg forces are gated by the contact flags (F_eff = enable * u_F), the
same structural choice as the centroidal model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcbench.reference.quadruped_kinematics import (
    QuadrupedDescription, const_tensor, euler_zyx_rate_matrix_inv,
    euler_zyx_to_rot, foot_positions_world, foot_velocities_world, matvec,
    matvec_t)

GRAVITY = 9.81
NX = 24
NU = 24


class SrbdParams(NamedTuple):
    desc: QuadrupedDescription = QuadrupedDescription()
    dt: float = 0.015  # task.info:33 (multiple_shooting dt)
    integrator: str = "rk2"  # task.info integratorType RK2


def unpack_srbd_state(x):
    return (x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:12],
            x[..., 12:24])


def unpack_srbd_input(u):
    forces = u[..., 0:12].reshape(*u.shape[:-1], 4, 3)
    qd = u[..., 12:24]
    return forces, qd


def _euler_rates(desc: QuadrupedDescription, R, eul, l_norm):
    """eul_dot = E^-1(eul) R I_b^-1 R' (m l_norm); the inverse of the
    constant diagonal inertia is a reciprocal made once."""
    inv_inertia = const_tensor(tuple(1.0 / i for i in desc.inertia), l_norm)
    omega = matvec(R, inv_inertia * matvec_t(R, desc.mass * l_norm))
    return matvec(euler_zyx_rate_matrix_inv(eul), omega)


def srbd_continuous_dynamics(params: SrbdParams, x, u, enable):
    """x_dot of the SRBD kinodynamic model. x, u: (..., 24); enable:
    (..., 4) contact flags (broadcast against the leading dimensions)."""
    desc = params.desc
    vcom, l_norm, p_base, eul, q = unpack_srbd_state(x)
    u_f, qd = unpack_srbd_input(u)
    f_eff = enable[..., :, None] * u_f  # (..., 4, 3)

    R = euler_zyx_to_rot(eul)
    com = p_base + matvec(R, const_tensor(desc.com_offset, x))
    feet = foot_positions_world(desc, p_base, eul, q)  # (..., 4, 3)

    m = desc.mass
    g_vec = const_tensor((0.0, 0.0, -GRAVITY), x)
    vcom_dot = g_vec + torch.sum(f_eff, dim=-2) / m
    l_norm_dot = torch.sum(torch.linalg.cross(feet - com[..., None, :], f_eff,
                                              dim=-1), dim=-2) / m
    eul_dot = _euler_rates(desc, R, eul, l_norm)
    return torch.cat([vcom_dot, l_norm_dot, vcom, eul_dot, qd], dim=-1)


def _dt_column(params: SrbdParams, dt):
    """The step as something that scales a (..., 24) state."""
    if dt is None:
        return params.dt
    return dt[..., None] if torch.is_tensor(dt) else dt


def srbd_step(params: SrbdParams, x, u, enable, dt=None):
    """One integration step (Euler or RK2 per task.info integratorType).

    ``dt`` overrides the nominal step: a float or a (...) tensor of
    per-interval durations of an event-aligned grid."""
    dt = _dt_column(params, dt)
    k1 = srbd_continuous_dynamics(params, x, u, enable)
    if params.integrator == "euler":
        return x + dt * k1
    # RK2 (midpoint), the reference SQP default (task.info:44).
    k2 = srbd_continuous_dynamics(params, x + 0.5 * dt * k1, u, enable)
    return x + dt * k2


def value_and_jacfwd(fn, diff, rest=()):
    """``(y, (dy/d diff[0], ...))`` of ``y = fn(*diff, *rest)`` by forward
    mode. ``fn`` is written for one sample; every tensor of ``diff`` and
    ``rest`` carries the same leading dimensions (those of ``diff[0]``
    before its last axis), which are flattened into one ``vmap`` axis."""
    lead = diff[0].shape[:-1]

    def with_value(*args):
        y = fn(*args)
        return y, y

    jac = torch.func.jacfwd(with_value, argnums=tuple(range(len(diff))),
                            has_aux=True)
    args = tuple(diff) + tuple(rest)
    if not lead:
        jacs, y = jac(*args)
        return y, jacs
    nl = len(lead)
    flat = tuple(a.reshape((-1,) + a.shape[nl:]) for a in args)
    jacs, y = torch.func.vmap(jac)(*flat)
    return (y.reshape(lead + y.shape[1:]),
            tuple(j.reshape(lead + j.shape[1:]) for j in jacs))


def srbd_linearize(params: SrbdParams, x, u, enable, dt=None):
    """(A, B, f): exact Jacobians of the discrete step by forward mode, and
    the step itself. x, u: (..., 24); enable: (..., 4); dt: None, a float
    or a (...) tensor."""
    lead = x.shape[:-1]
    u = u.expand(lead + u.shape[-1:])
    enable = enable.expand(lead + enable.shape[-1:])
    if torch.is_tensor(dt):
        dt = dt.expand(lead)
        f, (A, B) = value_and_jacfwd(
            lambda xx, uu, ee, dd: srbd_step(params, xx, uu, ee, dd),
            (x, u), (enable, dt))
    else:
        f, (A, B) = value_and_jacfwd(
            lambda xx, uu, ee: srbd_step(params, xx, uu, ee, dt),
            (x, u), (enable,))
    return A, B, f


def foot_velocity_constraint_values(params: SrbdParams, x, u):
    """(..., 4, 3) world foot velocities as a function of (x, u).

    Foot velocity = d/dt FK(p_base, eul, q) with p_base_dot = vcom,
    eul_dot from the momentum map, q_dot = commanded joint velocities —
    the quantity constrained by the zero-velocity (stance) and
    normal-velocity (swing) constraints.
    """
    desc = params.desc
    vcom, l_norm, p_base, eul, q = unpack_srbd_state(x)
    _, qd = unpack_srbd_input(u)
    eul_dot = _euler_rates(desc, euler_zyx_to_rot(eul), eul, l_norm)
    return foot_velocities_world(desc, p_base, eul, q, vcom, eul_dot, qd)


def weight_compensating_input(params: SrbdParams, enable):
    """Gravity split equally over the stance feet, zero joint velocity:
    (..., 4) contact flags -> (..., 24) input (the reference's
    weightCompensatingInput, utils.h:63-77)."""
    stance = torch.clamp(torch.sum(enable, dim=-1, keepdim=True), min=1.0)
    fz = enable * (params.desc.mass * GRAVITY / stance)  # (..., 4)
    zc = torch.zeros_like(fz)
    forces = torch.stack([zc, zc, fz], dim=-1)  # (..., 4, 3)
    return torch.cat([forces.reshape(fz.shape[:-1] + (12,)),
                      torch.zeros(fz.shape[:-1] + (12,), dtype=fz.dtype,
                                  device=fz.device)], dim=-1)
