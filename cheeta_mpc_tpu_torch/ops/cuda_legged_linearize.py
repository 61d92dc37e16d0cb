"""The legged SQP linearization (the ``linearize`` of
``mpc/legged_mpc.py::build_legged_solver``) as ONE CUDA kernel, L1.

Source note.
  Replaces: no TPU kernel. The JAX package linearizes the legged task by
  ``jax.jacfwd`` and leaves its fusion to XLA; the port's plain version,
  ``build_legged_solver``'s ``linearize_plain``, does the same with
  ``torch.func.jacfwd`` under ``vmap`` (``models/srbd_legged.py::
  srbd_linearize`` for the RK2 step, the same for the masked
  foot-velocity equalities) and the cost's closed forms. On the card that
  is ~1,700 small kernels and batched copies per linearization: 84 % of
  the device time of a legged fleet of 512.
  Kernel: ``csrc/legged_linearize.cu``, CUDA C++ for ``sm_90a``.
  What bounds it on this card: the bytes it writes, ~10.3 KB per stage (A,
  B, C, D, R and the vectors): ~0.11 ms for 512 problems of 67 stages at
  3.35 TB/s. Its arithmetic, ~152,000 f32 operations per stage, is ~0.08
  ms at 67 TFLOP/s for the same fleet.
  What the design does about it: forward mode by dual numbers in
  registers, one thread per (problem, stage, tangent); the thread of
  tangent j writes column j of [A | B] and [C | D], so a stage's 24 state
  tangents write each row of A as 24 adjacent floats, and no intermediate
  reaches device memory. One launch per SQP iteration.

Scope: float32, the state and input widths of the SRBD model (24 and 24),
16 equality rows, at most one batch dimension; every input either carries
the batch dimension or is shared by the batch (a broadcast view is taken
as shared). Tensors on the card go through the kernel or raise; the
solver keeps CPU tensors on its plain version, and this wrapper refuses
them. The launch counter ``legged_linearize.launches`` rises by one per
kernel launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from cheeta_mpc_tpu_torch.ops.cuda_ipm_riccati import _check, tensor_pointers

ENTRY = "cheeta_legged_linearize"
# The widths the kernel is built for (csrc/legged_linearize.cu).
NX = NU = 24  # state and input
NC = 16  # equality rows per stage
NL = 4  # legs


class L1Outputs(NamedTuple):
    """What one launch writes, per problem and stage."""

    A: torch.Tensor  # (..., N, 24, 24)
    B: torch.Tensor  # (..., N, 24, 24)
    b: torch.Tensor  # (..., N, 24) f(x_k, u_k) - x_{k+1}
    C: torch.Tensor  # (..., N, 16, 24) masked
    D: torch.Tensor  # (..., N, 16, 24) masked
    e: torch.Tensor  # (..., N, 16) masked equality values
    q: torch.Tensor  # (..., N+1, 24) Q (x - x_ref)
    r: torch.Tensor  # (..., N, 24) R (u - u_ref), plus the cone's gradient
    R: Optional[torch.Tensor]  # (..., N, 24, 24) with the cone; else None


def legged_linearize(x_traj, u_traj, enable, z_pos, z_vel, eq_mask, x_ref,
                     u_ref, dts, params, *, soft: bool,
                     rk2: bool) -> L1Outputs:
    """One launch of L1 on the current stream: the dynamics, the masked
    equalities and the cost's vectors at ``(x_traj, u_traj)``, and with
    ``soft`` R plus the relaxed-barrier friction cone's Hessian. ``params``
    are the floats of the kernel's ``Model`` in its order; ``dts`` is None
    on the uniform grid; ``rk2`` picks RK2 over Euler. Does not
    synchronize."""
    from cheeta_mpc_tpu_torch.native.build import check_launch, load_library

    dev = x_traj.device
    _check(dev.type != "cpu", "L1 takes tensors on the card; the legged "
           "solver linearizes CPU tensors by its plain version")
    N = x_traj.shape[-2] - 1
    lead = tuple(x_traj.shape[:-2])
    _check(len(lead) <= 1,
           f"the kernel takes at most one batch dimension, got {lead}",
           NotImplementedError)
    batch = lead[0] if lead else None
    named = [("x_traj", x_traj, (N + 1, NX)), ("u_traj", u_traj, (N, NU)),
             ("enable", enable, (N, NL)), ("z_pos", z_pos, (N, NL)),
             ("z_vel", z_vel, (N, NL)), ("eq_mask", eq_mask, (N, NC)),
             ("x_ref", x_ref, (N + 1, NX)), ("u_ref", u_ref, (N, NU))]
    if dts is not None:
        named.append(("dts", dts, (N,)))
    # A view broadcast along the batch is one shared input.
    named = [(name, t[0] if t.dim() == len(shape) + 1 and t.stride(0) == 0
              else t, shape) for name, t, shape in named]
    ptrs, strides = tensor_pointers(named, dev, batch)
    if dts is None:
        ptrs.append(None)
        strides.append(0)

    kw = dict(dtype=torch.float32, device=dev)
    out = L1Outputs(
        A=torch.empty(lead + (N, NX, NX), **kw),
        B=torch.empty(lead + (N, NX, NU), **kw),
        b=torch.empty(lead + (N, NX), **kw),
        C=torch.empty(lead + (N, NC, NX), **kw),
        D=torch.empty(lead + (N, NC, NU), **kw),
        e=torch.empty(lead + (N, NC), **kw),
        q=torch.empty(lead + (N + 1, NX), **kw),
        r=torch.empty(lead + (N, NU), **kw),
        R=torch.empty(lead + (N, NU, NU), **kw) if soft else None)

    lib = load_library()
    _check(lib.cheeta_legged_linearize_num_params() == len(params),
           f"the kernel's Model holds "
           f"{lib.cheeta_legged_linearize_num_params()} floats, got "
           f"{len(params)}", RuntimeError)
    with torch.cuda.device(dev):
        code = lib.cheeta_legged_linearize(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(strides))(*strides),
            (ctypes.c_void_p * len(out))(
                *(None if t is None else t.data_ptr() for t in out)),
            (ctypes.c_int * 3)(N, batch or 1, int(rk2)),
            (ctypes.c_float * len(params))(*params),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, ENTRY)
    legged_linearize.launches += 1
    return out


legged_linearize.launches = 0


def launch_occupancy(device) -> dict:
    """Threads per block, resident blocks per SM, registers and spill bytes
    per thread of the kernel on ``device``."""
    from cheeta_mpc_tpu_torch.native.build import check_launch, load_library
    lib = load_library()
    res = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        check_launch(lib, lib.cheeta_legged_linearize_occupancy(res),
                     ENTRY + " occupancy")
    return {"threads_per_block": res[3], "blocks_per_sm": res[0],
            "registers": res[1], "spill_bytes": res[2]}
