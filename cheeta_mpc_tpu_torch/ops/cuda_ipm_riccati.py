"""The whole Riccati-structured interior-point solve of one OCP-QP as ONE
CUDA kernel — counterpart of ``cheeta_mpc_tpu/ops/pallas_ipm_riccati.py``.

Source note.
  Replaces: ``ops/pallas_ipm_riccati.py::_ipm_kernel`` (launched by
  ``pallas_solve_ocp_qp``) of the JAX package.
  Kernel: ``csrc/ipm_riccati_single.cu`` (entry) + ``csrc/ipm_riccati.cuh``
  (device code shared with the fleet kernel), CUDA C++ for ``sm_90a``.
  What bounds it on this card: latency, not bytes or operations. One
  problem is ~65 MFLOP of 33x33 / 24x24 block products behind a
  stage-serial, iteration-serial dependency chain (about 700 barrier
  phases per IPM iteration), so a single thread block does all of it, and a
  thread runs its instructions in order: every load that a store or a use waits for costs
  its full latency. The problem data (~0.26 MB at the centroidal shape)
  stays in L2 after the first sweep, at ~330 cycles a load.
  What the design does about it: the iterate, slacks, duals, directions,
  the Riccati factors and a copy of A, B of all stages stay in shared
  memory for all iterations (the rest of the stage data does not fit and is
  re-read from L2 per sweep); products run on 4x4 register tiles, the
  independent products of a phase side by side on disjoint threads; inputs
  are declared read-only so their loads start ahead of stores;
  mat-vecs of the serial passes split each row over 8 lanes to shorten the
  chain; the kernel is compiled once per memory placement so that no
  pointer is generic. Arithmetic is plain f32 FMA with IEEE division:
  barrier conditioning reaches ~1/mu, which rules out TF32 and bf16, and
  the SPD inverse is the equilibrated Gauss-Jordan without Newton
  refinement, as in the Pallas kernel.

Scope: inequality-constrained f32 OCP-QPs with or without masked stage
equalities. Where the JAX wrapper warns and falls back to the scan solver
for f64 or inequality-free problems, this wrapper raises: a CUDA tensor
either goes through the kernel or is an error. The plain version beside the
kernel repeats its arithmetic in torch (any dtype, any batch dimensions) and
is taken only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains, symmetrize)
from cheeta_mpc_tpu_torch.ops.ocpqp import (IpmSettings, _finish, _IpmState,
                                            dtype_clamps, solve_ocp_qp)

EQ_EPS = 1.0  # dual regularization of inactive equality rows
# Threads per block: at the centroidal shape the independent products of a
# factorization phase (171 register tiles of 4x4) run side by side.
THREADS = 256
# What a launch keeps in shared memory, most first: the Riccati factors and
# a copy of A, B of all stages; the factors alone; neither (the factors then
# live in a global scratch buffer). The first that fits is taken.
PLACEMENTS = (("factors+AB", True, True), ("factors", True, False),
              ("none", False, False))


def spd_inverse_gj(M: torch.Tensor) -> torch.Tensor:
    """The kernels' SPD inverse in plain torch, batched: symmetrize, Jacobi
    equilibration ``M^-1 = D (D M D)^-1 D`` with ``D = diag(M)^-1/2``,
    Gauss-Jordan with the one-hot-shifted pivot column (safe because the
    equilibrated pivots are O(1)), the pivot row scaled by the pivot's
    reciprocal as the kernels do, and deliberately no Newton refinement:
    at the ~1/mu conditioning the barrier reaches, the f32 residual of a
    refinement step cancels catastrophically and makes the inverse worse."""
    n = M.shape[-1]
    if n == 0:
        return M
    M = symmetrize(M)
    s = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                                min=1e-30))
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    Ms = s[..., :, None] * M * s[..., None, :]
    Ag = torch.cat([Ms, eye.expand(Ms.shape)], dim=-1)  # (..., n, 2n)
    for j in range(n):
        row_j = Ag[..., j:j + 1, :] * (1.0 / Ag[..., j:j + 1, j:j + 1])
        colm = Ag[..., :, j:j + 1] - eye[:, j:j + 1]
        Ag = Ag - colm * row_j
    return s[..., :, None] * Ag[..., :, n:] * s[..., None, :]


def _masked_eq(data: OcpQpData) -> OcpQpData:
    """Zero the inactive equality rows, as the kernel expects them."""
    eq = data.eq
    if eq is None:
        return data
    mk = eq.mask
    return data.replace(eq=eq.replace(C=eq.C * mk[..., None],
                                      D=eq.D * mk[..., None], e=eq.e * mk))


def solve_ocp_qp_plain(data: OcpQpData,
                       settings: IpmSettings) -> OcpQpSolution:
    """Plain PyTorch version of the kernel: the same fixed-iteration
    Mehrotra loop (zero-iterate init, same sweeps, freeze and guard) with
    the kernel's Gauss-Jordan inverse in the factorization."""
    return solve_ocp_qp(_masked_eq(data), settings, inverse=spd_inverse_gj)


def _check(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(msg)


def shared_memory_plan(lib, shape, iters: int, device):
    """``(placement, dims, bytes)`` for a problem of ``shape = (N, nx, nu,
    ng, nc)``: the first of ``PLACEMENTS`` whose dynamic shared memory the
    device grants a block, the dims array the launchers take, and the
    bytes. Raises if even the smallest does not fit."""
    # What a block may opt in to (232,448 bytes on sm_90).
    limit = getattr(torch.cuda.get_device_properties(device),
                    "shared_memory_per_block_optin", 232448)
    for placement, in_shared, ab in PLACEMENTS:
        dims = (ctypes.c_int * 7)(*shape, iters, int(ab))
        smem = 4 * lib.cheeta_ipm_smem_floats(dims, int(in_shared))
        if smem <= limit:
            return placement, dims, smem
    N, nx, nu, ng, nc = shape
    raise RuntimeError(
        f"the kernel needs {smem} bytes of shared memory per block for "
        f"N={N}, nx={nx}, nu={nu}, ng={ng}, nc={nc} even with the Riccati "
        f"factors in global memory; the device offers {limit}")


def launch_ipm_kernel(entry: str, data: OcpQpData, settings: IpmSettings,
                      batch: Optional[int], gains: bool):
    """Check the tensors, allocate outputs and launch one of the two IPM
    kernels on the current stream. ``batch`` is None for an unbatched
    problem; otherwise every tensor either leads with ``batch`` or has no
    batch dimension (shared by all problems). Returns the dict of raw
    output tensors. Does not synchronize."""
    from cheeta_mpc_tpu_torch.native.build import check_launch, load_library

    dyn, cost, con, eq = data.dyn, data.cost, data.con, data.eq
    dev = data.dx0.device
    N, nx, nu, ng = dyn.horizon, dyn.nx, dyn.nu, con.ng
    nc = 0 if eq is None else eq.nc
    named = [("A", dyn.A, (N, nx, nx)), ("B", dyn.B, (N, nx, nu)),
             ("b", dyn.b, (N, nx)), ("Q", cost.Q, (N + 1, nx, nx)),
             ("q", cost.q, (N + 1, nx)), ("R", cost.R, (N, nu, nu)),
             ("r", cost.r, (N, nu)), ("S", cost.S, (N, nu, nx)),
             ("C", con.C, (N + 1, ng, nx)), ("D", con.D, (N + 1, ng, nu)),
             ("lg", con.lg, (N + 1, ng)), ("ug", con.ug, (N + 1, ng)),
             ("mask", con.mask, (N + 1, ng)), ("dx0", data.dx0, (nx,))]
    if nc:
        named += [("eq.C", eq.C, (N, nc, nx)), ("eq.D", eq.D, (N, nc, nu)),
                  ("eq.e", eq.e, (N, nc)), ("eq.mask", eq.mask, (N, nc))]
    ptrs, strides = [], []
    for name, t, shape in named:
        _check(t.device == dev, f"{name} is on {t.device}, dx0 on {dev}")
        _check(t.dtype == torch.float32,
               f"{name} is {t.dtype}: the kernel takes float32 only",
               TypeError)
        _check(t.is_contiguous(), f"{name} is not contiguous")
        if tuple(t.shape) == shape:
            strides.append(0)
        else:
            _check(batch is not None and tuple(t.shape) == (batch,) + shape,
                   f"{name} has shape {tuple(t.shape)}, expected {shape}"
                   + ("" if batch is None else f" or {(batch,) + shape}"))
            strides.append(t[0].numel())
        ptrs.append(t.data_ptr())
    ptrs += [None] * (18 - len(ptrs))
    strides += [0] * (18 - len(strides))

    nb = 1 if batch is None else batch
    lead = () if batch is None else (batch,)
    kw = dict(dtype=torch.float32, device=dev)
    out = {
        "dx": torch.empty(lead + (N + 1, nx), **kw),
        "du": torch.empty(lead + (N, nu), **kw),
        "s_l": torch.empty(lead + (N + 1, ng), **kw),
        "s_u": torch.empty(lead + (N + 1, ng), **kw),
        "lam_l": torch.empty(lead + (N + 1, ng), **kw),
        "lam_u": torch.empty(lead + (N + 1, ng), **kw),
        "diag": torch.empty(lead + (2,), **kw),  # mu, stationarity
    }
    if gains:
        out.update(K=torch.empty(lead + (N, nu, nx), **kw),
                   k=torch.empty(lead + (N, nu), **kw),
                   P=torch.empty(lead + (N + 1, nx, nx), **kw),
                   p=torch.empty(lead + (N + 1, nx), **kw))
    order = ("dx", "du", "s_l", "s_u", "lam_l", "lam_u", "diag", "K", "k",
             "P", "p")
    optrs = [out[n].data_ptr() if n in out else None for n in order]
    ostrides = [out[n][0].numel() if n in out and batch is not None else 0
                for n in order]

    lib = load_library()
    s = dtype_clamps(settings, torch.float32)
    params = (ctypes.c_float * 7)(s.tau, s.mu0, s.s0_min, s.reg, EQ_EPS,
                                  s.w_max, s.mu_tol)
    placement, dims, smem = shared_memory_plan(
        lib, (N, nx, nu, ng, nc), int(s.iters), dev)
    scratch, scratch_stride = None, 0
    if placement == "none":
        scratch_stride = lib.cheeta_ipm_factor_floats(dims)
        scratch = torch.empty(nb * scratch_stride, **kw)
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            (ctypes.c_void_p * 18)(*ptrs), (ctypes.c_longlong * 18)(*strides),
            (ctypes.c_void_p * 11)(*optrs),
            (ctypes.c_longlong * 11)(*ostrides),
            None if scratch is None else scratch.data_ptr(), scratch_stride,
            dims, params, nb, THREADS, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, entry)
    return out


def solve_ocp_qp_kernel(data: OcpQpData,
                        settings: Optional[IpmSettings] = None
                        ) -> OcpQpSolution:
    """Solve one inequality-constrained OCP-QP (with or without masked stage
    equalities) with the fused kernel; drop-in for
    :func:`cheeta_mpc_tpu_torch.ops.ocpqp.solve_ocp_qp`.

    CUDA tensors: unbatched float32 only — anything else raises (the JAX
    package's warn-and-fall-back to the scan solver for f64 problems is an
    error here, so no CUDA input is ever solved by another executor
    silently). CPU tensors: the plain version, any dtype and batch shape.
    The Riccati factors stay in shared memory when they fit and go to a
    global scratch buffer when they do not. The launch counter
    ``solve_ocp_qp_kernel.launches`` rises by one per kernel launch."""
    if settings is None:
        settings = IpmSettings()
    _check(data.con is not None,
           "solve_ocp_qp_kernel needs inequality rows (data.con); use "
           "ops.riccati.solve_lqr / solve_eq_lqr for inequality-free QPs")
    if data.dx0.device.type == "cpu":
        return solve_ocp_qp_plain(data, settings)
    _check(data.dx0.dim() == 1,
           "solve_ocp_qp_kernel takes one unbatched problem on a CUDA "
           "device; batches go through ops.cuda_ipm_batch")
    data = _masked_eq(data)
    out = launch_ipm_kernel("cheeta_ipm_riccati_single", data, settings,
                            batch=None, gains=True)
    solve_ocp_qp_kernel.launches += 1
    # Final diagnostics in plain torch on the kernel's outputs.
    state = _IpmState(out["dx"], out["du"], out["s_l"], out["s_u"],
                      out["lam_l"], out["lam_u"])
    gains = RiccatiGains(K=out["K"], k=out["k"], P=out["P"], p=out["p"])
    return _finish(data, state, gains, out["diag"][0], int(settings.iters))


solve_ocp_qp_kernel.launches = 0
