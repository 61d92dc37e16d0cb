"""The whole equality-constrained Riccati (LQR) solve of one OCP-QP as ONE
CUDA kernel — counterpart of ``cheeta_mpc_tpu/ops/pallas_riccati.py``.

Source note.
  Replaces: ``ops/pallas_riccati.py::_eq_lqr_kernel`` (launched by
  ``pallas_solve_eq_lqr``) of the JAX package.
  Kernel: ``csrc/eq_riccati_single.cu`` (entry) + ``csrc/eq_riccati.cuh``
  (device code shared with the fleet kernel), CUDA C++ for ``sm_90a``.
  What bounds it on this card: latency, not bytes or operations. One
  legged problem (N=67, nx=nu=24, nc=16) is ~25 MFLOP of 24x24 / 16x16
  block products over ~1.3 MB of data, both bounds under a microsecond,
  behind a stage-serial chain of eleven phases and two Gauss-Jordan
  eliminations (24 and 16 pivots) per stage.
  What the design does about it: one team of four warps, its own thread
  block, solves the problem, so no barrier is wider than the team; the
  stage's working set (~40 KB) stays in shared memory, and the next stage's
  A, B, C, D and vectors arrive by ``cp.async`` while this one computes
  (R, S and Q of the stage at its start, into the arrays their sums grow
  in). Each inverse runs on one warp's registers: lane c holds column c of
  the compact Gauss-Jordan tableau, rotated so that the pivot row is
  always the first register, the pivot column comes by shuffles from the
  pivot's lane, and no pivot needs a barrier. The products run on 4x4
  register tiles with 16-byte shared-memory loads, in one routine that
  every phase calls (the kernel's code stays small enough for the
  instruction cache); the tiles of a phase's products are dealt over the
  team so that a warp runs tiles of two products together. The vector
  pass runs beside the products in the same phases; K and k are written
  to their outputs as they are formed and streamed back, one step ahead,
  by the rollout. Arithmetic is plain f32 FMA (no TF32: a lower-precision
  product compounds over 67 stages to newtons of force), each output
  summed in one fixed order, so every team size and tile shape gives the
  same bits; the inverse is the PLAIN Gauss-Jordan with the separate
  add-back, as in the Pallas kernel (:func:`gj_inverse_compact` follows
  the order of operations of the kernel's compact tableau, but not its
  fused multiply-add rounding). ``phase_cycles`` runs the instantiation
  with section timers, ``launch_occupancy`` reports what the card makes
  of a launch.

Scope: f32, masked stage equalities (nc >= 1), no inequality rows. What is
out of scope raises with the reason and is never handed to another
executor. The plain version beside the kernel repeats its arithmetic in
torch (any dtype, any batch dimensions) and is taken only for tensors that
lie on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cheeta_mpc_tpu_torch.core.types import (OcpQpData, OcpQpSolution,
                                             RiccatiGains)
from cheeta_mpc_tpu_torch.ops.cuda_ipm_riccati import (EQ_EPS, _check,
                                                       section_times,
                                                       tensor_pointers)
from cheeta_mpc_tpu_torch.ops.riccati import (_no_inequality_solution,
                                              solve_eq_lqr)

SINGLE_ENTRY, FLEET_ENTRY = "cheeta_eq_riccati_single", "cheeta_eq_riccati_fleet"
# The section timers' phase classes, in the order the kernels write them
# (csrc/eq_riccati.cuh, EqPhaseClass); the kernel adds the whole launch last.
PHASE_CLASSES = ("inverse_G", "inverse_Lam", "products", "stage_waits",
                 "store", "rollout")


def gj_inverse_plain(M: torch.Tensor) -> torch.Tensor:
    """The equality-Riccati kernels' SPD inverse in plain torch, batched:
    Gauss-Jordan on ``[M | I]`` without equilibration, pivot search or
    refinement; the pivot row is scaled by the pivot's reciprocal (as the
    kernels do), column j is eliminated from every row, and the scaled
    pivot row is added back to row j in a separate step (the
    one-hot-shifted form loses the 1 once |pivot| >> 1)."""
    n = M.shape[-1]
    if n == 0:
        return M
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    Ag = torch.cat([M, eye.expand(M.shape)], dim=-1)  # (..., n, 2n)
    for j in range(n):
        row_j = Ag[..., j:j + 1, :] * (1.0 / Ag[..., j:j + 1, j:j + 1])
        Ag = Ag - Ag[..., :, j:j + 1] * row_j
        Ag = Ag + eye[:, j:j + 1] * row_j
    return Ag[..., :, n:]


def gj_inverse_compact(M: torch.Tensor) -> torch.Tensor:
    """:func:`gj_inverse_plain` on the compact n x n tableau that the
    kernels keep in one warp's registers (csrc/eq_riccati.cuh::
    warp_gj_inverse, one column per lane): before pivot j, slot c holds
    left column c for c >= j and right column n + c for c < j, the columns
    that pivot j changes. At pivot j slot j turns into right column n + j,
    which holds e_j and whose pivot-row entry is 1. Every entry sees the
    operations of the augmented form in the same order, so the result is
    the same, bit for bit (tests/test_torch_eq_kernel_plain.py). It shows
    that the compact order of operations loses nothing; it does not
    reproduce the kernels' rounding, which fuses each update into one
    multiply-add, so the kernels are held against the plain version only
    at chip_smoke.py's tolerances. Like
    :func:`gj_inverse_plain` it takes M as given; the kernels symmetrize on
    load, the plain solver before the call."""
    n = M.shape[-1]
    if n == 0:
        return M
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    T = M
    for j in range(n):
        ipiv = 1.0 / T[..., j:j + 1, j:j + 1]
        col_is_j = eye[j:j + 1, :].bool()  # (1, n): slot j
        rv = torch.where(col_is_j, torch.ones_like(ipiv), T[..., j:j + 1, :]) \
            * ipiv
        base = torch.where(col_is_j, eye[:, j:j + 1], T)
        T = base - T[..., :, j:j + 1] * rv
        T = T + eye[:, j:j + 1] * rv
    return T


def eq_out_of_scope_reason(data: OcpQpData) -> Optional[str]:
    """Why a problem cannot go to the equality-Riccati kernels, or None."""
    if data.eq is None or data.eq.nc == 0:
        return ("the problem has no stage-equality rows (data.eq is None or "
                "nc = 0); the equality-Riccati kernels eliminate them and "
                "take nothing else")
    if data.con is not None and data.con.ng > 0:
        return ("the problem has inequality rows (data.con), which an exact "
                "equality-Riccati solve would ignore; they go through the "
                "interior-point kernels (ops.cuda_ipm_riccati)")
    return None


def solve_eq_lqr_plain(data: OcpQpData, reg: float = 1e-9,
                       eps: float = EQ_EPS) -> OcpQpSolution:
    """Plain PyTorch version of the kernel: ``ops.riccati.solve_eq_lqr``
    with the kernels' plain Gauss-Jordan inverse."""
    return solve_eq_lqr(data, reg=reg, eps=eps, inverse=gj_inverse_plain)


def block_threads(lib) -> int:
    """Threads per block that the library builds both kernels for
    (csrc/eq_riccati.cuh, kEqTeamThreads): a block is the team of warps
    that solves one problem."""
    return int(lib.cheeta_eq_block_threads())


def shared_memory_plan(lib, data: OcpQpData):
    """``(dims, bytes)``: the dims array the launchers take (N, nx, nu, nc
    and the stage slots) and the dynamic shared memory of one block at this
    problem's shape. Two stage slots (each stage's data streamed one stage
    ahead) where they fit a block, else one. Raises if neither fits."""
    dyn = data.dyn
    N, nx, nu, nc = dyn.horizon, dyn.nx, dyn.nu, data.eq.nc
    limit = getattr(torch.cuda.get_device_properties(data.dx0.device),
                    "shared_memory_per_block_optin", 232448)
    for slots in (2, 1):
        dims = (ctypes.c_int * 5)(N, nx, nu, nc, slots)
        smem = 4 * lib.cheeta_eq_smem_floats(dims)
        if smem <= limit:
            return dims, smem
    raise RuntimeError(
        f"the kernel needs {smem} bytes of shared memory per block for "
        f"nx={nx}, nu={nu}, nc={nc} even with one stage slot; the device "
        f"offers {limit}")


def launch_eq_kernel(entry: str, data: OcpQpData, reg: float, eps: float,
                     batch: Optional[int], value_function: bool,
                     timers: Optional[torch.Tensor] = None):
    """Check the tensors, allocate outputs and launch one of the two
    equality-Riccati kernels on the current stream. ``batch`` is None for
    an unbatched problem; otherwise every tensor either leads with
    ``batch`` or has no batch dimension (shared by all problems).
    ``value_function`` asks for P and p. ``timers``, an int64 tensor of
    ``(problems, len(PHASE_CLASSES) + 1)``, selects the instantiation with
    section timers (:func:`phase_cycles`). Returns the dict of output
    tensors. Does not synchronize."""
    from cheeta_mpc_tpu_torch.native.build import check_launch, load_library

    dyn, cost, eq = data.dyn, data.cost, data.eq
    dev = data.dx0.device
    N, nx, nu, nc = dyn.horizon, dyn.nx, dyn.nu, eq.nc
    named = [("A", dyn.A, (N, nx, nx)), ("B", dyn.B, (N, nx, nu)),
             ("b", dyn.b, (N, nx)), ("Q", cost.Q, (N + 1, nx, nx)),
             ("q", cost.q, (N + 1, nx)), ("R", cost.R, (N, nu, nu)),
             ("r", cost.r, (N, nu)), ("S", cost.S, (N, nu, nx)),
             ("eq.C", eq.C, (N, nc, nx)), ("eq.D", eq.D, (N, nc, nu)),
             ("eq.e", eq.e, (N, nc)), ("eq.mask", eq.mask, (N, nc)),
             ("dx0", data.dx0, (nx,))]
    ptrs, strides = tensor_pointers(named, dev, batch)

    nb = 1 if batch is None else batch
    lead = () if batch is None else (batch,)
    kw = dict(dtype=torch.float32, device=dev)
    out = {"dx": torch.empty(lead + (N + 1, nx), **kw),
           "du": torch.empty(lead + (N, nu), **kw),
           "K": torch.empty(lead + (N, nu, nx), **kw),
           "k": torch.empty(lead + (N, nu), **kw)}
    if value_function:
        out.update(P=torch.empty(lead + (N + 1, nx, nx), **kw),
                   p=torch.empty(lead + (N + 1, nx), **kw))
    order = ("dx", "du", "K", "k", "P", "p")
    optrs = [out[n].data_ptr() if n in out else None for n in order]
    ostrides = [out[n][0].numel() if n in out and batch is not None else 0
                for n in order]

    lib = load_library()
    dims, smem = shared_memory_plan(lib, data)
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            (ctypes.c_void_p * 13)(*ptrs), (ctypes.c_longlong * 13)(*strides),
            (ctypes.c_void_p * 6)(*optrs), (ctypes.c_longlong * 6)(*ostrides),
            None if timers is None else timers.data_ptr(),
            dims, (ctypes.c_float * 2)(reg, eps), nb, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, entry)
    return out


def solve_eq_lqr_kernel(data: OcpQpData, reg: float = 1e-9,
                        eps: float = EQ_EPS) -> OcpQpSolution:
    """Solve one equality-constrained, inequality-free OCP-QP exactly with
    the fused kernel; drop-in for
    :func:`cheeta_mpc_tpu_torch.ops.riccati.solve_eq_lqr`.

    CUDA tensors: unbatched float32 only — anything else raises, so no CUDA
    input is ever solved by another executor silently. CPU tensors: the
    plain version, any dtype and batch shape. The launch counter
    ``solve_eq_lqr_kernel.launches`` rises by one per kernel launch."""
    reason = eq_out_of_scope_reason(data)
    if reason is not None:
        raise NotImplementedError(f"solve_eq_lqr_kernel: {reason}")
    if data.dx0.device.type == "cpu":
        return solve_eq_lqr_plain(data, reg, eps)
    _check(data.dx0.dim() == 1,
           "solve_eq_lqr_kernel takes one unbatched problem on a CUDA "
           "device; batches go through ops.cuda_eq_batch",
           NotImplementedError)
    out = launch_eq_kernel(SINGLE_ENTRY, data, reg, eps,
                           batch=None, value_function=True)
    solve_eq_lqr_kernel.launches += 1
    return _no_inequality_solution(
        data, out["dx"], out["du"],
        RiccatiGains(K=out["K"], k=out["k"], P=out["P"], p=out["p"]))


solve_eq_lqr_kernel.launches = 0


def _batch_of(entry: str, data: OcpQpData) -> Optional[int]:
    return data.dx0.shape[0] if entry == FLEET_ENTRY else None


def phase_cycles(entry: str, data: OcpQpData, reg: float = 1e-9,
                 eps: float = EQ_EPS) -> dict:
    """Section times (``ops.cuda_ipm_riccati.section_times``) of ``entry``
    (``SINGLE_ENTRY`` or ``FLEET_ENTRY``) on ``data``, whose batch is the
    fleet kernel's. Not counted in the solvers' launch counters."""
    batch = _batch_of(entry, data)
    timers = torch.zeros((batch or 1, len(PHASE_CLASSES) + 1),
                         dtype=torch.int64, device=data.dx0.device)
    return section_times(
        lambda t: launch_eq_kernel(entry, data, reg, eps, batch,
                                   value_function=entry == SINGLE_ENTRY,
                                   timers=t),
        timers, PHASE_CLASSES)


def launch_occupancy(entry: str, data: OcpQpData) -> dict:
    """What the card makes of ``entry``'s launch at this problem's shape:
    threads per block (one block solves one problem), shared bytes per
    block, resident blocks (= problems) per SM, registers and spill bytes per thread, and
    the waves the problems of ``data`` take."""
    from cheeta_mpc_tpu_torch.native.build import check_launch, load_library
    lib = load_library()
    dev = data.dx0.device
    dims, smem = shared_memory_plan(lib, data)
    res = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        check_launch(lib, getattr(lib, entry + "_occupancy")(smem, res),
                     entry + " occupancy")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    problems = _batch_of(entry, data) or 1
    return {"threads_per_block": block_threads(lib),
            "stage_slots": dims[4], "shared_bytes": smem,
            "problems_per_sm": res[0], "registers": res[1],
            "spill_bytes": res[2],
            "waves": -(-problems // max(1, sms * res[0]))}
