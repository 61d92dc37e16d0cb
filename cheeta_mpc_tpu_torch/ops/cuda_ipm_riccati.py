"""The whole Riccati-structured interior-point solve of one OCP-QP as ONE
CUDA kernel — counterpart of ``cheeta_mpc_tpu/ops/pallas_ipm_riccati.py``.

Source note.
  Replaces: ``ops/pallas_ipm_riccati.py::_ipm_kernel`` (launched by
  ``pallas_solve_ocp_qp``) of the JAX package.
  Kernel: ``csrc/ipm_riccati_single.cu`` (entry) + ``csrc/ipm_riccati.cuh``
  (device code shared with the fleet kernel), CUDA C++ for ``sm_90a``.
  What bounds it on this card: latency, not bytes or operations. One
  problem is ~65 MFLOP of 33x33 / 24x24 block products behind a
  stage-serial, iteration-serial chain of barrier phases, so a single
  thread block does all of it, and a thread runs its instructions in
  order: every load that a use waits for costs its full latency.
  What the design does about it: a stage's data is copied into shared
  memory by ``cp.async`` while an earlier stage computes; an SPD inverse
  up to 32 wide runs on one warp's registers, one tableau column per lane,
  rows rotated so that the pivot row is always the first register, and
  takes no barrier per pivot (a wider one spreads its tableau over the
  block and takes one barrier per pivot); passes
  over all stages read whole lines of global memory (row products split
  over lane groups, column products one output per thread); the iterate,
  directions, rolling P and work matrices stay in shared memory, the
  Riccati factors too when they fit (else a global scratch buffer);
  products run on register tiles, independent products of a phase side by
  side; the shared-memory layout comes with the launch parameters; the
  batch-1 kernel takes 384 threads, more than its widest product needs, so
  that the passes over all stages take fewer rounds. The kernel is
  compiled once per factor placement so that no pointer is generic.
  ``phase_cycles`` runs the instantiation with section timers.
  Arithmetic is plain f32 FMA with IEEE division: barrier conditioning
  reaches ~1/mu, which rules out TF32 and bf16, and the SPD inverse is the
  equilibrated Gauss-Jordan without Newton refinement, as in the Pallas
  kernel.

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
FLEET_ENTRY = "cheeta_ipm_riccati_fleet"
# Where a launch keeps the Riccati factors of all stages: in shared memory
# ("factors") or in a global scratch buffer ("none"); the first that fits
# the block's share of an SM (csrc/ipm_launch.inl: one block for K1, two
# for K2) is taken.
PLACEMENTS = (("factors", True), ("none", False))
# The section timers' phase classes, in the order the kernel writes them
# (csrc/ipm_riccati.cuh, PhaseClass); the kernel adds the whole launch last.
PHASE_CLASSES = ("inverse", "products", "sweeps", "gradients", "bulk",
                 "stage_loads", "elementwise")
# The kernels' SPD inverse runs on one warp's registers up to this width
# (csrc/ipm_riccati.cuh::warp_spd_inverse), instantiated exactly at the
# widths of WARP_INVERSE_EXACT and 32 wide for every other; wider ones take
# the block form (block_spd_inverse).
WARP_INVERSE_MAX = 32
WARP_INVERSE_EXACT = (16, 24)


def spd_inverse_gj(M: torch.Tensor) -> torch.Tensor:
    """The kernels' SPD inverse in plain torch, batched: symmetrize, Jacobi
    equilibration ``M^-1 = D (D M D)^-1 D`` with ``D = diag(M)^-1/2``,
    Gauss-Jordan with the one-hot-shifted pivot column (safe because the
    equilibrated pivots are O(1)), the pivot row scaled by the pivot's
    reciprocal as the kernels do, and deliberately no Newton refinement:
    at the ~1/mu conditioning the barrier reaches, the f32 residual of a
    refinement step cancels catastrophically and makes the inverse worse.

    Written on the compact n x n tableau that the kernels keep in
    registers (csrc/ipm_riccati.cuh: ``warp_spd_inverse`` on one warp up
    to n = 32, ``block_spd_inverse`` over the block above): after pivot j,
    slot c > j holds column c of the left block and slot c <= j column
    n + c of the right block of ``[S | I]``. Those are exactly the columns
    that pivot j changes, so the operations and their order are those of
    the elimination on the full ``n x 2n`` tableau.
    tests/test_torch_ipm_kernel_plain.py holds a model of the warp form's
    order to it, bit for bit."""
    n = M.shape[-1]
    if n == 0:
        return M
    M = symmetrize(M)
    s = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                                min=1e-30))
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    T = s[..., :, None] * M * s[..., None, :]
    for j in range(n):
        ipiv = 1.0 / T[..., j:j + 1, j:j + 1]
        colm = T[..., :, j:j + 1] - eye[:, j:j + 1]
        # Slot j turns into right column n + j, which holds e_j and whose
        # pivot-row entry is 1 * ipiv.
        row = T[..., j:j + 1, :] * ipiv
        row = torch.cat([row[..., :j], ipiv, row[..., j + 1:]], dim=-1)
        T = torch.cat([T[..., :j], eye[:, j:j + 1].expand(colm.shape),
                       T[..., j + 1:]], dim=-1)
        T = T - colm * row
    return s[..., :, None] * T * s[..., None, :]


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


def tensor_pointers(named, dev, batch: Optional[int]):
    """Data pointers and per-problem strides (in elements; 0 = shared by
    the batch) of ``(name, tensor, unbatched shape)`` triples, after
    checking what the kernels do not take: another device, another dtype
    than float32, a non-contiguous tensor, a wrong shape."""
    ptrs, strides = [], []
    for name, t, shape in named:
        _check(t.device == dev,
               f"{name} is on {t.device}, the other inputs on {dev}")
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
    return ptrs, strides


def launch_limits(lib, entry: str, has_eq: bool = False):
    """``(threads, blocks_per_sm, inverse_entries_per_thread)`` that the
    library builds ``entry``'s kernel for (csrc/ipm_launch.inl), with or
    without stage equalities: threads per block, blocks that share an SM,
    and the SPD inverse's tableau entries that one thread keeps in
    registers."""
    out = (ctypes.c_int * 3)()
    kernel = 0 if entry != FLEET_ENTRY else 2 if has_eq else 1
    lib.cheeta_ipm_launch_limits(kernel, out)
    return tuple(out)


def inverse_form(lib, n: int) -> str:
    """The form the kernels' SPD inverse takes at width ``n``, as the
    library builds it: ``"warp"`` (one warp's registers) or ``"block"``."""
    return "warp" if lib.cheeta_ipm_inverse_form(int(n)) else "block"


def spd_inverse_probe(M: torch.Tensor, block_form: bool = False):
    """Run csrc/spd_inverse_probe.cu, which no solve launches, on a
    ``(batch, n, n)`` float32 CUDA tensor: each matrix inverted by one
    block of K1's threads with the scales the kernels take, in the form the
    kernels take at width n (``block_form`` False) or in the block form
    (True). Returns the inverses and each block's clock64 cycles for the
    inverse alone; synchronizes nothing."""
    from cheeta_mpc_tpu_torch.native.build import check_launch, load_library
    _check(M.dim() == 3 and M.shape[-1] == M.shape[-2],
           f"M has shape {tuple(M.shape)}, expected (batch, n, n)")
    _check(M.is_cuda and M.dtype == torch.float32 and M.is_contiguous(),
           "M must be a contiguous float32 CUDA tensor", TypeError)
    lib = load_library()
    out = torch.empty_like(M)
    cycles = torch.empty(M.shape[0], dtype=torch.int64, device=M.device)
    with torch.cuda.device(M.device):
        code = lib.cheeta_spd_inverse_probe(
            M.data_ptr(), out.data_ptr(), cycles.data_ptr(), M.shape[0],
            M.shape[-1], int(block_form),
            torch.cuda.current_stream(M.device).cuda_stream)
    check_launch(lib, code, "cheeta_spd_inverse_probe")
    return out, cycles


def shared_memory_plan(lib, entry: str, shape, iters: int, device):
    """``(placement, dims, bytes)`` for ``entry``'s kernel on a problem of
    ``shape = (N, nx, nu, ng, nc)``: the first of ``PLACEMENTS`` whose
    dynamic shared memory fits the block's share of an SM (the kernel's
    blocks per SM), the dims array the launchers take, and the bytes.
    Raises if even the smallest does not fit."""
    props = torch.cuda.get_device_properties(device)
    # What a block may opt in to (232,448 bytes on sm_90), and what an SM
    # holds for all its blocks (233,472, of which 1 KB per block is the
    # system's).
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    blocks_per_sm = launch_limits(lib, entry, shape[4] > 0)[1]
    limit = min(optin, per_sm // blocks_per_sm - 1024)
    for placement, in_shared in PLACEMENTS:
        dims = (ctypes.c_int * 6)(*shape, iters)
        smem = 4 * lib.cheeta_ipm_smem_floats(dims, int(in_shared))
        if smem <= limit:
            return placement, dims, smem
    N, nx, nu, ng, nc = shape
    raise RuntimeError(
        f"{entry} needs {smem} bytes of shared memory per block for N={N}, "
        f"nx={nx}, nu={nu}, ng={ng}, nc={nc} even with the Riccati factors "
        f"in global memory; {blocks_per_sm} block(s) per SM leave {limit}")


def launch_ipm_kernel(entry: str, data: OcpQpData, settings: IpmSettings,
                      batch: Optional[int], gains: bool,
                      timers: Optional[torch.Tensor] = None):
    """Check the tensors, allocate outputs and launch one of the two IPM
    kernels on the current stream. ``batch`` is None for an unbatched
    problem; otherwise every tensor either leads with ``batch`` or has no
    batch dimension (shared by all problems). ``timers``, an int64 tensor
    of ``(blocks, len(PHASE_CLASSES) + 1)``, selects the instantiation with
    section timers (:func:`phase_cycles`). Returns the dict of raw output
    tensors. Does not synchronize."""
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
    ptrs, strides = tensor_pointers(named, dev, batch)
    lib = load_library()
    threads, _, per_thread = launch_limits(lib, entry, nc > 0)
    nmax = max(nu, nc)
    _check(nmax * nmax <= per_thread * threads,
           f"nu={nu}, nc={nc}: the kernel's SPD inverse keeps {per_thread} "
           f"tableau entries per thread in {threads} threads, so "
           f"max(nu, nc)^2 must be <= {per_thread * threads}")
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

    s = dtype_clamps(settings, torch.float32)
    params = (ctypes.c_float * 7)(s.tau, s.mu0, s.s0_min, s.reg, EQ_EPS,
                                  s.w_max, s.mu_tol)
    placement, dims, smem = shared_memory_plan(
        lib, entry, (N, nx, nu, ng, nc), int(s.iters), dev)
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
            None if timers is None else timers.data_ptr(),
            dims, params, nb, threads, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, entry)
    return out


def _entry_data(entry: str, data: OcpQpData):
    """(data as the entry's kernel takes it, batch or None)."""
    return _masked_eq(data), (data.dx0.shape[0] if entry == FLEET_ENTRY
                              else None)


def section_times(launch, timers: torch.Tensor, classes) -> dict:
    """Three calls of ``launch(timers)`` (the timed instantiation: thread 0
    of every block charges the cycles of each barrier phase to its class)
    alternating with three of ``launch(None)`` (the plain one) on the same
    inputs, after one timed call that loads the instantiation. ``timers``
    is the int64 ``(blocks, len(classes) + 1)`` buffer the kernel fills.
    Returns the cycles per class summed over the blocks, each class's
    share of the summed whole-kernel cycles, the whole kernel's cycles of
    the slowest block, and the median ms (CUDA events) of the timed and of
    the plain launches: their ratio is what the timers cost."""

    def timed_call(timed: bool) -> float:
        if timed:
            timers.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(timers if timed else None)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    timed_call(True)  # the timed instantiation's first launch loads it
    ms = {True: [], False: []}
    for _ in range(3):
        for timed in (True, False):
            ms[timed].append(timed_call(timed))
    t = timers.cpu()
    tot = t.sum(dim=0).tolist()
    whole = max(1, tot[-1])
    return {"cycles": dict(zip(classes, tot[:-1])),
            "share": {c: round(v / whole, 4)
                      for c, v in zip(classes, tot[:-1])},
            "kernel_cycles_max_block": int(t[:, -1].max()),
            "blocks": t.shape[0],
            "timed_ms": sorted(ms[True])[1],
            "untimed_ms": sorted(ms[False])[1]}


def phase_cycles(entry: str, data: OcpQpData,
                 settings: IpmSettings) -> dict:
    """:func:`section_times` of ``entry`` (``"cheeta_ipm_riccati_single"``
    or ``"cheeta_ipm_riccati_fleet"``) on ``data``. Not counted in the
    solvers' launch counters."""
    data, batch = _entry_data(entry, data)
    nb = 1 if batch is None else batch
    timers = torch.zeros((nb, len(PHASE_CLASSES) + 1), dtype=torch.int64,
                         device=data.dx0.device)
    return section_times(
        lambda t: launch_ipm_kernel(entry, data, settings, batch,
                                    gains=entry != FLEET_ENTRY, timers=t),
        timers, PHASE_CLASSES)


def launch_occupancy(entry: str, data: OcpQpData,
                     settings: IpmSettings) -> dict:
    """What the card makes of ``entry``'s launch at this problem's shape:
    the placement, threads and shared bytes per block, resident blocks per
    SM, registers and spill bytes per thread, and the form of the SPD
    inverse at each width it runs (``nu``; ``nc`` with stage
    equalities)."""
    from cheeta_mpc_tpu_torch.native.build import check_launch, load_library
    data, _ = _entry_data(entry, data)
    lib = load_library()
    eq = data.eq
    nc = 0 if eq is None else eq.nc
    shape = (data.dyn.horizon, data.dyn.nx, data.dyn.nu, data.con.ng, nc)
    s = dtype_clamps(settings, torch.float32)
    dev = data.dx0.device
    placement, _, smem = shared_memory_plan(lib, entry, shape, int(s.iters),
                                            dev)
    threads = launch_limits(lib, entry, nc > 0)[0]
    res = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        check_launch(lib, getattr(lib, entry + "_occupancy")(
            int(dict(PLACEMENTS)[placement]), int(nc > 0), threads, smem, res),
            entry + " occupancy")
    return {"placement": placement, "threads": threads,
            "shared_bytes": smem,
            "blocks_per_sm": res[0], "registers": res[1],
            "spill_bytes": res[2],
            "inverse_form": {name: inverse_form(lib, n)
                             for name, n in (("nu", shape[2]), ("nc", nc))
                             if n}}


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
           "solve_ocp_qp_kernel needs inequality rows (data.con); an "
           "inequality-free QP with stage equalities goes to the "
           "equality-Riccati kernels (ops.cuda_eq_riccati."
           "solve_eq_lqr_kernel, ops.cuda_eq_batch.solve_eq_lqr_fleet)")
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
