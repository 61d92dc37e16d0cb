"""Builds the CUDA kernels of ``csrc/`` and the transport's C++ buses at
first use and loads them.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into an object
file (one compiler process per source, all started together), the objects
are linked into one shared library with a plain C interface, and the library
is loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds. Output goes to ``cheeta_mpc_tpu_torch/_build/`` under a name that
carries the hash of all sources, so a changed source is rebuilt and an
unchanged one is reused. A build or load failure raises with the compiler's
output; nothing falls back.

The two buses of the transport (``native/policy_bus.cpp``, threads of one
process; ``native/shm_bus.cpp``, processes sharing a POSIX shared-memory
segment) are host code: :func:`load_policy_bus` and :func:`load_shm_bus`
build each with ``g++`` into the same directory, under a name that carries
the hash of its source, and load it with ``ctypes``. A failed build raises
:class:`NativeBuildError` with the compiler's output.

Importing this module needs no compiler: the builds happen inside
:func:`load_library`, which the kernel wrappers call at their first launch,
and inside the bus loaders.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # of the build this process ran
build_log: str = ""  # compiler output (registers, shared memory, spills)


class KernelCompileError(RuntimeError):
    """``nvcc`` is missing, failed, or the library did not load."""


class NativeBuildError(RuntimeError):
    """``g++`` is missing or failed for one of the transport's buses."""


def _find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelCompileError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of cheeta_mpc_tpu_torch are built from source at "
        "first use and need the CUDA toolkit")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> None:
    global build_seconds, build_log
    nvcc = _find_nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise KernelCompileError(f"no CUDA sources in {CSRC_DIR}")
    tag = lib_path.stem
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{tag}_{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append("$ " + " ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(obj.name)
    build_log = "\n".join(logs)
    if failed:
        raise KernelCompileError(
            f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]]
    link = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    build_log += "\n$ " + " ".join(cmd) + "\n" + link.stdout
    if link.returncode != 0:
        raise KernelCompileError(f"linking the kernels failed:\n{build_log}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    build_seconds = time.perf_counter() - t0


_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

_IO_ARGTYPES = [
    ctypes.POINTER(_PTR), ctypes.POINTER(_LL),  # inputs, their strides
    ctypes.POINTER(_PTR), ctypes.POINTER(_LL),  # outputs, their strides
]
_SHAPE_ARGTYPES = [
    ctypes.POINTER(_INT), ctypes.POINTER(ctypes.c_float),  # dims, params
    _INT, _INT, _LL, _PTR,  # batch, threads, smem bytes, stream
]
# The interior-point launchers also take the factor scratch, its stride and
# the section-timer buffer (null: the untimed kernel).
_LAUNCH_ARGTYPES = _IO_ARGTYPES + [_PTR, _LL, _PTR] + _SHAPE_ARGTYPES
# The equality-Riccati launchers take the section-timer buffer (null: the
# untimed kernel) and no thread count: the library sets it.
_EQ_LAUNCH_ARGTYPES = _IO_ARGTYPES + [
    _PTR, ctypes.POINTER(_INT), ctypes.POINTER(ctypes.c_float),
    _INT, _LL, _PTR]  # timers, dims, params, batch, smem bytes, stream


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("cheeta_ipm_riccati_single", "cheeta_ipm_riccati_fleet"):
        fn = getattr(lib, name)
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = _INT
    for name in ("cheeta_eq_riccati_single", "cheeta_eq_riccati_fleet"):
        fn = getattr(lib, name)
        fn.argtypes = _EQ_LAUNCH_ARGTYPES
        fn.restype = _INT
    lib.cheeta_eq_smem_floats.argtypes = [ctypes.POINTER(_INT)]
    lib.cheeta_eq_smem_floats.restype = _LL
    lib.cheeta_eq_block_threads.argtypes = []
    lib.cheeta_eq_block_threads.restype = _INT
    for name in ("cheeta_eq_riccati_single_occupancy",
                 "cheeta_eq_riccati_fleet_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = [_LL, ctypes.POINTER(_INT)]
        fn.restype = _INT
    lib.cheeta_ipm_smem_floats.argtypes = [ctypes.POINTER(_INT), _INT]
    lib.cheeta_ipm_smem_floats.restype = _LL
    lib.cheeta_ipm_factor_floats.argtypes = [ctypes.POINTER(_INT)]
    lib.cheeta_ipm_factor_floats.restype = _LL
    lib.cheeta_ipm_launch_limits.argtypes = [_INT, ctypes.POINTER(_INT)]
    lib.cheeta_ipm_launch_limits.restype = None
    lib.cheeta_ipm_inverse_form.argtypes = [_INT]
    lib.cheeta_ipm_inverse_form.restype = _INT
    lib.cheeta_spd_inverse_probe.argtypes = [_PTR, _PTR, _PTR, _INT, _INT,
                                             _INT, _PTR]
    lib.cheeta_spd_inverse_probe.restype = _INT
    for name in ("cheeta_ipm_riccati_single_occupancy",
                 "cheeta_ipm_riccati_fleet_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = [_INT, _INT, _INT, _LL, ctypes.POINTER(_INT)]
        fn.restype = _INT
    lib.cheeta_legged_linearize.argtypes = [
        ctypes.POINTER(_PTR), ctypes.POINTER(_LL),  # inputs, their strides
        ctypes.POINTER(_PTR), ctypes.POINTER(_INT),  # outputs, dims
        ctypes.POINTER(ctypes.c_float), _PTR]  # params, stream
    lib.cheeta_legged_linearize.restype = _INT
    lib.cheeta_legged_linearize_num_params.argtypes = []
    lib.cheeta_legged_linearize_num_params.restype = _INT
    lib.cheeta_legged_linearize_occupancy.argtypes = [ctypes.POINTER(_INT)]
    lib.cheeta_legged_linearize_occupancy.restype = _INT
    lib.cheeta_cuda_error_string.argtypes = [_INT]
    lib.cheeta_cuda_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if its sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    lib_path = BUILD_DIR / f"libcheeta_kernels_{_sources_hash()}.so"
    if not lib_path.exists():
        _build(lib_path)
    try:
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
    except (OSError, AttributeError) as exc:
        raise KernelCompileError(
            f"could not load {lib_path}: {exc}\n{build_log}") from exc
    _lib = lib
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.cheeta_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")


# -- the transport's buses (g++, host code) ---------------------------------

NATIVE_DIR = Path(__file__).resolve().parent
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_bus_lock = threading.Lock()
_buses: dict = {}


def _build_host_library(src: Path, stem: str, extra=()) -> Path:
    """``src`` built with ``g++`` into ``BUILD_DIR``, once per content."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + tuple(extra)).encode())
    h.update(src.read_bytes())
    so_path = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            f"g++ not found on PATH: {src.name} is built from source at "
            "first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(src), "-o", str(tmp), *extra]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed for {src.name}:\n$ {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or none
    return so_path


def _declare_policy_bus(lib: ctypes.CDLL) -> None:
    lib.bus_create.restype = ctypes.c_void_p
    lib.bus_create.argtypes = [ctypes.c_int]
    lib.bus_destroy.restype = None
    lib.bus_destroy.argtypes = [ctypes.c_void_p]
    lib.bus_publish.restype = ctypes.c_int64
    lib.bus_publish.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_uint32]
    lib.bus_consume.restype = ctypes.c_int64
    lib.bus_consume.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_uint32,
                                ctypes.POINTER(ctypes.c_uint32)]
    lib.bus_wait.restype = ctypes.c_int64
    lib.bus_wait.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_uint64, ctypes.c_int]
    lib.bus_seq.restype = ctypes.c_uint64
    lib.bus_seq.argtypes = [ctypes.c_void_p, ctypes.c_int]


def _declare_shm_bus(lib: ctypes.CDLL) -> None:
    lib.shm_bus_create.restype = ctypes.c_void_p
    lib.shm_bus_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_uint32]
    lib.shm_bus_attach.restype = ctypes.c_void_p
    lib.shm_bus_attach.argtypes = [ctypes.c_char_p]
    lib.shm_bus_close.restype = None
    lib.shm_bus_close.argtypes = [ctypes.c_void_p]
    lib.shm_bus_unlink.restype = ctypes.c_int
    lib.shm_bus_unlink.argtypes = [ctypes.c_char_p]
    lib.shm_bus_ntopics.restype = ctypes.c_int
    lib.shm_bus_ntopics.argtypes = [ctypes.c_void_p]
    lib.shm_bus_capacity.restype = ctypes.c_uint32
    lib.shm_bus_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_bus_publish.restype = ctypes.c_int64
    lib.shm_bus_publish.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_uint32]
    lib.shm_bus_consume.restype = ctypes.c_int64
    lib.shm_bus_consume.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.POINTER(ctypes.c_uint32)]
    lib.shm_bus_wait.restype = ctypes.c_int64
    lib.shm_bus_wait.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_uint64, ctypes.c_int]
    lib.shm_bus_seq.restype = ctypes.c_uint64
    lib.shm_bus_seq.argtypes = [ctypes.c_void_p, ctypes.c_int]


def _load_bus(src: str, stem: str, declare, extra=()) -> ctypes.CDLL:
    with _bus_lock:
        lib = _buses.get(stem)
        if lib is None:
            path = _build_host_library(NATIVE_DIR / src, stem, extra)
            try:
                lib = ctypes.CDLL(str(path))
                declare(lib)
            except (OSError, AttributeError) as exc:
                raise NativeBuildError(f"could not load {path}: {exc}") \
                    from exc
            _buses[stem] = lib
        return lib


def load_policy_bus() -> ctypes.CDLL:
    """The in-process seqlock bus (``native/policy_bus.cpp``), built first
    if its source changed."""
    return _load_bus("policy_bus.cpp", "libpolicybus", _declare_policy_bus)


def load_shm_bus() -> ctypes.CDLL:
    """The cross-process shared-memory bus (``native/shm_bus.cpp``), built
    first if its source changed."""
    return _load_bus("shm_bus.cpp", "libshmbus", _declare_shm_bus,
                     extra=("-lrt",))
