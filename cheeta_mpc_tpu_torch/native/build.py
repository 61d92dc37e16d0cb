"""Builds the CUDA kernels of ``csrc/`` at first use and loads them.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into an object
file (one compiler process per source, all started together), the objects
are linked into one shared library with a plain C interface, and the library
is loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds. Output goes to ``cheeta_mpc_tpu_torch/_build/`` under a name that
carries the hash of all sources, so a changed source is rebuilt and an
unchanged one is reused. A build or load failure raises with the compiler's
output; nothing falls back.

Importing this module needs no compiler: the build happens inside
:func:`load_library`, which the kernel wrappers call at their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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

_LAUNCH_ARGTYPES = [
    ctypes.POINTER(_PTR), ctypes.POINTER(_LL),  # inputs, their strides
    ctypes.POINTER(_PTR), ctypes.POINTER(_LL),  # outputs, their strides
    _PTR, _LL,  # factor scratch, its stride
    ctypes.POINTER(_INT), ctypes.POINTER(ctypes.c_float),  # dims, params
    _INT, _INT, _LL, _PTR,  # batch, threads, smem bytes, stream
]


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("cheeta_ipm_riccati_single", "cheeta_ipm_riccati_fleet"):
        fn = getattr(lib, name)
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = _INT
    lib.cheeta_ipm_smem_floats.argtypes = [ctypes.POINTER(_INT), _INT]
    lib.cheeta_ipm_smem_floats.restype = _LL
    lib.cheeta_ipm_factor_floats.argtypes = [ctypes.POINTER(_INT)]
    lib.cheeta_ipm_factor_floats.restype = _LL
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
