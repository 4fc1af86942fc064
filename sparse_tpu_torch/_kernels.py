"""Build and load the package's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The build runs at
first use, into the package's ``_build/`` directory (listed in
``.gitignore``); the library is named after a hash of the sources and the
flags, so an edited source rebuilds.  There is no fallback: without
``nvcc`` or with a failing compile, :func:`load` raises.

Every entry point takes device pointers and the CUDA stream as
``c_void_p``, sizes as ``c_longlong``/``c_int``, launches on that stream
without synchronising, and returns ``cudaGetLastError()`` (0 = launched).
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

__all__ = ["SOURCES", "NVCC_FLAGS", "find_nvcc", "library_path", "build",
           "load", "check"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"

#: Compiled together into one library (``segtile_common.cuh`` is included).
SOURCES = ("segtile_csr.cu", "segtile_block.cu")
_HEADERS = ("segtile_common.cuh",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# name -> argtypes.  Pointer arguments are c_void_p (a Python int from
# Tensor.data_ptr()); the last argument is the cudaStream_t.
_SIGNATURES = {
    # vals, q, seg_of, order, tile_ptr, v, partial, y, n_tiles, m, nbR, stream
    "segtile_csr_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P),
    "segtile_csr_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P),
    # vals, q, seg_of, order, tile_ptr, v, partial, y, n_tiles, nb, nbRb,
    # stream
    "segtile_block_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P),
    "segtile_block_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds the last :func:`build` took and the compiler's ``-Xptxas -v``
#: report (registers, shared memory, spills per kernel).
build_seconds: float | None = None
build_log: str = ""


def find_nvcc() -> str | None:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``PATH``, ``/usr/local/cuda``."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.is_file() else None


def library_path() -> Path:
    """Content-addressed path of the library for the current sources."""
    h = hashlib.sha256()
    for name in SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libsparse_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` into :func:`library_path` (skipped when present).
    Raises ``RuntimeError`` when ``nvcc`` is missing or the compile fails."""
    global build_seconds, build_log
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "sparse_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on "
            "PATH); the CUDA kernels are built from csrc/ at first use")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(_CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"sparse_tpu_torch: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error at launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
