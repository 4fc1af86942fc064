"""Build and load the package's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Each source is
compiled by its own ``nvcc`` process, all started together, then one link
makes the library.  The build runs at first use, into the package's
``_build/`` directory (listed in ``.gitignore``); the library is named after
a hash of the sources and the flags, so an edited source rebuilds.  There is
no fallback: without ``nvcc`` or with a failing compile, :func:`load`
raises.

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

__all__ = ["SOURCES", "NVCC_FLAGS", "StreamArgs", "find_nvcc",
           "library_path", "build", "load", "check"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"

#: Linked into one library (the ``.cuh`` headers are included).
SOURCES = ("segtile_csr.cu", "segtile_mxu.cu", "segtile_block.cu",
           "bell_spmm.cu", "bell_banded.cu", "bsr_slab.cu")
_HEADERS = ("segtile_common.cuh", "bell_kinds.cuh",
            "band_body.cuh", "block_body.cuh", "wide_body.cuh",
            "sm90_async.cuh", "sm90_tma.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# name -> argtypes.  Pointer arguments are c_void_p (a Python int from
# Tensor.data_ptr()); the last argument is the cudaStream_t.
_SIGNATURES = {
    # the compact-stream kernels (K1, K1-mxu, K2): the address of the
    # stream's StreamArgs, vals, v, partial, y, stream
    **{f"segtile_{k}_{t}": (_P,) * 6
       for k in ("csr", "block", "mxu") for t in ("f32", "f64", "i32", "bf16")
       if (k, t) != ("mxu", "i32")},
    # kind, blocks, cols, b, c, nb, Lb, bsz, k, stream
    "bell_fused": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P),
    "bell_block": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P),
    # bell_fused's (bell_block's) arguments, then the issued multiply-adds'
    # counter
    "bell_fused_issued": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P, _P),
    "bell_block_issued": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P, _P),
    # kind, tiles, start, b, c, ntiles, M, K, N, bsz, b_rows, stream
    "bell_banded": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P),
    # bell_banded's arguments, then the issued multiply-adds' counter
    "bell_banded_issued": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL,
                           _P, _P),
    # kind, tiles, start, chunk mask, b, c, ntiles, M, K, N, bsz, b_rows,
    # stream; then the same with the issued multiply-adds' counter
    "bell_banded_masked": (_I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL,
                           _LL, _P),
    "bell_banded_masked_issued": (_I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                  _LL, _LL, _P, _P),
    # kind, tiles_t, start, chunk mask, bt, ct, ntiles, M, K, N, bsz,
    # bt_cols, stream
    "bell_banded_t": (_I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL,
                      _P),
    # bell_banded_t's arguments, then two counters: multiply-adds, tile bytes
    "bell_banded_t_issued": (_I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL,
                             _LL, _P, _P),
    # kind, z1, z2, prod_ptr, prod_ab, out, n_out, bsz, issued counter (or
    # null), stream
    "bsr_slab": (_I, _P, _P, _P, _P, _P, _LL, _LL, _P, _P),
    # launched geometry, into a host int array: K1's row kernel (kind 0
    # float32, 1 float64, 2 bf16; lane group; rows of a launch), K7's body
    # (kind, bsz), K3's walk (kind, nb, Lb, bsz, k) and K4's / K8's body
    # (kind, masked, M, K, N)
    "segtile_csr_geometry": (_I, _I, _LL, _P),
    "bsr_slab_geometry": (_I, _LL, _P),
    "bell_fused_geometry": (_I, _LL, _LL, _LL, _LL, _P),
    "bell_banded_geometry": (_I, _I, _LL, _LL, _LL, _P),
}


class StreamArgs(ctypes.Structure):
    """``csrc/segtile_common.cuh``'s ``StreamArgs``: a compact stream's
    arguments that stay the same from call to call (device pointers as
    ints; ``out_rows`` / ``out_long`` 0 but in K2's folded view), built
    once per stream by its wrapper and passed by address."""

    _fields_ = [("cols", _P), ("row_ptr", _P), ("long_rows", _P),
                ("piece_ptr", _P), ("piece_row", _P), ("n_rows", _LL),
                ("n_long", _LL), ("n_pieces", _LL), ("long_min", _I),
                ("piece", _I), ("group", _I), ("out_rows", _P),
                ("out_long", _P)]


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


def _run(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands side by side; wait for all of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    done = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        done.append(subprocess.CompletedProcess(c, p.returncode, out, ""))
    return done


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
    tag = f"{out.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    results = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
                    for s, o in zip(SOURCES, objs)])
    if all(r.returncode == 0 for r in results):
        results += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *[str(o) for o in objs]]])
    build_seconds = time.perf_counter() - t0
    build_log = "".join(r.stdout for r in results)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [r for r in results if r.returncode != 0]
    if failed:
        raise RuntimeError(
            f"sparse_tpu_torch: nvcc failed ({failed[0].returncode}):\n"
            f"{' '.join(failed[0].args)}\n{build_log}")
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
