"""ctypes binding for the native plan-construction sorts (_plansort.cpp).

A copy of ``sparse_tpu/native/plansort.py`` (the port may not import the
reference package, which imports jax).  Compiled with the ambient g++ on
first use into the package's ignored ``_build/`` directory (written under a
temporary name and renamed, so concurrent test workers never load a
half-written library); every entry point degrades to NumPy when the
toolchain or shared object is unavailable.  These are host-side planning
sorts only: the CUDA kernels are built by ``sparse_tpu_torch._kernels``,
which never falls back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["argsort_u64", "counting_argsort", "seg_tile_layout",
           "seg_tile_layout_ff", "spgemm_schedule", "rcm_order",
           "build_shared"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "_plansort.cpp"
_SO = _HERE.parent / "_build" / "_plansort.so"
_lock = threading.Lock()
_lib = None
_tried = False


def build_shared(src: Path, so: Path) -> ctypes.CDLL:
    """Compile the C++ source ``src`` with g++ into the shared object ``so``
    unless it is up to date, and load it.  The object is written under a
    temporary name and renamed, so concurrent processes never load a
    half-written library.  Raises when g++ or the build fails."""
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = build_shared(_SRC, _SO)
            lib.radix_argsort_u64.restype = ctypes.c_int64
            lib.counting_argsort_i64.restype = ctypes.c_int64
            lib.seg_tile_layout.restype = ctypes.c_int64
            lib.seg_tile_layout_r.restype = ctypes.c_int64
            lib.seg_tile_layout_ff.restype = ctypes.c_int64
            lib.spgemm_schedule.restype = ctypes.c_int64
            lib.rcm_order.restype = ctypes.c_int64
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative integer keys.

    Native stable LSD radix sort when available (~10x NumPy's comparison
    sort on the plan-build hot path), else ``np.argsort(kind="stable")``.
    ``keys`` must be integer-typed with non-negative values fitting u64.
    """
    keys = np.ascontiguousarray(keys)
    if keys.dtype != np.uint64:
        if keys.size and int(keys.min()) < 0:
            raise ValueError("argsort_u64: negative keys")
        keys = keys.astype(np.uint64)
    lib = _load()
    if lib is None:
        return np.argsort(keys, kind="stable")
    out = np.empty(keys.size, np.int64)
    rc = lib.radix_argsort_u64(
        ctypes.c_void_p(keys.ctypes.data),
        ctypes.c_int64(keys.size),
        ctypes.c_void_p(out.ctypes.data),
    )
    if rc != 0:
        return np.argsort(keys, kind="stable")
    return out


def counting_argsort(keys: np.ndarray, nbuckets: int) -> np.ndarray:
    """Stable argsort of integer keys known to lie in [0, nbuckets).

    One counting + one placement pass natively (~4x fewer sweeps than the
    byte radix when buckets are small, e.g. segment-tile ids); NumPy stable
    argsort as the fallback."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load()
    if lib is not None and nbuckets > 0:
        out = np.empty(keys.size, np.int64)
        rc = lib.counting_argsort_i64(
            ctypes.c_void_p(keys.ctypes.data),
            ctypes.c_int64(keys.size),
            ctypes.c_int64(nbuckets),
            ctypes.c_void_p(out.ctypes.data),
        )
        if rc == 0:
            return out
    return np.argsort(keys, kind="stable")


def seg_tile_layout(indptr: np.ndarray, cols: np.ndarray, wsub: int,
                    rows: int = 8):
    """Native segment-tile layout sweep (ops/pallas_csr.build_seg_tiles's
    symbolic pass): returns ``(pos, sub, seg_of, t_rb)`` — per-entry slot
    positions/sublane pointers (in STORAGE order) and per-tile window base /
    row block — or None when the native library is unavailable.  One O(nnz)
    pass; bit-identical tile numbering to the NumPy path.  ``rows`` is the
    row-block height (8 for the original kernel, 32 for the super-block
    kernel; power of two)."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    n = indptr.size - 1
    nnz = int(indptr[-1])
    pos = np.empty(nnz, np.int64)
    sub = np.empty(nnz, np.int8)
    seg_of = np.empty(max(nnz, 1), np.int64)
    t_rb = np.empty(max(nnz, 1), np.int64)
    nt = lib.seg_tile_layout_r(
        ctypes.c_void_p(indptr.ctypes.data),
        ctypes.c_int64(n),
        ctypes.c_void_p(cols.ctypes.data),
        ctypes.c_int64(wsub),
        ctypes.c_int64(rows),
        ctypes.c_void_p(pos.ctypes.data),
        ctypes.c_void_p(sub.ctypes.data),
        ctypes.c_void_p(seg_of.ctypes.data),
        ctypes.c_void_p(t_rb.ctypes.data),
    )
    if nt < 0:
        return None
    return pos, sub, seg_of[:nt], t_rb[:nt]


def seg_tile_layout_ff(indptr: np.ndarray, cols: np.ndarray, wsub: int,
                       rows: int = 8):
    """Native FIRST-FIT segment-tile layout (see _plansort.cpp): greedy
    per-block packing that merges straddle windows and pools spills —
    measured ~25% fewer tiles than the rigid layout on the bench band.
    Returns ``(pos, sub, seg_of, t_rb)`` like :func:`seg_tile_layout`
    (within-tile entry order is column-major — callers re-sort by full slot
    position), or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    n = indptr.size - 1
    nnz = int(indptr[-1])
    pos = np.empty(nnz, np.int64)
    sub = np.empty(nnz, np.int8)
    seg_of = np.empty(max(nnz, 1), np.int64)
    t_rb = np.empty(max(nnz, 1), np.int64)
    nt = lib.seg_tile_layout_ff(
        ctypes.c_void_p(indptr.ctypes.data),
        ctypes.c_int64(n),
        ctypes.c_void_p(cols.ctypes.data),
        ctypes.c_int64(wsub),
        ctypes.c_int64(rows),
        ctypes.c_void_p(pos.ctypes.data),
        ctypes.c_void_p(sub.ctypes.data),
        ctypes.c_void_p(seg_of.ctypes.data),
        ctypes.c_void_p(t_rb.ctypes.data),
    )
    if nt < 0:
        return None
    return pos, sub, seg_of[:nt], t_rb[:nt]


def seg_tile_layout_ff_py(indptr: np.ndarray, cols: np.ndarray, wsub: int,
                          rows: int = 8):
    """Pure-Python reference of :func:`seg_tile_layout_ff` (bit-identical;
    pinned by tests).  O(nnz) Python loop — the degraded fallback when the
    native library is unavailable; fine for test sizes, slow at millions of
    entries."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    n = indptr.size - 1
    R = rows
    slots = R * 128
    nnz = int(indptr[-1])
    pos = np.empty(nnz, np.int64)
    sub = np.empty(nnz, np.int8)
    seg_list: list[int] = []
    rb_list: list[int] = []
    n_tiles = 0
    for rb in range(-(-n // R) if n else 0):
        r0, r1 = rb * R, min(rb * R + R, n)
        if indptr[r0] >= indptr[r1]:
            continue
        ents = []
        for r in range(r0, r1):
            ri = r & (R - 1)
            for p in range(int(indptr[r]), int(indptr[r + 1])):
                ents.append(((int(cols[p]) << 8) | ri, p))
        ents.sort()
        bases: list[int] = []
        ids: list[int] = []
        bits: list[int] = []
        for key, p in ents:
            c, ri = key >> 8, key & 0xFF
            q, lane = c >> 7, c & 127
            slot = ri * 128 + lane
            chosen = -1
            for ti in range(len(bases)):
                if q - bases[ti] >= wsub:
                    continue
                if (bits[ti] >> slot) & 1:
                    continue
                chosen = ti
                break
            if chosen < 0:
                chosen = len(bases)
                bases.append(q)
                ids.append(n_tiles)
                bits.append(0)
                seg_list.append(q)
                rb_list.append(rb)
                n_tiles += 1
            bits[chosen] |= 1 << slot
            pos[p] = ids[chosen] * slots + slot
            sub[p] = q - bases[chosen]
    return (pos, sub, np.asarray(seg_list, np.int64),
            np.asarray(rb_list, np.int64))


def rcm_order(indptr: np.ndarray, cols: np.ndarray) -> np.ndarray | None:
    """Native reverse Cuthill-McKee ordering of an n x n CSR pattern
    (ops/reorder.rcm_order's core): returns ``perm`` with ``perm[k]`` = old
    index at new position k, or None when the native library is unavailable.
    Symmetrizes internally; bit-identical to the NumPy path (tests pin
    this)."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    n = indptr.size - 1
    perm = np.empty(max(n, 1), np.int64)
    rc = lib.rcm_order(
        ctypes.c_void_p(indptr.ctypes.data),
        ctypes.c_int64(n),
        ctypes.c_void_p(cols.ctypes.data),
        ctypes.c_void_p(perm.ctypes.data),
    )
    if rc != 0:
        return None
    return perm[:n]


def spgemm_schedule(a_indptr, a_indices, b_starts, b_cols, b_src,
                    k: int, F: int):
    """Native SpGEMM product schedule (ops/spgemm.spgemm_prepare's symbolic
    pass): returns ``(a_pos, b_pos, seg, out_rows, out_cols)`` with the
    products sorted by output coordinate, or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, np.int64)
    a_indices = np.ascontiguousarray(a_indices, np.int64)
    b_starts = np.ascontiguousarray(b_starts, np.int64)
    b_cols = np.ascontiguousarray(b_cols, np.int64)
    b_src = np.ascontiguousarray(b_src, np.int64)
    n = a_indptr.size - 1
    m = b_starts.size - 1
    a_pos = np.empty(F, np.int64)
    b_pos = np.empty(F, np.int64)
    seg = np.empty(F, np.int64)
    out_rows = np.empty(max(F, 1), np.int64)
    out_cols = np.empty(max(F, 1), np.int64)
    nse = lib.spgemm_schedule(
        ctypes.c_void_p(a_indptr.ctypes.data), ctypes.c_int64(n),
        ctypes.c_void_p(a_indices.ctypes.data),
        ctypes.c_void_p(b_starts.ctypes.data), ctypes.c_int64(m),
        ctypes.c_void_p(b_cols.ctypes.data),
        ctypes.c_void_p(b_src.ctypes.data),
        ctypes.c_int64(k), ctypes.c_int64(F),
        ctypes.c_void_p(a_pos.ctypes.data),
        ctypes.c_void_p(b_pos.ctypes.data),
        ctypes.c_void_p(seg.ctypes.data),
        ctypes.c_void_p(out_rows.ctypes.data),
        ctypes.c_void_p(out_cols.ctypes.data),
    )
    if nse < 0:
        return None
    return a_pos, b_pos, seg, out_rows[:nse], out_cols[:nse]
