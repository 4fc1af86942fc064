"""ctypes binding for the native MatrixMarket body parser (_fastmm.cpp).

A copy of ``sparse_tpu/io/fastmm.py`` (the port may not import the
reference package, which imports jax), with ``_fastmm.cpp`` copied
verbatim.  ``mm_read`` parses array bodies with NumPy, as the reference
does; ``parse_array`` binds the array entry, as the reference's does.
Compiled with the ambient g++ on first use into the package's ignored
``_build/`` directory by ``native.plansort.build_shared``; every entry
point returns None when the toolchain or shared object is unavailable, and
the caller parses with NumPy instead.  This is host parsing: the parsed
entries go to the device afterwards.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..native.plansort import build_shared

__all__ = ["parse_coordinate", "parse_array"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "_fastmm.cpp"
_SO = _HERE.parent / "_build" / "_fastmm.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = build_shared(_SRC, _SO)
            lib.parse_mm_coordinate.restype = ctypes.c_int64
            lib.parse_mm_array.restype = ctypes.c_int64
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def parse_coordinate(body: bytes, nnz: int, pattern: bool):
    """Parse a coordinate body natively; returns (rows, cols, vals) 0-based
    or None when the native parser is unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    vals = np.empty(nnz, np.float64)
    buf = np.frombuffer(body, np.uint8)
    got = lib.parse_mm_coordinate(
        ctypes.c_void_p(buf.ctypes.data),
        ctypes.c_int64(len(body)),
        ctypes.c_int64(nnz),
        ctypes.c_void_p(rows.ctypes.data),
        ctypes.c_void_p(cols.ctypes.data),
        ctypes.c_void_p(vals.ctypes.data),
        ctypes.c_int(1 if pattern else 0),
    )
    if got != nnz:
        raise ValueError(
            f"MatrixMarket body malformed: parsed {got} of {nnz} entries"
        )
    return rows, cols, vals


def parse_array(body: bytes, count: int):
    """Parse an array body natively; returns ``count`` float64 values, or
    None when the native parser is unavailable."""
    lib = _load()
    if lib is None:
        return None
    vals = np.empty(count, np.float64)
    buf = np.frombuffer(body, np.uint8)
    got = lib.parse_mm_array(
        ctypes.c_void_p(buf.ctypes.data),
        ctypes.c_int64(len(body)),
        ctypes.c_int64(count),
        ctypes.c_void_p(vals.ctypes.data),
    )
    if got != count:
        raise ValueError(
            f"MatrixMarket array body malformed: parsed {got} of {count}"
        )
    return vals
