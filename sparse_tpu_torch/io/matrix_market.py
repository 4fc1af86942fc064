"""MatrixMarket I/O: the library's serialization format.

Port of ``sparse_tpu/io/matrix_market.py``: the ``matrix coordinate``
(sparse) and ``matrix array`` (dense) formats with real/integer/pattern
fields and general/symmetric/skew-symmetric symmetries.  The body is parsed
on the host (the native parser of :mod:`.fastmm`, else NumPy); the matrix
is then built on ``device`` — CUDA unless the caller asks for another
device — by the port's constructors (sort and duplicate sum there).
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..formats.coo import COO, _np_dtype, coo_make
from ..formats.csr import CSR, csr_from_coo, csr_to_coo
from . import fastmm

__all__ = ["mm_read_coo", "mm_read", "mm_write"]

_FIELD_DTYPES = {
    "real": np.float64,
    "double": np.float64,
    "integer": np.int64,
    "pattern": np.float64,
}


def mm_read_coo(path, dtype=None, *, device=None) -> COO:
    """Read a MatrixMarket file into a (compact, file-order) COO on
    ``device`` (default CUDA).  ``dtype`` (NumPy or torch) overrides the
    field's float64 / int64."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip().lower().split()
        if (len(header) < 5 or header[0] != "%%matrixmarket"
                or header[1] != "matrix"):
            raise ValueError(f"not a MatrixMarket matrix file: {path}")
        fmt, field, symm = header[2], header[3], header[4]
        if field not in _FIELD_DTYPES:
            raise ValueError(f"unsupported MatrixMarket field: {field}")
        line = f.readline().decode()
        while line.startswith("%"):
            line = f.readline().decode()
        dims = line.split()
        body = f.read()
    base_dtype = _FIELD_DTYPES[field]
    out_dtype = base_dtype if dtype is None else _np_dtype(dtype)
    if fmt == "coordinate":
        n, m, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        native = fastmm.parse_coordinate(body, nnz, field == "pattern")
        if native is not None:
            rows, cols, vals = native
            vals = vals.astype(base_dtype)
        else:
            raw = (np.loadtxt(_io.BytesIO(body), ndmin=2) if nnz
                   else np.zeros((0, 3)))
            rows = raw[:, 0].astype(np.int64) - 1
            cols = raw[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(rows.shape[0], base_dtype)
            else:
                vals = raw[:, 2].astype(base_dtype)
        if symm in ("symmetric", "skew-symmetric"):
            off = rows != cols
            sign = -1 if symm == "skew-symmetric" else 1
            rows, cols = (np.concatenate([rows, cols[off]]),
                          np.concatenate([cols, rows[off]]))
            vals = np.concatenate([vals, sign * vals[off]])
        elif symm != "general":
            raise ValueError(f"unsupported MatrixMarket symmetry: {symm}")
    elif fmt == "array":
        n, m = int(dims[0]), int(dims[1])
        vals_all = np.loadtxt(_io.BytesIO(body)).reshape(-1).astype(
            base_dtype)
        if symm == "general":
            dense = vals_all.reshape(m, n).T  # column-major storage
        elif symm in ("symmetric", "skew-symmetric"):
            dense = np.zeros((n, m), base_dtype)
            r, c = np.tril_indices(n)
            dense[r, c] = vals_all
            sign = -1 if symm == "skew-symmetric" else 1
            off = r != c
            dense[c[off], r[off]] = sign * vals_all[off]
        else:
            raise ValueError(f"unsupported MatrixMarket symmetry: {symm}")
        rows, cols = np.nonzero(dense)
        vals = dense[rows, cols]
    else:
        raise ValueError(f"unsupported MatrixMarket format: {fmt}")
    data = torch.from_numpy(np.ascontiguousarray(vals.astype(out_dtype)))
    if isinstance(dtype, torch.dtype):
        data = data.to(dtype)  # bfloat16 is held as float32 on the host
    return coo_make((n, m), torch.from_numpy(rows.astype(np.int64)),
                    torch.from_numpy(cols.astype(np.int64)), data,
                    device=resolve_device(device))


def mm_read(path, dtype=None, *, device=None) -> CSR:
    """Read a MatrixMarket file as CSR on ``device`` (default CUDA)."""
    return csr_from_coo(mm_read_coo(path, dtype=dtype, device=device))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mm_write(path, a, comment: str | None = None) -> None:
    """Write a COO or CSR (valid entries only) as ``coordinate general``."""
    if isinstance(a, CSR):
        a = csr_to_coo(a)
    if not isinstance(a, COO):
        raise TypeError(f"mm_write: expected COO or CSR, got {type(a)}")
    n, m = a.shape
    rows = _host(a.row)
    cols = _host(a.col)
    vals = _host(a.data)
    keep = rows < n
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    field = "integer" if np.issubdtype(vals.dtype, np.integer) else "real"
    path = Path(path)
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{n} {m} {rows.shape[0]}\n")
        for r, c, v in zip(rows, cols, vals):
            if field == "integer":
                f.write(f"{r + 1} {c + 1} {int(v)}\n")
            else:
                f.write(f"{r + 1} {c + 1} {float(v):.17g}\n")
