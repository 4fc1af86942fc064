"""CSR / CSC compressed sparse matrices (the central format).

Port of ``sparse_tpu/formats/csr.py`` (reference ``mk_compressed``,
compressed.fut:61-332):

* static stored capacity ``nse``: ``data``/``indices`` have length ``nse``,
  ``indptr`` is an exclusive prefix of length n+1 (``indptr[n]`` = valid
  entry count); padding entries sit at the tail with ``indices == 0`` and
  ``data == 0``;
* CSC is the same tensors reinterpreted, so ``transpose`` is O(1)
  (compressed.fut:185-226) and ``csc_vsmm`` is ``csr_smvm`` of the stored
  CSR;
* ``csr_smvm`` is gather + deterministic segment-sum, the semantic baseline
  of every faster SpMV path in ``sparse_tpu_torch.ops``.

Construction sums duplicate triples (compressed.fut:154-160) and ``nnz``
counts only non-zero stored values (compressed.fut:162-164).  ``CSR @ CSC``
is SpGEMM (``ops/spgemm.py``), as in the reference.  ``+``/``-`` merge by
COO concatenation and rebuild, so cancellations stay stored as explicit
zeros (compressed.fut:179-183); the result's capacity is nse(a) + nse(b).
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..ops.segmented import INDEX_DTYPE, row_ids_from_indptr, segment_sum
from .coo import (
    COO,
    coo_concatenate,
    coo_from_dense,
    coo_from_triples,
    coo_normalize,
    coo_todense,
    coo_transpose,
)

__all__ = [
    "CSR",
    "CSC",
    "csr_empty",
    "csr_eye",
    "csr_diag",
    "csr_compact",
    "csr_from_coo",
    "csr_from_dense",
    "csr_from_triples",
    "csr_to_coo",
    "csr_todense",
    "csr_smvm",
    "csr_scale",
    "csr_add",
    "csr_sub",
    "csr_diagonal",
    "csr_nnz",
    "csr_transpose",
    "csc_empty",
    "csc_eye",
    "csc_diag",
    "csc_from_coo",
    "csc_from_triples",
    "csc_from_dense",
    "csc_to_coo",
    "csc_todense",
    "csc_vsmm",
    "csc_scale",
    "csc_add",
    "csc_sub",
    "csc_nnz",
    "csc_transpose",
]


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with static capacity.

    ``indptr``: [n+1] exclusive prefix; ``indices``: [nse] column ids;
    ``data``: [nse] values.  Rows are sorted; within a row columns are sorted
    and unique (guaranteed by construction through :func:`csr_from_coo`).
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple[int, int]

    @property
    def nse(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __matmul__(self, other):
        if isinstance(other, CSC):
            from ..ops.spgemm import spgemm

            return spgemm(self, other)
        other = torch.as_tensor(other, device=self.device)
        if other.dim() == 1:
            return csr_smvm(self, other)
        if other.dim() == 2:
            from ..ops.spmm import spmm

            return spmm(self, other)
        return NotImplemented

    def __add__(self, other: "CSR") -> "CSR":
        return csr_add(self, other)

    def __sub__(self, other: "CSR") -> "CSR":
        return csr_sub(self, other)

    def __mul__(self, v) -> "CSR":
        return csr_scale(v, self)

    __rmul__ = __mul__

    @property
    def T(self) -> "CSC":
        return csr_transpose(self)

    def todense(self) -> torch.Tensor:
        return csr_todense(self)

    def tocoo(self) -> COO:
        return csr_to_coo(self)

    def nnz(self) -> torch.Tensor:
        return csr_nnz(self)


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column matrix of logical shape ``shape=(n, m)``:
    the tensors are a CSR of the transpose (m x n)."""

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple[int, int]

    @property
    def nse(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __add__(self, other: "CSC") -> "CSC":
        return csc_add(self, other)

    def __sub__(self, other: "CSC") -> "CSC":
        return csc_sub(self, other)

    def __mul__(self, v) -> "CSC":
        return csc_scale(v, self)

    __rmul__ = __mul__

    def __rmatmul__(self, v):
        v = torch.as_tensor(v, device=self.device)
        if v.dim() == 1:
            return csc_vsmm(v, self)
        return NotImplemented

    @property
    def T(self) -> "CSR":
        return csc_transpose(self)

    def todense(self) -> torch.Tensor:
        return csc_todense(self)

    def tocoo(self) -> COO:
        return csc_to_coo(self)

    def nnz(self) -> torch.Tensor:
        return csc_nnz(self)


# -- transpose duality (O(1), no data movement) ------------------------------


def csr_transpose(a: CSR) -> CSC:
    """CSR(n, m) -> CSC(m, n), zero cost (reference compressed.fut:185-186)."""
    n, m = a.shape
    return CSC(data=a.data, indices=a.indices, indptr=a.indptr, shape=(m, n))


def csc_transpose(a: CSC) -> CSR:
    n, m = a.shape
    return CSR(data=a.data, indices=a.indices, indptr=a.indptr, shape=(m, n))


def _csc_as_csr_t(a: CSC) -> CSR:
    """View the CSC's storage as the CSR of its transpose."""
    return csc_transpose(a)


# -- constructors -------------------------------------------------------------


def csr_empty(n: int, m: int, nse: int = 0, dtype=torch.float32, *,
              device=None) -> CSR:
    """The zero matrix (reference ``zero``, compressed.fut:98-103), with an
    optional pre-allocated capacity, on ``device`` (default CUDA)."""
    device = resolve_device(device)
    return CSR(data=torch.zeros(nse, dtype=dtype, device=device),
               indices=torch.zeros(nse, dtype=INDEX_DTYPE, device=device),
               indptr=torch.zeros(n + 1, dtype=INDEX_DTYPE, device=device),
               shape=(n, m))


def csr_eye(n: int, m: int, dtype=torch.float32, *, device=None) -> CSR:
    """Identity (reference ``eye``, compressed.fut:105-113), on ``device``
    (default CUDA)."""
    device = resolve_device(device)
    e = min(n, m)
    indptr = torch.cat([torch.arange(e + 1, dtype=INDEX_DTYPE, device=device),
                        torch.full((n - e,), e, dtype=INDEX_DTYPE,
                                   device=device)])
    return CSR(data=torch.ones(e, dtype=dtype, device=device),
               indices=torch.arange(e, dtype=INDEX_DTYPE, device=device),
               indptr=indptr, shape=(n, m))


def csr_diag(v, *, device=None) -> CSR:
    """Diagonal matrix from a vector (reference ``diag``,
    compressed.fut:115), on ``device``, else ``v``'s device, else CUDA."""
    v = torch.as_tensor(v, device=resolve_device(device, v))
    n = v.shape[0]
    return CSR(data=v,
               indices=torch.arange(n, dtype=INDEX_DTYPE, device=v.device),
               indptr=torch.arange(n + 1, dtype=INDEX_DTYPE, device=v.device),
               shape=(n, n))


def csr_from_coo(a: COO) -> CSR:
    """CSR from (possibly unsorted, duplicated) COO: sort + sum duplicates +
    compress (reference ``sparse``, compressed.fut:154-160).  Runs on the
    COO's device; capacity = input capacity."""
    n, m = a.shape
    a = coo_normalize(a)
    valid = a.row < n
    # rows are sorted with padding (row n) last: indptr[i] = #entries < row i
    bounds = torch.arange(n + 1, dtype=torch.long, device=a.device)
    indptr = torch.searchsorted(a.row.long(), bounds).to(INDEX_DTYPE)
    indices = torch.where(valid, a.col, torch.zeros_like(a.col))
    return CSR(data=a.data, indices=indices.to(INDEX_DTYPE), indptr=indptr,
               shape=(n, m))


def csr_from_triples(n: int, m: int, triples, dtype=None, *,
                     device=None) -> CSR:
    """Eager construction from python triples with host-side bounds checks
    (reference README.md:16-18: ``sparse 2 3 [(0,0,2),(1,2,3)]``)."""
    return csr_from_coo(coo_from_triples(n, m, triples, dtype=dtype,
                                         device=device))


def csr_from_dense(x, nse: int | None = None, *, device=None) -> CSR:
    return csr_from_coo(coo_from_dense(x, nse=nse, device=device))


# -- conversions ---------------------------------------------------------------


def csr_to_coo(a: CSR) -> COO:
    """Recover COO triples (reference ``coo``, compressed.fut:166-177)."""
    n, m = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse)
    valid = rows < n
    cols = torch.where(valid, a.indices.to(INDEX_DTYPE),
                       torch.full_like(rows, m))
    return COO(row=rows, col=cols, data=a.data, shape=(n, m))


def csr_todense(a: CSR) -> torch.Tensor:
    """Dense conversion (reference ``dense``, compressed.fut:122-132)."""
    return coo_todense(csr_to_coo(a))


# -- core ops -------------------------------------------------------------------


def csr_smvm(a: CSR, v) -> torch.Tensor:
    """Sparse matrix-vector multiply: gather + deterministic segment-sum
    (reference ``smvm``, compressed.fut:134-146).  The semantic baseline and
    small-size fallback; the fast paths live in ``sparse_tpu_torch.ops``."""
    n, m = a.shape
    v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (m,):
        raise ValueError(f"smvm: vector shape {tuple(v.shape)} != ({m},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if a.nse == 0 or m == 0:
        return torch.zeros(n, dtype=out_dtype, device=a.device)
    rows = row_ids_from_indptr(a.indptr, a.nse)
    prods = a.data.to(out_dtype) * v.to(out_dtype)[a.indices.long()]
    return segment_sum(prods, rows, n, indices_are_sorted=True)


def csr_scale(v, a: CSR) -> CSR:
    """Scale all elements (reference ``scale``, compressed.fut:148-152)."""
    return dataclasses.replace(a, data=a.data * v)


def csr_add(a: CSR, b: CSR) -> CSR:
    """Element-wise add by COO concatenation + rebuild: the duplicate sum
    performs the addition (reference ``+``, compressed.fut:179-180).
    Capacity of the result = nse(a) + nse(b)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return csr_from_coo(coo_concatenate(csr_to_coo(a), csr_to_coo(b)))


def csr_sub(a: CSR, b: CSR) -> CSR:
    """Element-wise subtract (reference ``-``, compressed.fut:182-183)."""
    return csr_add(a, csr_scale(-1, b))


def csr_diagonal(a: CSR) -> torch.Tensor:
    """The main diagonal as a dense vector (stored zeros included; absent
    entries are 0)."""
    n, m = a.shape
    k = min(n, m)
    if a.nse == 0 or k == 0:
        return torch.zeros(k, dtype=a.dtype, device=a.device)
    rows = row_ids_from_indptr(a.indptr, a.nse)
    on_diag = (rows < n) & (a.indices == rows)
    contrib = torch.where(on_diag, a.data, torch.zeros_like(a.data))
    return segment_sum(contrib, rows, n, indices_are_sorted=True)[:k]


def csr_compact(a: CSR) -> CSR:
    """Trim capacity to the exact valid entry count (host sync)."""
    k = int(a.indptr[-1])
    return CSR(data=a.data[:k], indices=a.indices[:k], indptr=a.indptr,
               shape=a.shape)


def csr_nnz(a: CSR) -> torch.Tensor:
    """Number of stored values that are non-zero (compressed.fut:162-164)."""
    n, _ = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse)
    return torch.sum((rows < n) & (a.data != 0)).to(INDEX_DTYPE)


# -- CSC: delegation through the transpose duality ----------------------------


def csc_empty(n: int, m: int, nse: int = 0, dtype=torch.float32, *,
              device=None) -> CSC:
    return csr_transpose(csr_empty(m, n, nse, dtype, device=device))


def csc_eye(n: int, m: int, dtype=torch.float32, *, device=None) -> CSC:
    return csr_transpose(csr_eye(m, n, dtype, device=device))


def csc_diag(v, *, device=None) -> CSC:
    return csr_transpose(csr_diag(v, device=device))


def csc_from_coo(a: COO) -> CSC:
    return csr_transpose(csr_from_coo(coo_transpose(a)))


def csc_from_triples(n: int, m: int, triples, dtype=None, *,
                     device=None) -> CSC:
    swapped = [(c, r, v) for (r, c, v) in triples]
    return csr_transpose(csr_from_triples(m, n, swapped, dtype=dtype,
                                          device=device))


def csc_from_dense(x, nse: int | None = None, *, device=None) -> CSC:
    x = torch.as_tensor(x, device=resolve_device(device, x))
    return csr_transpose(csr_from_dense(x.T, nse=nse))


def csc_to_coo(a: CSC) -> COO:
    return coo_transpose(csr_to_coo(_csc_as_csr_t(a)))


def csc_todense(a: CSC) -> torch.Tensor:
    return csr_todense(_csc_as_csr_t(a)).T


def csc_vsmm(v, a: CSC) -> torch.Tensor:
    """Vector-matrix multiply v . A (reference ``vsmm``, compressed.fut:223)."""
    return csr_smvm(_csc_as_csr_t(a), v)


def csc_scale(v, a: CSC) -> CSC:
    return dataclasses.replace(a, data=a.data * v)


def csc_add(a: CSC, b: CSC) -> CSC:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return csr_transpose(csr_add(_csc_as_csr_t(a), _csc_as_csr_t(b)))


def csc_sub(a: CSC, b: CSC) -> CSC:
    return csc_add(a, csc_scale(-1, b))


def csc_nnz(a: CSC) -> torch.Tensor:
    return csr_nnz(_csc_as_csr_t(a))
