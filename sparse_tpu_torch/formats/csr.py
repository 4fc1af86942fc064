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
counts only non-zero stored values (compressed.fut:162-164).  The CSR/COO
algebra (``add``/``sub``/``scale``) and the CSC constructors are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.segmented import INDEX_DTYPE, row_ids_from_indptr, segment_sum
from .coo import (
    COO,
    coo_from_dense,
    coo_from_triples,
    coo_normalize,
    coo_todense,
)

__all__ = [
    "CSR",
    "CSC",
    "csr_from_coo",
    "csr_from_dense",
    "csr_from_triples",
    "csr_to_coo",
    "csr_todense",
    "csr_smvm",
    "csr_nnz",
    "csr_transpose",
    "csc_todense",
    "csc_vsmm",
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
        other = torch.as_tensor(other, device=self.device)
        if other.dim() == 1:
            return csr_smvm(self, other)
        return NotImplemented

    @property
    def T(self) -> "CSC":
        return csr_transpose(self)

    def todense(self) -> torch.Tensor:
        return csr_todense(self)


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


# -- transpose duality (O(1), no data movement) ------------------------------


def csr_transpose(a: CSR) -> CSC:
    """CSR(n, m) -> CSC(m, n), zero cost (reference compressed.fut:185-186)."""
    n, m = a.shape
    return CSC(data=a.data, indices=a.indices, indptr=a.indptr, shape=(m, n))


def csc_transpose(a: CSC) -> CSR:
    n, m = a.shape
    return CSR(data=a.data, indices=a.indices, indptr=a.indptr, shape=(m, n))


# -- constructors -------------------------------------------------------------


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


def csr_nnz(a: CSR) -> torch.Tensor:
    """Number of stored values that are non-zero (compressed.fut:162-164)."""
    n, _ = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse)
    return torch.sum((rows < n) & (a.data != 0)).to(INDEX_DTYPE)


# -- CSC: delegation through the transpose duality ----------------------------


def csc_todense(a: CSC) -> torch.Tensor:
    return csr_todense(csc_transpose(a)).T


def csc_vsmm(v, a: CSC) -> torch.Tensor:
    """Vector-matrix multiply v . A (reference ``vsmm``, compressed.fut:223)."""
    return csr_smvm(csc_transpose(a), v)
