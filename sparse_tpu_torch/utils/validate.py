"""Invariant validation: the debug-mode mirror of the reference's hard
``assert`` scheme (SURVEY.md §5.3).

Port of ``sparse_tpu/utils/validate.py``.  The reference aborts on violated
invariants (COO bounds compressed.fut:156, one-per-row mono.fut:122-125,
named asserts blocked_square_regular.fut:175-177).  These checkers copy a
whole structure to the host and check it with NumPy, raising
:class:`SparseInvariantError` with a precise message; the hot paths stay
assertion-free.
"""

from __future__ import annotations

import numpy as np

from ..formats.bell import BELL
from ..formats.bsr import BSR
from ..formats.coo import COO
from ..formats.csr import CSC, CSR, _csc_as_csr_t
from ..formats.mono import MSR

__all__ = ["SparseInvariantError", "validate_coo", "validate_csr",
           "validate_csc", "validate_bsr", "validate_msr", "validate_bell"]


class SparseInvariantError(AssertionError):
    pass


def _fail(msg: str):
    raise SparseInvariantError(msg)


def _host(x) -> np.ndarray:
    """An integer tensor as a NumPy array on the host."""
    return x.detach().cpu().numpy()


def _nonzero_values(x) -> np.ndarray:
    """Mask of the values that are not 0 (+0 or -0), any dtype (bf16
    included) on the host."""
    return x.detach().cpu().ne(0).numpy()


def validate_coo(a: COO) -> None:
    """Entries in bounds or exact padding sentinels; padding data zero."""
    n, m = a.shape
    row = _host(a.row)
    col = _host(a.col)
    nonzero = _nonzero_values(a.data)
    pad = row == n
    if np.any((row < 0) | (row > n)):
        _fail(f"COO row ids outside [0, {n}]")
    if np.any(~pad & ((col < 0) | (col >= m))):
        _fail(f"COO column ids outside [0, {m}) on valid entries")
    if np.any(pad & (col != m)):
        _fail("COO padding entries must carry the column sentinel")
    if np.any(pad & nonzero):
        _fail("COO padding entries must carry zero data")


def validate_csr(a: CSR) -> None:
    """indptr a monotone exclusive prefix; indices in bounds, sorted and
    unique within rows on valid entries; padding zeroed."""
    n, m = a.shape
    indptr = _host(a.indptr).astype(np.int64)
    indices = _host(a.indices).astype(np.int64)
    nonzero = _nonzero_values(a.data)
    if indptr.shape != (n + 1,):
        _fail(f"CSR indptr shape {indptr.shape} != ({n + 1},)")
    if indptr[0] != 0 or np.any(np.diff(indptr) < 0):
        _fail("CSR indptr must be a monotone exclusive prefix starting at 0")
    k = int(indptr[-1])
    if k > a.nse:
        _fail(f"CSR valid count {k} exceeds capacity {a.nse}")
    if k and (indices[:k].min() < 0 or indices[:k].max() >= m):
        _fail(f"CSR column ids outside [0, {m})")
    # consecutive entries of one row must have increasing columns
    rows = np.repeat(np.arange(n), np.diff(indptr))
    same_row = rows[1:] == rows[:-1]
    bad = same_row & (np.diff(indices[:k]) <= 0)
    if np.any(bad):
        _fail(f"CSR row {rows[1:][bad][0]}: columns not strictly increasing")
    if np.any(indices[k:] != 0) or np.any(nonzero[k:]):
        _fail("CSR padding tail must be zeroed")


def validate_csc(a: CSC) -> None:
    validate_csr(_csc_as_csr_t(a))


def validate_msr(a: MSR) -> None:
    """One stored element per row, in bounds (mono.fut:122-125)."""
    n, m = a.shape
    col = _host(a.col_idx)
    if col.shape != (n,) or tuple(a.vals.shape) != (n,):
        _fail(f"MSR arrays must have one slot per row ({n})")
    if n and m == 0 and np.any(_nonzero_values(a.vals)):
        _fail("MSR with zero columns must be all-zero")
    if n and m > 0 and (col.min() < 0 or col.max() >= m):
        _fail(f"MSR column ids outside [0, {m})")


def validate_bsr(a: BSR) -> None:
    """Indices sorted, unique, in bounds or sentinel; padding blocks zero;
    bsz | n (blocked_square_regular.fut:175, 185)."""
    if a.n % a.bsz != 0:
        _fail(f"BSR block size {a.bsz} must divide n={a.n}")
    idxs = _host(a.indices).astype(np.int64)
    sent = a.sentinel
    valid = idxs < sent
    if np.any(idxs < 0) or np.any(idxs > sent):
        _fail(f"BSR indices outside [0, {sent}]")
    vi = idxs[valid]
    if vi.size and np.any(np.diff(idxs) < 0):
        _fail("BSR indices must be sorted ascending (sentinels last)")
    if vi.size != np.unique(vi).size:
        _fail("BSR valid block indices must be unique")
    if np.any(_nonzero_values(a.blocks)[~valid]):
        _fail("BSR padding blocks must be zero")


def validate_bell(a) -> None:
    """BELL invariants: bsz | n, block-column ids in [0, nb), padding slots
    (all-zero blocks) carry column id 0 (formats/bell.py layout
    contract)."""
    if not isinstance(a, BELL):
        _fail(f"validate_bell: expected BELL, got {type(a)}")
    if a.bsz <= 0 or a.n % a.bsz != 0:
        _fail(f"BELL block size {a.bsz} must divide n={a.n}")
    cols = _host(a.cols)
    nb = a.nb
    if cols.shape != (nb, a.Lb) or tuple(a.blocks.shape) != (
            nb, a.Lb, a.bsz, a.bsz):
        _fail("BELL cols/blocks shapes inconsistent with (nb, Lb, bsz)")
    if cols.size and (cols.min() < 0 or (nb and cols.max() >= nb)):
        _fail(f"BELL block-column ids outside [0, {nb})")
    stored = np.any(_nonzero_values(a.blocks), axis=(2, 3))
    if np.any(~stored & (cols != 0)):
        _fail("BELL padding slots (all-zero blocks) must carry column id 0")
    # within a row, stored slots must not repeat a block column
    for r in range(nb):
        c = cols[r][stored[r]]
        if c.size != np.unique(c).size:
            _fail(f"BELL block row {r}: duplicate stored block columns")
