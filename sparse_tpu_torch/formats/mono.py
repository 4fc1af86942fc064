"""Mono sparse matrices: at most one stored element per row (MSR) or per
column (MSC).

Port of ``sparse_tpu/formats/mono.py`` (the reference's ``mk_mono``,
mono.fut:63-209).  The representation is regular (one slot per row), so
there is no padding protocol: empty rows hold ``(col 0, val 0)``
(mono.fut:119-129).  MSR SpMV is one gather and one multiply per row.  MSC
delegates every op to MSR with swapped dimensions through the O(1)
transpose duality (mono.fut:166-204).
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..ops.segmented import INDEX_DTYPE, segment_sum
from .coo import COO, coo_from_triples, coo_normalize, coo_transpose

__all__ = [
    "MSR",
    "MSC",
    "debug_checks",
    "msr_empty",
    "msr_eye",
    "msr_diag",
    "msr_from_coo",
    "msr_from_triples",
    "msr_todense",
    "msr_to_coo",
    "msr_scale",
    "msr_add",
    "msr_sub",
    "msr_nnz",
    "msr_smvm",
    "msr_vsmm",
    "msr_dmsmm",
    "msr_transpose",
    "msc_empty",
    "msc_eye",
    "msc_diag",
    "msc_from_coo",
    "msc_from_triples",
    "msc_todense",
    "msc_to_coo",
    "msc_scale",
    "msc_add",
    "msc_sub",
    "msc_nnz",
    "msc_vsmm",
    "msc_transpose",
]


@dataclasses.dataclass(frozen=True)
class MSR:
    """Mono sparse row matrix: row i stores ``vals[i]`` at column
    ``col_idx[i]`` (reference mono.fut:95)."""

    col_idx: torch.Tensor  # [n]
    vals: torch.Tensor  # [n]
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def todense(self):
        return msr_todense(self)

    def nnz(self):
        return msr_nnz(self)

    @property
    def T(self) -> "MSC":
        return msr_transpose(self)

    def __add__(self, o):
        return msr_add(self, o)

    def __sub__(self, o):
        return msr_sub(self, o)

    def __mul__(self, v):
        return msr_scale(v, self)

    __rmul__ = __mul__

    def __matmul__(self, v):
        v = torch.as_tensor(v, device=self.device)
        if v.dim() == 1:
            return msr_smvm(self, v)
        return NotImplemented

    def __rmatmul__(self, d):
        d = torch.as_tensor(d, device=self.device)
        if d.dim() == 1:
            return msr_vsmm(d, self)
        if d.dim() == 2:
            return msr_dmsmm(d, self)
        return NotImplemented


@dataclasses.dataclass(frozen=True)
class MSC:
    """Mono sparse column matrix of logical shape (n, m): the tensors are
    an MSR of the transpose (reference mono.fut:203)."""

    col_idx: torch.Tensor  # [m] row index per column
    vals: torch.Tensor  # [m]
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def todense(self):
        return msc_todense(self)

    def nnz(self):
        return msc_nnz(self)

    @property
    def T(self) -> "MSR":
        return msc_transpose(self)

    def __add__(self, o):
        return msc_add(self, o)

    def __sub__(self, o):
        return msc_sub(self, o)

    def __mul__(self, v):
        return msc_scale(v, self)

    __rmul__ = __mul__

    def __rmatmul__(self, v):
        v = torch.as_tensor(v, device=self.device)
        if v.dim() == 1:
            return msc_vsmm(v, self)
        return NotImplemented


def _msc_as_msr_t(a: MSC) -> MSR:
    n, m = a.shape
    return MSR(col_idx=a.col_idx, vals=a.vals, shape=(m, n))


# -- constructors --------------------------------------------------------------


def msr_empty(n: int, m: int, dtype=torch.float32, *, device=None) -> MSR:
    """Zero matrix (mono.fut:97-100), on ``device`` (default CUDA)."""
    device = resolve_device(device)
    return MSR(col_idx=torch.zeros(n, dtype=INDEX_DTYPE, device=device),
               vals=torch.zeros(n, dtype=dtype, device=device), shape=(n, m))


def msr_eye(n: int, m: int, dtype=torch.float32, *, device=None) -> MSR:
    """Identity (mono.fut:102-105), on ``device`` (default CUDA).  Rows
    past min(n, m) hold ``(col 0, val 0)``: the reference stores a 1 there
    at an out-of-range column, and the dense result is what is kept."""
    device = resolve_device(device)
    rows = torch.arange(n, dtype=INDEX_DTYPE, device=device)
    inside = rows < min(n, m)
    return MSR(col_idx=torch.where(inside, rows, 0),
               vals=inside.to(dtype), shape=(n, m))


def msr_diag(v, *, device=None) -> MSR:
    """Diagonal matrix, on ``device``, else ``v``'s device, else CUDA."""
    v = torch.as_tensor(v, device=resolve_device(device, v))
    n = v.shape[0]
    return MSR(col_idx=torch.arange(n, dtype=INDEX_DTYPE, device=v.device),
               vals=v, shape=(n, n))


def msr_from_coo(a: COO) -> MSR:
    """From COO; duplicates at identical (r, c) sum.  A row with two
    distinct stored columns violates the mono invariant (the reference
    asserts, mono.fut:122-125): here the *last* normalized entry of such a
    row wins; :func:`msr_from_triples` checks it."""
    n, m = a.shape
    a = coo_normalize(a)
    valid = a.row < n
    tgt = torch.where(valid, a.row.long(), n)
    col_idx = torch.zeros(n + 1, dtype=INDEX_DTYPE, device=a.device)
    vals = torch.zeros(n + 1, dtype=a.dtype, device=a.device)
    # sorted by (row, col): the last write of a row is its last entry
    last = torch.ones_like(valid)
    last[:-1] = tgt[1:] != tgt[:-1]
    col_idx[tgt[last]] = a.col[last].to(INDEX_DTYPE)
    vals[tgt[last]] = a.data[last]
    return MSR(col_idx=col_idx[:n], vals=vals[:n], shape=(n, m))


def msr_from_triples(n: int, m: int, triples, dtype=None, *,
                     device=None) -> MSR:
    """Checked construction from ``[(r, c, v), ...]``: after the
    duplicate merge each row may hold one column (mono.fut:122-125), else
    ``ValueError``."""
    coo = coo_from_triples(n, m, list(triples), dtype=dtype, device=device)
    rows = coo.row.cpu().tolist()
    cols = coo.col.cpu().tolist()
    seen: dict[int, int] = {}
    for r, c in zip(rows, cols):
        if seen.setdefault(r, c) != c:
            raise ValueError("mono row matrix: more than one stored element "
                             "in a row")
    return msr_from_coo(coo)


# -- conversions ----------------------------------------------------------------


def msr_todense(a: MSR) -> torch.Tensor:
    n, m = a.shape
    out = a.vals.new_zeros((n, m))
    if n == 0 or m == 0:
        return out
    return out.index_put((torch.arange(n, device=a.device),
                          a.col_idx.long()), a.vals)


def msr_to_coo(a: MSR) -> COO:
    """Stored-and-nonzero entries as COO (mono.fut:135-137 filters zeros);
    zero slots become padding sentinels."""
    n, m = a.shape
    nonzero = a.vals != 0
    return COO(
        row=torch.where(nonzero, torch.arange(n, dtype=INDEX_DTYPE,
                                              device=a.device), n),
        col=torch.where(nonzero, a.col_idx, m).to(INDEX_DTYPE),
        data=torch.where(nonzero, a.vals, 0),
        shape=(n, m))


# -- ops --------------------------------------------------------------------------


def msr_scale(v, a: MSR) -> MSR:
    return dataclasses.replace(a, vals=a.vals * v)


# The reference's switch for traced structure checks on mono add/sub (its
# ``checkify`` path under ``jit``).  The port runs eagerly, so the check
# always runs on concrete tensors; the switch is kept for the reference's
# API.
_DEBUG_CHECKS = False


def debug_checks(enable: bool = True) -> None:
    """Enable/disable the reference's traced invariant checks on mono
    add/sub (SURVEY.md §5.3 debug mode).  Eager callers, which every
    caller of the port is, get a plain exception either way."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = enable


def _check_same_structure(a: MSR, b: MSR):
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if not torch.equal(a.col_idx, b.col_idx):
        raise ValueError(
            "mono add/sub requires identical stored structure (mono.fut:141)")


def msr_add(a: MSR, b: MSR) -> MSR:
    """Element-wise add; requires identical col_idx (mono.fut:139-143)."""
    _check_same_structure(a, b)
    return dataclasses.replace(a, vals=a.vals + b.vals)


def msr_sub(a: MSR, b: MSR) -> MSR:
    _check_same_structure(a, b)
    return dataclasses.replace(a, vals=a.vals - b.vals)


def msr_nnz(a: MSR) -> torch.Tensor:
    return torch.sum(a.vals != 0).to(INDEX_DTYPE)


def msr_transpose(a: MSR) -> MSC:
    n, m = a.shape
    return MSC(col_idx=a.col_idx, vals=a.vals, shape=(m, n))


def msr_smvm(a: MSR, v) -> torch.Tensor:
    """``y[i] = vals[i] * v[col_idx[i]]``: one gather and one multiply per
    row (mono.fut:154-155)."""
    n, m = a.shape
    v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (m,):
        raise ValueError(f"smvm: vector shape {tuple(v.shape)} != ({m},)")
    if n == 0 or m == 0:
        return torch.zeros(n, dtype=torch.promote_types(a.dtype, v.dtype),
                           device=a.device)
    return a.vals * v[a.col_idx.long()]


def msr_vsmm(v, a: MSR) -> torch.Tensor:
    """``y[c] = sum over rows i with col_idx[i] == c of v[i] * vals[i]``
    (mono.fut:157-159)."""
    n, m = a.shape
    v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (n,):
        raise ValueError(f"vsmm: vector shape {tuple(v.shape)} != ({n},)")
    return segment_sum(v * a.vals, a.col_idx, m)


def msr_dmsmm(d, a: MSR) -> torch.Tensor:
    """``C[i, c] = sum_k D[i, k] * S[k, c]`` for mono S: batched vsmm
    (mono.fut:161-162), one segment sum over columns."""
    d = torch.as_tensor(d, device=a.device)
    k, m = a.shape
    if d.dim() != 2 or d.shape[1] != k:
        raise ValueError(f"dmsmm: dense shape {tuple(d.shape)} != (n, {k})")
    return segment_sum((d * a.vals[None, :]).T, a.col_idx, m).T


# -- MSC delegation (mono.fut:166-204) -------------------------------------------


def msc_empty(n: int, m: int, dtype=torch.float32, *, device=None) -> MSC:
    return msr_transpose(msr_empty(m, n, dtype, device=device))


def msc_eye(n: int, m: int, dtype=torch.float32, *, device=None) -> MSC:
    return msr_transpose(msr_eye(m, n, dtype, device=device))


def msc_diag(v, *, device=None) -> MSC:
    return msr_transpose(msr_diag(v, device=device))


def msc_from_coo(a: COO) -> MSC:
    return msr_transpose(msr_from_coo(coo_transpose(a)))


def msc_from_triples(n: int, m: int, triples, dtype=None, *,
                     device=None) -> MSC:
    swapped = [(c, r, v) for (r, c, v) in triples]
    return msr_transpose(msr_from_triples(m, n, swapped, dtype=dtype,
                                          device=device))


def msc_todense(a: MSC) -> torch.Tensor:
    return msr_todense(_msc_as_msr_t(a)).T


def msc_to_coo(a: MSC) -> COO:
    return coo_transpose(msr_to_coo(_msc_as_msr_t(a)))


def msc_scale(v, a: MSC) -> MSC:
    return dataclasses.replace(a, vals=a.vals * v)


def msc_add(a: MSC, b: MSC) -> MSC:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return msr_transpose(msr_add(_msc_as_msr_t(a), _msc_as_msr_t(b)))


def msc_sub(a: MSC, b: MSC) -> MSC:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return msr_transpose(msr_sub(_msc_as_msr_t(a), _msc_as_msr_t(b)))


def msc_nnz(a: MSC) -> torch.Tensor:
    return msr_nnz(_msc_as_msr_t(a))


def msc_transpose(a: MSC) -> MSR:
    n, m = a.shape
    return MSR(col_idx=a.col_idx, vals=a.vals, shape=(m, n))


def msc_vsmm(v, a: MSC) -> torch.Tensor:
    """``v . A`` for MSC A: smvm of the stored transpose (mono.fut:
    200-201)."""
    return msr_smvm(_msc_as_msr_t(a), v)
