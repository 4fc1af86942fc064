"""Packed trapezoidal matrices (lower/upper, possibly non-square).

Port of ``sparse_tpu/formats/trapezoidal.py`` (the reference's
``mk_trapezoidal``, trapezoidal.fut:220-235).  An ``n x m`` lower
trapezoidal matrix (zero above the diagonal) stores its possibly-nonzero
elements packed row-major: the leading ``k = min(n, m)`` rows form a
triangle (``k(k+1)/2`` slots) and, for tall matrices, the remaining
``n - m`` rows are full width ``m`` (reference ``elements_lower``,
trapezoidal.fut:64-66).  An *upper* ``n x m`` matrix is stored as the
lower packing of its ``m x n`` transpose (``rank_upper``,
trapezoidal.fut:175-184), so ``transpose`` flips the flag.

``trap_smm`` densifies, multiplies and re-packs while every dimension is
at most 4096 (exact: same-orientation trapezoid products stay
trapezoidal); above, it multiplies (512, 512) tiles gathered from packed
storage in a host loop of ``torch.matmul``, as ``tri_smm`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..ops.segmented import INDEX_DTYPE
from ..utils.precision import contract, full_precision
from .triangular import _gather, _scatter, _unrank_rows

__all__ = [
    "Trapezoidal",
    "trap_elements",
    "trap_zero",
    "trap_eye",
    "trap_diag",
    "trap_from_dense",
    "trap_todense",
    "trap_idx",
    "trap_scale",
    "trap_add",
    "trap_sub",
    "trap_map",
    "trap_nnz",
    "trap_smm",
    "trap_transpose",
]


def trap_elements(n: int, m: int) -> int:
    """Packed size of an n x m lower trapezoid (reference
    ``elements_lower``, trapezoidal.fut:64-66)."""
    k = min(n, m)
    return k * (k + 1) // 2 + k * max(n - m, 0)


def _row_offsets(n: int, m: int, r: torch.Tensor) -> torch.Tensor:
    """Packed position of (r, 0) in a lower (n, m) trapezoid: the triangle
    rows first, then full rows of width m (reference ``rank_lower``,
    trapezoidal.fut:163-165)."""
    k = min(n, m)
    e = k * (k + 1) // 2
    return torch.where(r < k, r * (r + 1) // 2, e + (r.clamp(min=k) - k) * m)


def _packed_coords(n: int, m: int, device):
    """(rows, cols) of every packed slot of a lower n x m trapezoid,
    row-major (trapezoidal.fut:74-87)."""
    k = min(n, m)
    e = k * (k + 1) // 2
    p = torch.arange(trap_elements(n, m), device=device)
    tri_rows = _unrank_rows(p)
    in_tri = p < e
    rows = torch.where(in_tri, tri_rows, k + (p - e) // max(m, 1))
    cols = torch.where(in_tri, p - tri_rows * (tri_rows + 1) // 2,
                       (p - e) % max(m, 1))
    return rows, cols


@dataclasses.dataclass(frozen=True)
class Trapezoidal:
    """Packed n x m trapezoidal matrix.

    ``lower=True``: ``data`` is the row-major lower packing of the matrix;
    ``lower=False`` (upper): of its ``m x n`` transpose."""

    data: torch.Tensor
    n: int
    m: int
    lower: bool

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.m)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __add__(self, other: "Trapezoidal") -> "Trapezoidal":
        return trap_add(self, other)

    def __sub__(self, other: "Trapezoidal") -> "Trapezoidal":
        return trap_sub(self, other)

    def __mul__(self, v) -> "Trapezoidal":
        return trap_scale(v, self)

    __rmul__ = __mul__

    def __matmul__(self, other: "Trapezoidal") -> "Trapezoidal":
        return trap_smm(self, other)

    @property
    def T(self) -> "Trapezoidal":
        return trap_transpose(self)

    def todense(self) -> torch.Tensor:
        return trap_todense(self)

    def nnz(self) -> torch.Tensor:
        return trap_nnz(self)


def _storage_dims(n: int, m: int, lower: bool) -> tuple[int, int]:
    """Dims of the lower-packed storage: (n, m) for lower, (m, n) for
    upper."""
    return (n, m) if lower else (m, n)


# -- constructors -------------------------------------------------------------


def trap_zero(n: int, m: int, *, lower: bool = True, dtype=torch.float32,
              device=None) -> Trapezoidal:
    """All-zero trapezoid (reference ``zero``, trapezoidal.fut:118-121), on
    ``device`` (default CUDA)."""
    sn, sm = _storage_dims(n, m, lower)
    return Trapezoidal(data=torch.zeros(trap_elements(sn, sm), dtype=dtype,
                                        device=resolve_device(device)),
                       n=n, m=m, lower=lower)


def trap_eye(n: int, m: int, *, lower: bool = True, dtype=torch.float32,
             device=None) -> Trapezoidal:
    """Ones on the diagonal (reference ``eye``, trapezoidal.fut:123-124),
    on ``device`` (default CUDA)."""
    sn, sm = _storage_dims(n, m, lower)
    rows, cols = _packed_coords(sn, sm, resolve_device(device))
    return Trapezoidal(data=(rows == cols).to(dtype), n=n, m=m, lower=lower)


def trap_diag(v, *, lower: bool = True, device=None) -> Trapezoidal:
    """Square diagonal matrix (reference ``diag``, trapezoidal.fut:
    126-128), on ``device``, else ``v``'s device, else CUDA."""
    v = torch.as_tensor(v, device=resolve_device(device, v))
    n = v.shape[0]
    i = torch.arange(n, device=v.device)
    data = v.new_zeros(trap_elements(n, n))
    data[_row_offsets(n, n, i) + i] = v
    return Trapezoidal(data=data, n=n, m=n, lower=lower)


def trap_from_dense(x, *, lower: bool = True, device=None) -> Trapezoidal:
    """Pack the trapezoidal part of a dense matrix, ignoring the zero side
    (reference ``trapezoidal``, trapezoidal.fut:108-113).  Builds on
    ``device``, else ``x``'s device when it is a tensor, else CUDA."""
    x = torch.as_tensor(x, device=resolve_device(device, x))
    n, m = x.shape
    src = x if lower else x.T
    rows, cols = _packed_coords(*src.shape, x.device)
    return Trapezoidal(data=src[rows, cols], n=n, m=m, lower=lower)


# -- conversions ---------------------------------------------------------------


def trap_todense(a: Trapezoidal) -> torch.Tensor:
    """Unpack to dense (reference ``dense``, trapezoidal.fut:115-116)."""
    sn, sm = _storage_dims(a.n, a.m, a.lower)
    rows, cols = _packed_coords(sn, sm, a.device)
    out = a.data.new_zeros((sn, sm)).index_put((rows, cols), a.data)
    return out if a.lower else out.T


def trap_idx(a: Trapezoidal, i, j) -> torch.Tensor:
    """Element at logical (i, j); zero on the zero side (reference ``idx``,
    trapezoidal.fut:105-106)."""
    i = torch.as_tensor(i, device=a.device).long()
    j = torch.as_tensor(j, device=a.device).long()
    if not a.lower:
        i, j = j, i
    sn, sm = _storage_dims(a.n, a.m, a.lower)
    if a.data.shape[0] == 0:
        return a.data.new_zeros(())
    p = (_row_offsets(sn, sm, i) + torch.minimum(j, i)).clamp(
        0, trap_elements(sn, sm) - 1)
    return torch.where(j > i, a.data.new_zeros(()), a.data[p])


# -- elementwise ops -----------------------------------------------------------


def trap_scale(v, a: Trapezoidal) -> Trapezoidal:
    """Reference ``scale``, trapezoidal.fut:130-131."""
    return dataclasses.replace(a, data=a.data * v)


def trap_add(a: Trapezoidal, b: Trapezoidal) -> Trapezoidal:
    """Element-wise addition (reference ``+``, trapezoidal.fut:147-150)."""
    _check_same(a, b, "add")
    return dataclasses.replace(a, data=a.data + b.data)


def trap_sub(a: Trapezoidal, b: Trapezoidal) -> Trapezoidal:
    """Element-wise subtraction (reference ``-``, trapezoidal.fut:152)."""
    _check_same(a, b, "sub")
    return dataclasses.replace(a, data=a.data - b.data)


def trap_map(f, a: Trapezoidal) -> Trapezoidal:
    """Map over stored elements (reference ``map``, trapezoidal.fut:
    158-159)."""
    return dataclasses.replace(a, data=f(a.data))


def trap_nnz(a: Trapezoidal) -> torch.Tensor:
    """Non-zero stored values (reference ``nnz``, trapezoidal.fut:
    154-156)."""
    return torch.sum(a.data != 0).to(INDEX_DTYPE)


def _check_same(a: Trapezoidal, b: Trapezoidal, op: str) -> None:
    if a.shape != b.shape:
        raise ValueError(f"trap_{op}: shape mismatch {a.shape} vs {b.shape}")
    if a.lower != b.lower:
        raise ValueError(f"trap_{op}: cannot mix lower and upper trapezoids")


# -- matmul --------------------------------------------------------------------


# the size policy of tri_smm (triangular.py)
_TRAP_DENSE_MAX = 4096
_TRAP_BLOCK = 512


def _trap_tile(n, m, bi, bj, B, device):
    """The (B, B) tile (rows bi*B.., cols bj*B..) of a lower-packed (n, m)
    trapezoid: packed positions (clamped in range) and the mask of those
    that hold entries."""
    r = bi * B + torch.arange(B, device=device)
    c = bj * B + torch.arange(B, device=device)
    valid = (c[None, :] <= r[:, None]) & (c[None, :] < m) & (r[:, None] < n)
    idx = _row_offsets(n, m, r)[:, None] + c[None, :]
    return idx.clamp(max=max(trap_elements(n, m) - 1, 0)), valid


def _trap_smm_blocked(ad, bd, n: int, m: int, k: int, B: int):
    """Lower-packed (n, m) x lower-packed (m, k) -> lower-packed (n, k)
    without densifying: C_ij = sum_{t=j..min(i, mb-1)} A_it @ B_tj over
    B-sized tiles, each output tile's valid part scattered into the packed
    output."""
    nb, mb, kb = -(-n // B), -(-m // B), -(-k // B)
    dev = ad.device
    out = ad.new_zeros(trap_elements(n, k) + 1)
    for bi in range(nb):
        for bj in range(min(bi + 1, kb)):
            acc = ad.new_zeros((B, B))
            for bt in range(bj, min(bi + 1, mb)):
                acc = acc + contract(
                    "ij,jk->ik",
                    _gather(ad, _trap_tile(n, m, bi, bt, B, dev)),
                    _gather(bd, _trap_tile(m, k, bt, bj, B, dev)))
            _scatter(out, _trap_tile(n, k, bi, bj, B, dev), acc)
    return out[:-1]


def trap_smm(a: Trapezoidal, b: Trapezoidal) -> Trapezoidal:
    """Trapezoid x trapezoid multiply: (n, m) @ (m, k) -> (n, k)
    (reference ``smm``, trapezoidal.fut:133-145; upper duality at :231):
    densify, one matmul and re-pack, or the blocked packed path once any
    dimension exceeds ``_TRAP_DENSE_MAX``."""
    if a.lower != b.lower:
        raise ValueError("trap_smm: cannot mix lower and upper trapezoids")
    if a.m != b.n:
        raise ValueError(f"trap_smm: inner dims {a.shape} @ {b.shape}")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    n, m, k = a.n, a.m, b.m
    with full_precision(out_dtype):
        if max(n, m, k) > _TRAP_DENSE_MAX:
            imax = np.iinfo(np.int32).max
            if max(trap_elements(n, m), trap_elements(m, k),
                   trap_elements(n, k)) > imax:
                raise ValueError(
                    f"trap_smm: packed size of {a.shape} @ {b.shape} "
                    "exceeds the int32 packed-index cap")
            ad, bd = a.data.to(out_dtype), b.data.to(out_dtype)
            # upper storage is the lower packing of the transpose: (AB)^T =
            # B^T A^T computes the upper product in lower space
            data = (_trap_smm_blocked(ad, bd, n, m, k, _TRAP_BLOCK)
                    if a.lower else
                    _trap_smm_blocked(bd, ad, k, m, n, _TRAP_BLOCK))
            return Trapezoidal(data=data, n=n, m=k, lower=a.lower)
        dc = contract("ij,jk->ik", trap_todense(a).to(out_dtype),
                      trap_todense(b).to(out_dtype))
    return trap_from_dense(dc, lower=a.lower)


def trap_transpose(a: Trapezoidal) -> Trapezoidal:
    """O(1) transpose: (n, m) lower <-> (m, n) upper (reference
    trapezoidal.fut:224-231)."""
    return Trapezoidal(data=a.data, n=a.m, m=a.n, lower=not a.lower)
