"""Packed triangular matrices (lower/upper).

Port of ``sparse_tpu/formats/triangular.py`` (the reference's
``mk_triangular``, triangular.fut:195-208).  An ``n x n`` triangular
matrix stores exactly the ``n(n+1)/2`` possibly-nonzero elements in a
packed 1-D ``data`` vector:

* a *lower* matrix is packed row-major, ``rank(i, j) = i(i+1)/2 + j``
  (triangular.fut:141-142);
* an *upper* matrix is stored as the packed-lower form of its transpose,
  so ``transpose`` flips the orientation flag and moves no data
  (triangular.fut:199, 203).

``tri_smm`` densifies both operands, runs one matmul and re-packs for
n <= 4096 (exact: same-orientation triangle products stay triangular).
Above that it multiplies (512, 512) tiles gathered from packed storage, a
host loop of ``torch.matmul`` over block pairs that skips each pair's
structurally zero k-range, and scatters each tile's lower part back into
the packed output, so peak memory stays near the packed size.  Float32
stays full float32 (``utils.precision.full_precision``).  Packed positions
are int64 here; n is capped at ``_TRI_N_MAX`` = 46340, the reference's
int32 limit on ``n(n+1)/2``.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..ops.segmented import INDEX_DTYPE
from ..utils.precision import contract, full_precision

__all__ = [
    "Triangular",
    "tri_elements",
    "tri_zero",
    "tri_eye",
    "tri_diag",
    "tri_from_dense",
    "tri_todense",
    "tri_idx",
    "tri_scale",
    "tri_add",
    "tri_sub",
    "tri_map",
    "tri_nnz",
    "tri_smm",
    "tri_transpose",
]


def tri_elements(n: int) -> int:
    """Packed size of an n x n triangle (reference ``elements``,
    triangular.fut:58-59)."""
    return (n * (n + 1)) // 2


def _unrank_rows(p: torch.Tensor) -> torch.Tensor:
    """Row index of packed position ``p`` in lower row-major packing: the
    float32 square-root inversion of ``rank`` (triangular.fut:135-136),
    then an exact integer fix-up against rounding at large ``p``."""
    p = p.long()
    r = torch.floor((torch.sqrt(8.0 * p.to(torch.float32) + 1.0) - 1.0)
                    / 2.0).long()
    # exact: r is the integer with r(r+1)/2 <= p < (r+1)(r+2)/2
    r = torch.where((r + 1) * (r + 2) // 2 <= p, r + 1, r)
    return torch.where(r * (r + 1) // 2 > p, r - 1, r)


def _packed_coords(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) of every packed slot, lower row-major order."""
    p = torch.arange(tri_elements(n), device=device)
    rows = _unrank_rows(p)
    return rows, p - rows * (rows + 1) // 2


@dataclasses.dataclass(frozen=True)
class Triangular:
    """Packed n x n triangular matrix.

    ``data`` has length ``n(n+1)/2``.  ``lower=True``: ``data`` is the
    row-major packing of the matrix itself; ``lower=False``: of its
    transpose (the matrix is upper triangular)."""

    data: torch.Tensor
    n: int
    lower: bool

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __add__(self, other: "Triangular") -> "Triangular":
        return tri_add(self, other)

    def __sub__(self, other: "Triangular") -> "Triangular":
        return tri_sub(self, other)

    def __mul__(self, v) -> "Triangular":
        return tri_scale(v, self)

    __rmul__ = __mul__

    def __matmul__(self, other: "Triangular") -> "Triangular":
        return tri_smm(self, other)

    @property
    def T(self) -> "Triangular":
        return tri_transpose(self)

    def todense(self) -> torch.Tensor:
        return tri_todense(self)

    def nnz(self) -> torch.Tensor:
        return tri_nnz(self)


# -- constructors -------------------------------------------------------------


def tri_zero(n: int, *, lower: bool = True, dtype=torch.float32,
             device=None) -> Triangular:
    """All-zero triangle (reference ``zero``, triangular.fut:89-92), on
    ``device`` (default CUDA)."""
    return Triangular(data=torch.zeros(tri_elements(n), dtype=dtype,
                                       device=resolve_device(device)),
                      n=n, lower=lower)


def tri_eye(n: int, *, lower: bool = True, dtype=torch.float32,
            device=None) -> Triangular:
    """Identity (reference ``eye``, triangular.fut:94-95), on ``device``
    (default CUDA)."""
    rows, cols = _packed_coords(n, resolve_device(device))
    return Triangular(data=(rows == cols).to(dtype), n=n, lower=lower)


def tri_diag(v, *, lower: bool = True, device=None) -> Triangular:
    """Diagonal matrix (reference ``diag``, triangular.fut:97-99), on
    ``device``, else ``v``'s device, else CUDA."""
    v = torch.as_tensor(v, device=resolve_device(device, v))
    n = v.shape[0]
    i = torch.arange(n, device=v.device)
    data = v.new_zeros(tri_elements(n))
    data[i * (i + 1) // 2 + i] = v
    return Triangular(data=data, n=n, lower=lower)


def tri_from_dense(x, *, lower: bool = True, device=None) -> Triangular:
    """Pack the triangular part of a dense matrix, ignoring the zero side
    (reference ``triangular``, triangular.fut:79-84).  Builds on
    ``device``, else ``x``'s device when it is a tensor, else CUDA."""
    x = torch.as_tensor(x, device=resolve_device(device, x))
    n, m = x.shape
    if n != m:
        raise ValueError(f"triangular matrices are square; got "
                         f"{tuple(x.shape)}")
    src = x if lower else x.T
    rows, cols = _packed_coords(n, x.device)
    return Triangular(data=src[rows, cols], n=n, lower=lower)


# -- conversions ---------------------------------------------------------------


def tri_todense(a: Triangular) -> torch.Tensor:
    """Unpack to dense (reference ``dense``, triangular.fut:86-87)."""
    n = a.n
    rows, cols = _packed_coords(n, a.device)
    out = a.data.new_zeros((n, n)).index_put((rows, cols), a.data)
    return out if a.lower else out.T


def tri_idx(a: Triangular, i, j) -> torch.Tensor:
    """Element at logical position (i, j); zero on the zero side
    (reference ``idx``, triangular.fut:76-77)."""
    i = torch.as_tensor(i, device=a.device).long()
    j = torch.as_tensor(j, device=a.device).long()
    if not a.lower:
        i, j = j, i
    if a.data.shape[0] == 0:
        return a.data.new_zeros(())
    p = (i * (i + 1) // 2 + torch.minimum(j, i)).clamp(
        0, tri_elements(a.n) - 1)
    return torch.where(j > i, a.data.new_zeros(()), a.data[p])


# -- elementwise ops -----------------------------------------------------------


def tri_scale(v, a: Triangular) -> Triangular:
    """Scale all elements (reference ``scale``, triangular.fut:101-102)."""
    return dataclasses.replace(a, data=a.data * v)


def tri_add(a: Triangular, b: Triangular) -> Triangular:
    """Element-wise addition (reference ``+``, triangular.fut:114-119)."""
    _check_same(a, b, "add")
    return dataclasses.replace(a, data=a.data + b.data)


def tri_sub(a: Triangular, b: Triangular) -> Triangular:
    """Element-wise subtraction (reference ``-``, triangular.fut:121)."""
    _check_same(a, b, "sub")
    return dataclasses.replace(a, data=a.data - b.data)


def tri_map(f, a: Triangular) -> Triangular:
    """Map an element-wise function over the stored elements (reference
    ``map``, triangular.fut:127-129)."""
    return dataclasses.replace(a, data=f(a.data))


def tri_nnz(a: Triangular) -> torch.Tensor:
    """Number of stored values that are non-zero (reference ``nnz``,
    triangular.fut:124-125)."""
    return torch.sum(a.data != 0).to(INDEX_DTYPE)


def _check_same(a: Triangular, b: Triangular, op: str) -> None:
    if a.n != b.n:
        raise ValueError(f"tri_{op}: size mismatch {a.n} vs {b.n}")
    if a.lower != b.lower:
        raise ValueError(f"tri_{op}: cannot mix lower and upper triangles")


# -- matmul --------------------------------------------------------------------


# below this size, densify -> one matmul wins (2x transient memory, no
# bookkeeping); above it the blocked packed path keeps the packed format's
# memory edge.  46340 is the reference's int32 cap on n(n+1)/2.
_TRI_DENSE_MAX = 4096
_TRI_BLOCK = 512
_TRI_N_MAX = 46340


def _tri_tile(n, bi, bj, B, device):
    """The (B, B) tile (rows bi*B.., cols bj*B..) of a packed-lower n x n
    triangle: its packed positions (clamped in range) and the mask of the
    positions that hold entries."""
    r = bi * B + torch.arange(B, device=device)
    c = bj * B + torch.arange(B, device=device)
    valid = (c[None, :] <= r[:, None]) & (r[:, None] < n)
    idx = (r * (r + 1) // 2)[:, None] + c[None, :]
    return idx.clamp(max=max(tri_elements(n) - 1, 0)), valid


def _gather(data, tile):
    idx, valid = tile
    return torch.where(valid, data[idx], 0)


def _scatter(out, tile, acc):
    """Write the valid lanes of ``acc`` into ``out``, the rest into its
    last slot (a discard slot past the packed data)."""
    idx, valid = tile
    out.index_put_((torch.where(valid, idx, out.shape[0] - 1),), acc)


def _tri_smm_blocked(ad, bd, n: int, B: int) -> torch.Tensor:
    """Packed-lower x packed-lower -> packed-lower without densifying:
    C_ij = sum_{k=j..i} A_ik @ B_kj over B-sized tiles, each tile's lower
    part scattered into the packed output."""
    nb = -(-n // B)
    dev = ad.device
    out = ad.new_zeros(tri_elements(n) + 1)
    for bi in range(nb):
        for bj in range(bi + 1):
            acc = ad.new_zeros((B, B))
            for bk in range(bj, bi + 1):
                acc = acc + contract(
                    "ij,jk->ik",
                    _gather(ad, _tri_tile(n, bi, bk, B, dev)),
                    _gather(bd, _tri_tile(n, bk, bj, B, dev)))
            _scatter(out, _tri_tile(n, bi, bj, B, dev), acc)
    return out[:-1]


def tri_smm(a: Triangular, b: Triangular) -> Triangular:
    """Triangular x triangular matrix multiply (reference ``smm``,
    triangular.fut:104-112, and the upper-via-transpose duality at :204):
    densify, one matmul and re-pack for n <= 4096, the blocked packed
    path above."""
    _check_same(a, b, "smm")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    n = a.n
    with full_precision(out_dtype):
        if n > _TRI_DENSE_MAX:
            if n > _TRI_N_MAX:
                raise ValueError(f"tri_smm: n={n} exceeds the packed-index "
                                 f"cap {_TRI_N_MAX}")
            # upper storage is the packed-lower of the transpose: (AB)^T =
            # B^T A^T computes the upper product in lower space
            ad, bd = (a.data, b.data) if a.lower else (b.data, a.data)
            data = _tri_smm_blocked(ad.to(out_dtype), bd.to(out_dtype), n,
                                    _TRI_BLOCK)
            return Triangular(data=data, n=n, lower=a.lower)
        dc = contract("ij,jk->ik", tri_todense(a).to(out_dtype),
                      tri_todense(b).to(out_dtype))
    return tri_from_dense(dc, lower=a.lower)


def tri_transpose(a: Triangular) -> Triangular:
    """O(1) transpose: lower <-> upper by flipping the orientation flag
    (reference triangular.fut:199, 203)."""
    return dataclasses.replace(a, lower=not a.lower)
