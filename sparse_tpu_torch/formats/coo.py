"""COO (coordinate) format: the construction/interchange format.

Port of ``sparse_tpu/formats/coo.py`` (reference ``coo``/``sort_coo``/
``merge_coo``/``norm_coo``, compressed.fut:66-87).  Every tensor has a static
stored capacity ``nse``; entries beyond the valid count are padding with the
row sentinel ``shape[0]``, column sentinel ``shape[1]`` and value 0.  Sorting
pushes padding to the end; segment sums drop it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..ops.segmented import INDEX_DTYPE, segment_sum

__all__ = [
    "COO",
    "coo_make",
    "coo_from_triples",
    "coo_sort",
    "coo_normalize",
    "coo_todense",
    "coo_from_dense",
    "coo_transpose",
    "coo_nnz",
    "coo_pad_to",
    "coo_concatenate",
    "coo_compact",
    "coo_scale",
]


def _np_dtype(dtype):
    """NumPy dtype that holds ``dtype``'s values on the host: float32 for
    bfloat16, which NumPy lacks (the caller casts the tensor back)."""
    if dtype is None or not isinstance(dtype, torch.dtype):
        return dtype
    if dtype == torch.bfloat16:
        return np.float32
    return torch.empty(0, dtype=dtype).numpy().dtype


@dataclasses.dataclass(frozen=True)
class COO:
    """Padded COO matrix.

    Invariants:
      * ``row``/``col``/``data`` all have static length ``nse``.
      * Valid entries have ``0 <= row < n`` and ``0 <= col < m``.
      * Padding entries have ``row == n``, ``col == m``, ``data == 0``.
      * No ordering or uniqueness is implied; see :func:`coo_normalize`.
    """

    row: torch.Tensor
    col: torch.Tensor
    data: torch.Tensor
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


def coo_make(shape, row, col, data, *, device=None) -> COO:
    """Build a COO from index/value arrays (all valid entries, no padding)
    on ``device`` (default: the device of a tensor argument, else CUDA)."""
    dev = resolve_device(device, data, row, col)
    return COO(
        row=torch.as_tensor(row, device=dev).to(INDEX_DTYPE),
        col=torch.as_tensor(col, device=dev).to(INDEX_DTYPE),
        data=torch.as_tensor(data, device=dev),
        shape=(int(shape[0]), int(shape[1])),
    )


def coo_from_triples(n: int, m: int, triples, dtype=None, *,
                     device=None) -> COO:
    """Eager construction from ``[(r, c, v), ...]`` with bounds validation
    (reference constructor assert, compressed.fut:156): ``ValueError`` on an
    out-of-range coordinate."""
    triples = list(triples)
    if triples:
        rows, cols, vals = zip(*triples)
    else:
        rows, cols, vals = (), (), ()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=_np_dtype(dtype))
    if rows.size and (
        rows.min() < 0 or rows.max() >= n or cols.min() < 0 or cols.max() >= m
    ):
        raise ValueError(f"coordinate out of bounds for {n}x{m} matrix")
    data = torch.from_numpy(vals)
    if isinstance(dtype, torch.dtype):
        data = data.to(dtype)
    return coo_make((n, m), torch.from_numpy(rows), torch.from_numpy(cols),
                    data, device=resolve_device(device))


def coo_pad_to(a: COO, nse: int) -> COO:
    """Pad to capacity ``nse`` with sentinel entries; shrinking raises."""
    cur = a.nse
    if nse < cur:
        raise ValueError(f"cannot shrink COO capacity {cur} -> {nse}; use "
                         "coo_compact")
    if nse == cur:
        return a
    n, m = a.shape
    extra = nse - cur
    return COO(row=torch.cat([a.row, a.row.new_full((extra,), n)]),
               col=torch.cat([a.col, a.col.new_full((extra,), m)]),
               data=torch.cat([a.data, a.data.new_zeros(extra)]),
               shape=a.shape)


def coo_concatenate(a: COO, b: COO) -> COO:
    """Both entry lists, ``a``'s first (duplicates are summed later, by
    :func:`coo_normalize`)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return COO(row=torch.cat([a.row, b.row]), col=torch.cat([a.col, b.col]),
               data=torch.cat([a.data, b.data]), shape=a.shape)


def coo_sort(a: COO) -> COO:
    """Stable sort of entries by (row, col), padding (sentinel row n) last.
    One fused int64 key ``row * (m+1) + col`` (int32 coordinates always fit);
    padding ``(n, m)`` fuses to the maximum key.  Relies on the invariant
    ``0 <= col <= m``."""
    w = a.shape[1] + 1
    key, order = torch.sort(a.row.long() * w + a.col.long(), stable=True)
    return COO(row=(key // w).to(INDEX_DTYPE), col=(key % w).to(INDEX_DTYPE),
               data=a.data[order], shape=a.shape)


def coo_normalize(a: COO) -> COO:
    """Sort by (row, col) and sum duplicates (reference ``norm_coo``,
    compressed.fut:86-87).  Same static capacity; unique entries packed at
    the front, the rest is padding.  Entries summing to zero stay stored
    (they count 0 in ``nnz``).  The duplicate sum is deterministic
    (:func:`~sparse_tpu_torch.ops.segmented.segment_sum`)."""
    nse = a.nse
    n, m = a.shape
    if nse == 0:
        return a
    s = coo_sort(a)
    valid = s.row < n
    is_head = torch.ones(nse, dtype=torch.bool, device=a.device)
    is_head[1:] = (s.row[1:] != s.row[:-1]) | (s.col[1:] != s.col[:-1])
    is_head &= valid
    group = torch.cumsum(is_head.long(), 0) - 1
    target = torch.where(valid, group, torch.full_like(group, nse))
    out_data = segment_sum(s.data, target, nse, indices_are_sorted=True)
    heads = torch.nonzero(is_head).reshape(-1)
    out_row = torch.full((nse,), n, dtype=INDEX_DTYPE, device=a.device)
    out_col = torch.full((nse,), m, dtype=INDEX_DTYPE, device=a.device)
    out_row[group[heads]] = s.row[heads]
    out_col[group[heads]] = s.col[heads]
    return COO(row=out_row, col=out_col, data=out_data, shape=a.shape)


def coo_todense(a: COO) -> torch.Tensor:
    n, m = a.shape
    if a.nse == 0:
        return torch.zeros((n, m), dtype=a.dtype, device=a.device)
    r, c = a.row.long(), a.col.long()
    valid = (r < n) & (c < m)
    flat = torch.where(valid, r * m + c, torch.full_like(r, n * m))
    return segment_sum(a.data, flat, n * m).reshape(n, m)


def coo_from_dense(x, nse: int | None = None, *, device=None) -> COO:
    """Stored entries of a dense matrix, row-major; ``nse`` fixes the
    capacity (default: the nonzero count).  Builds on ``device``, else on
    ``x``'s device when it is a tensor, else on CUDA."""
    x = torch.as_tensor(x, device=resolve_device(device, x))
    n, m = x.shape
    flat = x.reshape(-1)
    nz = flat != 0
    if nse is None:
        nse = int(torch.sum(nz))
    total = n * m
    order = torch.argsort((~nz).to(torch.int8), stable=True)
    if nse <= total:
        idx = order[:nse]
        taken = nz[idx]
    else:
        pad = nse - total
        idx = torch.cat([order, order.new_zeros(pad)])
        taken = torch.cat([nz[order], nz.new_zeros(pad)])
    row = torch.where(taken, idx // max(m, 1), torch.full_like(idx, n))
    col = torch.where(taken, idx % max(m, 1), torch.full_like(idx, m))
    data = torch.where(taken, flat[idx] if total else flat.new_zeros(idx.shape),
                       torch.zeros((), dtype=x.dtype, device=x.device))
    return COO(row=row.to(INDEX_DTYPE), col=col.to(INDEX_DTYPE), data=data,
               shape=(n, m))


def coo_transpose(a: COO) -> COO:
    """Swap rows and columns; padding sentinels move from (n, m) to (m, n)."""
    n, m = a.shape
    pad = a.row >= n
    return COO(row=torch.where(pad, torch.full_like(a.col, m), a.col),
               col=torch.where(pad, torch.full_like(a.row, n), a.row),
               data=a.data, shape=(m, n))


def coo_nnz(a: COO) -> torch.Tensor:
    """Stored values that are non-zero (compressed.fut:162-164: explicit
    stored zeros do not count)."""
    n, _ = a.shape
    return torch.sum((a.row < n) & (a.data != 0)).to(INDEX_DTYPE)


def coo_compact(a: COO) -> COO:
    """Normalize, then trim padding to the exact valid count (host sync)."""
    a = coo_normalize(a)
    k = int(torch.sum(a.row < a.shape[0]))
    return COO(row=a.row[:k], col=a.col[:k], data=a.data[:k], shape=a.shape)


def coo_scale(v, a: COO) -> COO:
    return dataclasses.replace(a, data=a.data * v)
