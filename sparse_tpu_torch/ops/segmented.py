"""Segmented-operation engines (port of ``sparse_tpu/ops/segmented.py``).

The reference builds every sparse op out of four primitives
(``segmented_reduce``, ``expand``, ``expand_outer_reduce``,
``replicated_iota``; compressed.fut:129,146,176).  Here they are plain
PyTorch over padded, static-capacity tensors: out-of-range ids (the padding
sentinel) are dropped, exactly as the JAX package's scatter semantics drop
them.

Determinism: :func:`segment_sum` never uses float atomics (``index_add_`` on
a CUDA tensor sums in a run-dependent order).  Ids are stably sorted and each
segment is reduced by a segmented doubling scan, so the summation order is a
pure function of the input — bitwise repeatable on every device.
"""

from __future__ import annotations

import torch

__all__ = [
    "INDEX_DTYPE",
    "segment_sum",
    "row_ids_from_indptr",
    "repeated_iota",
    "expand",
    "cumsum_exclusive",
]

# Index dtype of the stored formats, as in the reference (int32).  Torch
# indexing takes int64; ops widen with ``.long()`` where they index.
INDEX_DTYPE = torch.int32


def _broadcast_rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _sorted_segment_totals(data: torch.Tensor, ids: torch.Tensor):
    """Totals of runs of equal ``ids`` (ids sorted ascending).

    Returns ``(run_ids, totals)``.  A segmented Hillis-Steele scan: after
    ``ceil(log2(longest run))`` doubling steps the last element of each run
    holds the run's sum.  Fixed order, no atomics."""
    k = ids.shape[0]
    head = torch.ones(k, dtype=torch.bool, device=ids.device)
    head[1:] = ids[1:] != ids[:-1]
    starts = torch.nonzero(head).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_tensor([k])])
    longest = int((ends - starts).max()) if k else 0
    x = data
    flag = head
    s = 1
    while s < longest:
        add = _broadcast_rows(~flag[s:], x)
        x = torch.cat([x[:s], torch.where(add, x[s:] + x[:-s], x[s:])])
        flag = torch.cat([flag[:s], flag[s:] | flag[:-s]])
        s *= 2
    last = ends - 1
    return ids[starts], x[last]


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Sum ``data`` (leading axis) into ``num_segments`` buckets keyed by
    ``segment_ids``; out-of-range ids (e.g. the padding sentinel
    ``num_segments``) are dropped.  Deterministic on every device (module
    docstring)."""
    ids = segment_ids.reshape(-1).long()
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if ids.numel() == 0 or num_segments == 0:
        return out
    if not indices_are_sorted:
        ids, order = torch.sort(ids, stable=True)
        data = data[order]
    keep = (ids >= 0) & (ids < num_segments)
    ids, data = ids[keep], data[keep]
    if ids.numel() == 0:
        return out
    run_ids, totals = _sorted_segment_totals(data, ids)
    out[run_ids] = totals
    return out


def row_ids_from_indptr(indptr: torch.Tensor, nse: int) -> torch.Tensor:
    """One row id per stored entry from an exclusive row pointer; padding
    positions (>= ``indptr[n]``) get the sentinel ``n``."""
    n = indptr.shape[0] - 1
    if nse == 0:
        return torch.zeros(0, dtype=INDEX_DTYPE, device=indptr.device)
    ptr = indptr.long()
    pos = torch.arange(nse, dtype=torch.long, device=indptr.device)
    ids = torch.searchsorted(ptr, pos, right=True) - 1
    ids = torch.where(pos < ptr[n], ids, torch.full_like(ids, n))
    return ids.to(INDEX_DTYPE)


def repeated_iota(sizes: torch.Tensor, total: int) -> torch.Tensor:
    """``replicated_iota`` (compressed.fut:176): segment ids where element
    ``i`` repeats ``sizes[i]`` times; slots beyond ``sum(sizes)`` carry the
    sentinel ``len(sizes)``."""
    k = sizes.shape[0]
    dev = sizes.device
    if total == 0:
        return torch.zeros(0, dtype=INDEX_DTYPE, device=dev)
    s = sizes.long()
    ends = torch.cumsum(s, 0)
    pos = torch.arange(total, dtype=torch.long, device=dev)
    # first segment whose end exceeds pos (empty segments are skipped)
    ids = torch.searchsorted(ends, pos, right=True)
    valid = pos < (ends[-1] if k else 0)
    return torch.where(valid, ids, torch.full_like(ids, k)).to(INDEX_DTYPE)


def expand(sizes: torch.Tensor, total: int):
    """Flat irregular expansion (reference ``expand``, compressed.fut:129):
    ``(elem_ids, inner_ids)`` of length ``total``; slots beyond
    ``sum(sizes)`` carry the sentinel ``len(sizes)`` and inner id 0."""
    k = sizes.shape[0]
    ids = repeated_iota(sizes, total)
    if total == 0:
        return ids, torch.zeros(0, dtype=INDEX_DTYPE, device=sizes.device)
    s = sizes.long()
    offsets = torch.cumsum(s, 0) - s
    safe = torch.clamp(ids.long(), max=max(k - 1, 0))
    pos = torch.arange(total, dtype=torch.long, device=sizes.device)
    inner = pos - offsets[safe] if k else pos
    inner = torch.where(ids.long() < k, inner, torch.zeros_like(inner))
    return ids, inner.to(INDEX_DTYPE)


def cumsum_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum with the total appended: [0, x0, x0+x1, ...]."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0, dtype=x.dtype)])
