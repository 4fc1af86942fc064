"""Row-binned CSR SpMV and SpMM: the ``xla`` rung of the dispatch ladder.

Port of ``sparse_tpu/ops/spmv.py`` in plain PyTorch (the reference left this
path to XLA, so the port leaves it to PyTorch's own ops).  Each row's
entries are viewed as a dense ``(rows, L)`` window of the CSR tensors, so
SpMV is gather -> multiply -> row-sum and SpMM gathers rows of the operand
and contracts the window axis (full float32, ``utils.precision``); rows are
bucketed by length into power-of-2 capacity bins (``SpmvPlan``, once per
pattern) so a few long rows do not inflate the padding of the many short
ones.  ``row_chunk`` bounds the gathered intermediate of each bin.  Every
reduction is a dense row sum: deterministic on every device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csr import CSR
from ..utils.precision import full_precision

__all__ = [
    "csr_smvm_ell",
    "csr_spmm_ell",
    "row_capacity",
    "SpmvPlan",
    "build_spmv_plan",
    "csr_smvm_fast",
    "csr_spmm_fast",
]


def row_capacity(a: CSR) -> int:
    """Max stored entries in any row (host sync): the static ELL width."""
    indptr = a.indptr.cpu().numpy()
    if indptr.shape[0] <= 1:
        return 0
    return int(np.max(indptr[1:] - indptr[:-1]))


def _ell_windows(a: CSR, L: int, rows_sel=None):
    """(idx, val) dense (rows, L) windows of the CSR tensors; masked tails."""
    ptr = a.indptr.long()
    starts = ptr[:-1] if rows_sel is None else ptr[rows_sel]
    ends = ptr[1:] if rows_sel is None else ptr[rows_sel + 1]
    lens = ends - starts
    offs = torch.arange(L, dtype=torch.long, device=ptr.device)
    pos = starts[:, None] + offs[None, :]
    mask = offs[None, :] < lens[:, None]
    pos = torch.clamp(pos, max=max(a.nse - 1, 0))
    idx = torch.where(mask, a.indices.long()[pos], torch.zeros_like(pos))
    val = torch.where(mask, a.data[pos], torch.zeros((), dtype=a.dtype,
                                                      device=ptr.device))
    return idx, val


def csr_smvm_ell(a: CSR, v, L: int) -> torch.Tensor:
    """SpMV via on-the-fly ELL windows; ``L`` must bound the longest row
    (see :func:`row_capacity`)."""
    n, m = a.shape
    v = torch.as_tensor(v, device=a.device)
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if a.nse == 0 or m == 0 or L == 0:
        return torch.zeros(n, dtype=out_dtype, device=a.device)
    idx, val = _ell_windows(a, L)
    g = v.to(out_dtype)[idx.reshape(-1)].reshape(idx.shape)
    return torch.sum(val.to(out_dtype) * g, dim=1)


def _spmm_rows(idx, val, b):
    """Rows of A @ B for ELL windows ``(idx, val)`` of shape (rows, L)."""
    g = b[idx.reshape(-1)].reshape(*idx.shape, b.shape[1])
    with full_precision(b.dtype):
        return torch.einsum("nl,nlk->nk", val.to(b.dtype), g)


def _dense_operand(name: str, a: CSR, b):
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    if b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"{name}: operand shape {tuple(b.shape)} != "
                         f"({a.shape[1]}, k)")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    return b.to(out_dtype), out_dtype


def csr_spmm_ell(a: CSR, b, L: int) -> torch.Tensor:
    """SpMM (CSR x dense (m, k)) via ELL windows: gather rows of ``b`` and
    contract the window axis; ``L`` bounds the longest row."""
    n, m = a.shape
    b, out_dtype = _dense_operand("csr_spmm_ell", a, b)
    k = b.shape[1]
    if a.nse == 0 or m == 0 or k == 0 or L == 0:
        return torch.zeros(n, k, dtype=out_dtype, device=a.device)
    idx, val = _ell_windows(a, L)
    return _spmm_rows(idx, val, b)


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """Row-binning plan: ``perm`` orders rows by length bin; bin ``i`` covers
    ``bin_sizes[i]`` rows with static ELL capacity ``bin_caps[i]``."""

    perm: torch.Tensor
    bin_sizes: tuple[int, ...]
    bin_caps: tuple[int, ...]
    n: int


def build_spmv_plan(a: CSR) -> SpmvPlan:
    """Bucket rows into power-of-2 length bins (host, once per pattern)."""
    indptr = a.indptr.cpu().numpy()
    n = a.shape[0]
    lens = indptr[1:] - indptr[:-1]
    caps = np.zeros(n, np.int64)
    nz = lens > 0
    caps[nz] = 2 ** np.ceil(np.log2(lens[nz])).astype(np.int64)
    order = np.argsort(caps, kind="stable")
    sorted_caps = caps[order]
    uniq, counts = np.unique(sorted_caps, return_counts=True)
    keep = uniq > 0
    skip = int(counts[~keep].sum())  # empty rows contribute nothing
    return SpmvPlan(
        perm=torch.from_numpy(order[skip:].astype(np.int64)).to(a.device),
        bin_sizes=tuple(int(c) for c in counts[keep]),
        bin_caps=tuple(int(u) for u in uniq[keep]),
        n=n,
    )


def _apply_plan(a: CSR, operand, plan: SpmvPlan, rows_fn,
                row_chunk: int | None = None):
    """``rows_fn(idx, val, operand)`` over every bin's ELL windows, in plan
    order.  With ``row_chunk`` set, each bin runs in chunks of that many
    rows, so the gathered intermediate stays at ``row_chunk * cap * width``
    elements (SpMM with a large k)."""
    if row_chunk is not None and row_chunk < 1:
        raise ValueError(f"row_chunk must be >= 1, got {row_chunk}")
    pieces = []
    start = 0
    for size, cap in zip(plan.bin_sizes, plan.bin_caps):
        step = size if row_chunk is None else row_chunk
        for s in range(start, start + size, step):
            rows_sel = plan.perm[s:min(s + step, start + size)]
            idx, val = _ell_windows(a, cap, rows_sel=rows_sel)
            pieces.append(rows_fn(idx, val, operand))
        start += size
    return torch.cat(pieces)


def _smvm_rows(idx, val, v):
    g = v[idx.reshape(-1)].reshape(idx.shape)
    return torch.sum(val.to(v.dtype) * g, dim=1)


def csr_smvm_fast(a: CSR, v, plan: SpmvPlan | None = None,
                  row_chunk: int | None = None) -> torch.Tensor:
    """Row-binned SpMV (plan built here when not given); ``row_chunk``
    bounds the rows gathered at once."""
    n, m = a.shape
    v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (m,):
        raise ValueError(
            f"csr_smvm_fast: vector shape {tuple(v.shape)} != ({m},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if plan is None:
        plan = build_spmv_plan(a)
    out = torch.zeros(n, dtype=out_dtype, device=a.device)
    if not plan.bin_sizes or a.nse == 0 or m == 0:
        return out
    # out of place, so torch.func.vmap can batch the operand
    return out.index_put((plan.perm,), _apply_plan(
        a, v.to(out_dtype), plan, _smvm_rows, row_chunk))


def csr_spmm_fast(a: CSR, b, plan: SpmvPlan | None = None,
                  row_chunk: int | None = None) -> torch.Tensor:
    """Row-binned SpMM (CSR x dense (m, k)).  Set ``row_chunk`` to bound
    the gathered intermediate at ``row_chunk * L * k`` elements."""
    n, m = a.shape
    b, out_dtype = _dense_operand("csr_spmm_fast", a, b)
    k = b.shape[1]
    if plan is None:
        plan = build_spmv_plan(a)
    out = torch.zeros(n, k, dtype=out_dtype, device=a.device)
    if not plan.bin_sizes or a.nse == 0 or m == 0 or k == 0:
        return out
    return out.index_put((plan.perm,),
                         _apply_plan(a, b, plan, _spmm_rows, row_chunk))
