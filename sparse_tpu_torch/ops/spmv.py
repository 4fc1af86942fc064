"""Row-binned CSR SpMV: the ``xla`` rung of the dispatch ladder.

Port of the SpMV half of ``sparse_tpu/ops/spmv.py`` in plain PyTorch (the
reference left this path to XLA, so the port leaves it to PyTorch's own
ops).  Each row's entries are viewed as a dense ``(rows, L)`` window of the
CSR tensors, so SpMV is gather -> multiply -> row-sum; rows are bucketed by
length into power-of-2 capacity bins (``SpmvPlan``, once per pattern) so a
few long rows do not inflate the padding of the many short ones.  Every
reduction is a dense row sum: deterministic on every device.  The SpMM half
(``csr_spmm_ell``/``csr_spmm_fast``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csr import CSR

__all__ = [
    "csr_smvm_ell",
    "row_capacity",
    "SpmvPlan",
    "build_spmv_plan",
    "csr_smvm_fast",
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


def csr_smvm_fast(a: CSR, v, plan: SpmvPlan | None = None) -> torch.Tensor:
    """Row-binned SpMV (plan built here when not given)."""
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
    vv = v.to(out_dtype)
    pieces = []
    start = 0
    for size, cap in zip(plan.bin_sizes, plan.bin_caps):
        rows_sel = plan.perm[start:start + size]
        idx, val = _ell_windows(a, cap, rows_sel=rows_sel)
        g = vv[idx.reshape(-1)].reshape(idx.shape)
        pieces.append(torch.sum(val.to(out_dtype) * g, dim=1))
        start += size
    out[plan.perm] = torch.cat(pieces)
    return out
