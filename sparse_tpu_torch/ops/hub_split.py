"""Hub/tail split SpMV for power-law patterns (the ``hubsplit`` rung).

Port of ``sparse_tpu/ops/hub_split.py``.  A thin strip of top-degree hub
columns, remapped to a compact space ordered by descending degree, goes
through the segment-tile kernel K1 (window locality manufactured from
degree skew); the tail goes through the row-binned path:
``y = hub_tiles(v[hub_cols]) + tail(v)`` — exact and deterministic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import device_values, host_values
from ..formats.csr import CSR
from .cuda_csr import SegTilePlan, build_seg_tiles, csr_smvm_segtile
from .spmv import SpmvPlan, build_spmv_plan, csr_smvm_fast

__all__ = ["HubSplit", "hub_split_prepare", "hub_split_smvm",
           "hub_mass_fraction", "DEFAULT_HUB_COLS"]

#: Default hub-strip width: four wsub=32 operand windows (the reference's
#: TPU-measured sweet spot; to re-measure on the H100, ROADMAP).
DEFAULT_HUB_COLS = 32 * 128 * 4


def _degrees(a: CSR):
    n, m = a.shape
    indptr = a.indptr.cpu().numpy().astype(np.int64)
    k = int(indptr[-1])
    cols = a.indices[:k].cpu().numpy().astype(np.int64)
    return indptr, k, cols, np.bincount(cols, minlength=m)


def hub_mass_fraction(a: CSR, max_hub_cols: int | None = None) -> float:
    """Fraction of stored entries carried by the top-degree column strip
    (the strip :func:`hub_split_prepare` would take) — a degree histogram,
    cheap enough to gate the full split."""
    n, m = a.shape
    H = min(max_hub_cols if max_hub_cols is not None else DEFAULT_HUB_COLS,
            m)
    _, k, _, deg = _degrees(a)
    if k == 0 or H == 0:
        return 0.0
    top = np.partition(deg, m - H)[m - H:].sum() if H < m else k
    return float(top / k)


@dataclasses.dataclass(frozen=True)
class HubSplit:
    """Prepared hub/tail split (pattern + value bound, like every plan)."""

    hub_csr: CSR
    hub_plan: SegTilePlan
    tail_csr: CSR
    tail_plan: SpmvPlan
    hub_cols: torch.Tensor  # (H,) original column ids of the hub strip
    shape: tuple[int, int]
    hub_nnz: int
    tail_nnz: int

    @property
    def hub_fraction(self) -> float:
        """Fraction of stored entries routed through the tile kernel."""
        tot = self.hub_nnz + self.tail_nnz
        return self.hub_nnz / tot if tot else 0.0


def hub_split_prepare(a: CSR, max_hub_cols: int | None = None,
                      wsub: int = 32) -> HubSplit:
    """Host-side split (once per pattern + values); both halves live on
    ``a``'s device."""
    n, m = a.shape
    H = min(max_hub_cols if max_hub_cols is not None else DEFAULT_HUB_COLS,
            m)
    indptr, k, cols, deg = _degrees(a)
    data = host_values(a.data[:k])
    hub_ids = np.argpartition(deg, m - H)[m - H:] if H < m \
        else np.arange(m, dtype=np.int64)
    hub_ids = hub_ids[np.argsort(-deg[hub_ids], kind="stable")]
    is_hub = np.zeros(m, bool)
    is_hub[hub_ids] = True
    compact = np.zeros(m, np.int64)
    compact[hub_ids] = np.arange(hub_ids.size)
    sel = is_hub[cols]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dev = a.device

    def build(mask, ncols, remap):
        r = rows[mask]
        c = cols[mask]
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(r, minlength=n), out=ptr[1:])
        idx = remap[c] if remap is not None else c
        return CSR(data=device_values(data[mask], a.dtype, dev),
                   indices=torch.from_numpy(idx.astype(np.int32)).to(dev),
                   indptr=torch.from_numpy(ptr).to(dev), shape=(n, ncols))

    hub_csr = build(sel, hub_ids.size, compact)
    tail_csr = build(~sel, m, None)
    return HubSplit(
        hub_csr=hub_csr,
        hub_plan=build_seg_tiles(hub_csr, wsub=wsub),
        tail_csr=tail_csr,
        tail_plan=build_spmv_plan(tail_csr),
        hub_cols=torch.from_numpy(hub_ids.astype(np.int64)).to(dev),
        shape=(n, m),
        hub_nnz=int(sel.sum()),
        tail_nnz=int(k - sel.sum()),
    )


def hub_split_smvm(split: HubSplit, v) -> torch.Tensor:
    """SpMV through the split: hub strip on K1, tail on the row-binned
    path; matches ``csr_smvm`` up to float summation order."""
    v = torch.as_tensor(v, device=split.hub_cols.device)
    n, m = split.shape
    if tuple(v.shape) != (m,):
        raise ValueError(
            f"hub_split_smvm: vector shape {tuple(v.shape)} != ({m},)")
    y_hub = csr_smvm_segtile(split.hub_csr, v[split.hub_cols],
                             split.hub_plan)
    y_tail = csr_smvm_fast(split.tail_csr, v, split.tail_plan)
    return y_hub + y_tail
