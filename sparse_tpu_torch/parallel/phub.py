"""Distributed hub/tail SpMV: the power-law class over a mesh.

Port of ``sparse_tpu/parallel/phub.py``.  Each shard holds its row slab
split hub/tail as the single-card split does (``ops/hub_split.py``): hub
entries remapped into a shared degree-ordered compact space, the rest as
(value, global column, local row) triples.  The hub operand — the ``H``
top-degree entries of ``v``, which every shard reads — is assembled by one
``all_gather`` of each shard's owned hub entries (O(H) per shard); the
tail's columns are dense in ``m`` on this class, so it all-gathers the
whole operand (the O(m) term this class cannot avoid).  The per-shard sums
are plain PyTorch, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csr import CSR
from ..ops.segmented import segment_sum
from .mesh import Mesh
from .pcsr import _csr_host, _gathered, _slabs, put_sharded

__all__ = ["PHubSplit", "phub_partition", "phub_spmv"]


@dataclasses.dataclass(frozen=True)
class PHubSplit:
    """Row-partitioned hub/tail split.

    Per shard (leading shard axis): hub entries as (data, compact-hub col,
    local row) triples and tail entries as (data, global col, local row)
    triples, both padded with sentinel rows; ``own_hub_idx[d]``: the
    positions within shard d's operand slab of the hub entries it owns
    (padded with 0 — the all_gather assembles the shared hub operand)."""

    hub_data: torch.Tensor   # (D, nse_hub_p)
    hub_idx: torch.Tensor    # (D, nse_hub_p) compact hub ids
    hub_rows: torch.Tensor   # (D, nse_hub_p) local rows (rows_p = dropped)
    tail_data: torch.Tensor  # (D, nse_tail_p)
    tail_idx: torch.Tensor   # (D, nse_tail_p) global cols
    tail_rows: torch.Tensor  # (D, nse_tail_p)
    own_hub_idx: torch.Tensor  # (D, hub_cols_per_shard)
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    cols_per_shard: int
    hub_cols_per_shard: int
    n_hub: int
    n_shards: int

    @property
    def hub_comm_entries_per_device(self) -> int:
        """The O(H) hub-operand assembly payload per shard."""
        return self.n_shards * self.hub_cols_per_shard


def phub_partition(a: CSR, mesh: Mesh, axis: str = "shards",
                   max_hub_cols: int | None = None) -> PHubSplit:
    """Host split (once per pattern + mesh): contiguous row slabs; hubs =
    the ``max_hub_cols`` highest-degree columns, compact space ordered by
    descending degree."""
    from ..ops.hub_split import DEFAULT_HUB_COLS

    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    cols_p = -(-max(m, 1) // d)
    indptr, indices, data = _csr_host(a)
    k = int(indptr[-1])
    cols = indices[:k].astype(np.int64)
    data = data[:k]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    H = min(max_hub_cols if max_hub_cols is not None else DEFAULT_HUB_COLS,
            m)
    deg = np.bincount(cols, minlength=m)
    hub_ids = np.argpartition(deg, m - H)[m - H:] if H < m else \
        np.arange(m, dtype=np.int64)
    hub_ids = hub_ids[np.argsort(-deg[hub_ids], kind="stable")]
    is_hub = np.zeros(m, bool)
    is_hub[hub_ids] = True

    # shard s owns operand entries [s*cols_p, (s+1)*cols_p); the gathered
    # hub operand is [shard 0's owned hubs | shard 1's | ...], each part in
    # global degree order, and the compact remap matches that layout
    owner = hub_ids // cols_p
    hub_pc = max(int(np.bincount(owner, minlength=d).max()), 1) if H else 1
    own = np.zeros((d, hub_pc), np.int64)
    gathered_pos = np.zeros(H, np.int64)
    fill = np.zeros(d, np.int64)
    for j, c in enumerate(hub_ids):
        s = int(owner[j])
        own[s, fill[s]] = c - s * cols_p
        gathered_pos[j] = s * hub_pc + fill[s]
        fill[s] += 1
    compact_g = np.zeros(m, np.int64)
    compact_g[hub_ids] = gathered_pos

    sel = is_hub[cols]

    def pack(mask, idx_map):
        per = []
        for s in range(d):
            lo, hi = min(s * rows_p, n), min((s + 1) * rows_p, n)
            in_slab = (rows >= lo) & (rows < hi) & mask
            per.append((data[in_slab], idx_map[cols[in_slab]],
                        rows[in_slab] - lo))
        cap = max(max(p[0].size for p in per), 1)
        dv = np.zeros((d, cap), data.dtype)
        iv = np.zeros((d, cap), np.int64)
        rv = np.full((d, cap), rows_p, np.int64)  # sentinel -> dropped
        for s, (dd, ii, rr) in enumerate(per):
            dv[s, : dd.size] = dd
            iv[s, : ii.size] = ii
            rv[s, : rr.size] = rr
        return dv, iv.astype(np.int32), rv.astype(np.int32)

    hd, hi, hr = pack(sel, compact_g)
    td, ti, tr = pack(~sel, np.arange(m, dtype=np.int64))

    def put(x, dtype=None):
        return put_sharded(x, mesh, axis, dtype)

    return PHubSplit(
        hub_data=put(hd, a.dtype), hub_idx=put(hi), hub_rows=put(hr),
        tail_data=put(td, a.dtype), tail_idx=put(ti), tail_rows=put(tr),
        own_hub_idx=put(own.astype(np.int32)),
        shape=(n, m), axis=axis, rows_per_shard=rows_p,
        cols_per_shard=cols_p, hub_cols_per_shard=hub_pc, n_hub=H,
        n_shards=d,
    )


def phub_spmv(a: PHubSplit, v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed hub/tail SpMV; ``v`` sharded to ``cols_per_shard * D``
    (``shard_vector``), output padded row-sharded.  One all_gather of the
    owned hub entries (O(H)), one of the whole operand for the tail."""
    vl = _slabs(v, mesh)
    shard = torch.arange(mesh.local, device=vl.device)[:, None]
    v_hub = mesh.all_gather(vl[shard, a.own_hub_idx.long()]).reshape(-1)
    v_full = _gathered(v, mesh)
    rows_p = a.rows_per_shard
    out = []
    for i in range(mesh.local):
        y = segment_sum(a.hub_data[i] * v_hub[a.hub_idx[i].long()],
                        a.hub_rows[i], rows_p)
        out.append(y + segment_sum(a.tail_data[i]
                                   * v_full[a.tail_idx[i].long()],
                                   a.tail_rows[i], rows_p))
    return torch.cat(out)
