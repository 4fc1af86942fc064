"""Distributed SpGEMM and transpose for row-partitioned CSR.

Port of ``sparse_tpu/parallel/pspgemm.py``.  1-D row-partition algebra:
``C_i = A_i @ B``, so each shard's output slab needs the B rows its A
columns name.  :func:`pcsr_spgemm` all-gathers B's padded per-shard
storage; :func:`pcsr_spgemm_aa` moves only the needed B rows' values with
one ``all_to_all`` under a plan built once per (pattern pair, mesh).  Both
run the port's ESC core (``ops/spgemm.spgemm_products``) per shard on the
gathered storage through its (starts, lengths) row interface, and keep the
output row-partitioned.  :func:`pcsr_transpose_device` repartitions A^T by
a values-only ``all_to_all`` into a structure planned on the host.
Everything is plain PyTorch, as the reference is plain XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.coo import COO
from ..formats.csr import CSR, csr_from_coo
from ..ops.segmented import INDEX_DTYPE
from ..ops.spgemm import spgemm_products
from .mesh import Mesh
from .pcsr import PCSR, _all_shards, put_sharded

__all__ = [
    "pcsr_spgemm",
    "pcsr_transpose",
    "PSpGEMMPlan",
    "build_pspgemm_plan",
    "pcsr_spgemm_aa",
    "PTransposePlan",
    "build_transpose_plan",
    "pcsr_transpose_device",
]


def _check_pair(name, a: PCSR, b: PCSR):
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: inner dims {a.shape} @ {b.shape}")
    if a.axis != b.axis or a.n_shards != b.n_shards:
        raise ValueError(f"{name}: operands must share the mesh axis")


def _shard_product(a: PCSR, i: int, bd, bi, starts, lens, k, cap):
    """One shard's C slab: ESC products against the combined B storage,
    merged into CSR (capacity ``cap``)."""
    rows_p = a.rows_per_shard
    local_a = CSR(data=a.data[i], indices=a.indices[i], indptr=a.indptr[i],
                  shape=(rows_p, a.shape[1]))
    prods = spgemm_products(local_a, bd, bi, starts, lens, k, cap)
    return csr_from_coo(COO(row=prods.row, col=prods.col, data=prods.data,
                            shape=(rows_p, k)))


def _stack_csr(parts, a: PCSR, k: int) -> PCSR:
    return PCSR(data=torch.stack([c.data for c in parts]),
                indices=torch.stack([c.indices for c in parts]),
                indptr=torch.stack([c.indptr for c in parts]),
                shape=(a.shape[0], k), axis=a.axis,
                rows_per_shard=a.rows_per_shard, n_shards=a.n_shards)


def pcsr_spgemm(a: PCSR, b: PCSR, mesh: Mesh,
                expansion_nse: int | None = None) -> PCSR:
    """C = A @ B, both row-partitioned over the same mesh axis; returns C
    row-partitioned with per-shard capacity ``expansion_nse`` (the max
    per-shard product count when None, from a host pass)."""
    _check_pair("pcsr_spgemm", a, b)
    m, k = b.shape
    d = a.n_shards
    b_ptr_all = _all_shards(b.indptr, mesh).astype(np.int64)
    if expansion_nse is None:
        b_lens_global = np.diff(b_ptr_all, axis=1).reshape(-1)[:m]
        a_ptr = _all_shards(a.indptr, mesh)
        a_idx = _all_shards(a.indices, mesh)
        f = 0
        for s in range(d):
            f = max(f, int(b_lens_global[a_idx[s, :a_ptr[s, -1]]].sum()))
        expansion_nse = max(f, 1)

    bd = mesh.all_gather(b.data)  # (D, nse_p): shard rows stay contiguous
    bi = mesh.all_gather(b.indices)
    bp = mesh.all_gather(b.indptr).long()
    nse_p = bd.shape[1]
    off = (torch.arange(d, device=bp.device) * nse_p)[:, None]
    starts = (bp[:, :-1] + off).reshape(-1)[:m]
    lens = (bp[:, 1:] - bp[:, :-1]).reshape(-1)[:m].to(INDEX_DTYPE)
    parts = [_shard_product(a, i, bd.reshape(-1), bi.reshape(-1), starts,
                            lens, k, expansion_nse)
             for i in range(mesh.local)]
    return _stack_csr(parts, a, k)


def pcsr_transpose(a: PCSR, mesh: Mesh) -> PCSR:
    """A^T row-partitioned: builds the all-to-all plan (host pass, once per
    pattern) and applies it (:func:`pcsr_transpose_device`)."""
    return pcsr_transpose_device(a, mesh, build_transpose_plan(a, mesh))


def _shard_entries(ptr: np.ndarray):
    """(local_row, pos) of a shard's valid entries, from its row pointer."""
    cnt = int(ptr[-1])
    rows = np.searchsorted(ptr, np.arange(cnt), side="right") - 1
    return rows, np.arange(cnt)


@dataclasses.dataclass(frozen=True)
class PSpGEMMPlan:
    """Static all-to-all plan for :func:`pcsr_spgemm_aa` (one per pattern
    pair + mesh).  ``send_pos[s, t]``: positions in shard s's padded B
    storage to send to shard t; ``bi_gath[t, s]``: the column ids those
    slots carry (receiver side); ``starts``/``lens``: per global B row,
    offsets into the receiver's combined [recv | local] storage (0 length
    for rows the shard never multiplies).  ``exch``: the padded per-pair
    entry count; ``cap``: the per-shard ESC capacity."""

    send_pos: torch.Tensor  # (D, D, E) int32
    bi_gath: torch.Tensor   # (D, D, E) int32
    starts: torch.Tensor    # (D, m) int32
    lens: torch.Tensor      # (D, m) int32
    exch: int
    cap: int
    k: int

    @property
    def comm_entries_per_device(self) -> int:
        return self.send_pos.shape[1] * self.exch


def build_pspgemm_plan(a: PCSR, b: PCSR, mesh: Mesh) -> PSpGEMMPlan:
    """Host symbolic pass (once per pattern pair + mesh)."""
    _check_pair("build_pspgemm_plan", a, b)
    m, k = b.shape
    d = a.n_shards
    b_rows_p = b.rows_per_shard
    b_ptrs = _all_shards(b.indptr, mesh).astype(np.int64)
    b_idx = _all_shards(b.indices, mesh)
    a_ptrs = _all_shards(a.indptr, mesh).astype(np.int64)
    a_idx = _all_shards(a.indices, mesh).astype(np.int64)
    b_lens_global = np.zeros(max(m, 1), np.int64)
    for s in range(d):
        lo = s * b_rows_p
        hi = min(lo + b_rows_p, m)
        b_lens_global[lo:hi] = np.diff(b_ptrs[s])[: max(hi - lo, 0)]

    # per destination: the distinct B rows its A slab names
    need = []
    cap = 1
    for t in range(d):
        cols = a_idx[t, : a_ptrs[t, -1]]
        need.append(np.unique(cols))
        cap = max(cap, int(b_lens_global[cols].sum()))

    pos_lists = [[None] * d for _ in range(d)]
    exch = 1
    for t in range(d):
        for s in range(d):
            if s == t:
                continue
            rs = need[t][(need[t] >= s * b_rows_p)
                         & (need[t] < (s + 1) * b_rows_p)]
            ptr = b_ptrs[s]
            segs = [np.arange(ptr[r], ptr[r + 1]) for r in rs - s * b_rows_p]
            pos = np.concatenate(segs) if segs else np.zeros(0, np.int64)
            pos_lists[s][t] = (pos, rs)
            exch = max(exch, pos.size)

    send_pos = np.zeros((d, d, exch), np.int32)
    bi_gath = np.zeros((d, d, exch), np.int32)
    starts = np.zeros((d, max(m, 1)), np.int32)
    lens = np.zeros((d, max(m, 1)), np.int32)
    for t in range(d):
        for s in range(d):
            if s == t:
                continue
            pos, rs = pos_lists[s][t]
            send_pos[s, t, : pos.size] = pos
            bi_gath[t, s, : pos.size] = b_idx[s][pos]
            # rows arrive concatenated in row order at s * exch
            o = s * exch
            for r in rs:
                ln = int(b_lens_global[r])
                starts[t, r] = o
                lens[t, r] = ln
                o += ln
        # own rows: read from local storage, after the recv block
        own = need[t][(need[t] >= t * b_rows_p)
                      & (need[t] < (t + 1) * b_rows_p)]
        for r in own:
            starts[t, r] = d * exch + int(b_ptrs[t][r - t * b_rows_p])
            lens[t, r] = int(b_lens_global[r])

    def put(x):
        return put_sharded(x, mesh, a.axis)

    return PSpGEMMPlan(send_pos=put(send_pos), bi_gath=put(bi_gath),
                       starts=put(starts), lens=put(lens), exch=exch,
                       cap=cap, k=k)


def pcsr_spgemm_aa(a: PCSR, b: PCSR, mesh: Mesh,
                   plan: PSpGEMMPlan) -> PCSR:
    """C = A @ B via a values-only all-to-all of the needed B rows
    (``plan.comm_entries_per_device`` values per shard — O(nnz_B / D) for
    patterns with column locality — against the all-gather's O(nnz_B))."""
    k = b.shape[1]
    shard = torch.arange(mesh.local, device=b.data.device)[:, None, None]
    recv = mesh.all_to_all(b.data[shard, plan.send_pos.long()])
    parts = []
    for i in range(mesh.local):
        # combined storage: [exchanged remote rows | whole local slab]
        bd = torch.cat([recv[i].reshape(-1), b.data[i]])
        bi = torch.cat([plan.bi_gath[i].reshape(-1),
                        b.indices[i].to(torch.int32)])
        parts.append(_shard_product(a, i, bd, bi, plan.starts[i],
                                    plan.lens[i].to(INDEX_DTYPE), k,
                                    plan.cap))
    return _stack_csr(parts, a, k)


@dataclasses.dataclass(frozen=True)
class PTransposePlan:
    """Static all-to-all plan for :func:`pcsr_transpose_device`.

    ``send_pos[s, t]``: positions in shard s's padded value storage whose
    entries land on shard t of A^T; ``perm``: per destination, the gather
    map from the combined [recv | local | 0] value storage into the output
    CSR slot order; ``indices``/``indptr``: the structure of A^T's shards."""

    send_pos: torch.Tensor  # (D, D, E) int32
    perm: torch.Tensor      # (D, nse_pT) int32
    indices: torch.Tensor   # (D, nse_pT)
    indptr: torch.Tensor    # (D, rows_pT + 1)
    exch: int
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    n_shards: int

    @property
    def comm_entries_per_device(self) -> int:
        """all_to_all payload per shard (D pair slots x padded pair
        width)."""
        return self.send_pos.shape[1] * self.exch


def build_transpose_plan(a: PCSR, mesh: Mesh) -> PTransposePlan:
    """Host symbolic pass for the device transpose (once per pattern)."""
    n, m = a.shape
    d = a.n_shards
    rows_p = a.rows_per_shard
    nse_p = a.nse_per_shard
    rows_pT = -(-max(m, 1) // d)
    ptrs = _all_shards(a.indptr, mesh).astype(np.int64)
    idxs = _all_shards(a.indices, mesh).astype(np.int64)

    ent = []  # per source: (local_pos, global_row, col, dst)
    for s in range(d):
        lr, pos = _shard_entries(ptrs[s])
        cols = idxs[s, : pos.size]
        ent.append((pos, s * rows_p + lr, cols,
                    np.minimum(cols // rows_pT, d - 1)))

    exch = 1
    for s in range(d):
        dst = ent[s][3]
        for t in range(d):
            if s != t:
                exch = max(exch, int((dst == t).sum()))

    send_pos = np.zeros((d, d, exch), np.int32)
    recs = [[] for _ in range(d)]  # per dst: (rowT, colT, storage_index)
    for s in range(d):
        pos, g, cols, dst = ent[s]
        for t in range(d):
            sel = dst == t
            if s == t:  # local entries: storage index D*E + local position
                base_idx = d * exch + pos[sel]
            else:
                send_pos[s, t, : int(sel.sum())] = pos[sel]
                base_idx = s * exch + np.arange(int(sel.sum()))
            recs[t].append((cols[sel] - t * rows_pT, g[sel], base_idx))

    nse_pT = 1
    per_dst = []
    for t in range(d):
        rT = np.concatenate([r[0] for r in recs[t]])
        cT = np.concatenate([r[1] for r in recs[t]])
        si = np.concatenate([r[2] for r in recs[t]])
        order = np.lexsort((cT, rT))
        per_dst.append((rT[order], cT[order], si[order]))
        nse_pT = max(nse_pT, rT.size)

    perm = np.full((d, nse_pT), d * exch + nse_p, np.int32)  # -> appended 0
    indices = np.zeros((d, nse_pT), np.int32)
    indptr = np.zeros((d, rows_pT + 1), np.int32)
    for t in range(d):
        rT, cT, si = per_dst[t]
        perm[t, : si.size] = si
        indices[t, : cT.size] = cT
        indptr[t, 1:] = np.cumsum(np.bincount(rT, minlength=rows_pT))

    def put(x):
        return put_sharded(x, mesh, a.axis)

    return PTransposePlan(send_pos=put(send_pos), perm=put(perm),
                          indices=put(indices), indptr=put(indptr),
                          exch=exch, shape=(m, n), axis=a.axis,
                          rows_per_shard=rows_pT, n_shards=d)


def pcsr_transpose_device(a: PCSR, mesh: Mesh,
                          plan: PTransposePlan) -> PCSR:
    """A^T row-partitioned, computed on the device: one values-only
    all_to_all (O(nnz/D) per shard) and one gather into the plan's
    structure."""
    shard = torch.arange(mesh.local, device=a.data.device)[:, None, None]
    recv = mesh.all_to_all(a.data[shard, plan.send_pos.long()])
    zero = a.data.new_zeros(1)
    vals = torch.stack([
        torch.cat([recv[i].reshape(-1), a.data[i], zero])[plan.perm[i].long()]
        for i in range(mesh.local)])
    return PCSR(data=vals, indices=plan.indices, indptr=plan.indptr,
                shape=plan.shape, axis=a.axis,
                rows_per_shard=plan.rows_per_shard, n_shards=a.n_shards)
