"""Halo-exchange distributed SpMV: move only the operand entries each shard
reads.

Port of ``sparse_tpu/parallel/halo.py``.  ``pcsr_spmv`` all-gathers the whole
operand (O(m) per shard).  For matrices with column locality each row slab
touches few remote columns: the plans here record, once per (pattern,
mesh), which entries each shard pair exchanges, and the apply is one
``all_to_all`` of the padded halo buffers followed by a local SpMV whose
column indices were remapped at plan time into the received layout.

Three plans:

* :class:`HaloPCSR` — every column a shard reads, its own included, goes
  through the exchange; the local SpMV is a gather and ``segment_sum``.
* :class:`HaloPCSROverlap` — each shard's entries split into interior
  (own operand slab) and frontier (remote) parts; only the frontier
  travels.  On a process-group mesh the ``all_to_all`` is issued
  asynchronously and the interior partial sum runs while it is in flight;
  on an in-process mesh there is nothing to overlap.  The result is the
  same either way.
* :class:`HaloSegtile` — the frontier exchange of the overlapped plan, and
  per shard the segment-tile SpMV over a plan built once at partition time
  (:func:`~..ops.cuda_csr.build_seg_tiles`, with its compact stream): on
  CUDA tensors kernel K1 runs once per shard per apply
  (:func:`~..ops.cuda_csr.segtile_stream_apply`), on CPU tensors its plain
  version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csr import CSR
from ..ops.segmented import segment_sum
from .mesh import Mesh
from .pcsr import PCSR, _csr_host, _local_spmv, _slabs, pcsr_spmv, \
    put_sharded

__all__ = [
    "HaloPCSR",
    "halo_partition",
    "halo_spmv",
    "halo_spmm",
    "HaloPCSROverlap",
    "halo_partition_overlapped",
    "halo_spmv_overlapped",
    "halo_spmm_overlapped",
    "HaloSegtile",
    "halo_partition_segtile",
    "halo_spmv_segtile",
    "dist_spmv",
]


@dataclasses.dataclass(frozen=True)
class HaloPCSR:
    """Row-partitioned CSR with a precomputed halo-exchange plan.

    ``data``/``indices``/``indptr``: per-shard local CSR (leading shard
    axis); ``indices`` are remapped into the halo buffer layout
    ``s * halo + rank`` (entry rank within the halo received from shard s).
    ``send_idx[d, t]``: positions within shard d's operand slab to send to
    shard t (padded with 0)."""

    data: torch.Tensor  # (D, nse_p)
    indices: torch.Tensor  # (D, nse_p) halo-space column ids
    indptr: torch.Tensor  # (D, rows_p + 1)
    send_idx: torch.Tensor  # (D, D, halo)
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    cols_per_shard: int
    halo: int
    n_shards: int

    @property
    def comm_entries_per_device(self) -> int:
        """all_to_all payload per shard, in operand entries (D * halo)."""
        return self.n_shards * self.halo


def _slab_bounds(dst, rows_p, n, indptr):
    lo, hi = min(dst * rows_p, n), min((dst + 1) * rows_p, n)
    return lo, hi, int(indptr[lo]), int(indptr[hi])


def _local_ptr(indptr, lo, hi, rows_p):
    ptr = np.zeros(rows_p + 1, np.int64)
    ptr[: hi - lo + 1] = indptr[lo: hi + 1] - indptr[lo]
    ptr[hi - lo + 1:] = ptr[hi - lo]
    return ptr


def _remote_by_src(uniq, dst, d, cols_p, own_too):
    """The sorted columns of ``uniq`` each source shard holds, as offsets
    in its slab; the destination's own slab is empty unless ``own_too``."""
    return [
        np.zeros(0, np.int64) if (src == dst and not own_too)
        else uniq[(uniq >= src * cols_p) & (uniq < (src + 1) * cols_p)]
        - src * cols_p
        for src in range(d)
    ]


def _send_table(needed, d, halo):
    send = np.zeros((d, d, halo), np.int32)
    for dst in range(d):
        for src in range(d):
            b = needed[dst][src]
            send[src, dst, : b.size] = b
    return send


def _halo_remap(needed_dst, d, m, cols_p, halo, base=0):
    """Global column -> position in the received halo (``base`` + src *
    halo + rank)."""
    remap = np.zeros(m + 1, np.int64)
    for src in range(d):
        b = needed_dst[src]
        remap[src * cols_p + b] = base + src * halo + np.arange(b.size)
    return remap


def halo_partition(a: CSR, mesh: Mesh, axis: str = "shards") -> HaloPCSR:
    """Build the halo plan (host pass, once per sparsity pattern + mesh)."""
    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    cols_p = -(-max(m, 1) // d)
    indptr, indices, data = _csr_host(a)

    needed, local_idx, local_ptr, local_dat = [], [], [], []
    halo = 1
    for dst in range(d):
        lo, hi, s, e = _slab_bounds(dst, rows_p, n, indptr)
        cols = indices[s:e].astype(np.int64)
        by_src = _remote_by_src(np.unique(cols), dst, d, cols_p, True)
        needed.append(by_src)
        halo = max(halo, max((b.size for b in by_src), default=0))
        local_ptr.append(_local_ptr(indptr, lo, hi, rows_p))
        local_idx.append(cols)
        local_dat.append(data[s:e])

    send = _send_table(needed, d, halo)
    local_idx = [_halo_remap(needed[dst], d, m, cols_p, halo)[local_idx[dst]]
                 for dst in range(d)]
    nse_p = max(max((x.size for x in local_idx), default=0), 1)
    idxs = np.zeros((d, nse_p), np.int32)
    vals = np.zeros((d, nse_p), data.dtype)
    for i in range(d):
        idxs[i, : local_idx[i].size] = local_idx[i]
        vals[i, : local_dat[i].size] = local_dat[i]
    ptrs = np.stack(local_ptr).astype(np.int32)
    return HaloPCSR(
        data=put_sharded(vals, mesh, axis, a.dtype),
        indices=put_sharded(idxs, mesh, axis),
        indptr=put_sharded(ptrs, mesh, axis),
        send_idx=put_sharded(send, mesh, axis),
        shape=(n, m),
        axis=axis,
        rows_per_shard=rows_p,
        cols_per_shard=cols_p,
        halo=halo,
        n_shards=d,
    )


def _exchange(send_idx, v, mesh: Mesh, async_op: bool = False):
    """Gather each shard's outgoing halo entries (row t: what it sends to
    shard t) from its operand slab and ``all_to_all`` them; returns the
    received ``[local, D, H, ...]`` buffers (or the pending collective)."""
    vl = _slabs(v, mesh)
    shard = torch.arange(mesh.local, device=vl.device)[:, None, None]
    send = vl[shard, send_idx.long()]
    return mesh.all_to_all(send, async_op=async_op)


def _halo_apply(a: HaloPCSR, v, mesh: Mesh) -> torch.Tensor:
    recv = _exchange(a.send_idx, v, mesh)
    tail = tuple(v.shape[1:])
    return torch.cat([
        _local_spmv(a.data[i], a.indices[i], a.indptr[i],
                    recv[i].reshape((-1,) + tail))
        for i in range(mesh.local)])


def halo_spmv(a: HaloPCSR, v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed SpMV with halo exchange.  ``v`` sharded over the mesh,
    padded to ``cols_per_shard * D`` (``shard_vector``); output padded
    row-sharded.  Comm: one all_to_all of (D * halo) entries per shard."""
    return _halo_apply(a, v, mesh)


def halo_spmm(a: HaloPCSR, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed SpMM with halo exchange: ``b`` is ``(cols_per_shard * D,
    k)`` row-sharded; the all_to_all carries ``D * halo`` operand rows."""
    return _halo_apply(a, b, mesh)


@dataclasses.dataclass(frozen=True)
class HaloPCSROverlap:
    """Row-partitioned CSR split for compute/comm overlap.

    Each shard's entries are split at plan time into interior entries
    (column in the shard's own operand slab, indexed directly into it) and
    frontier entries (remote columns, indexed into the received halo buffer
    ``src * halo + rank``).  Only frontier columns travel."""

    int_data: torch.Tensor  # (D, nse_int_p)
    int_idx: torch.Tensor   # (D, nse_int_p) local-slab column ids
    int_rows: torch.Tensor  # (D, nse_int_p) local row ids (rows_p = padding)
    fr_data: torch.Tensor   # (D, nse_fr_p)
    fr_idx: torch.Tensor    # (D, nse_fr_p) halo-space ids src * halo + rank
    fr_rows: torch.Tensor   # (D, nse_fr_p)
    send_idx: torch.Tensor  # (D, D, halo)
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    cols_per_shard: int
    halo: int
    n_shards: int

    @property
    def comm_entries_per_device(self) -> int:
        """all_to_all payload per shard, in operand entries."""
        return self.n_shards * self.halo


def _pad_triples(parts, idx_parts, row_parts, d, rows_p, dtype):
    """Stack per-shard (value, index, row) lists, padded with sentinel rows
    ``rows_p`` (dropped by ``segment_sum``)."""
    cap = max(max((p.size for p in parts), default=0), 1)
    vals = np.zeros((d, cap), dtype)
    idxs = np.zeros((d, cap), np.int32)
    rows = np.full((d, cap), rows_p, np.int32)
    for i in range(d):
        k = parts[i].size
        vals[i, :k] = parts[i]
        idxs[i, :k] = idx_parts[i]
        rows[i, :k] = row_parts[i]
    return vals, idxs, rows


def halo_partition_overlapped(a: CSR, mesh: Mesh,
                              axis: str = "shards") -> HaloPCSROverlap:
    """Build the interior/frontier split plan (host pass, once per pattern
    + mesh)."""
    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    cols_p = -(-max(m, 1) // d)
    indptr, indices, data = _csr_host(a)

    needed, per_int, per_fr = [], [], []
    halo = 1
    for dst in range(d):
        lo, hi, s, e = _slab_bounds(dst, rows_p, n, indptr)
        cols = indices[s:e].astype(np.int64)
        vals = data[s:e]
        rows = np.searchsorted(indptr[lo: hi + 1], np.arange(s, e),
                               side="right") - 1
        own = (cols >= dst * cols_p) & (cols < (dst + 1) * cols_p)
        per_int.append((vals[own], cols[own] - dst * cols_p, rows[own]))
        per_fr.append((vals[~own], cols[~own], rows[~own]))
        by_src = _remote_by_src(np.unique(cols[~own]), dst, d, cols_p, False)
        needed.append(by_src)
        halo = max(halo, max((b.size for b in by_src), default=0))

    send = _send_table(needed, d, halo)
    fr_remapped = [_halo_remap(needed[dst], d, m, cols_p, halo)[per_fr[dst][1]]
                   for dst in range(d)]
    iv, ii, ir = _pad_triples([p[0] for p in per_int],
                              [p[1] for p in per_int],
                              [p[2] for p in per_int], d, rows_p, data.dtype)
    fv, fi, fr = _pad_triples([p[0] for p in per_fr], fr_remapped,
                              [p[2] for p in per_fr], d, rows_p, data.dtype)

    def put(x, dtype=None):
        return put_sharded(x, mesh, axis, dtype)

    return HaloPCSROverlap(
        int_data=put(iv, a.dtype), int_idx=put(ii), int_rows=put(ir),
        fr_data=put(fv, a.dtype), fr_idx=put(fi), fr_rows=put(fr),
        send_idx=put(send),
        shape=(n, m), axis=axis,
        rows_per_shard=rows_p, cols_per_shard=cols_p, halo=halo, n_shards=d,
    )


def _partial(data, idx, rows, v, rows_p):
    trail = (1,) * (v.dim() - 1)
    return segment_sum(data.reshape(data.shape + trail) * v[idx.long()],
                       rows, rows_p)


def _overlapped_apply(a: HaloPCSROverlap, v, mesh: Mesh) -> torch.Tensor:
    pending = _exchange(a.send_idx, v, mesh, async_op=True)
    vl = _slabs(v, mesh)
    rows_p = a.rows_per_shard
    # interior partials: independent of the exchange, so they run while it
    # is in flight on a process-group mesh
    ys = [_partial(a.int_data[i], a.int_idx[i], a.int_rows[i], vl[i], rows_p)
          for i in range(mesh.local)]
    recv = pending.wait()
    tail = tuple(v.shape[1:])
    return torch.cat([
        ys[i] + _partial(a.fr_data[i], a.fr_idx[i], a.fr_rows[i],
                         recv[i].reshape((-1,) + tail), rows_p)
        for i in range(mesh.local)])


def halo_spmv_overlapped(a: HaloPCSROverlap, v: torch.Tensor,
                         mesh: Mesh) -> torch.Tensor:
    """Distributed SpMV with the halo exchange overlapped with interior
    compute.  Same calling convention as :func:`halo_spmv`; the frontier
    partial sum closes the row totals after the exchange lands."""
    return _overlapped_apply(a, v, mesh)


def halo_spmm_overlapped(a: HaloPCSROverlap, b: torch.Tensor,
                         mesh: Mesh) -> torch.Tensor:
    """SpMM variant of :func:`halo_spmv_overlapped`: ``b`` is
    ``(cols_per_shard * D, k)`` row-sharded."""
    return _overlapped_apply(a, b, mesh)


# ---------------------------------------------------------------------------
# Segment-tile halo SpMV: kernel K1 per shard.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloSegtile:
    """Halo-exchange plan + one segment-tile plan per shard.

    ``plans``: this process's shards' :class:`~..ops.cuda_csr.SegTilePlan`,
    each built once over the shard's ``[own slab | received halo]`` column
    space (``rows_per_shard`` rows, ``cols_per_shard + D * halo`` columns)
    with its compact stream, which the apply reads.  ``send_idx``:
    (D, D, halo) strictly remote entries (a shard's own columns are read
    from its operand slab directly, as in :class:`HaloPCSROverlap`).  The
    reference's shared kernel meta is kept (``kstep``, ``chunks``,
    ``n_tiles``: the common tile count its stacked slots are padded to);
    ``fill`` is the worst shard's slot occupancy."""

    plans: tuple
    send_idx: torch.Tensor
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    cols_per_shard: int
    halo: int
    wsub: int
    rows: int
    kstep: int
    chunks: tuple
    n_tiles: int
    fill: float
    n_shards: int

    @property
    def dtype(self):
        return self.plans[0].vals.dtype

    @property
    def comm_entries_per_device(self) -> int:
        """all_to_all payload per shard, in operand entries (D * halo)."""
        return self.n_shards * self.halo


def _segtile_meta(plans):
    """The reference's shared meta of per-shard plans: common kstep, tile
    count (a multiple of it) and chunks."""
    from ..ops.cuda_csr import _K, _TILE_CAP

    kstep = max(p.kstep for p in plans)
    n_tiles = max(-(-p.n_tiles // kstep) * kstep for p in plans)
    n_groups = n_tiles // kstep
    cap_groups = max(_TILE_CAP // _K, 1)
    chunks = tuple((g0, min(g0 + cap_groups, n_groups))
                   for g0 in range(0, n_groups, cap_groups))
    return kstep, n_tiles, chunks


def halo_partition_segtile(a: CSR, mesh: Mesh, axis: str = "shards",
                           wsub: int | str = 8) -> HaloSegtile:
    """Build the halo plan + per-shard segment-tile plans (host pass, once
    per pattern + mesh).  ``wsub``: window height per ``build_seg_tiles``
    (``"auto"`` resolves once on the largest shard and applies to all).
    The plans of this process's shards are built on the mesh's device; on
    a process-group mesh the other shards' plans are built on the CPU only
    for the shared meta."""
    from .._device import device_values
    from ..ops.cuda_csr import build_seg_tiles

    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    cols_p = -(-max(m, 1) // d)
    indptr, indices, data = _csr_host(a)

    # pass 1: per-shard needed REMOTE columns; a shard's own slab never
    # enters the exchange (its operand is [own slab | received halo])
    needed, raw = [], []
    halo = 1
    for dst in range(d):
        lo, hi, s, e = _slab_bounds(dst, rows_p, n, indptr)
        cols = indices[s:e].astype(np.int64)
        by_src = _remote_by_src(np.unique(cols), dst, d, cols_p, False)
        needed.append(by_src)
        halo = max(halo, max((b.size for b in by_src), default=0))
        raw.append((_local_ptr(indptr, lo, hi, rows_p), cols, data[s:e]))

    # pass 2: remap into the [own slab | halo] operand space
    send = _send_table(needed, d, halo)
    local_csrs = []
    for dst in range(d):
        remap = _halo_remap(needed[dst], d, m, cols_p, halo, base=cols_p)
        own = np.arange(max(min(cols_p, m - dst * cols_p), 0),
                        dtype=np.int64)
        remap[dst * cols_p + own] = own
        ptr, cols, vals = raw[dst]
        dev = mesh.device if mesh.lo <= dst < mesh.hi else "cpu"
        local_csrs.append(CSR(
            data=device_values(np.ascontiguousarray(vals), a.dtype, dev),
            indices=torch.from_numpy(remap[cols].astype(np.int32)).to(dev),
            indptr=torch.from_numpy(ptr).to(dev),
            shape=(rows_p, cols_p + d * halo)))

    if wsub == "auto":
        big = max(range(d), key=lambda i: int(local_csrs[i].data.shape[0]))
        wsub = build_seg_tiles(local_csrs[big], wsub="auto").wsub
    plans = [build_seg_tiles(c, wsub=wsub) for c in local_csrs]
    kstep, n_tiles, chunks = _segtile_meta(plans)
    return HaloSegtile(
        plans=tuple(plans[mesh.lo: mesh.hi]),
        send_idx=put_sharded(send, mesh, axis),
        shape=(n, m),
        axis=axis,
        rows_per_shard=rows_p,
        cols_per_shard=cols_p,
        halo=halo,
        wsub=wsub,
        rows=plans[0].rows,
        kstep=kstep,
        chunks=chunks,
        n_tiles=n_tiles,
        fill=min(p.fill for p in plans),
        n_shards=d,
    )


def halo_spmv_segtile(a: HaloSegtile, v: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """Distributed SpMV: halo all_to_all + the segment-tile SpMV per shard
    over its plan's compact stream — K1 once per shard on CUDA tensors,
    its plain version on CPU tensors.  Same calling convention as
    :func:`halo_spmv`."""
    from ..ops.cuda_csr import segtile_stream_apply

    recv = _exchange(a.send_idx, v, mesh)
    vl = _slabs(v, mesh)
    rows_p = a.rows_per_shard
    return torch.cat([
        segtile_stream_apply(p.stream, torch.cat([vl[i], recv[i].reshape(-1)]),
                             rows=p.rows)[:rows_p]
        for i, p in enumerate(a.plans)])


def dist_spmv(a, v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed SpMV dispatch over the partitioned-matrix types:
    :class:`~.pcsr.PCSR` (all-gather baseline), :class:`HaloPCSR`,
    :class:`HaloPCSROverlap` or :class:`HaloSegtile` (K1 per shard).  All
    share the padded row-sharded vector convention, so the solvers of
    :mod:`.cg` take any of them.  Like the reference, it takes no
    ``PHubSplit`` (``TypeError``)."""
    if isinstance(a, HaloSegtile):
        return halo_spmv_segtile(a, v, mesh)
    if isinstance(a, HaloPCSROverlap):
        return halo_spmv_overlapped(a, v, mesh)
    if isinstance(a, HaloPCSR):
        return halo_spmv(a, v, mesh)
    if isinstance(a, PCSR):
        return pcsr_spmv(a, v, mesh)
    raise TypeError(f"dist_spmv: unsupported partitioned type {type(a)!r}")
