"""Scalar segment-tile CSR SpMV: kernel K1, its variants and its planner.

Port of ``sparse_tpu/ops/pallas_csr.py``.  The plan (:class:`SegTilePlan`,
built once per pattern + values by :func:`build_seg_tiles`) tiles the stored
entries by (``rows``-row block, ``wsub*128``-column window): entry (r, c)
sits at slot ``(r % rows, c % 128)`` of a tile and carries the int8 window
pointer ``q = c // 128 - seg_of[tile]``; lane conflicts spill into further
tiles of the same row block.  ``rows`` is 8 or 32; the host layout pass is
the reference's first-fit sweep (``layout="ff"``) or its anchor-partitioned
windows with spill tiers (``layout="rigid"``), both in
``native/_plansort.cpp`` (copied) with the reference's NumPy passes as
fallbacks, so both packages build the same plan from the same CSR.

The slots are the TPU's layout.  The card's kernels read instead the plan's
:class:`CompactStream`, built once with the plan by one device sort: every
stored entry (stored zeros included) as a value and an int32 column in
(row, tile, lane) order, with int32 row offsets — 8 bytes per entry in
float32 where the slots cost 5 per slot at fills near 0.07.
:func:`csr_smvm_segtile` runs :func:`segtile_stream_apply` on it: on CUDA
tensors one pass of a hand-written Hopper kernel, ``csrc/segtile_csr.cu``
for ``reduce="vpu"`` (K1 at ``rows=8``, K1-r32 at ``rows=32``) or
``csrc/segtile_mxu.cu`` for ``reduce="mxu"`` (K1-mxu, row sums by a
tensor-core product against an all-ones matrix); on CPU tensors
:func:`segtile_stream_plain`, the same sum in plain PyTorch.  There is no
other route: a CUDA tensor never reaches a plain version.

:func:`segtile_apply` is the raw-array SpMV over a plan's slot arrays (the
contract the per-shard halo SpMV calls): it compacts the non-zero slots on
every call, then runs the same kernels.  :func:`segtile_apply_plain`, the
slot-by-slot sum, stays as the reference-shaped oracle.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import _kernels
from ..formats.csr import CSR
from ..utils.precision import full_precision
from ._transforms import kernel_call

__all__ = [
    "CompactStream",
    "SegTilePlan",
    "build_seg_tiles",
    "csr_smvm_segtile",
    "seg_tiles_refresh",
    "seg_tiles_stream",
    "segtile_apply",
    "segtile_apply_plain",
    "segtile_stream_apply",
    "segtile_stream_plain",
    "csr_smvm_auto",
    "segtile_hbm_bytes",
    "segtile_stream_bytes",
]

#: Launches of each CUDA kernel (with the long rows' piece sum, when it
#: runs, as one), counted where the wrapper launches it and nowhere else:
#: K1 (``reduce="vpu"`` on an 8-row plan), K1-r32 (``reduce="vpu"`` on a
#: 32-row plan), K1-mxu (``reduce="mxu"``, either height).
K1_LAUNCHES = 0
K1_R32_LAUNCHES = 0
K1_MXU_LAUNCHES = 0

_LANES = 128
_TILE_CAP = 102_400  # reference SMEM chunk budget; kept for plan parity
_K = 512  # reference tiles per grid step at production sizes
_REDUCES = ("vpu", "mxu")
#: A row longer than ``_LONG_PASSES`` passes of its lane group is long and
#: is cut into pieces of ``_PIECE_UNITS`` load units, one warp each (4 units
#: a lane; csrc/segtile_common.cuh).
_LONG_PASSES = 8
_PIECE_UNITS = 128


@dataclasses.dataclass(frozen=True)
class CompactStream:
    """A plan's stored entries as the card's kernels read them.

    ``vals``: the values in (output row, tile, lane) order — one per entry
    for a scalar plan (zero-padded to a multiple of 4 for 16-byte loads), a
    ``(nnz, 4)`` record ``(a00, a01, a10, a11)`` per 2x2 block for a block
    plan; ``cols``: int32 (block) columns, padded alike; ``row_ptr``: int32
    ``(n_rows + 1)`` offsets, row r being entries ``[row_ptr[r],
    row_ptr[r+1])``.  Row classes: a short row is summed by ``group`` lanes
    (the mean row length in load units — 4 entries, or one block — rounded
    up to a power of two, at most 32); a row of more than ``long_min``
    entries is long and cut into pieces of ``piece`` entries: ``long_rows``
    lists the long rows, ``piece_ptr`` (n_long + 1) offsets their pieces,
    ``piece_row`` names each piece's long row.  ``perm`` (refreshable
    plans): each stream entry's index in the plan's ``pos``/``eidx`` order.
    """

    vals: torch.Tensor
    cols: torch.Tensor
    row_ptr: torch.Tensor
    long_rows: torch.Tensor
    piece_ptr: torch.Tensor
    piece_row: torch.Tensor
    n_rows: int
    nnz: int
    group: int
    long_min: int
    piece: int
    perm: torch.Tensor | None = None

    @property
    def n_long(self) -> int:
        return self.long_rows.numel()

    @property
    def n_pieces(self) -> int:
        return self.piece_row.numel()

    @property
    def entry_nbytes(self) -> int:
        """Bytes of the values and columns one apply reads, padding
        included."""
        return (self.vals.numel() * self.vals.element_size()
                + self.cols.numel() * self.cols.element_size())

    @property
    def bytes_per_entry(self) -> float:
        """``entry_nbytes`` over the stored entries (a 2x2 block record
        holds four): 8 for a float32 scalar stream, 5 for a float32 block
        stream, at no padding."""
        per_record = self.vals[0].numel() if self.vals.dim() > 1 else 1
        return self.entry_nbytes / max(self.nnz * per_record, 1)

    def apply_nbytes(self, n_in: int, n_out: int) -> int:
        """Bytes one apply moves: the values and columns, the row offsets,
        an ``n_in``-element operand and an ``n_out``-element output in the
        values' dtype."""
        return (self.entry_nbytes
                + self.row_ptr.numel() * self.row_ptr.element_size()
                + (n_in + n_out) * self.vals.element_size())


def _k_step(rows: int, n_real: int = 1 << 30) -> int:
    """Reference tiles per grid step (``pallas_csr._k_step``).  The CUDA
    kernel has no grid step; ``n_tiles`` is still padded to a multiple of it
    so ``fill`` — and with it the dispatch rung — matches the reference."""
    base = _K if n_real >= 4 * _K else (64 if n_real >= 64 else 16)
    return max(base * 8 // rows, 1)


@dataclasses.dataclass(frozen=True)
class SegTilePlan:
    """Static segment-tile layout of a CSR pattern (+ values).

    ``vals``: (n_tiles, rows, 128) slot values; ``q``: int8 window pointers
    in [0, wsub); ``seg_of``: (n_tiles,) int32 window base (in 128-column
    units); ``rb``: (n_tiles,) int32 output row block; ``fill``: nnz / slots
    (padding tiles included, as in the reference — dispatch compares it
    with ``_MIN_FILL``).  ``chunks`` and ``kstep`` are the reference's TPU
    grid bookkeeping, kept for parity and ignored by the kernel.  ``pos``/
    ``eidx`` (``refreshable=True``): sorted slot positions and the source
    entry of each, for :func:`seg_tiles_refresh`; ``nse``: length of the
    ``data`` tensor the plan was built from.  ``stream``: the
    :class:`CompactStream` the kernels read (the slot tensors serve the
    plain slot version and the raw-array route)."""

    vals: torch.Tensor
    q: torch.Tensor
    seg_of: torch.Tensor
    rb: torch.Tensor
    n: int
    m: int
    n_tiles: int
    fill: float
    chunks: tuple
    wsub: int = 8
    rows: int = 8
    kstep: int = 64
    pos: torch.Tensor | None = None
    eidx: torch.Tensor | None = None
    nse: int | None = None
    stream: CompactStream | None = None


def build_seg_tiles(a: CSR, wsub: int | str = 8, rows: int = 8,
                    layout: str = "ff",
                    refreshable: bool = False) -> SegTilePlan:
    """Host-side tiling of a CSR matrix (once per pattern + values); the
    slot tensors are filled on ``a``'s device.

    ``wsub`` (8, 16, 32 or ``"auto"``): window height in 128-column units;
    ``"auto"`` sweeps the three with the chosen layout and takes the argmin
    of ``tiles * (1 + 0.05 * extra_chunk_pairs)``, the reference's rule.
    ``rows`` (8 or 32): row-block height.  ``layout``: ``"ff"``, greedy
    first-fit packing (per block, entries visit open tiles in (column, row)
    order and land in the first whose window covers them and whose slot is
    free), or ``"rigid"``, windows anchored at each block's first
    lane-aligned column with the k-th entry of a (row, lane) slot in spill
    tier k."""
    if rows not in (8, 32):
        raise ValueError(f"build_seg_tiles: rows must be 8 or 32, got {rows}")
    if layout not in ("ff", "rigid"):
        raise ValueError(
            f"build_seg_tiles: layout must be 'ff' or 'rigid', got {layout}")
    from ..native.plansort import (seg_tile_layout, seg_tile_layout_ff,
                                   seg_tile_layout_ff_py)

    indptr = a.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    cols = a.indices[:nnz].cpu().numpy().astype(np.int64)
    sweep = seg_tile_layout if layout == "rigid" else seg_tile_layout_ff
    if wsub == "auto":
        best, best_cost = 8, None
        for cand in (8, 16, 32):
            res = sweep(indptr, cols, cand, rows=rows)
            if res is None:
                continue
            cost = res[2].size * (1 + 0.05 * (cand // 8 - 1))
            if best_cost is None or cost < best_cost:
                best, best_cost = cand, cost
        wsub = best
    if wsub not in (8, 16, 32):
        raise ValueError(
            f"build_seg_tiles: wsub must be 8, 16, or 32, got {wsub}")
    n, m = a.shape
    res = sweep(indptr, cols, wsub, rows=rows) if nnz else None
    src_index = None
    if res is None:
        if layout == "ff":
            res = seg_tile_layout_ff_py(indptr, cols, wsub, rows=rows)
        else:
            *res, src_index = _rigid_layout_np(indptr, cols, n, wsub, rows)
    pos_src, sub_src, t_base, t_rb = res
    return _finish_plan(a, n, m, nnz, wsub, rows, pos_src, sub_src, src_index,
                        t_base, t_rb, t_base.size, refreshable,
                        by_tile=layout == "rigid")


def _rigid_layout_np(indptr, cols, n: int, wsub: int, R: int):
    """NumPy pass of the rigid layout (the reference's fallback for a host
    without the native sweep; the same tile numbering).  Returns ``(pos,
    sub, seg_of, t_rb, order)``: slot positions and window pointers in the
    ``order`` the entries were sorted into, and the per-tile arrays."""
    nnz = int(indptr[-1])
    nbR = -(-max(n, 1) // R)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    rsh = R.bit_length() - 1  # log2(R)
    rb = row_ids >> rsh

    # window anchor: each row block's first (lane-aligned) column
    minc = np.full(nbR, np.iinfo(np.int64).max)
    np.minimum.at(minc, rb, cols)
    anchor_sub = np.where(minc == np.iinfo(np.int64).max, 0, minc >> 7)
    win = ((cols >> 7) - anchor_sub[rb]) // wsub  # wsub*128-col window index
    base = anchor_sub[rb] + win * wsub  # window base sublane
    sub = (cols >> 7) - base  # in [0, wsub)
    lane = cols & (_LANES - 1)

    # sort by (rb, win, row, lane, sub): one fused-u64-key radix argsort
    # when the key fits, else lexsort
    from ..native.plansort import argsort_u64

    nwin = int(win.max()) + 1 if nnz else 1
    if nnz and nbR * nwin * R * 128 * wsub < (1 << 62):
        key = ((((rb * nwin + win) * R + (row_ids & (R - 1))) * 128 + lane)
               * wsub + sub).astype(np.uint64)
        order = argsort_u64(key)
    else:
        order = np.lexsort((sub, lane, row_ids, win, rb))
    rb_o, win_o, lane_o = rb[order], win[order], lane[order]
    rows_o, sub_o = row_ids[order], sub[order]
    base_o = base[order]
    ri = rows_o & (R - 1)

    # spill tiers: k-th entry of a (rb, win, row, lane) group -> tile k
    ne = rb_o.size
    if ne:
        grp = np.empty(ne, np.bool_)
        grp[0] = True
        grp[1:] = ((rb_o[1:] != rb_o[:-1]) | (win_o[1:] != win_o[:-1])
                   | (rows_o[1:] != rows_o[:-1])
                   | (lane_o[1:] != lane_o[:-1]))
        tier = np.arange(ne) - np.maximum.accumulate(
            np.where(grp, np.arange(ne), -1))
        # number tiles in (rb, win, tier) order
        T = int(tier.max()) + 1
        if nbR * nwin * T < (1 << 62):
            order2 = argsort_u64(
                ((rb_o * nwin + win_o) * T + tier).astype(np.uint64))
        else:
            order2 = np.lexsort((tier, win_o, rb_o))
        key_change = np.empty(ne, np.bool_)
        key_change[0] = True
        key_change[1:] = ((rb_o[order2][1:] != rb_o[order2][:-1])
                          | (win_o[order2][1:] != win_o[order2][:-1])
                          | (tier[order2][1:] != tier[order2][:-1]))
        tile_id_sorted = np.cumsum(key_change) - 1
        tile_of = np.empty(ne, np.int64)
        tile_of[order2] = tile_id_sorted
        n_real = int(tile_id_sorted[-1]) + 1
        t_base = np.zeros(n_real, np.int64)
        t_rb = np.zeros(n_real, np.int64)
        t_base[tile_of] = base_o
        t_rb[tile_of] = rb_o
    else:
        tile_of = np.zeros(0, np.int64)
        t_base = np.zeros(0, np.int64)
        t_rb = np.zeros(0, np.int64)
    pos = tile_of * (R * _LANES) + ri * _LANES + lane_o
    return pos, sub_o, t_base, t_rb, order


def _fill_slots(pos: torch.Tensor, vals: torch.Tensor,
                size: int) -> torch.Tensor:
    """Dense slot tensor from unique, sorted positions and their values (a
    scatter without accumulation: deterministic)."""
    out = torch.zeros(size, dtype=vals.dtype, device=vals.device)
    out[pos] = vals
    return out


def _pad_tiles(n_real: int, rows: int, t_base, t_rb):
    """Reference tile padding: ``(kstep, n_tiles, seg_of, rb, chunks)``."""
    kstep = _k_step(rows, n_real)
    n_tiles = max(-(-max(n_real, 1) // kstep) * kstep, kstep)
    seg_of = np.zeros(n_tiles, np.int32)
    rb = np.zeros(n_tiles, np.int32)
    seg_of[:n_real] = t_base
    rb[:n_real] = t_rb
    n_groups = n_tiles // kstep
    cap_groups = max(_TILE_CAP // _K, 1)
    chunks = tuple((g0, min(g0 + cap_groups, n_groups))
                   for g0 in range(0, n_groups, cap_groups))
    return kstep, n_tiles, seg_of, rb, chunks


def _finish_plan(a, n, m, nnz, wsub, R, pos_src, sub_src, src_index, t_base,
                 t_rb, n_real, refreshable, by_tile=False) -> SegTilePlan:
    """Plan tail: reference tile padding, then the device fill of the slot
    tensors (values gathered from ``a.data`` on its device).  ``src_index``
    maps ``pos_src``'s order to entry ids (None: storage order).  Entries
    are sorted by slot position, or (``by_tile``, the reference's rigid
    path) stably by tile alone, so ``pos``/``eidx`` equal the reference's;
    the fill takes positions in any order."""
    kstep, n_tiles, seg_of, rb, chunks = _pad_tiles(n_real, R, t_base, t_rb)
    slots = R * _LANES
    if n_tiles * slots > np.iinfo(np.int32).max:
        raise ValueError(
            f"build_seg_tiles: {n_tiles} tiles overflows int32 slot "
            "positions (8 GB of slot storage — use the row-binned path)")
    from ..native.plansort import argsort_u64, counting_argsort

    pos_np = np.asarray(pos_src)
    if not nnz:
        order = np.zeros(0, np.int64)
    elif by_tile:
        order = counting_argsort(pos_np >> (slots.bit_length() - 1),
                                 max(n_real, 1))
    else:
        order = argsort_u64(pos_np.astype(np.uint64))
    entry = order if src_index is None else np.asarray(src_index)[order]
    dev = a.device
    pos = torch.from_numpy(pos_np[order].astype(np.int64)).to(dev)
    eidx = torch.from_numpy(entry.astype(np.int64)).to(dev)
    size = n_tiles * slots
    tvals = _fill_slots(pos, a.data[eidx], size).reshape(n_tiles, R, _LANES)
    sub = torch.from_numpy(np.asarray(sub_src)[order].astype(np.int8))
    tq = _fill_slots(pos, sub.to(dev), size).reshape(n_tiles, R, _LANES)
    seg_of_t = torch.from_numpy(seg_of).to(dev)
    rb_t = torch.from_numpy(rb).to(dev)
    return SegTilePlan(
        vals=tvals,
        q=tq,
        seg_of=seg_of_t,
        rb=rb_t,
        stream=_stream_from_slots(tvals, tq, seg_of_t, rb_t, rows=R,
                                  n_rows=n, n_cols=m, pos=pos,
                                  keep_perm=refreshable),
        n=n,
        m=m,
        n_tiles=n_tiles,
        fill=nnz / max(n_tiles * slots, 1),
        chunks=chunks,
        wsub=wsub,
        rows=R,
        kstep=kstep,
        pos=pos if refreshable else None,
        eidx=eidx if refreshable else None,
        nse=a.nse,
    )


def _stream_from_slots(vals, q, seg_of, rb, *, rows: int, n_rows: int,
                       n_cols: int, pos=None,
                       keep_perm: bool = False) -> CompactStream:
    """The compact stream of a slot plan, on the plan's device.

    ``vals`` is ``(t, rows, 128)`` (scalar plan) or ``(t, 4, 8, 128)``
    (2x2 block plan, planes a00, a01, a10, a11).  The entries are the slots
    at ``pos`` — a plan's every stored entry, stored zeros included — or,
    without ``pos``, the non-zero slots.  Entries whose row or column falls
    outside ``[0, n_rows)`` x ``[0, n_cols)`` (the reference's kernels read
    them as 0) are left out.  One device sort of the fused (row, slot) key
    puts them in (row, tile, lane) order."""
    block = vals.dim() == 4
    planes = vals if block else vals.unsqueeze(1)
    slots = rows * _LANES
    total = max(planes.shape[0] * slots, 1)
    if max(n_rows, 1) * total >= 1 << 62:
        raise ValueError(f"compact stream: {n_rows} rows x {total} slots "
                         "overflow the int64 sort key")
    if pos is None:
        pos = torch.nonzero((planes != 0).any(1).reshape(-1)).squeeze(1)
    tile, rin, lane = pos // slots, pos // _LANES % rows, pos % _LANES
    rbt = rb.long()[tile]
    row = rbt * rows + rin
    col = (seg_of.long()[tile] + q.reshape(-1)[pos].long()) * _LANES + lane
    keep = torch.nonzero((rbt >= 0) & (row < n_rows) & (col >= 0)
                         & (col < n_cols)).squeeze(1)
    order = keep[torch.sort(row[keep] * total + pos[keep]).indices]
    ent = planes[tile[order], :, rin[order], lane[order]]
    unit = 1 if block else 4
    pad = -order.numel() % unit
    cvals = ent if block else ent[:, 0]
    ccols = col[order]
    if pad:
        cvals = torch.cat([cvals, cvals.new_zeros(pad)])
        ccols = torch.cat([ccols, ccols.new_zeros(pad)])
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=vals.device)
    torch.cumsum(torch.bincount(row[order], minlength=n_rows), 0,
                 out=row_ptr[1:])
    return CompactStream(vals=cvals.contiguous(),
                         cols=ccols.to(torch.int32), n_rows=n_rows,
                         nnz=order.numel(),
                         perm=order if keep_perm else None,
                         **_row_classes(row_ptr, unit))


def _row_classes(row_ptr: torch.Tensor, unit: int) -> dict:
    """Lane group, long-row threshold and pieces of a stream (the
    :class:`CompactStream` fields), from its int64 row offsets; ``unit``:
    entries per load unit (4 scalar entries, or one block)."""
    s, e = row_ptr[:-1], row_ptr[1:]
    lens = e - s
    units = torch.where(lens > 0, (e + unit - 1) // unit - s // unit, 0)
    mean = float(units.double().mean()) if units.numel() else 0.0
    group = 1
    while group < min(mean, 32):
        group *= 2
    long_min = _LONG_PASSES * group * unit
    piece = _PIECE_UNITS * unit
    long_rows = torch.nonzero(lens > long_min).squeeze(1)
    n_pieces = (lens[long_rows] + piece - 1) // piece
    piece_ptr = torch.zeros(long_rows.numel() + 1, dtype=torch.int64,
                            device=row_ptr.device)
    torch.cumsum(n_pieces, 0, out=piece_ptr[1:])
    piece_row = torch.repeat_interleave(
        torch.arange(long_rows.numel(), device=row_ptr.device), n_pieces)
    i32 = torch.int32
    return dict(row_ptr=row_ptr.to(i32), long_rows=long_rows.to(i32),
                piece_ptr=piece_ptr.to(i32), piece_row=piece_row.to(i32),
                group=group, long_min=long_min, piece=piece)


def seg_tiles_stream(plan: SegTilePlan) -> CompactStream:
    """The compact stream of a plan given by its slot arrays (a plan carried
    from the reference by :mod:`~sparse_tpu_torch.interop`): from the
    plan's ``pos`` when it has them (every stored entry), else from its
    non-zero slots — where a stored zero cannot be told from padding and is
    left out, which changes no sum over finite operands."""
    return _stream_from_slots(plan.vals, plan.q, plan.seg_of, plan.rb,
                              rows=plan.rows, n_rows=plan.n, n_cols=plan.m,
                              pos=plan.pos, keep_perm=plan.eidx is not None)


def _refresh_stream(stream: CompactStream, values: torch.Tensor):
    """``stream`` with new values, given in the plan's ``pos`` order (one
    per entry, or one 2x2 block each)."""
    new = values[stream.perm]
    if new.dim() == 1:
        new = torch.cat([new, new.new_zeros(stream.vals.numel()
                                            - new.numel())])
    else:
        new = new.reshape(-1, 4)
    return dataclasses.replace(stream, vals=new)


def _check_refresh_source(name: str, source: torch.Tensor, nse, eidx):
    """The refresh source must be the full tensor the plan was built from:
    an index past its end would read another entry's value (the reference
    never checks this length)."""
    if nse is not None:
        if source.shape[0] != nse:
            raise ValueError(
                f"{name}: got {source.shape[0]} entries, the plan was built "
                f"from {nse}")
    elif eidx.numel() and source.shape[0] <= int(eidx.max()):
        raise ValueError(
            f"{name}: got {source.shape[0]} entries, the plan reads entry "
            f"{int(eidx.max())}")


def seg_tiles_refresh(plan: SegTilePlan, data) -> SegTilePlan:
    """Re-bind a plan to NEW values of the SAME pattern in one gather (the
    Newton / time-stepping idiom).  Requires ``build_seg_tiles(...,
    refreshable=True)``; ``data`` is the updated CSR ``.data``, whose length
    must match the plan's source (``ValueError`` otherwise)."""
    if plan.pos is None:
        raise ValueError(
            "seg_tiles_refresh: plan was not built with refreshable=True")
    data = torch.as_tensor(data, device=plan.vals.device)
    if data.dim() != 1:
        raise ValueError(f"seg_tiles_refresh: data must be 1-D, got "
                         f"{tuple(data.shape)}")
    _check_refresh_source("seg_tiles_refresh", data, plan.nse, plan.eidx)
    size = plan.n_tiles * plan.rows * _LANES
    values = data[plan.eidx]
    tvals = _fill_slots(plan.pos, values, size).reshape(
        plan.n_tiles, plan.rows, _LANES)
    return dataclasses.replace(plan, vals=tvals,
                               stream=_refresh_stream(plan.stream, values))


def csr_smvm_segtile(a: CSR, v, plan: SegTilePlan, *, reduce: str = "vpu",
                     batch: int | None = None) -> torch.Tensor:
    """SpMV through the segment-tile kernel over the plan's compact stream;
    matches ``csr_smvm`` up to float summation order.  ``plan`` from
    :func:`build_seg_tiles` (or :mod:`~sparse_tpu_torch.interop`).

    ``reduce``: how a row's products become one sum — ``"vpu"`` (a lane
    group's shuffle sum) or ``"mxu"`` (a tensor-core product against an
    all-ones matrix, float32 split into two TF32 terms so the sum keeps
    float32 accuracy).  ``batch`` (the reference's per-grid-step emission
    group of the TPU kernel) is accepted and does not change the result;
    below 1 it raises ``ValueError``, as the reference fails there."""
    _check_variant("csr_smvm_segtile", plan.rows, reduce, batch)
    v = torch.as_tensor(v, device=plan.vals.device)
    n, m = a.shape
    if tuple(v.shape) != (m,):
        raise ValueError(
            f"csr_smvm_segtile: vector shape {tuple(v.shape)} != ({m},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if n == 0:
        return torch.zeros(0, dtype=out_dtype, device=v.device)
    if plan.stream is None:
        raise ValueError("csr_smvm_segtile: the plan carries no compact "
                         "stream; build it with build_seg_tiles or "
                         "interop.seg_tile_plan_from_arrays")
    return segtile_stream_apply(plan.stream, v, rows=plan.rows,
                                reduce=reduce, out_dtype=out_dtype)


def _check_variant(name: str, rows: int, reduce: str, batch) -> None:
    if rows not in (8, 32):
        raise ValueError(f"{name}: rows must be 8 or 32, got {rows}")
    if reduce not in _REDUCES:
        raise ValueError(f"{name}: reduce must be 'vpu' or 'mxu', got "
                         f"{reduce!r}")
    if batch is not None and batch < 1:
        raise ValueError(f"{name}: batch must be >= 1, got {batch}")


def segtile_apply(vals, q, seg_of, rb, v, *, n: int, wsub: int, rows: int,
                  kstep: int, chunks: tuple, reduce: str = "vpu",
                  batch: int | None = None, out_dtype=None) -> torch.Tensor:
    """Raw-array segment-tile SpMV over a plan's slot tensors, for callers
    that hold only slot arrays.

    ``v`` is the operand in the plan's column space; returns the padded
    ``(ceil(n/rows)*rows,)`` output.  This is the slow route, which the
    main path does not take: every call compacts the non-zero slots (a
    device sort), then runs :func:`segtile_stream_apply` — K1, K1-r32 or
    K1-mxu on CUDA tensors, :func:`segtile_stream_plain` on CPU tensors.
    Slots whose column lies outside ``[0, len(v))`` or whose row block lies
    outside the output read 0, as in the reference; a stored zero is not
    told from padding (the same sums for finite operands).
    ``kstep``/``chunks``/``batch`` are accepted for the reference's
    signature and do not change the result."""
    _check_variant("segtile_apply", rows, reduce, batch)
    _check_slot_arrays("segtile_apply", vals, q, seg_of, rb, v,
                       (rows, _LANES), (rows, _LANES))
    if wsub not in (8, 16, 32):
        raise ValueError(f"segtile_apply: wsub must be 8, 16 or 32, got "
                         f"{wsub}")
    nbR = -(-n // rows)

    def apply(vals, v):
        stream = _stream_from_slots(vals, q, seg_of, rb, rows=rows,
                                    n_rows=nbR * rows, n_cols=v.shape[0])
        return segtile_stream_apply(stream, v, rows=rows, reduce=reduce,
                                    out_dtype=out_dtype)

    if not v.is_cuda:
        return apply(vals, v)
    # the per-call compaction reads the values: a transform sees it whole
    return kernel_call("segtile_apply", apply, vals, v)


def _check_slot_arrays(name, vals, q, seg_of, rb, v, val_shape, q_shape):
    """Raise on slot arrays that do not form a plan (``val_shape``/
    ``q_shape``: the per-tile shapes of ``vals`` and ``q``), or that lie on
    more than one device."""
    devices = {t.device for t in (vals, q, seg_of, rb, v)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors must share one device, got "
                         f"{sorted(str(d) for d in devices)}")
    if q.dtype != torch.int8:
        raise TypeError(f"{name}: q must be int8, got {q.dtype}")
    if seg_of.dtype != torch.int32 or rb.dtype != torch.int32:
        raise TypeError(f"{name}: seg_of/rb must be int32, got "
                        f"{seg_of.dtype}/{rb.dtype}")
    t = vals.shape[0] if vals.dim() else -1
    if (tuple(vals.shape) != (t, *val_shape)
            or tuple(q.shape) != (t, *q_shape)
            or tuple(seg_of.shape) != (t,) or tuple(rb.shape) != (t,)
            or v.dim() != 1):
        raise ValueError(
            f"{name}: shapes vals {tuple(vals.shape)}, q {tuple(q.shape)}, "
            f"seg_of {tuple(seg_of.shape)}, rb {tuple(rb.shape)}, v "
            f"{tuple(v.shape)} do not form a plan with (t, {val_shape}) "
            f"values and (t, {q_shape}) pointers")


def segtile_apply_plain(vals, q, seg_of, rb, v, *, n: int, wsub: int,
                        rows: int = 8, kstep: int = 0, chunks: tuple = (),
                        reduce: str = "vpu", batch: int | None = None,
                        out_dtype=None) -> torch.Tensor:
    """The reference's sum slot by slot, in plain PyTorch (any device): the
    oracle of the slot arrays.  Gather, product, lane sum (``"mxu"``: one
    product with an all-ones column at full precision, the reference's
    reduction), sum by row block.  Columns at or past ``len(v)`` read 0."""
    _check_variant("segtile_apply_plain", rows, reduce, batch)
    if out_dtype is None:
        out_dtype = torch.promote_types(vals.dtype, v.dtype)
    m = v.shape[0]
    nbR = -(-n // rows)
    vpad = torch.cat([v.to(out_dtype),
                      torch.zeros(1, dtype=out_dtype, device=v.device)])
    lane = torch.arange(_LANES, device=v.device)
    col = (seg_of.long()[:, None, None] + q.long()) * _LANES + lane
    col = torch.where((col >= 0) & (col < m), col, torch.full_like(col, m))
    prod = vals.to(out_dtype) * vpad[col]  # (n_tiles, rows, 128)
    if reduce == "vpu":
        part = prod.sum(-1)
    else:
        ones = torch.ones(_LANES, 1, dtype=out_dtype, device=v.device)
        with full_precision(out_dtype):
            part = (prod.reshape(-1, _LANES) @ ones).reshape(prod.shape[:2])
    rbl = rb.long()
    keep = (rbl >= 0) & (rbl < nbR)
    y = torch.zeros(nbR, rows, dtype=out_dtype, device=v.device)
    # out of place, so torch.func.vmap can batch the operand
    return y.index_add(0, rbl[keep], part[keep]).reshape(-1)


def segtile_stream_apply(stream: CompactStream, v, *, rows: int = 8,
                         reduce: str = "vpu",
                         out_dtype=None) -> torch.Tensor:
    """``y = A v`` over a scalar plan's compact stream, ``(stream.n_rows,)``.
    CUDA tensors launch K1 (``reduce="vpu"``; counted as K1-r32 when the
    plan has ``rows=32``) or K1-mxu (``reduce="mxu"``); CPU tensors run
    :func:`segtile_stream_plain`."""
    _check_variant("segtile_stream_apply", rows, reduce, None)
    if out_dtype is None:
        out_dtype = torch.promote_types(stream.vals.dtype, v.dtype)
    devices = {stream.vals.device, v.device}
    if devices == {torch.device("cpu")}:
        return segtile_stream_plain(stream, v, out_dtype=out_dtype)
    if len(devices) == 1 and v.is_cuda:
        return _segtile_stream_cuda(stream, v, rows, reduce, out_dtype)
    raise ValueError(f"segtile_stream_apply: tensors must share one device, "
                     f"got {sorted(str(d) for d in devices)}")


def _stream_rows(stream: CompactStream) -> torch.Tensor:
    """The row of each stream entry (int64)."""
    return torch.repeat_interleave(
        torch.arange(stream.n_rows, device=stream.row_ptr.device),
        stream.row_ptr.diff().long())


def segtile_stream_plain(stream: CompactStream, v, *,
                         out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of K1, K1-r32 and K1-mxu over a compact stream
    (any device): gather, product, sum by row in entry order.  The three
    kernels compute this one function; they differ in the order of the sum
    and in which unit adds."""
    if out_dtype is None:
        out_dtype = torch.promote_types(stream.vals.dtype, v.dtype)
    k = stream.nnz
    prod = (stream.vals[:k].to(out_dtype)
            * v.to(out_dtype)[stream.cols[:k].long()])
    y = torch.zeros(stream.n_rows, dtype=out_dtype, device=v.device)
    # out of place, so torch.func.vmap can batch the operand
    return y.index_add(0, _stream_rows(stream), prod)


def _launch(name: str, fn, stream: CompactStream, v, out_dtype, comps: int,
            tail: tuple, counted) -> torch.Tensor:
    """Launch a compact-stream kernel (csrc/segtile_csr.cu's arguments, then
    ``tail`` and the CUDA stream) on ``v``'s device; returns ``y``,
    ``comps`` values per row, and calls ``counted()`` once per launch.
    The stream's values and ``v`` go through
    :func:`~sparse_tpu_torch.ops._transforms.kernel_call` (``vmap`` launches
    once per slice; derivatives raise).  Kept lean: at the sizes of a
    solver step the host's work per call is comparable to the kernel's."""
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, "
                        f"got {out_dtype}")

    def launch(vals, v):
        if vals.dtype != out_dtype:
            vals = vals.to(out_dtype)
        if v.dtype != out_dtype or not v.is_contiguous():
            v = v.to(out_dtype).contiguous()
        if v.data_ptr() % (comps * v.element_size()):
            v = v.clone()  # a block kernel gathers the operand in pairs
        if vals.data_ptr() % 16 or stream.cols.data_ptr() % 16:
            raise ValueError(f"{name}: the stream's vals and cols must be "
                             "16-byte aligned")
        dev = v.device
        y = torch.empty(comps * stream.n_rows, dtype=out_dtype, device=dev)
        partial = (torch.empty(comps * stream.n_pieces, dtype=out_dtype,
                               device=dev) if stream.n_pieces else None)
        args = (vals.data_ptr(), stream.cols.data_ptr(),
                stream.row_ptr.data_ptr(), stream.long_rows.data_ptr(),
                stream.piece_ptr.data_ptr(), stream.piece_row.data_ptr(),
                v.data_ptr(), 0 if partial is None else partial.data_ptr(),
                y.data_ptr(), stream.n_rows, stream.n_long, stream.n_pieces,
                *tail, torch.cuda.current_stream(dev).cuda_stream)
        if dev.index == torch.cuda.current_device():
            rc = fn(*args)
        else:
            with torch.cuda.device(dev):
                rc = fn(*args)
        _kernels.check(rc, name)
        counted()
        return y

    return kernel_call(name, launch, stream.vals, v)


def _count_k1():
    global K1_LAUNCHES
    K1_LAUNCHES += 1


def _count_k1_r32():
    global K1_R32_LAUNCHES
    K1_R32_LAUNCHES += 1


def _count_k1_mxu():
    global K1_MXU_LAUNCHES
    K1_MXU_LAUNCHES += 1


def _segtile_stream_cuda(stream, v, rows, reduce, out_dtype):
    lib = _kernels.load()
    f32 = out_dtype == torch.float32
    if reduce == "mxu":
        fn = lib.segtile_mxu_f32 if f32 else lib.segtile_mxu_f64
        tail = (stream.long_min, stream.piece)
        counted = _count_k1_mxu
    else:
        fn = lib.segtile_csr_f32 if f32 else lib.segtile_csr_f64
        tail = (stream.long_min, stream.piece, stream.group)
        counted = _count_k1_r32 if rows == 32 else _count_k1
    return _launch(f"segtile_{reduce}", fn, stream, v, out_dtype, 1, tail,
                   counted)


def segtile_hbm_bytes(plan: SegTilePlan) -> int:
    """Bytes one segment-tile SpMV moves at float32, the reference's model:
    5 B per slot (value + int8 pointer) + the operand + the output."""
    slots = plan.n_tiles * plan.rows * _LANES
    nbR = -(-plan.n // plan.rows)
    return slots * 5 + plan.m * 4 + nbR * plan.rows * 4


def segtile_stream_bytes(plan: SegTilePlan) -> int:
    """Bytes one K1 apply over the compact stream moves, from the stream's
    own tensors: each value and int32 column (8 B per stored entry in
    float32), the int32 row offsets, the operand and the output."""
    return plan.stream.apply_nbytes(plan.m, plan.n)


# Dispatch crossovers, kept at the reference's values so the port picks the
# same rung as the reference.  TPU-calibrated (v5e VMEM residency and the
# XLA scalar-gather rate), due for re-measurement on the H100 (ROADMAP).
_MAX_RESIDENT = 2_000_000
_MIN_FILL = 0.007
_BLOCK_SPMV_MIN_BSZ = 8
_BLOCK_SPMV_MIN_FILL = 0.5


def _smvm_block_bsz(a: CSR) -> int:
    """Detected BELL-route block size for SpMV, or 0 (host-side)."""
    from ..utils.stats import detect_block_size

    if a.shape[0] != a.shape[1]:
        return 0
    bsz, _ = detect_block_size(a, candidates=(32, 16, 8),
                               min_fill=_BLOCK_SPMV_MIN_FILL)
    return bsz if bsz >= _BLOCK_SPMV_MIN_BSZ else 0


def csr_smvm_auto(a: CSR, v, plan: SegTilePlan | None = None,
                  wsub: int = 8) -> torch.Tensor:
    """Unstructured SpMV dispatch per call.  On a CUDA matrix: the segment
    tile kernel when operand + output fit the residency cap and the tile
    fill clears the floor (plan built here when not given), else BELL when
    the pattern has dense natural blocks at bsz >= 8; everything else (and
    every CPU matrix, as off-TPU in the reference) takes the row-binned
    path.  Hot paths should prepare once (:func:`~.dispatch.smvm_prepare`)."""
    from .spmv import csr_smvm_fast

    v = torch.as_tensor(v, device=a.device)
    on_cuda = a.device.type == "cuda"
    if on_cuda and a.shape[0] + a.shape[1] <= _MAX_RESIDENT:
        if plan is None:
            if a.nse > 1_000_000:
                warnings.warn(
                    f"csr_smvm_auto: building a segment-tile plan for "
                    f"{a.nse} stored entries on the host; build it once with "
                    "build_seg_tiles(a) and pass plan= if you call this more "
                    "than once per pattern", stacklevel=2)
            try:
                plan = build_seg_tiles(a, wsub=wsub)
            except ValueError:
                plan = None  # tile count overflows int32 slot positions
        if plan is not None and plan.fill >= _MIN_FILL:
            return csr_smvm_segtile(a, v, plan)
    if on_cuda:
        bsz = _smvm_block_bsz(a)
        if bsz:
            from ..formats.bell import bell_from_csr, bell_smvm

            warnings.warn(
                f"csr_smvm_auto: dense {bsz}x{bsz} block structure detected"
                " — re-blocking to BELL per call; convert once with "
                f"bell_from_csr(a, {bsz}) and call bell_smvm on hot paths",
                stacklevel=2)
            return bell_smvm(bell_from_csr(a, bsz), v)
    return csr_smvm_fast(a, v)
