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

:func:`segtile_apply` is the raw-array SpMV over a plan's slot arrays (the
contract the per-shard halo SpMV calls).  On CUDA tensors it launches a
hand-written Hopper kernel: ``csrc/segtile_csr.cu`` for ``reduce="vpu"``
(K1 at ``rows=8``, K1-r32 at ``rows=32``) and ``csrc/segtile_mxu.cu`` for
``reduce="mxu"`` (K1-mxu, lanes summed by a tensor-core product against an
all-ones matrix); on CPU tensors it runs :func:`segtile_apply_plain`, the
same sum in plain PyTorch.  There is no other route: a CUDA tensor never
reaches the plain version.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import _kernels
from ..formats.csr import CSR
from ..utils.precision import full_precision

__all__ = [
    "SegTilePlan",
    "build_seg_tiles",
    "csr_smvm_segtile",
    "seg_tiles_refresh",
    "segtile_apply",
    "segtile_apply_plain",
    "csr_smvm_auto",
    "segtile_hbm_bytes",
]

#: Launches of each CUDA kernel (pass 1 + pass 2 count as one), counted
#: where the wrapper launches it and nowhere else: K1 (``reduce="vpu"`` at
#: ``rows=8``), K1-r32 (``reduce="vpu"`` at ``rows=32``), K1-mxu
#: (``reduce="mxu"``, either height).
K1_LAUNCHES = 0
K1_R32_LAUNCHES = 0
K1_MXU_LAUNCHES = 0

_LANES = 128
_TILE_CAP = 102_400  # reference SMEM chunk budget; kept for plan parity
_K = 512  # reference tiles per grid step at production sizes
_REDUCES = ("vpu", "mxu")


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
    ``data`` tensor the plan was built from."""

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
    return SegTilePlan(
        vals=tvals,
        q=tq,
        seg_of=torch.from_numpy(seg_of).to(dev),
        rb=torch.from_numpy(rb).to(dev),
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
    tvals = _fill_slots(plan.pos, data[plan.eidx], size).reshape(
        plan.n_tiles, plan.rows, _LANES)
    return dataclasses.replace(plan, vals=tvals)


def csr_smvm_segtile(a: CSR, v, plan: SegTilePlan, *, reduce: str = "vpu",
                     batch: int | None = None) -> torch.Tensor:
    """SpMV through the segment-tile kernel; matches ``csr_smvm`` up to
    float summation order.  ``plan`` from :func:`build_seg_tiles`.

    ``reduce``: how each tile row's 128 products become one sum — ``"vpu"``
    (a warp's shuffle sum) or ``"mxu"`` (a tensor-core product against an
    all-ones matrix, float32 split into two TF32 terms so the sum keeps
    float32 accuracy).  ``batch`` (the reference's per-grid-step emission
    group of the TPU kernel) is accepted and does not change the result;
    below 1 it raises ``ValueError``, as the reference fails there."""
    v = torch.as_tensor(v, device=plan.vals.device)
    n, m = a.shape
    if tuple(v.shape) != (m,):
        raise ValueError(
            f"csr_smvm_segtile: vector shape {tuple(v.shape)} != ({m},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if n == 0:
        return torch.zeros(0, dtype=out_dtype, device=v.device)
    y = segtile_apply(plan.vals, plan.q, plan.seg_of, plan.rb, v, n=n,
                      wsub=plan.wsub, rows=plan.rows, kstep=plan.kstep,
                      chunks=plan.chunks, reduce=reduce, batch=batch,
                      out_dtype=out_dtype)
    return y[:n]


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
    """Raw-array segment-tile SpMV over a plan's slot tensors.

    ``v`` is the operand in the plan's column space; returns the padded
    ``(ceil(n/rows)*rows,)`` output.  CUDA tensors launch K1 or K1-r32
    (``csrc/segtile_csr.cu``, ``reduce="vpu"``) or K1-mxu
    (``csrc/segtile_mxu.cu``); CPU tensors run :func:`segtile_apply_plain`.
    ``kstep``/``chunks``/``batch`` are accepted for the reference's
    signature and do not change the result."""
    _check_variant("segtile_apply", rows, reduce, batch)
    if out_dtype is None:
        out_dtype = torch.promote_types(vals.dtype, v.dtype)
    devices = {t.device for t in (vals, q, seg_of, rb, v)}
    if devices == {torch.device("cpu")}:
        return segtile_apply_plain(vals, q, seg_of, rb, v, n=n, wsub=wsub,
                                   rows=rows, kstep=kstep, chunks=chunks,
                                   reduce=reduce, out_dtype=out_dtype)
    if len(devices) == 1 and v.is_cuda:
        return _segtile_apply_cuda(vals, q, seg_of, rb, v, n, wsub, rows,
                                   reduce, out_dtype)
    raise ValueError(f"segtile_apply: tensors must share one device, got "
                     f"{sorted(str(d) for d in devices)}")


def segtile_apply_plain(vals, q, seg_of, rb, v, *, n: int, wsub: int,
                        rows: int = 8, kstep: int = 0, chunks: tuple = (),
                        reduce: str = "vpu", batch: int | None = None,
                        out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of K1, K1-r32 and K1-mxu (any device): gather,
    product, lane sum (``"mxu"``: one product with an all-ones column at
    full precision, the reference's reduction), sum by row block.  Columns
    at or past ``len(v)`` read 0."""
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
    y.index_add_(0, rbl[keep], part[keep])
    return y.reshape(-1)


def _tile_order(rb: torch.Tensor, n_row_blocks: int):
    """Stable tile order by row block and each row block's range in it
    (int32, on ``rb``'s device): what pass 2 of the kernels walks.  Tiles
    with an out-of-range row block fall outside every range."""
    rb_sorted, order = torch.sort(rb, stable=True)
    bounds = torch.arange(n_row_blocks + 1, dtype=rb.dtype, device=rb.device)
    tile_ptr = torch.searchsorted(rb_sorted, bounds, out_int32=True)
    return order.to(torch.int32), tile_ptr


def _check_kernel_inputs(name, vals, q, seg_of, rb, v, out_dtype,
                         val_shape, q_shape):
    """Raise on anything the kernel does not take (``val_shape``/``q_shape``:
    the per-tile shapes of ``vals`` and ``q``); returns (vals, v) in the
    output dtype."""
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, "
                        f"got {out_dtype}")
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
    vals = vals.to(out_dtype)
    v = v.to(out_dtype)
    for nm, x in (("vals", vals), ("q", q), ("seg_of", seg_of), ("rb", rb),
                  ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    if vals.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError(f"{name}: vals must be 16-byte and q 4-byte aligned")
    return vals, v


def _segtile_apply_cuda(vals, q, seg_of, rb, v, n, wsub, rows, reduce,
                        out_dtype):
    global K1_LAUNCHES, K1_R32_LAUNCHES, K1_MXU_LAUNCHES
    tile = (rows, _LANES)
    vals, v = _check_kernel_inputs("segtile_apply", vals, q, seg_of, rb, v,
                                   out_dtype, tile, tile)
    if wsub not in (8, 16, 32):
        raise ValueError(f"segtile_apply: wsub must be 8, 16 or 32, got "
                         f"{wsub}")
    dev = v.device
    n_tiles = vals.shape[0]
    nbR = -(-n // rows)
    lib = _kernels.load()
    f32 = out_dtype == torch.float32
    if reduce == "mxu":
        fn = lib.segtile_mxu_f32 if f32 else lib.segtile_mxu_f64
    else:
        fn = lib.segtile_csr_f32 if f32 else lib.segtile_csr_f64
    with torch.cuda.device(dev):
        order, tile_ptr = _tile_order(rb, nbR)
        partial = torch.empty(n_tiles * rows, dtype=out_dtype, device=dev)
        y = torch.empty(nbR * rows, dtype=out_dtype, device=dev)
        rc = fn(vals.data_ptr(), q.data_ptr(), seg_of.data_ptr(),
                order.data_ptr(), tile_ptr.data_ptr(), v.data_ptr(),
                partial.data_ptr(), y.data_ptr(), n_tiles, v.shape[0], nbR,
                rows, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(rc, f"segtile_{reduce}")
    if reduce == "mxu":
        K1_MXU_LAUNCHES += 1
    elif rows == 32:
        K1_R32_LAUNCHES += 1
    else:
        K1_LAUNCHES += 1
    return y


def segtile_hbm_bytes(plan: SegTilePlan) -> int:
    """Bytes one segment-tile SpMV moves at float32, the reference's model:
    5 B per slot (value + int8 pointer) + the operand + the output."""
    slots = plan.n_tiles * plan.rows * _LANES
    nbR = -(-plan.n // plan.rows)
    return slots * 5 + plan.m * 4 + nbR * plan.rows * 4


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
