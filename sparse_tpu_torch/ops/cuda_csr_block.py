"""Block-granule segment-tile SpMV: kernel K2 and its host planner.

Port of ``sparse_tpu/ops/pallas_csr_block.py``.  Matrices with natural dense
2x2 blocks (vector-valued FEM: 2 dof per mesh node) let one slot carry a
whole block: the tile layout is the scalar first-fit layout built over the
BLOCK pattern, each slot holds the 4 values of its block as separate value
planes sharing one int8 window pointer.  The symmetric reorder that keeps
blocks intact is :func:`~sparse_tpu_torch.ops.reorder.rcm_order_blocked`.

The plan also holds its stored blocks as a compact stream
(:class:`~.cuda_csr.CompactStream`, built once with the plan): one record
of four values and one int32 block column per block, in (block row, tile,
lane) order.  On CUDA tensors :func:`bsr_smvm_segtile_block` launches the
hand-written Hopper kernel ``csrc/segtile_block.cu`` on it (one pass, K2;
float32, float64, int32 summed modulo 2^32, and bf16 summed in float32 and
rounded once);
on CPU tensors it runs :func:`block_stream_plain`, the same sum in plain
PyTorch.  :func:`bsr_smvm_segtile_block_plain`, the slot-by-slot sum, stays
as the reference-shaped oracle.  The result matches ``csr_smvm`` of the
scalar expansion up to float summation order.

A plan built on a block-permuted matrix ``P A P^T`` (the dispatcher's block
RCM) can carry a folded view of its stream (:func:`block_seg_tiles_fold`):
the same values, row offsets and long rows, the block columns in the
caller's numbering and a map from stream block row to the caller's block
row.  :func:`block_folded_apply` runs K2 on it: ``y = A v`` in one launch
on ``v`` as the caller holds it, with no gather before or after, and the
bits of the unfolded apply gathered back through ``P``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..formats.bsr import BSR
from .cuda_csr import (
    _LANES,
    _SUFFIX,
    CompactStream,
    _check_refresh_source,
    _fill_slots,
    _launch,
    _pad_tiles,
    _refresh_stream,
    _stream_from_slots,
    _stream_rows,
    _sum_dtype,
)

__all__ = [
    "BlockSegTilePlan",
    "build_seg_tiles_block",
    "block_folded_apply",
    "block_seg_tiles_fold",
    "block_seg_tiles_refresh",
    "block_seg_tiles_stream",
    "bsr_smvm_segtile_block",
    "bsr_smvm_segtile_block_plain",
    "block_stream_plain",
    "block_segtile_hbm_bytes",
    "block_stream_bytes",
]

#: Launches of the K2 CUDA kernel, counted where the wrapper launches it.
K2_LAUNCHES = 0

_R = 8


@dataclasses.dataclass(frozen=True)
class BlockSegTilePlan:
    """Static block-granule segment-tile layout (+ values) of a BSR matrix.

    ``vals``: (n_tiles, bsz*bsz, 8, 128) slot value planes (plane i*bsz+j
    holds block element (i, j)); ``q``: int8 window pointers shared by all
    planes of a slot; ``seg_of``/``rb``: int32 per-tile window base (in
    128-block-column units) / output block-row block.  ``fill`` is block-
    slot occupancy, padding tiles included as in the reference.  ``pos``/
    ``eidx`` (``refreshable=True``) feed :func:`block_seg_tiles_refresh`;
    ``nbz``: block capacity of the BSR the plan was built from; ``stream``:
    the compact stream K2 reads; ``folded``: its folded view
    (:func:`block_seg_tiles_fold`), or None."""

    vals: torch.Tensor
    q: torch.Tensor
    seg_of: torch.Tensor
    rb: torch.Tensor
    n: int
    nb: int
    bsz: int
    n_tiles: int
    fill: float
    chunks: tuple
    wsub: int
    kstep: int
    pos: torch.Tensor | None = None
    eidx: torch.Tensor | None = None
    nbz: int | None = None
    stream: CompactStream | None = None
    folded: CompactStream | None = None


def _fill_planes(pos, values, size, n_tiles, bsz):
    """Value planes from the blocks at slot positions ``pos``."""
    planes = [_fill_slots(pos, values[:, i, j], size)
              for i in range(bsz) for j in range(bsz)]
    return torch.stack(planes, 0).reshape(bsz * bsz, n_tiles, _R, _LANES) \
        .transpose(0, 1).contiguous()


def build_seg_tiles_block(ab: BSR, wsub: int = 8,
                          refreshable: bool = False) -> BlockSegTilePlan:
    """Host-side block-granule tiling of a BSR matrix (once per pattern +
    values; value planes filled on ``ab``'s device).  bsz=2 only, as in the
    reference: wider blocks belong to the BELL paths."""
    bsz = ab.bsz
    if bsz != 2:
        raise ValueError(
            f"build_seg_tiles_block: bsz=2 only (got {bsz}); bsz >= 8 "
            "routes to the BELL block paths")
    nb = ab.nb
    idx = ab.indices.cpu().numpy().astype(np.int64)
    store = np.flatnonzero(idx < nb * nb)
    bi = idx[store]
    order0 = np.argsort(bi, kind="stable")
    store = store[order0]
    bi = bi[order0]
    rows_b = bi // nb
    cols_b = bi % nb
    nnz_b = rows_b.size
    indptr_b = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(rows_b, minlength=nb), out=indptr_b[1:])

    from ..native.plansort import (
        argsort_u64,
        seg_tile_layout_ff,
        seg_tile_layout_ff_py,
    )

    res = seg_tile_layout_ff(indptr_b, cols_b, wsub, rows=_R) if nnz_b \
        else None
    if res is None:
        res = seg_tile_layout_ff_py(indptr_b, cols_b, wsub, rows=_R)
    pos_src, sub_src, t_base, t_rb = res
    kstep, n_tiles, seg_of, rb, chunks = _pad_tiles(t_base.size, _R, t_base,
                                                    t_rb)
    slots = _R * _LANES
    if n_tiles * slots > np.iinfo(np.int32).max:
        raise ValueError(
            "build_seg_tiles_block: tile count overflows int32 slot "
            "positions — use the scalar paths")
    order = (argsort_u64(np.asarray(pos_src).astype(np.uint64)) if nnz_b
             else np.zeros(0, np.int64))
    dev = ab.device
    pos = torch.from_numpy(np.asarray(pos_src)[order].astype(np.int64)) \
        .to(dev)
    entry = torch.from_numpy(store[order].astype(np.int64)).to(dev)
    size = n_tiles * slots
    sub = torch.from_numpy(np.asarray(sub_src)[order].astype(np.int8))
    q = _fill_slots(pos, sub.to(dev), size).reshape(n_tiles, _R, _LANES)
    vals = _fill_planes(pos, ab.blocks[entry], size, n_tiles, bsz)
    seg_of_t = torch.from_numpy(seg_of).to(dev)
    rb_t = torch.from_numpy(rb).to(dev)
    return BlockSegTilePlan(
        vals=vals,
        q=q,
        seg_of=seg_of_t,
        rb=rb_t,
        stream=_stream_from_slots(vals, q, seg_of_t, rb_t, rows=_R,
                                  n_rows=nb, n_cols=nb, pos=pos,
                                  keep_perm=refreshable),
        n=ab.n,
        nb=nb,
        bsz=bsz,
        n_tiles=n_tiles,
        fill=nnz_b / max(n_tiles * slots, 1),
        chunks=chunks,
        wsub=wsub,
        kstep=kstep,
        pos=pos if refreshable else None,
        eidx=entry if refreshable else None,
        nbz=ab.nbz,
    )


def block_seg_tiles_refresh(plan: BlockSegTilePlan,
                            blocks) -> BlockSegTilePlan:
    """Re-bind a block-granule plan to NEW block values of the SAME pattern
    (bsz^2 gathers).  Requires ``build_seg_tiles_block(...,
    refreshable=True)``; ``blocks`` is the updated BSR ``.blocks``, whose
    length must match the plan's source (``ValueError`` otherwise)."""
    if plan.pos is None:
        raise ValueError(
            "block_seg_tiles_refresh: plan was not built with "
            "refreshable=True")
    blocks = torch.as_tensor(blocks, device=plan.vals.device)
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (plan.bsz, plan.bsz):
        raise ValueError(
            f"block_seg_tiles_refresh: blocks must be (nbz, {plan.bsz}, "
            f"{plan.bsz}), got {tuple(blocks.shape)}")
    _check_refresh_source("block_seg_tiles_refresh", blocks, plan.nbz,
                          plan.eidx)
    values = blocks[plan.eidx]
    vals = _fill_planes(plan.pos, values, plan.n_tiles * _R * _LANES,
                        plan.n_tiles, plan.bsz)
    stream = _refresh_stream(plan.stream, values)
    folded = (None if plan.folded is None
              else dataclasses.replace(plan.folded, vals=stream.vals))
    return dataclasses.replace(plan, vals=vals, stream=stream, folded=folded)


def block_seg_tiles_fold(plan: BlockSegTilePlan, perm) -> BlockSegTilePlan:
    """``plan`` (built on ``P A P^T``, block row ``i`` of it being block row
    ``perm[i]`` of ``A``) with the folded view of its stream: the stream's
    values, row offsets and long-row arrays, its block columns mapped to
    ``perm[c]`` and the output map ``perm`` (stream block row ``r`` writes
    ``y[2*perm[r] + i]``), on the stream's device.  The view adds two int32
    arrays of the plan's size (block columns, block rows) and one of its
    long rows'; :func:`block_seg_tiles_refresh` keeps it in step."""
    stream = plan.stream
    if stream is None:
        raise ValueError("block_seg_tiles_fold: the plan carries no compact "
                         "stream")
    p = torch.as_tensor(perm, device=stream.cols.device).to(torch.int32)
    if tuple(p.shape) != (plan.nb,):
        raise ValueError(f"block_seg_tiles_fold: perm has shape "
                         f"{tuple(p.shape)}, the plan has {plan.nb} block "
                         "rows")
    folded = dataclasses.replace(stream, cols=p[stream.cols.long()],
                                 out_rows=p, out_long=p[
                                     stream.long_rows.long()])
    return dataclasses.replace(plan, folded=folded)


def block_seg_tiles_stream(plan: BlockSegTilePlan) -> CompactStream:
    """The compact stream of a block plan given by its slot arrays (carried
    from the reference by :mod:`~sparse_tpu_torch.interop`): from ``pos``
    when the plan has them, else from the slots with a non-zero value — a
    stored all-zero block cannot be told from padding and is left out,
    which changes no sum over finite operands."""
    if plan.bsz != 2:
        raise ValueError(f"block_seg_tiles_stream: bsz=2 only, got "
                         f"{plan.bsz}")
    return _stream_from_slots(plan.vals, plan.q, plan.seg_of, plan.rb,
                              rows=_R, n_rows=plan.nb, n_cols=plan.nb,
                              pos=plan.pos, keep_perm=plan.eidx is not None)


def _operand(name, ab: BSR, v, plan: BlockSegTilePlan):
    dev = plan.vals.device
    if not isinstance(v, torch.Tensor) or v.device != dev:
        v = torch.as_tensor(v, device=dev)
    if tuple(v.shape) != (ab.n,):
        raise ValueError(f"{name}: vector shape {tuple(v.shape)} != "
                         f"({ab.n},)")
    dt = ab.blocks.dtype
    return v, dt if v.dtype == dt else torch.promote_types(dt, v.dtype)


def bsr_smvm_segtile_block(ab: BSR, v, plan: BlockSegTilePlan) -> \
        torch.Tensor:
    """SpMV through the block-granule kernel over the plan's compact stream
    (K2 on CUDA tensors, :func:`block_stream_plain` on CPU tensors)."""
    name = "bsr_smvm_segtile_block"
    v, out_dtype = _operand(name, ab, v, plan)
    if ab.n == 0:
        return torch.zeros(0, dtype=out_dtype, device=v.device)
    if plan.stream is None:
        raise ValueError(f"{name}: the plan carries no compact stream; "
                         "build it with build_seg_tiles_block or "
                         "interop.block_seg_tile_plan_from_arrays")
    return _stream_apply(name, plan.stream, v, out_dtype)


def block_folded_apply(ab: BSR, v, plan: BlockSegTilePlan) -> torch.Tensor:
    """``y = A v`` in the caller's numbering through the plan's folded view
    (:func:`block_seg_tiles_fold`; ``ab`` is the plan's permuted BSR, ``v``
    in the caller's numbering): one K2 launch on CUDA tensors,
    :func:`block_stream_plain` on the view on CPU tensors.  Its result has
    the bits of ``bsr_smvm_segtile_block`` on the permuted operand,
    gathered back."""
    name = "block_folded_apply"
    v, out_dtype = _operand(name, ab, v, plan)
    if ab.n == 0:
        return torch.zeros(0, dtype=out_dtype, device=v.device)
    if plan.folded is None:
        raise ValueError(f"{name}: the plan carries no folded view; build it "
                         "with block_seg_tiles_fold")
    return _stream_apply(name, plan.folded, v, out_dtype)


def _stream_apply(name, stream: CompactStream, v, out_dtype):
    """K2 on a stream (or its view) on CUDA tensors, its plain version on
    CPU tensors; raises when the two lie on different devices."""
    if stream.vals.device != v.device:
        raise ValueError(f"{name}: tensors must share one device, got "
                         f"{stream.vals.device} and {v.device}")
    if v.is_cuda:
        return _launch(name, "segtile_block", stream, v, out_dtype, 2,
                       _count_k2)
    return block_stream_plain(stream, v, out_dtype=out_dtype)


def block_stream_plain(stream: CompactStream, v, *,
                       out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of K2 over a block plan's compact stream or its
    folded view (any device): gather each block's operand pair, the two
    products, sum by output block row in entry order; ``y[2*row + i]``.
    bf16 is summed in float32 and rounded once, as the kernel does; int32
    sums wrap modulo 2^32."""
    if out_dtype is None:
        out_dtype = torch.promote_types(stream.vals.dtype, v.dtype)
    acc = _sum_dtype(out_dtype)
    k = stream.nnz
    a = stream.vals[:k].to(out_dtype).to(acc)
    x = v.to(out_dtype).to(acc).reshape(-1, 2)[stream.cols[:k].long()]
    prod = torch.stack([a[:, 0] * x[:, 0] + a[:, 1] * x[:, 1],
                        a[:, 2] * x[:, 0] + a[:, 3] * x[:, 1]], 1)
    y = torch.zeros(stream.n_rows, 2, dtype=acc, device=v.device)
    # out of place, so torch.func.vmap can batch the operand
    return y.index_add(0, _stream_rows(stream), prod).reshape(-1).to(
        out_dtype)


def bsr_smvm_segtile_block_plain(ab: BSR, v, plan: BlockSegTilePlan) -> \
        torch.Tensor:
    """Plain PyTorch version of K2 (any device): gather both operand planes,
    4 plane products, lane sums, sum by row block."""
    v, out_dtype = _operand("bsr_smvm_segtile_block_plain", ab, v, plan)
    nb = plan.nb
    if ab.n == 0:
        return torch.zeros(0, dtype=out_dtype, device=v.device)
    nbRb = -(-nb // _R)
    v2 = v.to(out_dtype).reshape(nb, 2)
    zero = torch.zeros(1, dtype=out_dtype, device=v.device)
    v0 = torch.cat([v2[:, 0], zero])
    v1 = torch.cat([v2[:, 1], zero])
    lane = torch.arange(_LANES, device=v.device)
    c = (plan.seg_of.long()[:, None, None] + plan.q.long()) * _LANES + lane
    c = torch.where((c >= 0) & (c < nb), c, torch.full_like(c, nb))
    x0, x1 = v0[c], v1[c]
    vals = plan.vals.to(out_dtype)
    acc0 = (vals[:, 0] * x0 + vals[:, 1] * x1).sum(-1)
    acc1 = (vals[:, 2] * x0 + vals[:, 3] * x1).sum(-1)
    rbl = plan.rb.long()
    keep = (rbl >= 0) & (rbl < nbRb)
    y = torch.zeros(nbRb, _R, 2, dtype=out_dtype, device=v.device)
    # out of place, so torch.func.vmap can batch the operand
    y = y.index_add(0, rbl[keep], torch.stack([acc0, acc1], -1)[keep])
    return y.reshape(-1)[:nb * 2]


def _count_k2():
    global K2_LAUNCHES
    K2_LAUNCHES += 1


def block_segtile_hbm_bytes(plan: BlockSegTilePlan) -> int:
    """Bytes one block-granule SpMV moves at float32, the reference's model:
    bsz^2 value planes (4 B) + one shared pointer plane (1 B) per slot, the
    operand and the output."""
    slots = plan.n_tiles * _R * _LANES
    return (slots * (4 * plan.bsz * plan.bsz + 1) + plan.nb * plan.bsz * 4
            + (-(-plan.nb // _R)) * _R * plan.bsz * 4)


def block_stream_bytes(plan: BlockSegTilePlan) -> int:
    """Bytes one K2 apply over the compact stream moves, from the stream's
    own tensors: each value record and int32 block column (20 B per stored
    2x2 block in float32), the int32 block-row offsets, the operand and the
    output."""
    return plan.stream.apply_nbytes(2 * plan.nb, 2 * plan.nb)
