"""Block-granule segment-tile SpMV: kernel K2 and its host planner.

Port of ``sparse_tpu/ops/pallas_csr_block.py``.  Matrices with natural dense
2x2 blocks (vector-valued FEM: 2 dof per mesh node) let one slot carry a
whole block: the tile layout is the scalar first-fit layout built over the
BLOCK pattern, each slot holds the 4 values of its block as separate value
planes sharing one int8 window pointer.  The symmetric reorder that keeps
blocks intact is :func:`~sparse_tpu_torch.ops.reorder.rcm_order_blocked`.

On CUDA tensors :func:`bsr_smvm_segtile_block` launches the hand-written
Hopper kernel ``csrc/segtile_block.cu``; on CPU tensors it runs
:func:`bsr_smvm_segtile_block_plain`.  The result matches ``csr_smvm`` of the
scalar expansion up to float summation order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..formats.bsr import BSR
from .cuda_csr import (
    _LANES,
    _check_kernel_inputs,
    _check_refresh_source,
    _fill_slots,
    _pad_tiles,
    _tile_order,
)

__all__ = [
    "BlockSegTilePlan",
    "build_seg_tiles_block",
    "block_seg_tiles_refresh",
    "bsr_smvm_segtile_block",
    "bsr_smvm_segtile_block_plain",
    "block_segtile_hbm_bytes",
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
    ``nbz``: block capacity of the BSR the plan was built from."""

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


def _fill_planes(pos, eidx, blocks, size, n_tiles, bsz):
    planes = [_fill_slots(pos, blocks[eidx, i, j], size)
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
    vals = _fill_planes(pos, entry, ab.blocks, size, n_tiles, bsz)
    return BlockSegTilePlan(
        vals=vals,
        q=q,
        seg_of=torch.from_numpy(seg_of).to(dev),
        rb=torch.from_numpy(rb).to(dev),
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
    vals = _fill_planes(plan.pos, plan.eidx, blocks,
                        plan.n_tiles * _R * _LANES, plan.n_tiles, plan.bsz)
    return dataclasses.replace(plan, vals=vals)


def _operand(ab: BSR, v, plan: BlockSegTilePlan):
    v = torch.as_tensor(v, device=plan.vals.device)
    if tuple(v.shape) != (ab.n,):
        raise ValueError(
            f"bsr_smvm_segtile_block: vector shape {tuple(v.shape)} != "
            f"({ab.n},)")
    return v, torch.promote_types(ab.dtype, v.dtype)


def bsr_smvm_segtile_block(ab: BSR, v, plan: BlockSegTilePlan) -> \
        torch.Tensor:
    """SpMV through the block-granule kernel (K2 on CUDA tensors, the plain
    version on CPU tensors)."""
    v, out_dtype = _operand(ab, v, plan)
    if ab.n == 0:
        return torch.zeros(0, dtype=out_dtype, device=v.device)
    tensors = (plan.vals, plan.q, plan.seg_of, plan.rb, v)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return bsr_smvm_segtile_block_plain(ab, v, plan)
    if len(devices) == 1 and v.is_cuda:
        return _segtile_block_cuda(plan, v, out_dtype)
    raise ValueError(f"bsr_smvm_segtile_block: tensors must share one "
                     f"device, got {sorted(str(d) for d in devices)}")


def bsr_smvm_segtile_block_plain(ab: BSR, v, plan: BlockSegTilePlan) -> \
        torch.Tensor:
    """Plain PyTorch version of K2 (any device): gather both operand planes,
    4 plane products, lane sums, sum by row block."""
    v, out_dtype = _operand(ab, v, plan)
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
    y.index_add_(0, rbl[keep], torch.stack([acc0, acc1], -1)[keep])
    return y.reshape(-1)[:nb * 2]


def _segtile_block_cuda(plan: BlockSegTilePlan, v, out_dtype):
    global K2_LAUNCHES
    if plan.bsz != 2:
        raise ValueError(f"bsr_smvm_segtile_block: the CUDA kernel takes "
                         f"bsz=2, got {plan.bsz}")
    vals, v = _check_kernel_inputs("bsr_smvm_segtile_block", plan.vals,
                                   plan.q, plan.seg_of, plan.rb, v,
                                   out_dtype, (4, _R, _LANES))
    dev = v.device
    n_tiles = vals.shape[0]
    nb = plan.nb
    nbRb = -(-nb // _R)
    lib = _kernels.load()
    fn = lib.segtile_block_f32 if out_dtype == torch.float32 \
        else lib.segtile_block_f64
    with torch.cuda.device(dev):
        order, tile_ptr = _tile_order(plan.rb, nbRb)
        partial = torch.empty(n_tiles * _R * 2, dtype=out_dtype, device=dev)
        y = torch.empty(nbRb * _R * 2, dtype=out_dtype, device=dev)
        rc = fn(vals.data_ptr(), plan.q.data_ptr(), plan.seg_of.data_ptr(),
                order.data_ptr(), tile_ptr.data_ptr(), v.data_ptr(),
                partial.data_ptr(), y.data_ptr(), n_tiles, nb, nbRb,
                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(rc, "segtile_block")
    K2_LAUNCHES += 1
    return y[:nb * 2]


def block_segtile_hbm_bytes(plan: BlockSegTilePlan) -> int:
    """Bytes one block-granule SpMV moves at float32, the reference's model:
    bsz^2 value planes (4 B) + one shared pointer plane (1 B) per slot, the
    operand and the output."""
    slots = plan.n_tiles * _R * _LANES
    return (slots * (4 * plan.bsz * plan.bsz + 1) + plan.nb * plan.bsz * 4
            + (-(-plan.nb // _R)) * _R * plan.bsz * 4)
