"""Carry state across from the reference package.

Each function builds one of the port's objects from the reference's arrays,
given as anything ``numpy.asarray`` accepts (NumPy arrays, or the reference's
own device arrays, converted without importing their framework).  The
``*_plan_from_arrays`` functions let the tests feed the SAME plan to both
packages, so a kernel is checked apart from its planner.  Every function
builds on ``device``, CUDA by default; ``device="cpu"`` asks for the CPU.

:func:`smvm_plan_from_arrays` takes a dispatch plan's ``state`` as a tuple
whose elements are the rung's objects — any objects carrying the
reference's field names (``data``/``indices``/``indptr``/``shape`` for a
CSR, and so on).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .formats.bell import BELL
from .formats.bsr import BSR, BsrSmsmmPlan, _bidx_dtype
from .formats.coo import COO
from .formats.csr import CSR
from .formats.mono import MSR
from .formats.trapezoidal import Trapezoidal
from .formats.triangular import Triangular
from .ops.cuda_bell import BandedKit, BandedKitT, BandedPlan
from .ops.cuda_bsr import BsrSlabPlan, BsrSlabPlanAD, slot_list
from .ops.cuda_csr import SegTilePlan, seg_tiles_stream
from .ops.cuda_csr_block import BlockSegTilePlan, block_seg_tiles_stream
from .ops.dispatch import SmvmAutoPlan
from .ops.hub_split import HubSplit
from .ops.segmented import INDEX_DTYPE
from .ops.spgemm import SpgemmPlan
from .ops.spmv import SpmvPlan
from .parallel import (PBELL, PBSR, PCSR, HaloPCSR, HaloPCSROverlap,
                       HaloSegtile, PBsrSlabPlan, PBsrSmsmmPlan, PHubSplit,
                       PSpGEMMPlan, PTransposePlan, put_sharded)
from .solve.bsr_lu import LuNumericPlan, TriSolvePlan

__all__ = [
    "coo_from_arrays",
    "csr_from_arrays",
    "bsr_from_arrays",
    "msr_from_arrays",
    "triangular_from_arrays",
    "trapezoidal_from_arrays",
    "lu_plan_from_arrays",
    "tri_plan_from_arrays",
    "seg_tile_plan_from_arrays",
    "block_seg_tile_plan_from_arrays",
    "smvm_plan_from_arrays",
    "bell_from_arrays",
    "banded_plan_from_arrays",
    "banded_kit_from_arrays",
    "banded_kit_t_from_arrays",
    "bsr_smsmm_plan_from_arrays",
    "slab_plan_from_arrays",
    "slab_plan_ad_from_arrays",
    "spgemm_plan_from_arrays",
    "pcsr_from_arrays",
    "halo_pcsr_from_arrays",
    "halo_overlap_from_arrays",
    "halo_segtile_from_arrays",
    "phub_from_arrays",
    "pbell_from_arrays",
    "pbsr_from_arrays",
    "pspgemm_plan_from_arrays",
    "ptranspose_plan_from_arrays",
    "pbsr_smsmm_plan_from_arrays",
    "pbsr_slab_plan_from_arrays",
]


def _t(x, device, dtype=None) -> torch.Tensor | None:
    if x is None:
        return None
    x = np.array(x)
    if x.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def coo_from_arrays(row, col, data, shape, *, device=None) -> COO:
    return COO(row=_t(row, device, INDEX_DTYPE),
               col=_t(col, device, INDEX_DTYPE), data=_t(data, device),
               shape=(int(shape[0]), int(shape[1])))


def csr_from_arrays(data, indices, indptr, shape, *, device=None) -> CSR:
    return CSR(data=_t(data, device), indices=_t(indices, device, INDEX_DTYPE),
               indptr=_t(indptr, device, INDEX_DTYPE),
               shape=(int(shape[0]), int(shape[1])))


def bsr_from_arrays(indices, blocks, n, bsz, *, device=None) -> BSR:
    nb = int(n) // int(bsz)
    return BSR(indices=_t(indices, device, _bidx_dtype(nb)),
               blocks=_t(blocks, device), n=int(n), bsz=int(bsz))


def msr_from_arrays(col_idx, vals, shape, *, device=None) -> MSR:
    return MSR(col_idx=_t(col_idx, device, INDEX_DTYPE),
               vals=_t(vals, device), shape=(int(shape[0]), int(shape[1])))


def triangular_from_arrays(data, n, lower, *, device=None) -> Triangular:
    return Triangular(data=_t(data, device), n=int(n), lower=bool(lower))


def trapezoidal_from_arrays(data, n, m, lower, *,
                            device=None) -> Trapezoidal:
    return Trapezoidal(data=_t(data, device), n=int(n), m=int(m),
                       lower=bool(lower))


def lu_plan_from_arrays(diag, p21, p12, s1, s2, st, pleft, *, nb, bsz,
                        device=None) -> LuNumericPlan:
    """The reference's ``LuNumericPlan`` (its seven index arrays, padded
    lanes at the scratch slot ``nbz``) for ``bsr_lu_numeric_apply``."""
    return LuNumericPlan(*(_t(x, device, torch.int32) for x in (
        diag, p21, p12, s1, s2, st, pleft)), nb=int(nb), bsz=int(bsz))


def tri_plan_from_arrays(off_pos, off_col, diag_pos, *, lower,
                         device=None) -> TriSolvePlan:
    """The reference's ``TriSolvePlan`` for ``bsr_forsolve`` /
    ``bsr_backsolve``."""
    return TriSolvePlan(off_pos=_t(off_pos, device, torch.int32),
                        off_col=_t(off_col, device, torch.int32),
                        diag_pos=_t(diag_pos, device, torch.int32),
                        lower=bool(lower))


def seg_tile_plan_from_arrays(vals, q, seg_of, rb, *, n, m, n_tiles, fill,
                              chunks, wsub, rows, kstep, pos=None, eidx=None,
                              nse=None, device=None) -> SegTilePlan:
    """A :class:`SegTilePlan` from the reference's slot arrays, with its
    compact stream built here (:func:`~.ops.cuda_csr.seg_tiles_stream`):
    from ``pos`` when given, which holds every stored entry, else from the
    non-zero slots.  There a stored zero cannot be told from padding and is
    left out of the stream, which gives the same result for finite
    operands."""
    plan = SegTilePlan(
        vals=_t(vals, device), q=_t(q, device, torch.int8),
        seg_of=_t(seg_of, device, torch.int32),
        rb=_t(rb, device, torch.int32), n=int(n), m=int(m),
        n_tiles=int(n_tiles), fill=float(fill), chunks=tuple(chunks),
        wsub=int(wsub), rows=int(rows), kstep=int(kstep),
        pos=_t(pos, device, torch.int64), eidx=_t(eidx, device, torch.int64),
        nse=None if nse is None else int(nse))
    return dataclasses.replace(plan, stream=seg_tiles_stream(plan))


def block_seg_tile_plan_from_arrays(vals, q, seg_of, rb, *, n, nb, bsz,
                                    n_tiles, fill, chunks, wsub, kstep,
                                    pos=None, eidx=None, nbz=None,
                                    device=None) -> BlockSegTilePlan:
    """A :class:`BlockSegTilePlan` from the reference's slot arrays, with
    its compact stream built here as in :func:`seg_tile_plan_from_arrays`
    (without ``pos``, a stored all-zero block is left out: the same result
    for finite operands)."""
    plan = BlockSegTilePlan(
        vals=_t(vals, device), q=_t(q, device, torch.int8),
        seg_of=_t(seg_of, device, torch.int32),
        rb=_t(rb, device, torch.int32), n=int(n), nb=int(nb), bsz=int(bsz),
        n_tiles=int(n_tiles), fill=float(fill), chunks=tuple(chunks),
        wsub=int(wsub), kstep=int(kstep), pos=_t(pos, device, torch.int64),
        eidx=_t(eidx, device, torch.int64),
        nbz=None if nbz is None else int(nbz))
    return dataclasses.replace(plan, stream=block_seg_tiles_stream(plan))


def bell_from_arrays(cols, blocks, n, bsz, *, device=None) -> BELL:
    return BELL(cols=_t(cols, device, torch.int32), blocks=_t(blocks, device),
                n=int(n), bsz=int(bsz))


def banded_plan_from_arrays(offs, start, rel, sup, *, W, rt, S, SW,
                            device=None) -> BandedPlan:
    return BandedPlan(offs=_t(offs, device, torch.int32),
                      start=_t(start, device, torch.int32),
                      rel=_t(rel, device, torch.int32),
                      sup=_t(sup, device, torch.int32), W=int(W), rt=int(rt),
                      S=int(S), SW=int(SW))


def _banded_plan(src, device) -> BandedPlan:
    return banded_plan_from_arrays(
        src.offs, src.start, src.rel, src.sup, W=src.W, rt=src.rt, S=src.S,
        SW=src.SW, device=device)


def banded_kit_from_arrays(plan, tiles, *, device=None) -> BandedKit:
    """A :class:`BandedKit` from a plan with the reference's field names
    (``offs``/``start``/``rel``/``sup``/``W``/``rt``/``S``/``SW``) and its
    densified tiles."""
    return BandedKit(plan=_banded_plan(plan, device),
                     tiles=_t(tiles, device))


def banded_kit_t_from_arrays(plan, tiles_t, *, device=None) -> BandedKitT:
    """A :class:`BandedKitT` from a plan as in
    :func:`banded_kit_from_arrays` and its transposed tiles."""
    return BandedKitT(plan=_banded_plan(plan, device),
                      tiles_t=_t(tiles_t, device))


def bsr_smsmm_plan_from_arrays(a_pos, b_pos, seg, indices, *, n, bsz,
                               device=None) -> BsrSmsmmPlan:
    nb = int(n) // int(bsz)
    return BsrSmsmmPlan(a_pos=_t(a_pos, device, INDEX_DTYPE),
                        b_pos=_t(b_pos, device, INDEX_DTYPE),
                        seg=_t(seg, device, INDEX_DTYPE),
                        indices=_t(indices, device, _bidx_dtype(nb)),
                        n=int(n), bsz=int(bsz))


def slab_plan_from_arrays(a_idx, b_idx, oloc, slab, first, indices, *,
                          chunks, n, bsz, g, p, nbz_out, nbz_a, nbz_b,
                          paired=False, device=None) -> BsrSlabPlan:
    """A :class:`BsrSlabPlan` from the reference's slab tables, prepared for
    ``nbz_a`` / ``nbz_b`` stored A / B blocks (the counts the reference's
    ``bsr_smsmm_pallas_prepare`` takes: its pad slots read past them).
    ``slab_start`` (the port's step range of each slab) is read off
    ``first``, which holds one 1 per slab, in slab order, and K7's product
    list is derived here once (``cuda_bsr.slot_list``, pads left out)."""
    first_h = np.asarray(first).astype(np.int64)
    starts = np.append(np.flatnonzero(first_h), first_h.size)
    idx = np.asarray(indices)
    tables = dict(a_idx=_t(a_idx, device, torch.int32),
                  b_idx=_t(b_idx, device, torch.int32),
                  oloc=_t(oloc, device, torch.int32),
                  slab_start=_t(starts, device, torch.int32))
    prod_ptr, prod_ab = slot_list(
        tables["a_idx"], tables["b_idx"], tables["oloc"],
        tables["slab_start"], g=int(g), p=int(p), nbz_out=int(nbz_out),
        paired=bool(paired), caps=(int(nbz_a), int(nbz_b)))
    return BsrSlabPlan(
        **tables, slab=_t(slab, device, torch.int32),
        first=_t(first, device, torch.int32),
        indices=_t(idx, device, torch.int64 if idx.dtype == np.int64
                   else INDEX_DTYPE),
        chunks=tuple(tuple(int(x) for x in c) for c in chunks), n=int(n),
        bsz=int(bsz), g=int(g), p=int(p), nbz_out=int(nbz_out),
        paired=bool(paired), prod_ptr=prod_ptr, prod_ab=prod_ab)


def _slab_plan(src, device, nbz_a, nbz_b) -> BsrSlabPlan:
    return slab_plan_from_arrays(
        src.a_idx, src.b_idx, src.oloc, src.slab, src.first, src.indices,
        device=device, nbz_a=nbz_a, nbz_b=nbz_b, **_plan_fields(
            src, ("chunks", "n", "bsz", "g", "p", "nbz_out", "paired"), ()))


def slab_plan_ad_from_arrays(fwd, da, db, *, device=None) -> BsrSlabPlanAD:
    """A :class:`BsrSlabPlanAD` from three plans with the reference's field
    names (``a_idx``/``b_idx``/``oloc``/``slab``/``first``/``indices`` and
    ``chunks``/``n``/``bsz``/``g``/``p``/``nbz_out``/``paired``).  Their
    output counts are each other's stored counts: ``da`` accumulates into
    A's blocks, ``db`` into B's, and both read dC, which has the forward's
    output blocks."""
    na, nb, nc = int(da.nbz_out), int(db.nbz_out), int(fwd.nbz_out)
    return BsrSlabPlanAD(fwd=_slab_plan(fwd, device, na, nb),
                         da=_slab_plan(da, device, nc, nb),
                         db=_slab_plan(db, device, na, nc))


def spgemm_plan_from_arrays(a_pos, b_pos, seg, indices, indptr, *, shape,
                            device=None) -> SpgemmPlan:
    return SpgemmPlan(a_pos=_t(a_pos, device, INDEX_DTYPE),
                      b_pos=_t(b_pos, device, INDEX_DTYPE),
                      seg=_t(seg, device, INDEX_DTYPE),
                      indices=_t(indices, device, INDEX_DTYPE),
                      indptr=_t(indptr, device, INDEX_DTYPE),
                      shape=(int(shape[0]), int(shape[1])))


def _csr(src, device) -> CSR:
    return csr_from_arrays(src.data, src.indices, src.indptr, src.shape,
                           device=device)


def _plan_fields(src, keys, optional):
    """Plan fields by the reference's names; ``optional`` ones (absent from
    some plans) default to None."""
    fields = {k: getattr(src, k) for k in keys}
    fields.update({k: getattr(src, k, None) for k in optional})
    return fields


def _seg_plan(src, device) -> SegTilePlan:
    return seg_tile_plan_from_arrays(
        src.vals, src.q, src.seg_of, src.rb, device=device,
        **_plan_fields(src, ("n", "m", "n_tiles", "fill", "chunks", "wsub",
                             "rows", "kstep"), ("pos", "eidx", "nse")))


def _block_plan(src, device) -> BlockSegTilePlan:
    return block_seg_tile_plan_from_arrays(
        src.vals, src.q, src.seg_of, src.rb, device=device,
        **_plan_fields(src, ("n", "nb", "bsz", "n_tiles", "fill", "chunks",
                             "wsub", "kstep"), ("pos", "eidx", "nbz")))


def _spmv_plan(src, device) -> SpmvPlan:
    return SpmvPlan(perm=_t(src.perm, device, torch.int64),
                    bin_sizes=tuple(int(x) for x in src.bin_sizes),
                    bin_caps=tuple(int(x) for x in src.bin_caps),
                    n=int(src.n))


def _state(kind: str, state, device) -> tuple:
    if kind == "segtile":
        a, plan = state
        return (_csr(a, device), _seg_plan(plan, device))
    if kind == "blockseg":
        ab, plan = state
        return (bsr_from_arrays(ab.indices, ab.blocks, ab.n, ab.bsz,
                                device=device), _block_plan(plan, device))
    if kind == "bell":
        (b,) = state
        return (bell_from_arrays(b.cols, b.blocks, b.n, b.bsz,
                                 device=device),)
    if kind == "hubsplit":
        (s,) = state
        return (HubSplit(
            hub_csr=_csr(s.hub_csr, device),
            hub_plan=_seg_plan(s.hub_plan, device),
            tail_csr=_csr(s.tail_csr, device),
            tail_plan=_spmv_plan(s.tail_plan, device),
            hub_cols=_t(s.hub_cols, device, torch.int64),
            shape=tuple(int(x) for x in s.shape),
            hub_nnz=int(s.hub_nnz),
            tail_nnz=int(s.tail_nnz)),)
    if kind == "xla":
        a, plan = state
        return (_csr(a, device), _spmv_plan(plan, device))
    raise ValueError(f"smvm_plan_from_arrays: unknown kind {kind!r}")


def smvm_plan_from_arrays(kind: str, state, *, shape, perm=None,
                          inv_perm=None, value_src=None,
                          device=None) -> SmvmAutoPlan:
    """A dispatch plan of rung ``kind`` from the reference's state objects
    (see the module docstring) and its reorder arrays; a ``blockseg`` plan
    with a reorder carries its folded view, as ``smvm_prepare``'s does."""
    st = _state(kind, state, device)
    if kind == "blockseg" and perm is not None:
        from .ops.cuda_csr_block import block_seg_tiles_fold

        st = (st[0], block_seg_tiles_fold(st[1], _t(perm, device,
                                                     torch.int64)))
    return SmvmAutoPlan(
        state=st,
        perm=_t(perm, device, torch.int64),
        inv_perm=_t(inv_perm, device, torch.int64),
        kind=kind, shape=(int(shape[0]), int(shape[1])),
        value_src=_t(value_src, device, torch.int64))


# -- the distributed layer ----------------------------------------------------
#
# Each function takes a partitioned object's stacked ``[D, ...]`` fields (all
# D shards, as the reference holds them) and keeps this process's shards on
# ``mesh`` (``put_sharded``); the shard count is the fields' leading
# dimension.


def _sh(x, mesh, dtype=None) -> torch.Tensor:
    return put_sharded(_t(x, "cpu", dtype), mesh)


def pcsr_from_arrays(data, indices, indptr, *, shape, rows_per_shard, mesh,
                     axis="shards") -> PCSR:
    return PCSR(data=_sh(data, mesh), indices=_sh(indices, mesh, torch.int32),
                indptr=_sh(indptr, mesh, torch.int32),
                shape=(int(shape[0]), int(shape[1])), axis=axis,
                rows_per_shard=int(rows_per_shard),
                n_shards=np.shape(indptr)[0])


def halo_pcsr_from_arrays(data, indices, indptr, send_idx, *, shape,
                          rows_per_shard, cols_per_shard, halo, mesh,
                          axis="shards") -> HaloPCSR:
    return HaloPCSR(
        data=_sh(data, mesh), indices=_sh(indices, mesh, torch.int32),
        indptr=_sh(indptr, mesh, torch.int32),
        send_idx=_sh(send_idx, mesh, torch.int32),
        shape=(int(shape[0]), int(shape[1])), axis=axis,
        rows_per_shard=int(rows_per_shard),
        cols_per_shard=int(cols_per_shard), halo=int(halo),
        n_shards=np.shape(indptr)[0])


def halo_overlap_from_arrays(int_data, int_idx, int_rows, fr_data, fr_idx,
                             fr_rows, send_idx, *, shape, rows_per_shard,
                             cols_per_shard, halo, mesh,
                             axis="shards") -> HaloPCSROverlap:
    i32 = torch.int32
    return HaloPCSROverlap(
        int_data=_sh(int_data, mesh), int_idx=_sh(int_idx, mesh, i32),
        int_rows=_sh(int_rows, mesh, i32), fr_data=_sh(fr_data, mesh),
        fr_idx=_sh(fr_idx, mesh, i32), fr_rows=_sh(fr_rows, mesh, i32),
        send_idx=_sh(send_idx, mesh, i32),
        shape=(int(shape[0]), int(shape[1])), axis=axis,
        rows_per_shard=int(rows_per_shard),
        cols_per_shard=int(cols_per_shard), halo=int(halo),
        n_shards=np.shape(send_idx)[0])


def halo_segtile_from_arrays(vals, q, seg_of, rb, send_idx, *, shape,
                             rows_per_shard, cols_per_shard, halo, wsub,
                             rows, kstep, chunks, n_tiles, fill, mesh,
                             axis="shards") -> HaloSegtile:
    """A :class:`~.parallel.HaloSegtile` from the reference's stacked slot
    arrays (``(D, n_tiles, rows, 128)``): each of this process's shards
    becomes a :class:`SegTilePlan` with its compact stream built here
    (:func:`seg_tile_plan_from_arrays`, from the non-zero slots)."""
    d = np.shape(send_idx)[0]
    m_op = int(cols_per_shard) + d * int(halo)
    vals, q, seg_of, rb = (np.asarray(x) for x in (vals, q, seg_of, rb))
    plans = tuple(
        seg_tile_plan_from_arrays(
            vals[i], q[i], seg_of[i], rb[i], n=int(rows_per_shard), m=m_op,
            n_tiles=int(n_tiles), fill=fill, chunks=chunks, wsub=wsub,
            rows=rows, kstep=kstep, device=mesh.device)
        for i in range(mesh.lo, mesh.hi))
    return HaloSegtile(
        plans=plans, send_idx=_sh(send_idx, mesh, torch.int32),
        shape=(int(shape[0]), int(shape[1])), axis=axis,
        rows_per_shard=int(rows_per_shard),
        cols_per_shard=int(cols_per_shard), halo=int(halo), wsub=int(wsub),
        rows=int(rows), kstep=int(kstep),
        chunks=tuple(tuple(int(x) for x in c) for c in chunks),
        n_tiles=int(n_tiles), fill=float(fill), n_shards=d)


def phub_from_arrays(hub_data, hub_idx, hub_rows, tail_data, tail_idx,
                     tail_rows, own_hub_idx, *, shape, rows_per_shard,
                     cols_per_shard, hub_cols_per_shard, n_hub, mesh,
                     axis="shards") -> PHubSplit:
    i32 = torch.int32
    return PHubSplit(
        hub_data=_sh(hub_data, mesh), hub_idx=_sh(hub_idx, mesh, i32),
        hub_rows=_sh(hub_rows, mesh, i32), tail_data=_sh(tail_data, mesh),
        tail_idx=_sh(tail_idx, mesh, i32),
        tail_rows=_sh(tail_rows, mesh, i32),
        own_hub_idx=_sh(own_hub_idx, mesh, i32),
        shape=(int(shape[0]), int(shape[1])), axis=axis,
        rows_per_shard=int(rows_per_shard),
        cols_per_shard=int(cols_per_shard),
        hub_cols_per_shard=int(hub_cols_per_shard), n_hub=int(n_hub),
        n_shards=np.shape(own_hub_idx)[0])


def pbell_from_arrays(cols, blocks, *, n, bsz, rows_per_shard, mesh,
                      axis="shards") -> PBELL:
    return PBELL(cols=_sh(cols, mesh, torch.int32), blocks=_sh(blocks, mesh),
                 n=int(n), bsz=int(bsz), axis=axis,
                 rows_per_shard=int(rows_per_shard),
                 n_shards=np.shape(cols)[0])


def pbsr_from_arrays(indices, blocks, *, n, bsz, rows_per_shard, mesh,
                     axis="shards") -> PBSR:
    return PBSR(indices=_sh(indices, mesh), blocks=_sh(blocks, mesh),
                n=int(n), bsz=int(bsz), axis=axis,
                rows_per_shard=int(rows_per_shard),
                n_shards=np.shape(indices)[0])


def pspgemm_plan_from_arrays(send_pos, bi_gath, starts, lens, *, exch, cap,
                             k, mesh) -> PSpGEMMPlan:
    i32 = torch.int32
    return PSpGEMMPlan(send_pos=_sh(send_pos, mesh, i32),
                       bi_gath=_sh(bi_gath, mesh, i32),
                       starts=_sh(starts, mesh, i32),
                       lens=_sh(lens, mesh, i32), exch=int(exch),
                       cap=int(cap), k=int(k))


def ptranspose_plan_from_arrays(send_pos, perm, indices, indptr, *, exch,
                                shape, rows_per_shard, mesh,
                                axis="shards") -> PTransposePlan:
    i32 = torch.int32
    return PTransposePlan(
        send_pos=_sh(send_pos, mesh, i32), perm=_sh(perm, mesh, i32),
        indices=_sh(indices, mesh, i32), indptr=_sh(indptr, mesh, i32),
        exch=int(exch), shape=(int(shape[0]), int(shape[1])), axis=axis,
        rows_per_shard=int(rows_per_shard), n_shards=np.shape(perm)[0])


def pbsr_smsmm_plan_from_arrays(send_pos, a_pos, b_pos, seg, out_indices, *,
                                exch, cap, nbz_out, n, bsz, rows_per_shard,
                                mesh, axis="shards") -> PBsrSmsmmPlan:
    i32 = torch.int32
    return PBsrSmsmmPlan(
        send_pos=_sh(send_pos, mesh, i32), a_pos=_sh(a_pos, mesh, i32),
        b_pos=_sh(b_pos, mesh, i32), seg=_sh(seg, mesh, i32),
        out_indices=_sh(out_indices, mesh), exch=int(exch), cap=int(cap),
        nbz_out=int(nbz_out), n=int(n), bsz=int(bsz), axis=axis,
        rows_per_shard=int(rows_per_shard))


def pbsr_slab_plan_from_arrays(send_pos, a_idx, b_idx, oloc, first, slab,
                               out_indices, *, exch, chunks, g, p, nbz_out,
                               n, bsz, rows_per_shard, mesh,
                               axis="shards") -> PBsrSlabPlan:
    """A :class:`~.parallel.PBsrSlabPlan` from the reference's
    ``PBsrPallasPlan`` tables; ``slab_start`` is read off ``first`` (one 1
    per slab, in slab order)."""
    i32 = torch.int32
    first_h = np.asarray(first).astype(np.int64)
    starts = np.append(np.flatnonzero(first_h), first_h.size)
    return PBsrSlabPlan(
        send_pos=_sh(send_pos, mesh, i32), a_idx=_sh(a_idx, mesh, i32),
        b_idx=_sh(b_idx, mesh, i32), oloc=_sh(oloc, mesh, i32),
        first=_t(first, mesh.device, i32), slab=_t(slab, mesh.device, i32),
        slab_start=_t(starts, mesh.device, i32),
        out_indices=_sh(out_indices, mesh), exch=int(exch),
        chunks=tuple(tuple(int(x) for x in c) for c in chunks), g=int(g),
        p=int(p), nbz_out=int(nbz_out), n=int(n), bsz=int(bsz), axis=axis,
        rows_per_shard=int(rows_per_shard))
