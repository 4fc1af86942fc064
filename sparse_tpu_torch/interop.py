"""Carry state across from the reference package.

Each function builds one of the port's objects from the reference's arrays,
given as anything ``numpy.asarray`` accepts (NumPy arrays, or the reference's
own device arrays, converted without importing their framework).  The
``*_plan_from_arrays`` functions let the tests feed the SAME plan to both
packages, so a kernel is checked apart from its planner.

:func:`smvm_plan_from_arrays` takes a dispatch plan's ``state`` as a tuple
whose elements are the rung's objects — any objects carrying the
reference's field names (``data``/``indices``/``indptr``/``shape`` for a
CSR, and so on).
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.bell import BELL
from .formats.bsr import BSR, _bidx_dtype
from .formats.coo import COO
from .formats.csr import CSR
from .ops.cuda_csr import SegTilePlan
from .ops.cuda_csr_block import BlockSegTilePlan
from .ops.dispatch import SmvmAutoPlan
from .ops.hub_split import HubSplit
from .ops.segmented import INDEX_DTYPE
from .ops.spmv import SpmvPlan

__all__ = [
    "coo_from_arrays",
    "csr_from_arrays",
    "bsr_from_arrays",
    "seg_tile_plan_from_arrays",
    "block_seg_tile_plan_from_arrays",
    "smvm_plan_from_arrays",
]


def _t(x, device, dtype=None) -> torch.Tensor | None:
    if x is None:
        return None
    t = torch.from_numpy(np.array(x))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device or "cpu")


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


def seg_tile_plan_from_arrays(vals, q, seg_of, rb, *, n, m, n_tiles, fill,
                              chunks, wsub, rows, kstep, pos=None, eidx=None,
                              nse=None, device=None) -> SegTilePlan:
    return SegTilePlan(
        vals=_t(vals, device), q=_t(q, device, torch.int8),
        seg_of=_t(seg_of, device, torch.int32),
        rb=_t(rb, device, torch.int32), n=int(n), m=int(m),
        n_tiles=int(n_tiles), fill=float(fill), chunks=tuple(chunks),
        wsub=int(wsub), rows=int(rows), kstep=int(kstep),
        pos=_t(pos, device, torch.int64), eidx=_t(eidx, device, torch.int64),
        nse=None if nse is None else int(nse))


def block_seg_tile_plan_from_arrays(vals, q, seg_of, rb, *, n, nb, bsz,
                                    n_tiles, fill, chunks, wsub, kstep,
                                    pos=None, eidx=None, nbz=None,
                                    device=None) -> BlockSegTilePlan:
    return BlockSegTilePlan(
        vals=_t(vals, device), q=_t(q, device, torch.int8),
        seg_of=_t(seg_of, device, torch.int32),
        rb=_t(rb, device, torch.int32), n=int(n), nb=int(nb), bsz=int(bsz),
        n_tiles=int(n_tiles), fill=float(fill), chunks=tuple(chunks),
        wsub=int(wsub), kstep=int(kstep), pos=_t(pos, device, torch.int64),
        eidx=_t(eidx, device, torch.int64),
        nbz=None if nbz is None else int(nbz))


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
        return (BELL(cols=_t(b.cols, device, torch.int32),
                     blocks=_t(b.blocks, device), n=int(b.n),
                     bsz=int(b.bsz)),)
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
    (see the module docstring) and its reorder arrays."""
    return SmvmAutoPlan(
        state=_state(kind, state, device),
        perm=_t(perm, device, torch.int64),
        inv_perm=_t(inv_perm, device, torch.int64),
        kind=kind, shape=(int(shape[0]), int(shape[1])),
        value_src=_t(value_src, device, torch.int64))
