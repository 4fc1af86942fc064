"""Distributed block SpGEMM for block-row partitioned BSR.

Port of ``sparse_tpu/parallel/pbsr.py``: C = A @ B with both operands
partitioned by contiguous block-row slabs.  The exchange is a values-only
padded ``all_to_all`` of exactly the remote B block rows each shard's A
pattern names (blocks a shard owns never travel); every index, placement
and capacity is resolved on the host once per (pattern pair, mesh).  Two
numeric steps per shard:

* :func:`pbsr_smsmm` — the plain block apply (flat ``(F, bsz^2)``
  products at ``bsz <= 8``, one batched matmul above, ``segment_sum`` by
  output block), as the reference's XLA apply;
* :func:`pbsr_smsmm_slab` — the raw-array slab apply
  :func:`~..ops.cuda_bsr.run_slabs_arrays` on a schedule whose step / slab
  layout all shards share (:func:`~..ops.cuda_bsr.schedule_stacked`): on
  CUDA tensors kernel K7 once per shard per apply, on CPU tensors its
  plain version.  The reference's ``_pallas`` names lose the infix
  (``PBsrSlabPlan``, ``build_pbsr_smsmm_plan_slab``, ``pbsr_smsmm_slab``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import host_values
from ..formats.bsr import BSR, _bidx_dtype, _flat_block_products
from ..ops.segmented import INDEX_DTYPE, segment_sum
from ..utils.precision import contract
from .mesh import Mesh
from .pcsr import _all_shards, put_sharded

__all__ = [
    "PBSR",
    "pbsr_from_bsr",
    "pbsr_to_bsr",
    "PBsrSmsmmPlan",
    "build_pbsr_smsmm_plan",
    "pbsr_smsmm",
    "PBsrSlabPlan",
    "build_pbsr_smsmm_plan_slab",
    "pbsr_smsmm_slab",
]


@dataclasses.dataclass(frozen=True)
class PBSR:
    """Block-row partitioned BSR: ``indices``: [D, nbz_p] flattened
    ``r_local * nb + c`` block coords (c global, sorted, sentinel
    ``rows_per_shard * nb`` padding); ``blocks``: [D, nbz_p, bsz, bsz].
    Shard d owns global block rows [d*rows_p, (d+1)*rows_p)."""

    indices: torch.Tensor
    blocks: torch.Tensor
    n: int
    bsz: int
    axis: str
    rows_per_shard: int
    n_shards: int

    @property
    def nb(self) -> int:
        return self.n // self.bsz

    @property
    def nbz_per_shard(self) -> int:
        return self.indices.shape[1]

    @property
    def dtype(self):
        return self.blocks.dtype


def _index_dtype(rb, nb):
    return np.int32 if rb * nb <= np.iinfo(np.int32).max else np.int64


def pbsr_from_bsr(a: BSR, mesh: Mesh, axis: str = "shards") -> PBSR:
    """Partition a BSR by contiguous block-row slabs (host pass; per-shard
    capacity = the largest slab's block count)."""
    nb, bsz = a.nb, a.bsz
    d = mesh.shape[axis]
    rb = -(-max(nb, 1) // d)
    idx = a.indices.cpu().numpy().astype(np.int64)
    valid = idx < nb * nb
    r = np.where(valid, idx // max(nb, 1), 0)
    shard_of = np.where(valid, r // rb, d)
    blocks = host_values(a.blocks)
    nbz_p = max(int(np.bincount(shard_of, minlength=d + 1)[:d].max()), 1) \
        if idx.size else 1
    out_idx = np.full((d, nbz_p), rb * nb, np.int64)
    out_blk = np.zeros((d, nbz_p, bsz, bsz), blocks.dtype)
    for s in range(d):
        take = np.flatnonzero(shard_of == s)
        out_idx[s, : take.size] = idx[take] - (s * rb) * nb
        out_blk[s, : take.size] = blocks[take]
    return PBSR(
        indices=put_sharded(out_idx.astype(_index_dtype(rb, nb)), mesh, axis),
        blocks=put_sharded(out_blk, mesh, axis, a.dtype),
        n=a.n,
        bsz=bsz,
        axis=axis,
        rows_per_shard=rb,
        n_shards=d,
    )


def pbsr_to_bsr(a: PBSR) -> BSR:
    """The shards this process holds (all of them on an in-process mesh) as
    one BSR (host pass; tests and debugging)."""
    L, rb, nb, bsz = a.indices.shape[0], a.rows_per_shard, a.nb, a.bsz
    idx = a.indices.long()
    gi, gb = [], []
    for s in range(L):
        valid = idx[s] < rb * nb
        gi.append(idx[s][valid] + (s * rb) * nb)
        gb.append(a.blocks[s][valid])
    gi = torch.cat(gi)
    order = torch.sort(gi, stable=True).indices
    return BSR(indices=gi[order].to(_bidx_dtype(nb)),
               blocks=torch.cat(gb)[order], n=a.n, bsz=bsz)


def _shard_blocks(idx: np.ndarray, nb: int, rb: int):
    """(local_row, global_col, storage_pos) of one shard's valid blocks."""
    pos = np.flatnonzero(idx < rb * nb)
    return idx[pos] // nb, idx[pos] % nb, pos


@dataclasses.dataclass(frozen=True)
class PBsrSmsmmPlan:
    """Static plan for :func:`pbsr_smsmm` (one per pattern pair + mesh).

    ``send_pos[s, t]``: block storage slots of shard s to send to shard t
    (slot ``nbz_p`` pads with the appended zero block); per shard,
    ``a_pos``/``b_pos``/``seg`` are the numeric schedule against the
    combined [recv (D*E) | local (nbz_p) | zero] B storage, padded to the
    cross-shard capacity ``cap`` with zero-block products aimed at the
    dropped segment ``nbz_out``; ``out_indices``: the result's block
    coordinates (sentinel padded to ``nbz_out`` slots)."""

    send_pos: torch.Tensor     # (D, D, E) int32
    a_pos: torch.Tensor        # (D, cap) int32
    b_pos: torch.Tensor        # (D, cap) int32
    seg: torch.Tensor          # (D, cap) int32
    out_indices: torch.Tensor  # (D, nbz_out)
    exch: int
    cap: int
    nbz_out: int
    n: int
    bsz: int
    axis: str
    rows_per_shard: int

    @property
    def comm_entries_per_device(self) -> int:
        """Exchanged values per shard (block count x bsz^2)."""
        return self.send_pos.shape[1] * self.exch * self.bsz * self.bsz


def _pbsr_symbolic(a: PBSR, b: PBSR, mesh: Mesh):
    """Host symbolic pass shared by both plans: per-pair exchange lists and
    per-shard product schedules.  Returns ``(send_lists, scheds, exch,
    cap, nbz_out)``, ``scheds[t] = (a_pos, b_pos, seg, out_idx)`` against
    the combined ``[recv (D*exch) | local (nbz_p_b) | zero]`` B storage."""
    if a.n != b.n or a.bsz != b.bsz:
        raise ValueError(
            f"build_pbsr_smsmm_plan: incompatible operands "
            f"n={a.n}/{b.n} bsz={a.bsz}/{b.bsz}")
    if a.axis != b.axis or a.n_shards != b.n_shards \
            or a.rows_per_shard != b.rows_per_shard:
        raise ValueError("build_pbsr_smsmm_plan: operands must share mesh "
                         "axis and partition")
    d, rb, nb = a.n_shards, a.rows_per_shard, a.nb
    a_idx = _all_shards(a.indices, mesh).astype(np.int64)
    b_idx = _all_shards(b.indices, mesh).astype(np.int64)

    b_rows = []  # per shard: global row -> (cols, pos)
    for s in range(d):
        r_l, c, pos = _shard_blocks(b_idx[s], nb, rb)
        rows = {}
        for rr in np.unique(r_l):
            sel = r_l == rr
            rows[int(rr + s * rb)] = (c[sel], pos[sel])
        b_rows.append(rows)
    a_parts = [_shard_blocks(a_idx[t], nb, rb) for t in range(d)]

    # per (src, dst): which of src's B rows dst needs, in row order
    send_lists = [[None] * d for _ in range(d)]
    exch = 1
    for t in range(d):
        need = np.unique(a_parts[t][1])
        for s in range(d):
            if s == t:
                continue
            rs = [int(r) for r in need[(need >= s * rb) & (need < (s + 1) * rb)]
                  if int(r) in b_rows[s]]
            pos = np.concatenate([b_rows[s][r][1] for r in rs]) if rs else \
                np.zeros(0, np.int64)
            send_lists[s][t] = (rs, pos)
            exch = max(exch, pos.size)

    scheds = []
    cap = 1
    nbz_out = 1
    for t in range(d):
        row_at = {}
        for s in range(d):
            if s == t:
                continue
            off = s * exch
            for r in send_lists[s][t][0]:
                row_at[r] = off
                off += b_rows[s][r][1].size
        a_r, a_c, a_posn = a_parts[t]
        ap, bp, tgt = [], [], []
        for i in range(a_r.size):
            c_mid = int(a_c[i])
            holder = c_mid // rb
            if holder == t:
                ent = b_rows[t].get(c_mid)
                if ent is None:
                    continue
                cols_m, pos_m = ent
                bpos = d * exch + pos_m
            else:
                if c_mid not in row_at:
                    continue
                cols_m = b_rows[holder][c_mid][0]
                bpos = row_at[c_mid] + np.arange(cols_m.size)
            ap.append(np.full(cols_m.size, a_posn[i]))
            bp.append(np.asarray(bpos))
            tgt.append(int(a_r[i]) * nb + cols_m)
        if ap:
            ap, bp, tgt = np.concatenate(ap), np.concatenate(bp), \
                np.concatenate(tgt)
            order = np.argsort(tgt, kind="stable")
            ap, bp, tgt = ap[order], bp[order], tgt[order]
            heads = np.ones(tgt.size, bool)
            heads[1:] = tgt[1:] != tgt[:-1]
            seg = np.cumsum(heads) - 1
            out_idx = tgt[heads]
        else:
            ap = bp = seg = out_idx = np.zeros(0, np.int64)
        scheds.append((ap, bp, seg, out_idx))
        cap = max(cap, ap.size)
        nbz_out = max(nbz_out, out_idx.size)
    return send_lists, scheds, exch, cap, nbz_out


def _send_and_out(send_lists, scheds, d, exch, nbz_p_b, nbz_out, rb, nb):
    send_pos = np.full((d, d, exch), nbz_p_b, np.int32)  # pad: zero slot
    out_indices = np.full((d, nbz_out), rb * nb, np.int64)
    for t in range(d):
        for s in range(d):
            if s != t:
                pos = send_lists[s][t][1]
                send_pos[s, t, : pos.size] = pos
        out_indices[t, : scheds[t][3].size] = scheds[t][3]
    return send_pos, out_indices.astype(_index_dtype(rb, nb))


def build_pbsr_smsmm_plan(a: PBSR, b: PBSR, mesh: Mesh) -> PBsrSmsmmPlan:
    """Host symbolic pass (once per pattern pair + mesh)."""
    send_lists, scheds, exch, cap, nbz_out = _pbsr_symbolic(a, b, mesh)
    d, rb, nb = a.n_shards, a.rows_per_shard, a.nb
    nbz_p_a, nbz_p_b = a.nbz_per_shard, b.nbz_per_shard
    send_pos, out_indices = _send_and_out(send_lists, scheds, d, exch,
                                          nbz_p_b, nbz_out, rb, nb)
    a_pos = np.full((d, cap), nbz_p_a, np.int32)
    b_pos = np.full((d, cap), d * exch + nbz_p_b, np.int32)  # zero slot
    seg = np.full((d, cap), nbz_out, np.int32)  # dropped segment
    for t in range(d):
        ap, bp, sg, _ = scheds[t]
        a_pos[t, : ap.size] = ap
        b_pos[t, : bp.size] = bp
        seg[t, : sg.size] = sg

    def put(x):
        return put_sharded(x, mesh, a.axis)

    return PBsrSmsmmPlan(
        send_pos=put(send_pos), a_pos=put(a_pos), b_pos=put(b_pos),
        seg=put(seg), out_indices=put(out_indices), exch=exch, cap=cap,
        nbz_out=nbz_out, n=a.n, bsz=a.bsz, axis=a.axis, rows_per_shard=rb)


def _exchange_blocks(a: PBSR, b: PBSR, send_pos, mesh: Mesh, dtype):
    """Per shard, the combined ``[recv | local | zero]`` B storage in the
    flat ``(N, bsz^2)`` layout, after the values-only all_to_all."""
    b2 = b.bsz * b.bsz
    L = mesh.local
    fb_loc = b.blocks.reshape(L, -1, b2)
    fb_send = torch.cat([fb_loc, fb_loc.new_zeros(L, 1, b2)], 1)
    shard = torch.arange(L, device=fb_loc.device)[:, None, None]
    recv = mesh.all_to_all(fb_send[shard, send_pos.long()])  # (L, D, E, b2)
    zero = fb_loc.new_zeros(1, b2)
    return [torch.cat([recv[i].reshape(-1, b2), fb_loc[i], zero]).to(dtype)
            for i in range(L)]


def _result(a: PBSR, out_indices, blocks) -> PBSR:
    return PBSR(indices=out_indices, blocks=blocks, n=a.n, bsz=a.bsz,
                axis=a.axis, rows_per_shard=a.rows_per_shard,
                n_shards=a.n_shards)


def pbsr_smsmm(a: PBSR, b: PBSR, mesh: Mesh, plan: PBsrSmsmmPlan) -> PBSR:
    """C = A @ B via a values-only all-to-all of the needed B block rows
    (``plan.comm_entries_per_device`` values per shard — O(nnz_B / D) on
    banded block patterns) and the plain block apply per shard;
    deterministic."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    bsz, b2 = a.bsz, a.bsz * a.bsz
    combs = _exchange_blocks(a, b, plan.send_pos, mesh, dtype)
    out = []
    for i, comb in enumerate(combs):
        fa = torch.cat([a.blocks[i].reshape(-1, b2).to(dtype),
                        a.blocks.new_zeros(1, b2, dtype=dtype)])
        ga = fa[plan.a_pos[i].long()]
        gb = comb[plan.b_pos[i].long()]
        if bsz <= 8:
            prods = _flat_block_products(ga, gb, bsz, dtype)
        else:
            prods = contract("fij,fjk->fik", ga.reshape(-1, bsz, bsz),
                             gb.reshape(-1, bsz, bsz)).reshape(-1, b2)
        out.append(segment_sum(prods, plan.seg[i].to(INDEX_DTYPE),
                               plan.nbz_out, indices_are_sorted=True)
                   .reshape(plan.nbz_out, bsz, bsz))
    return _result(a, plan.out_indices, torch.stack(out))


@dataclasses.dataclass(frozen=True)
class PBsrSlabPlan:
    """Stacked slab schedule for :func:`pbsr_smsmm_slab` (the reference's
    ``PBsrPallasPlan``).

    ``a_idx``/``b_idx``/``oloc``: (D, S*g) per-shard factor-slot / output
    row tables (B slots index the combined ``[recv | local | zero]``
    storage); ``first``/``slab``: (S,) the shared step layout, whole on
    every process; ``slab_start``: (nslabs+1,) its slab step ranges (read
    off ``first`` once, for the raw apply); ``send_pos``/``out_indices``
    as in :class:`PBsrSmsmmPlan`."""

    send_pos: torch.Tensor
    a_idx: torch.Tensor
    b_idx: torch.Tensor
    oloc: torch.Tensor
    first: torch.Tensor
    slab: torch.Tensor
    slab_start: torch.Tensor
    out_indices: torch.Tensor
    exch: int
    chunks: tuple
    g: int
    p: int
    nbz_out: int
    n: int
    bsz: int
    axis: str
    rows_per_shard: int

    @property
    def comm_entries_per_device(self) -> int:
        """Exchanged values per shard (block count x bsz^2)."""
        return self.send_pos.shape[1] * self.exch * self.bsz * self.bsz


def build_pbsr_smsmm_plan_slab(a: PBSR, b: PBSR, mesh: Mesh,
                               g: int | None = None,
                               p: int | None = None) -> PBsrSlabPlan:
    """Host symbolic pass + stacked slab schedule (once per pattern pair +
    mesh): the exchange of :func:`build_pbsr_smsmm_plan`, the numeric
    schedule of ``bsr_smsmm_slab_prepare`` with per-slab step counts
    equalized across shards."""
    from ..ops.cuda_bsr import schedule_stacked

    send_lists, scheds, exch, _, nbz_out = _pbsr_symbolic(a, b, mesh)
    d, rb, nb = a.n_shards, a.rows_per_shard, a.nb
    nbz_p_a, nbz_p_b = a.nbz_per_shard, b.nbz_per_shard
    a_idx, b_idx, oloc, first, slab, chunks, g, p = schedule_stacked(
        [s[2] for s in scheds],   # out slot = segment id
        [s[0] for s in scheds],   # A storage slot
        [s[1] for s in scheds],   # combined-B storage slot
        nbz_p_a, d * exch + nbz_p_b, nbz_out, g, p, a.bsz)
    send_pos, out_indices = _send_and_out(send_lists, scheds, d, exch,
                                          nbz_p_b, nbz_out, rb, nb)
    starts = np.append(np.flatnonzero(first), first.size).astype(np.int32)

    def put(x):
        return put_sharded(x, mesh, a.axis)

    def whole(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)

    return PBsrSlabPlan(
        send_pos=put(send_pos), a_idx=put(a_idx), b_idx=put(b_idx),
        oloc=put(oloc), first=whole(first), slab=whole(slab),
        slab_start=whole(starts), out_indices=put(out_indices), exch=exch,
        chunks=chunks, g=g, p=p, nbz_out=nbz_out, n=a.n, bsz=a.bsz,
        axis=a.axis, rows_per_shard=rb)


def pbsr_smsmm_slab(a: PBSR, b: PBSR, mesh: Mesh,
                    plan: PBsrSlabPlan) -> PBSR:
    """C = A @ B: the values-only all-to-all of :func:`pbsr_smsmm`, then
    the raw-array slab apply per shard (``run_slabs_arrays``: K7 on CUDA
    tensors, one launch per shard, its plain version on CPU tensors).
    Same result as :func:`pbsr_smsmm` up to summation order; float32 sums
    in full float32."""
    from ..ops.cuda_bsr import run_slabs_arrays

    dtype = torch.promote_types(a.dtype, b.dtype)
    bsz = a.bsz
    combs = _exchange_blocks(a, b, plan.send_pos, mesh, dtype)
    out = []
    for i, comb in enumerate(combs):
        za = torch.cat([a.blocks[i].to(dtype),
                        a.blocks.new_zeros(1, bsz, bsz, dtype=dtype)])
        out.append(run_slabs_arrays(
            plan.a_idx[i], plan.b_idx[i], plan.oloc[i], plan.first,
            plan.slab, za, comb.reshape(-1, bsz, bsz), chunks=plan.chunks,
            bsz=bsz, g=plan.g, p=plan.p, nbz_out=plan.nbz_out,
            out_dtype=dtype,
            precision="highest" if dtype == torch.float32 else None,
            slab_start=plan.slab_start))
    return _result(a, plan.out_indices, torch.stack(out))
