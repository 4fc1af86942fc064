"""Block-sparse LU factorization and direct solver for BSR matrices.

Port of ``sparse_tpu/solve/bsr_lu.py`` (the reference's solver stack,
blocked_square_regular.fut:366-603): right-looking block LU with
block-limited partial pivoting, symbolic fill-in analysis, factor
extraction, block triangular solves, and the direct solver ``ols``.

The sparsity pattern is static data: the symbolic passes (fill-in
discovery, the per-step plans) run on the host in NumPy once per pattern
and produce the reference's plans entry for entry.  The numeric phase runs
on the matrix's device as a host loop over the ``nb`` block columns (the
inherent critical path of right-looking LU): per step one ``lup_dense`` of
the diagonal block, one batched triangular solve for each panel, one
batched Schur product and one scatter-add.  Every step has the same shapes:
the plans are padded to one width with a zero scratch block at index
``nbz``, from which gathers read zeros and into which padded lanes write.

Contract (blocked_square_regular.fut:87-140): ``lup a`` returns ``(LU, p)``
with ``permute(p, dense(a)) == dense(lower LU @ upper LU)``; ``lower`` is
strict-lower + unit diagonal; ``upper`` includes the diagonal;
``forsolve`` reads only the strict lower part; ``backsolve`` reads the
upper part and divides by the diagonal; ``ols`` is ``backsolve . forsolve .
permute . lup``.  Pivoting is limited to within a block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.bsr import BSR, _merge_blocks, bsr_add, bsr_eye, bsr_make
from ..linalg.dense import (
    backsolve_dense,
    forsolve_dense,
    lu_dense,
    lup_dense,
    rowsolve_upper,
)
from ..ops.segmented import INDEX_DTYPE
from ..utils.precision import full_precision

__all__ = [
    "bsr_lu_find_fills",
    "bsr_lup_nofill",
    "bsr_lup",
    "bsr_lu_nofill",
    "bsr_lu",
    "bsr_lower",
    "bsr_upper",
    "bsr_forsolve",
    "bsr_backsolve",
    "bsr_tri_plan",
    "TriSolvePlan",
    "bsr_factorize",
    "BSRFactorization",
    "bsr_ols",
    "LuNumericPlan",
    "bsr_lu_numeric_prepare",
    "bsr_lu_numeric_apply",
]


def _host_pattern(a: BSR):
    """(positions, rows, cols) of the valid blocks, on the host, in storage
    order (sorted by row, then column)."""
    idxs = a.indices.cpu().numpy().astype(np.int64)
    nb = a.nb
    pos = np.nonzero(idxs < nb * nb)[0]
    return pos, idxs[pos] // max(nb, 1), idxs[pos] % max(nb, 1)


class _Groups:
    """The valid blocks of each block row (by column) and of each block
    column (by row), as slices of two orderings of the host pattern."""

    def __init__(self, a: BSR):
        nb = a.nb
        self.pos, self.rs, self.cs = _host_pattern(a)
        bounds = np.arange(nb + 1)
        self.row_ptr = np.searchsorted(self.rs, bounds)
        self.corder = np.lexsort((self.rs, self.cs))
        self.col_ptr = np.searchsorted(self.cs[self.corder], bounds)

    def row(self, i):
        """(columns, positions) of block row ``i``, columns ascending."""
        s, e = self.row_ptr[i], self.row_ptr[i + 1]
        return self.cs[s:e], self.pos[s:e]

    def col(self, i):
        """(rows, positions) of block column ``i``, rows ascending."""
        sel = self.corder[self.col_ptr[i]:self.col_ptr[i + 1]]
        return self.rs[sel], self.pos[sel]


def bsr_lu_find_fills(a: BSR) -> np.ndarray:
    """Symbolic fill-in positions for LU, as an array of (block_row,
    block_col) pairs in discovery order (reference ``lu_find_fills``,
    blocked_square_regular.fut:366-380).

    The reference's sweep rescans the live set at every block column; here
    each row and column keeps its adjacency set, which gives the same fills
    in the same order: at step i only entries right of and below (i, i)
    are read, and none of them was ever dropped from the live set."""
    nb = a.nb
    _, rs, cs = _host_pattern(a)
    rows = [set() for _ in range(nb)]
    cols = [set() for _ in range(nb)]
    for r, c in zip(rs.tolist(), cs.tolist()):
        rows[r].add(c)
        cols[c].add(r)
    acc: list[tuple[int, int]] = []
    for i in range(nb):
        row_i = sorted(c for c in rows[i] if c > i)
        col_i = sorted(r for r in cols[i] if r > i)
        fills = [(r, c) for r in col_i for c in row_i if c not in rows[r]]
        for r, c in fills:
            rows[r].add(c)
            cols[c].add(r)
        acc.extend(fills)
    return np.asarray(acc, np.int64).reshape(-1, 2)


def _pad(lists, fill, width=None):
    w = max((len(x) for x in lists), default=0) if width is None else width
    out = np.full((len(lists), max(w, 1)), fill, np.int32)
    for i, x in enumerate(lists):
        out[i, :len(x)] = x
    return out


def _lu_plan(a: BSR):
    """Padded per-step index plans of the numeric phase (the reference's
    ``_lu_plan``, entry for entry): per block column the diagonal block,
    the column panel below it, the row panel right of it, the Schur pairs
    (column-panel block, row-panel block, existing target) and the blocks
    left of the diagonal.  Padded lanes hold the scratch slot ``nbz``."""
    nb = a.nb
    g = _Groups(a)
    scratch = a.nbz
    flat = dict(zip(zip(g.rs.tolist(), g.cs.tolist()), g.pos.tolist()))
    diag = np.empty(nb, np.int32)
    l21, l12, lpairs, lleft = [], [], [], []
    for i in range(nb):
        rc, rp = g.row(i)
        d = int(np.searchsorted(rc, i))
        # mirrors ERROR_diagonal_block_must_be_nonempty (blocked:176, 429)
        if d == rc.size or rc[d] != i:
            raise ValueError(
                f"LU: diagonal block ({i},{i}) must be present exactly once "
                f"(found 0); add fill blocks or use bsr_lup")
        diag[i] = rp[d]
        cr, cp = g.col(i)
        below = int(np.searchsorted(cr, i, side="right"))
        h21, r21 = cp[below:], cr[below:]
        h12, c12 = rp[d + 1:], rc[d + 1:]
        lpairs.append([(h1, h2, flat[(r, c)])
                       for h1, r in zip(h21.tolist(), r21.tolist())
                       for h2, c in zip(h12.tolist(), c12.tolist())
                       if (r, c) in flat])
        l21.append(h21)
        l12.append(h12)
        lleft.append(rp[:d])
    ws = max((len(x) for x in lpairs), default=0)
    s1, s2, st = (_pad([[t[j] for t in pairs] for pairs in lpairs],
                       scratch, ws) for j in range(3))
    return (diag, _pad(l21, scratch), _pad(l12, scratch), s1, s2, st,
            _pad(lleft, scratch))


@dataclass(frozen=True)
class LuNumericPlan:
    """Static per-step index plan of the LU numeric phase (one row per
    block column; padded lanes point at the zero scratch slot), int32
    tensors on the matrix's device.  Built once per sparsity pattern by
    :func:`bsr_lu_numeric_prepare`; :func:`bsr_lu_numeric_apply` then
    re-factorizes changed values without the host symbolic pass."""

    diag: torch.Tensor
    p21: torch.Tensor
    p12: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    st: torch.Tensor
    pleft: torch.Tensor
    nb: int
    bsz: int


def bsr_lu_numeric_prepare(a: BSR) -> LuNumericPlan:
    """Host symbolic pass over the (fill-complete) pattern of ``a``, once
    per pattern.  Pair with :func:`bsr_lu_numeric_apply`."""
    arrays = (torch.from_numpy(x).to(a.device) for x in _lu_plan(a))
    return LuNumericPlan(*arrays, nb=a.nb, bsz=a.bsz)


def bsr_lu_numeric_apply(plan: LuNumericPlan, a: BSR,
                         pivot: bool = True) -> tuple[BSR, torch.Tensor]:
    """Numeric right-looking block LU over ``plan``'s pattern (values may
    change, the pattern must not)."""
    return _lu_steps(a, plan, pivot)


def _repeat(step, count: int, device) -> None:
    """Run ``step()`` ``count`` times, in order.  Every step has the same
    shapes and reads its position from a device counter that it advances
    itself, so on a CUDA device the first run warms up on a side stream,
    the second is captured once in a CUDA graph and the rest replay it:
    one graph launch per step instead of several hundred from Python.  On
    any other device the steps run one by one."""
    if device.type != "cuda" or count < 2:
        for _ in range(count):
            step()
        return
    stream = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        step()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(count - 1):
        graph.replay()
    # the graph's memory pool goes with it: let the replays finish first
    stream.synchronize()


def _lu_steps(a: BSR, plan: LuNumericPlan,
              pivot: bool) -> tuple[BSR, torch.Tensor]:
    """Reference ``lup_nofill`` (blocked_square_regular.fut:414-464) and
    ``lu_nofill`` (:502-546) over a fixed pattern: one step per block
    column, every index on the device (the step's block column ``i`` is a
    device counter), so the steps can replay as one CUDA graph."""
    nb, bsz = plan.nb, plan.bsz
    dev = a.device
    blocks = torch.cat([a.blocks, a.blocks.new_zeros((1, bsz, bsz))])
    diag, p21, p12, s1, s2, st, pleft = (x.long() for x in (
        plan.diag, plan.p21, plan.p12, plan.s1, plan.s2, plan.st,
        plan.pleft))
    ar = torch.arange(bsz, dtype=INDEX_DTYPE, device=dev)
    perms = (ar[None, :] + (torch.arange(nb, dtype=INDEX_DTYPE, device=dev)
                            * bsz)[:, None]).contiguous()
    i = torch.zeros(1, dtype=torch.long, device=dev)

    def row(table):
        return table.index_select(0, i)[0]

    def step():
        hd = diag.index_select(0, i)
        if pivot:
            lu_d, p = lup_dense(blocks.index_select(0, hd))
            p = p[0].long()
        else:
            lu_d = lu_dense(blocks.index_select(0, hd))
        blocks.index_copy_(0, hd, lu_d)
        lu_d = lu_d[0]
        # X21 solves X @ U = A per block (backsolve' per row,
        # blocked:433-435); padded lanes solve the zero block
        h21 = row(p21)
        blocks.index_copy_(0, h21, rowsolve_upper(
            lu_d, blocks.index_select(0, h21)))
        # X12 = L^-1 P A12 (blocked:436-439)
        h12 = row(p12)
        b12 = blocks.index_select(0, h12)
        blocks.index_copy_(0, h12, forsolve_dense(
            lu_d, b12[:, p] if pivot else b12))
        # Schur update D -= X21 @ X12 on existing targets only ("ignore
        # fillins", blocked:443-456); the targets are distinct but for
        # the scratch slot
        prods = torch.bmm(blocks.index_select(0, row(s1)),
                          blocks.index_select(0, row(s2)))
        blocks.index_add_(0, row(st), prods, alpha=-1)
        if pivot:
            # permute the final L blocks left of the diagonal
            # (blocked:457-459)
            hl = row(pleft)
            blocks.index_copy_(0, hl, blocks.index_select(0, hl)[:, p])
            perms.index_copy_(0, i, (i * bsz + p)[None].to(perms.dtype))
        i.add_(1)

    with full_precision(blocks.dtype):
        _repeat(step, nb, dev)
    lu_mat = BSR(indices=a.indices, blocks=blocks[:-1], n=a.n, bsz=a.bsz)
    return lu_mat, perms.reshape(-1)


def _lu_numeric(a: BSR, pivot: bool) -> tuple[BSR, torch.Tensor]:
    return _lu_steps(a, bsr_lu_numeric_prepare(a), pivot)


def bsr_lup_nofill(a: BSR) -> tuple[BSR, torch.Tensor]:
    """LU with block-limited partial pivoting over the existing pattern
    (reference ``lup_nofill``, blocked_square_regular.fut:414-464)."""
    return _lu_numeric(a, pivot=True)


def bsr_lu_nofill(a: BSR) -> BSR:
    """LU without pivoting over the existing pattern (reference
    ``lu_nofill``, blocked_square_regular.fut:502-546)."""
    return _lu_numeric(a, pivot=False)[0]


def _with_fills(a: BSR) -> BSR:
    fills = bsr_lu_find_fills(a)
    if fills.size == 0:
        return a
    zero = np.zeros((a.bsz, a.bsz), np.float32)
    x = bsr_make(a.n, a.bsz, [(int(r), int(c), zero) for r, c in fills],
                 dtype=a.dtype, device=a.device)
    return bsr_add(a, x)


def bsr_lup(a: BSR) -> tuple[BSR, torch.Tensor]:
    """Symbolic fill-in + pivoted numeric factorization (reference ``lup``,
    blocked_square_regular.fut:466-469)."""
    return bsr_lup_nofill(_with_fills(a))


def bsr_lu(a: BSR) -> BSR:
    """Fill-in + non-pivoting factorization (reference ``lu``,
    blocked_square_regular.fut:548-551)."""
    return bsr_lu_nofill(_with_fills(a))


# -- factor extraction ---------------------------------------------------------


def _part(a: BSR, lower: bool):
    """The stored blocks on one side of the block diagonal, diagonal blocks
    included but cut to their strict lower (``lower``) or upper triangle;
    the other blocks become padding.  Returns (indices, blocks), unsorted."""
    nb = a.nb
    idx = a.indices.long()
    r, c = idx // max(nb, 1), idx % max(nb, 1)
    keep = (idx < a.sentinel) & ((r >= c) if lower else (r <= c))
    idxs = torch.where(keep, idx, torch.full_like(idx, a.sentinel))
    i = torch.arange(a.bsz, device=a.device)
    inner = (i[:, None] > i[None, :]) if lower else (i[:, None] <= i[None, :])
    blocks = torch.where(
        (keep & (r == c))[:, None, None],
        torch.where(inner[None], a.blocks, 0),
        torch.where(keep[:, None, None], a.blocks, 0))
    return idxs.to(a.indices.dtype), blocks


def bsr_lower(a: BSR) -> BSR:
    """Strictly-lower part + unit diagonal (reference ``lower``,
    blocked_square_regular.fut:477-488)."""
    idxs, blocks = _part(a, lower=True)
    return bsr_add(bsr_eye(a.n, a.bsz, a.dtype, device=a.device),
                   BSR(indices=idxs, blocks=blocks, n=a.n, bsz=a.bsz))


def bsr_upper(a: BSR) -> BSR:
    """Upper part incl. diagonal (reference ``upper``,
    blocked_square_regular.fut:490-500)."""
    idxs, blocks = _part(a, lower=False)
    return _merge_blocks(a.n, a.bsz, idxs, blocks)


# -- block triangular solves ---------------------------------------------------


@dataclass(frozen=True)
class TriSolvePlan:
    """Static per-block-row index plan of a triangular sweep, int32
    tensors on the matrix's device.  Padded lanes point at a zero scratch
    block (position ``nbz``) and a zero scratch right-hand-side row (block
    row ``nb``), so they add nothing."""

    off_pos: torch.Tensor  # (nb, W) block positions, pad = nbz (zero block)
    off_col: torch.Tensor  # (nb, W) their block columns, pad = nb (zero row)
    diag_pos: torch.Tensor  # (nb,) diagonal position; forsolve pad = nbz
    lower: bool


def bsr_tri_plan(t: BSR, lower: bool) -> TriSolvePlan:
    """The :class:`TriSolvePlan` of ``t`` (host pass over its pattern).
    For ``lower=True`` an absent diagonal block means the identity (the
    reference forsolve reads strict lower + unit diagonal,
    blocked_square_regular.fut:556-573); for ``lower=False`` a missing
    diagonal raises, mirroring ERROR_backsolve_diagonal_element_is_zero
    (blocked:597)."""
    nb = t.nb
    g = _Groups(t)
    scratch = t.nbz
    offs, cols = [], []
    diag = np.full(nb, scratch, np.int32)
    for k in range(nb):
        rc, rp = g.row(k)
        lo = int(np.searchsorted(rc, k))
        hi = int(np.searchsorted(rc, k, side="right"))
        sel = slice(0, lo) if lower else slice(hi, None)
        offs.append(rp[sel])
        cols.append(rc[sel])
        if hi > lo:
            diag[k] = rp[lo]
        elif not lower:
            raise ValueError(f"backsolve: diagonal block ({k},{k}) missing")
    dev = t.device
    return TriSolvePlan(
        off_pos=torch.from_numpy(_pad(offs, scratch)).to(dev),
        off_col=torch.from_numpy(_pad(cols, nb)).to(dev),
        diag_pos=torch.from_numpy(diag).to(dev), lower=lower)


def _tri_sweep(t: BSR, b, plan: TriSolvePlan) -> torch.Tensor:
    """One step per block row (the block row a device counter): gather the
    already-solved neighbour rows (padded plan), one batched product summed
    over the row's blocks, one dense triangular solve of the diagonal
    block; the steps replay as one CUDA graph on the card (``_repeat``).
    ``b`` is (n,) or (n, k); the result has ``t``'s dtype."""
    b = torch.as_tensor(b, device=t.device)
    nb, bsz = t.nb, t.bsz
    vec = b.dim() == 1
    kk = 1 if vec else b.shape[1]
    if nb == 0:
        return b
    ext = torch.cat([t.blocks, t.blocks.new_zeros((1, bsz, bsz))])
    y = torch.cat([b.reshape(nb, bsz, kk).to(ext.dtype),
                   ext.new_zeros((1, bsz, kk))])
    off_pos, off_col, diag = (x.long() for x in (
        plan.off_pos, plan.off_col, plan.diag_pos))
    solve = forsolve_dense if plan.lower else backsolve_dense
    k = torch.full((1,), 0 if plan.lower else nb - 1, dtype=torch.long,
                   device=t.device)

    def step():
        contrib = torch.bmm(
            ext.index_select(0, off_pos.index_select(0, k)[0]),
            y.index_select(0, off_col.index_select(0, k)[0]))
        rhs = solve(ext.index_select(0, diag.index_select(0, k))[0],
                    y.index_select(0, k)[0] - contrib.sum(0))
        y.index_copy_(0, k, rhs[None])
        k.add_(1 if plan.lower else -1)

    with full_precision(ext.dtype):
        _repeat(step, nb, t.device)
    y = y[:nb]
    return y.reshape(t.n) if vec else y.reshape(t.n, kk)


def bsr_forsolve(L: BSR, b, plan: TriSolvePlan | None = None
                 ) -> torch.Tensor:
    """Solve ``L x = b`` reading only the strict lower part of ``L`` with
    an implicit unit diagonal (reference ``forsolve``,
    blocked_square_regular.fut:556-573).  ``b`` is (n,) or (n, k); pass
    ``plan=bsr_tri_plan(L, lower=True)`` to skip the host pass."""
    if plan is None:
        plan = bsr_tri_plan(L, lower=True)
    return _tri_sweep(L, b, plan)


def bsr_backsolve(U: BSR, yv, plan: TriSolvePlan | None = None
                  ) -> torch.Tensor:
    """Solve ``U x = y`` reading the upper part incl. diagonal (reference
    ``backsolve``, blocked_square_regular.fut:577-599).  A zero diagonal
    element yields inf/nan (the reference aborts,
    ERROR_backsolve_diagonal_element_is_zero, blocked:597); a missing
    diagonal block raises at plan-build time."""
    if plan is None:
        plan = bsr_tri_plan(U, lower=False)
    return _tri_sweep(U, yv, plan)


@dataclass(frozen=True)
class BSRFactorization:
    """Reusable pivoted block-sparse LU factorization: factor once with
    :func:`bsr_factorize`, then :meth:`solve` many right-hand sides (the
    two phases of ``ols``, blocked_square_regular.fut:601-603)."""

    lu: BSR
    p: torch.Tensor
    fplan: TriSolvePlan
    bplan: TriSolvePlan

    def solve(self, b) -> torch.Tensor:
        """Solve ``A x = b`` with the cached factors."""
        b = torch.as_tensor(b, device=self.lu.device)
        y = bsr_forsolve(self.lu, b[self.p.long()], self.fplan)
        return bsr_backsolve(self.lu, y, self.bplan)


def bsr_factorize(a: BSR) -> BSRFactorization:
    """Symbolic fill-in + pivoted numeric LU + triangular-solve plans, as a
    reusable carrier: ``bsr_factorize(a).solve(b) == bsr_ols(a, b)``."""
    LU, p = bsr_lup(a)
    return BSRFactorization(lu=LU, p=p, fplan=bsr_tri_plan(LU, lower=True),
                            bplan=bsr_tri_plan(LU, lower=False))


def bsr_ols(a: BSR, b) -> torch.Tensor:
    """Direct solve of ``A x = b`` via pivoted block-sparse LU (reference
    ``ols``, blocked_square_regular.fut:601-603).  ``b`` is (n,) or
    (n, k); use :func:`bsr_factorize` to factor once and solve many."""
    return bsr_factorize(a).solve(b)
