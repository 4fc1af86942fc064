"""SpGEMM: sparse x sparse matrix multiplication.

Port of ``sparse_tpu/ops/spgemm.py``.  Semantics follow the reference's
``smsmm : sr[n][m] -> sc[m][k] -> sr[n][k]`` (compressed.fut:268-331): exact
product with duplicate summation, stored zeros preserved (cancellation
produces explicit stored zeros, which ``nnz`` does not count).

Three cores, picked by :func:`spgemm` as the reference picks them:

* ESC (expand-sort-compress, row-wise Gustavson): expands only the actual
  multiply pairs, sorts them by output coordinate and sums duplicates;
* the dense accumulator (``method="mxu"``, the reference's name for its
  MXU route): both operands densified, two plain dense products (values and
  a stored-pattern count) in full float32, compacted by one cumsum;
* the block route: a CSR whose stored pattern is fully dense bsz x bsz
  blocks is re-blocked, multiplied as BSR through the slab apply (kernel K7,
  ``ops/cuda_bsr.py``) on a CUDA device, and turned back into a scalar CSR
  that keeps every stored block position.

:func:`spgemm_prepare` / :func:`spgemm_apply` split the symbolic pass (host
NumPy, once per pattern pair) from the numeric pass (two gathers, a
multiply and one pre-sorted segment sum).  Every sum is
:func:`~.segmented.segment_sum` (no float atomics): bitwise repeatable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.coo import COO, coo_transpose
from ..formats.csr import (
    CSC,
    CSR,
    _csc_as_csr_t,
    csr_compact,
    csr_empty,
    csr_from_coo,
    csr_to_coo,
)
from ..utils.precision import contract, full_precision
from .segmented import (
    INDEX_DTYPE,
    cumsum_exclusive,
    expand,
    row_ids_from_indptr,
    segment_sum,
)

__all__ = [
    "SpgemmPlan",
    "spgemm",
    "spgemm_apply",
    "spgemm_csr_csr",
    "spgemm_flops",
    "spgemm_mxu_csr_csr",
    "spgemm_mxu_nse",
    "spgemm_prepare",
    "spgemm_products",
]


def _csc_to_csr(b: CSC) -> CSR:
    """Re-compress a CSC by rows (one device sort of nse entries): its
    storage is the CSR of b^T, whose COO with axes swapped is b."""
    return csr_from_coo(coo_transpose(csr_to_coo(_csc_as_csr_t(b))))


def spgemm_flops(a: CSR, b_rows: CSR) -> torch.Tensor:
    """Number of scalar products in A @ B (the expansion size F, the
    symbolic pass that sizes the numeric one)."""
    return torch.sum(_expansion_sizes(a, b_rows))


def _expansion_sizes(a: CSR, b_rows: CSR) -> torch.Tensor:
    """Per-A-entry count of partner entries in the matching B row."""
    n, m = a.shape
    if a.nse == 0:
        return torch.zeros(0, dtype=torch.long, device=a.device)
    if m == 0:
        return torch.zeros(a.nse, dtype=torch.long, device=a.device)
    a_rows = row_ids_from_indptr(a.indptr, a.nse)
    valid = a_rows < n
    b_row_len = (b_rows.indptr[1:] - b_rows.indptr[:-1]).long()
    safe_s = torch.where(valid, a.indices.long(), torch.zeros_like(
        a.indices.long()))
    return torch.where(valid, b_row_len[safe_s], torch.zeros_like(safe_s))


def spgemm_products(a: CSR, b_data, b_indices, b_starts, b_lens, k: int,
                    expansion_nse: int) -> COO:
    """ESC product expansion against a generalised row-compressed B given
    as (data, indices, per-row starts, per-row lengths) — rows need only be
    internally contiguous.  Returns the raw product COO (duplicates
    unmerged) with capacity ``expansion_nse``."""
    n, m = a.shape
    dev = a.device
    out_dtype = torch.promote_types(a.dtype, b_data.dtype)
    a_rows = row_ids_from_indptr(a.indptr, a.nse).long()
    valid = a_rows < n
    idx = a.indices.long()
    safe_s = torch.where(valid, idx, torch.zeros_like(idx))
    if m == 0:
        sizes = torch.zeros_like(safe_s)
    else:
        lens = b_lens.long()[safe_s.clamp(max=m - 1)]
        sizes = torch.where(valid, lens, torch.zeros_like(lens))
    elem_ids, inner_ids = expand(sizes, expansion_nse)
    live = elem_ids.long() < a.nse
    e = torch.where(live, elem_ids.long(), torch.zeros_like(elem_ids.long()))
    r = a_rows[e]  # target row (may be the sentinel n for A padding)
    s = idx[e]
    va = a.data[e]
    nse_b = b_data.shape[0]
    b_pos = b_starts.long()[s.clamp(max=max(m - 1, 0))] + inner_ids.long()
    b_pos = b_pos.clamp(max=max(nse_b - 1, 0))
    c = b_indices.long()[b_pos]
    vb = b_data[b_pos]
    ok = live & (r < n)
    row = torch.where(ok, r, torch.full_like(r, n))
    col = torch.where(ok, c, torch.full_like(c, k))
    val = torch.where(ok, va.to(out_dtype) * vb.to(out_dtype),
                      torch.zeros((), dtype=out_dtype, device=dev))
    return COO(row=row.to(INDEX_DTYPE), col=col.to(INDEX_DTYPE), data=val,
               shape=(n, k))


# -- the dense-accumulator core ("mxu" in the reference) ----------------------
#
# At moderate dimensions the ESC core is dominated by the sort that merges
# duplicate (row, col) products.  Densify both operands (values AND a
# stored-entry indicator), do two dense products (value product + pattern
# count), then compact the count>0 mask straight into row-major CSR with one
# cumsum.  An output entry is stored iff some stored A entry meets a stored B
# entry (even when values cancel or are zero), as in the ESC core.

_MXU_DENSE_ELEMS = 64 * 1024 * 1024
"""Auto-dispatch budget: total dense elements (n*m + m*k + n*k) the dense
core may materialise (~768 MB at f32 across the three temporaries)."""


def _dense_flat(a: CSR):
    n, m = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse).long()
    return torch.where(rows < n, rows * m + a.indices.long(),
                       torch.full_like(rows, n * m))


def _dense_values(a: CSR) -> torch.Tensor:
    """Dense [n, m] values (duplicates summed, padding dropped)."""
    n, m = a.shape
    return segment_sum(a.data, _dense_flat(a), n * m).reshape(n, m)


def _dense_pattern(a: CSR) -> torch.Tensor:
    """Dense [n, m] stored-entry indicator (1.0 where at least one stored
    entry, including explicit zeros; 0.0 elsewhere)."""
    n, m = a.shape
    out = torch.zeros(n * m + 1, dtype=torch.float32, device=a.device)
    out[_dense_flat(a)] = 1.0  # every write stores the same value
    return out[:-1].reshape(n, m)


def _pattern_mask(a: CSR, b: CSR) -> torch.Tensor:
    """Boolean [n, k] mask of stored output entries of A @ B: the pattern
    product counts pairs exactly in full float32 (counts < 2**24)."""
    with full_precision(torch.float32):
        return torch.matmul(_dense_pattern(a), _dense_pattern(b)) > 0.5


def _csr_from_dense_mask(vals: torch.Tensor, mask: torch.Tensor,
                         cap: int) -> CSR:
    """Compact a dense value matrix + stored mask into CSR (capacity
    ``cap``) with a single cumsum — no sort.  If the true stored count
    exceeds ``cap`` the result is truncated in row-major order."""
    n, k = vals.shape
    dev = vals.device
    fm = mask.reshape(-1)
    pos = torch.cumsum(fm.long(), 0) - 1
    total = pos[-1] + 1
    flat_ids = torch.arange(n * k, dtype=torch.long, device=dev)
    tgt = torch.where(fm, pos.clamp(max=cap), torch.full_like(pos, cap))
    packed = torch.zeros(cap + 1, dtype=torch.long, device=dev)
    packed[tgt] = flat_ids  # slot `cap` collects the dropped entries
    packed = packed[:cap]
    live = torch.arange(cap, device=dev) < torch.clamp(total, max=cap)
    indices = torch.where(live, packed % k, torch.zeros_like(packed))
    data = torch.where(live, vals.reshape(-1)[packed],
                       torch.zeros((), dtype=vals.dtype, device=dev))
    indptr = cumsum_exclusive(mask.sum(1, dtype=torch.long)).clamp(max=cap)
    return CSR(data=data, indices=indices.to(INDEX_DTYPE),
               indptr=indptr.to(INDEX_DTYPE), shape=(n, k))


def spgemm_mxu_nse(a: CSR, b: CSR) -> torch.Tensor:
    """Stored-entry count of A @ B via the pattern product (the dense
    core's symbolic pass)."""
    n, m = a.shape
    _, k = b.shape
    if a.nse == 0 or b.nse == 0 or n == 0 or m == 0 or k == 0:
        return torch.zeros((), dtype=INDEX_DTYPE, device=a.device)
    return torch.sum(_pattern_mask(a, b)).to(INDEX_DTYPE)


def spgemm_mxu_csr_csr(a: CSR, b: CSR, out_nse: int) -> CSR:
    """Dense-accumulator SpGEMM core: C = A @ B, both row-compressed.

    ``out_nse`` is the result capacity (>= the true stored count, see
    :func:`spgemm_mxu_nse`; short capacities truncate row-major).  The dense
    value product touches unstored positions as 0.0, so non-finite stored
    values can reach entries the ESC core leaves alone; finite data agrees
    with ESC up to summation order."""
    n, m = a.shape
    m2, k = b.shape
    if m != m2:
        raise ValueError(f"spgemm: inner dims {a.shape} @ {b.shape}")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if out_nse == 0 or a.nse == 0 or b.nse == 0 or n == 0 or m == 0 or k == 0:
        return csr_empty(n, k, out_nse, out_dtype, device=a.device)
    av = _dense_values(a).to(out_dtype)
    bv = _dense_values(b).to(out_dtype)
    cv = contract("ij,jk->ik", av, bv)
    return _csr_from_dense_mask(cv.to(out_dtype), _pattern_mask(a, b),
                                out_nse)


def _mxu_eligible(a: CSR, b: CSR, budget: int = _MXU_DENSE_ELEMS) -> bool:
    n, m = a.shape
    _, k = b.shape
    dt = torch.promote_types(a.dtype, b.dtype)
    return ((dt.is_floating_point or dt.is_complex)
            and n * m + m * k + n * k <= budget
            and max(n * m, m * k, n * k) < 2**31)


# -- the block route ----------------------------------------------------------

_BLOCK_ROUTE_CANDIDATES = (32, 16, 8, 4, 2)
_BLOCK_ROUTE_MIN_NNZ = 4096
"""Below this stored-entry count the ESC core is already fast; the two
re-blocking passes + block product would only add latency."""

_SLAB_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def _spgemm_route(a: CSR, b_rows: CSR,
                  mxu_budget: int | None = None) -> tuple[str, int]:
    """Pick the SpGEMM core for ``method="auto"``: ``("mxu"|"block"|"esc",
    bsz)`` (bsz only meaningful for the block route), by the reference's
    rule: the dense core while its footprint fits; the block route when
    BOTH stored patterns are fully dense natural blocks
    (``csr_block_fill == 1.0``, so re-blocking is free and the block
    product's stored structure is exactly ``smsmm``'s); else ESC.  Block
    coordinates go to int64 past ``BSR_MAX_NB`` with no mode switch, so the
    reference's x64 condition has no counterpart."""
    n, m = a.shape
    _, k = b_rows.shape
    if _mxu_eligible(a, b_rows,
                     _MXU_DENSE_ELEMS if mxu_budget is None else mxu_budget):
        return "mxu", 0
    if n == m == k and n > 0:
        nnz_a = int(a.indptr[-1])
        nnz_b = int(b_rows.indptr[-1])
        if min(nnz_a, nnz_b) >= _BLOCK_ROUTE_MIN_NNZ:
            from ..utils.stats import csr_block_fill

            for bsz in _BLOCK_ROUTE_CANDIDATES:
                if n % bsz:
                    continue
                if (csr_block_fill(a, bsz) == 1.0
                        and csr_block_fill(b_rows, bsz) == 1.0):
                    return "block", bsz
    return "esc", 0


def _spgemm_block(a: CSR, b_rows: CSR, bsz: int, compact: bool,
                  use_slab: bool | None = None) -> CSR:
    """Block-routed SpGEMM: re-block both operands, multiply as BSR, return
    to scalar CSR keeping every stored block position (exact reference
    structure under the full-fill routing precondition).

    The numeric pass follows the reference's rule: bsz >= 8 with the slab
    backend (``use_slab``; default: the operands lie on a CUDA device, where
    the reference asks for a TPU backend) takes the slab apply (K7); bsz < 8,
    a pattern the slab planner refuses
    (one output with more products than a step cap allows), and integer
    dtypes (exact integer sums) take ``bsr_smsmm_apply``.  All of it is
    decided from the plan before any launch."""
    from ..formats.bsr import (
        bsr_smsmm_apply,
        bsr_smsmm_prepare,
        bsr_to_csr,
        csr_to_bsr,
    )

    ab = csr_to_bsr(a, bsz, compact=True)
    bb = csr_to_bsr(b_rows, bsz, compact=True)
    plan = bsr_smsmm_prepare(ab, bb)
    cb = None
    if use_slab is None:
        use_slab = a.device.type == "cuda"
    out_dtype = torch.promote_types(ab.dtype, bb.dtype)
    if bsz >= 8 and use_slab and out_dtype in _SLAB_DTYPES:
        from .cuda_bsr import bsr_smsmm_apply_slab, bsr_smsmm_slab_prepare

        try:
            pp = bsr_smsmm_slab_prepare(plan, ab.nbz, bb.nbz)
        except ValueError:
            pp = None  # one output's products exceed a step cap
        if pp is not None:
            cb = bsr_smsmm_apply_slab(pp, ab, bb)
    if cb is None:
        cb = bsr_smsmm_apply(plan, ab, bb)
    out = bsr_to_csr(cb)
    return csr_compact(out) if compact else out


def spgemm_csr_csr(a: CSR, b: CSR, expansion_nse: int) -> CSR:
    """ESC SpGEMM core: C = A @ B, both row-compressed.

    ``expansion_nse`` must be >= the true number of scalar products (see
    :func:`spgemm_flops`).  The result CSR has capacity ``expansion_nse``
    with unique (row, col) entries packed at the front."""
    n, m = a.shape
    m2, k = b.shape
    if m != m2:
        raise ValueError(f"spgemm: inner dims {a.shape} @ {b.shape}")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if expansion_nse == 0 or a.nse == 0 or b.nse == 0:
        return csr_empty(n, k, expansion_nse, out_dtype, device=a.device)
    prods = spgemm_products(a, b.data, b.indices, b.indptr[:-1],
                            b.indptr[1:] - b.indptr[:-1], k, expansion_nse)
    return csr_from_coo(prods)


# -- symbolic/numeric split ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Pattern-static SpGEMM schedule from :func:`spgemm_prepare`.

    ``a_pos``/``b_pos``: storage positions of each scalar product's factors
    (``b_pos`` indexes the *prepared* operand's storage — for a CSC operand
    the column-to-row permutation is already composed in); ``seg``: the
    output slot of each product, non-decreasing; ``indices``/``indptr``: the
    result's CSR structure (capacity = exact stored count, explicit zeros
    included, compressed.fut:162-164)."""

    a_pos: torch.Tensor
    b_pos: torch.Tensor
    seg: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple[int, int]

    @property
    def nse_out(self) -> int:
        return self.indices.shape[0]

    @property
    def n_products(self) -> int:
        return self.a_pos.shape[0]


def spgemm_prepare(a: CSR, b) -> SpgemmPlan:
    """Symbolic SpGEMM pass (host NumPy, once per pattern pair; the
    reference's pass to the letter).

    Accepts B as CSR or CSC (the reference's ``smsmm`` takes CSC,
    compressed.fut:268); the plan binds to the ORIGINAL storage order, so
    :func:`spgemm_apply` never re-sorts values.  The plan lives on ``a``'s
    device."""
    from ..native.plansort import argsort_u64, spgemm_schedule

    n, m = a.shape
    if isinstance(b, CSC):
        t = _csc_as_csr_t(b)  # CSR of b^T: storage order = b's storage order
        k = b.shape[1]
        bt_indptr = t.indptr.cpu().numpy().astype(np.int64)
        bt_indices = t.indices.cpu().numpy().astype(np.int64)
        nb_valid = int(bt_indptr[-1])
        # b^T entry (row=c, col=s) at position p  <->  b entry (s, c) at p
        b_rows_of = bt_indices[:nb_valid]  # B row (shared index s) per pos
        b_cols_of = np.repeat(np.arange(k, dtype=np.int64),
                              np.diff(bt_indptr))  # B col per pos
        perm = argsort_u64(b_rows_of)  # row-compress B (stable)
        src_pos = perm  # prepared order -> original storage position
        b_idx_rows = b_rows_of[perm]
        b_idx_cols = b_cols_of[perm]
    elif isinstance(b, CSR):
        if b.shape[0] != m:
            raise ValueError(f"spgemm: inner dims {a.shape} @ {b.shape}")
        k = b.shape[1]
        b_indptr = b.indptr.cpu().numpy().astype(np.int64)
        b_indices = b.indices.cpu().numpy()
        nb_valid = int(b_indptr[-1])
        src_pos = np.arange(nb_valid, dtype=np.int64)
        b_idx_rows = np.repeat(np.arange(m, dtype=np.int64),
                               np.diff(b_indptr))
        b_idx_cols = b_indices[:nb_valid].astype(np.int64)
    else:
        raise TypeError(
            f"spgemm_prepare: expected CSR/CSC operand, got {type(b)}")

    b_starts = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(b_idx_rows, minlength=m), out=b_starts[1:])
    b_lens = np.diff(b_starts)

    a_indptr = a.indptr.cpu().numpy().astype(np.int64)
    a_indices = a.indices.cpu().numpy()
    na_valid = int(a_indptr[-1])
    s = a_indices[:na_valid].astype(np.int64)
    sizes = b_lens[s] if m else np.zeros(na_valid, np.int64)
    F = int(sizes.sum())

    # native one-pass enumeration + radix sort + dedup (the NumPy branch is
    # result-identical)
    native = spgemm_schedule(a_indptr, s, b_starts, b_idx_cols, src_pos,
                             k, F) if F else None
    if native is not None:
        a_pos_o, b_pos_o, seg, out_rows, out_indices = native
    else:
        a_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(a_indptr))
        starts = np.cumsum(sizes) - sizes
        prod_a = np.repeat(np.arange(na_valid, dtype=np.int64), sizes)
        inner = np.arange(F, dtype=np.int64) - starts[prod_a]
        prod_b = b_starts[s[prod_a]] + inner

        row = a_rows[prod_a]
        col = b_idx_cols[prod_b]
        order = argsort_u64(row * (k + 1) + col)
        row_o, col_o = row[order], col[order]
        head = np.ones(F, bool)
        head[1:] = (row_o[1:] != row_o[:-1]) | (col_o[1:] != col_o[:-1])
        seg = np.cumsum(head) - 1
        out_indices = col_o[head] if F else np.zeros(0, np.int64)
        out_rows = row_o[head] if F else np.zeros(0, np.int64)
        a_pos_o = prod_a[order] if F else np.zeros(0, np.int64)
        b_pos_o = src_pos[prod_b[order]] if F else np.zeros(0, np.int64)
        if F == 0:
            seg = np.zeros(0, np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(out_rows, minlength=n), out=indptr[1:])
    dev = a.device

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            INDEX_DTYPE).to(dev)

    return SpgemmPlan(a_pos=put(a_pos_o), b_pos=put(b_pos_o), seg=put(seg),
                      indices=put(out_indices), indptr=put(indptr),
                      shape=(n, k))


def spgemm_apply(plan: SpgemmPlan, a: CSR, b) -> CSR:
    """Numeric SpGEMM pass: C = A @ B for the pattern pair captured in
    ``plan`` (values may have changed; structure must not).  Sort-free and
    deterministic; B must be the same format (CSR or CSC) it was prepared
    as — only its ``data`` is read."""
    out_dtype = torch.promote_types(a.dtype, b.data.dtype)
    if plan.n_products == 0:
        data = torch.zeros(plan.nse_out, dtype=out_dtype, device=a.device)
    else:
        prods = (a.data.to(out_dtype)[plan.a_pos.long()]
                 * b.data.to(out_dtype)[plan.b_pos.long()])
        data = segment_sum(prods, plan.seg, plan.nse_out,
                           indices_are_sorted=True)
    return CSR(data=data, indices=plan.indices, indptr=plan.indptr,
               shape=plan.shape)


def spgemm(a: CSR, b, *, expansion_nse: int | None = None,
           compact: bool = True, method: str = "auto",
           block_bsz: int | None = None) -> CSR:
    """C = A @ B for sparse A (CSR) and sparse B (CSC or CSR).

    Matches the reference's ``smsmm`` contract (CSR x CSC -> CSR,
    compressed.fut:268-331).  With ``expansion_nse=None`` the symbolic pass
    runs first (host sync) to size the numeric pass exactly; a given bound
    runs the ESC core with result capacity ``expansion_nse``.  ``compact``
    trims the result capacity to the exact stored-entry count.

    ``method``: ``"auto"`` (default) picks per :func:`_spgemm_route` — the
    dense-accumulator core while its dense footprint fits
    (``_MXU_DENSE_ELEMS``), the block route (``csr_to_bsr`` -> block
    product -> ``bsr_to_csr``; the slab kernel K7 on a CUDA device) when
    both stored patterns are fully dense natural blocks, else ESC.
    ``"mxu"`` / ``"esc"`` / ``"block"`` force a core (``"block"`` detects
    bsz, or pass ``block_bsz``; it needs square operands and, for the exact
    reference structure, full block fill).  Values agree across cores up to
    float summation order."""
    b_rows = _csc_to_csr(b) if isinstance(b, CSC) else b
    if not isinstance(b_rows, CSR):
        raise TypeError(f"spgemm: expected CSR/CSC operand, got {type(b)}")
    if method not in ("auto", "mxu", "esc", "block"):
        raise ValueError(f"spgemm: unknown method {method!r}")
    if expansion_nse is not None:
        return spgemm_csr_csr(a, b_rows, expansion_nse)
    if method == "auto":
        method, bsz = _spgemm_route(a, b_rows)
    elif method == "block":
        n, m = a.shape
        _, k = b_rows.shape
        if not (n == m == k):
            raise ValueError(
                f"spgemm(method='block'): operands must be square, got "
                f"{a.shape} @ {b_rows.shape}")
        if block_bsz is not None:
            bsz = block_bsz
        else:
            from ..utils.stats import detect_block_size

            bsz, _ = detect_block_size(a, _BLOCK_ROUTE_CANDIDATES)
            if bsz < 2:
                raise ValueError(
                    "spgemm(method='block'): no dense natural block size "
                    "detected; pass block_bsz= explicitly")
    if method == "block":
        return _spgemm_block(a, b_rows, bsz, compact)
    if method == "mxu":
        nse = int(spgemm_mxu_nse(a, b_rows))  # host sync (symbolic pass)
        return spgemm_mxu_csr_csr(a, b_rows, nse)
    f = int(spgemm_flops(a, b_rows))  # host sync (symbolic pass)
    out = spgemm_csr_csr(a, b_rows, f)
    return csr_compact(out) if compact else out
