"""Bandwidth-reducing reordering (reverse Cuthill-McKee) and CSR permutation.

Port of ``sparse_tpu/ops/reorder.py``.  The segment-tile SpMV kernels win
when each row block's columns land in a narrow window; RCM recovers that
locality for matrices whose stored order hides it.  The symbolic pass
(:func:`rcm_order`, :func:`permute_prepare`) runs once per pattern on the
host (native C++ core, NumPy fallback pinned bit-identical by tests); the
numeric pass (:func:`permute_apply`) is one gather on the matrix's device.

Usage (symmetric reorder around SpMV)::

    perm = rcm_order(a)                      # host, once per pattern
    plan = permute_prepare(a, perm, perm)    # host, once per pattern
    ap = permute_apply(plan, a)              # A' = P A P^T
    yp = ap @ x[perm]
    y = unpermute_vector(yp, perm)           # y == a @ x
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csr import CSR
from ..native import plansort
from .segmented import INDEX_DTYPE

__all__ = [
    "rcm_order",
    "rcm_order_blocked",
    "block_perm_pair",
    "csr_bandwidth",
    "PermutePlan",
    "permute_prepare",
    "permute_apply",
    "csr_permute",
    "permute_vector",
    "unpermute_vector",
    "reorder_for_locality",
]


def _host_structure(a: CSR):
    """(indptr, valid column ids) as host int64 arrays."""
    indptr = a.indptr.cpu().numpy().astype(np.int64)
    k = int(indptr[-1])
    return indptr, a.indices[:k].cpu().numpy().astype(np.int64)


# -- RCM ordering ----------------------------------------------------------------


def rcm_order(a: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a square CSR's symmetrized pattern:
    a host int64 ``perm`` with ``perm[k]`` = old index at new position k
    (SciPy's convention; ``A[perm][:, perm]`` is near-banded)."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"rcm_order: matrix must be square, got {a.shape}")
    if n == 0:
        return np.zeros(0, np.int64)
    indptr, cols = _host_structure(a)
    perm = plansort.rcm_order(indptr, cols)
    if perm is None:
        perm = _rcm_numpy(indptr, cols, n)
    return perm


def _rcm_numpy(indptr: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Pure-NumPy RCM, the native core's semantic pin: symmetrize + dedup,
    BFS per component from the first unvisited minimum-degree node, frontier
    neighbours appended in ascending (degree, node id) order, whole order
    reversed."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    off = rows != cols
    r, c = rows[off], cols[off]
    keys = np.unique(np.concatenate([r * n + c, c * n + r]) if r.size else r)
    adj_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount((keys // n).astype(np.int64), minlength=n),
              out=adj_ptr[1:])
    adj = (keys % n).astype(np.int64)
    deg = np.diff(adj_ptr)

    visited = np.zeros(n, bool)
    perm = np.empty(n, np.int64)
    head = tail = 0
    while tail < n:
        cand = np.flatnonzero(~visited)
        seed = cand[np.argmin(deg[cand])]
        visited[seed] = True
        perm[tail] = seed
        tail += 1
        while head < tail:
            u = perm[head]
            head += 1
            nb = adj[adj_ptr[u]:adj_ptr[u + 1]]
            nb = nb[~visited[nb]]
            if nb.size:
                nb = nb[np.argsort(deg[nb], kind="stable")]
                visited[nb] = True
                perm[tail:tail + nb.size] = nb
                tail += nb.size
    return perm[::-1].copy()


def rcm_order_blocked(a: CSR, bsz: int) -> np.ndarray:
    """RCM on the BLOCK graph of a square CSR with natural ``bsz x bsz``
    blocks, expanded to a scalar permutation that keeps each block's rows
    adjacent and in order (scalar RCM would interleave dof pairs and destroy
    the blocks the block-granule kernel needs)."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"rcm_order_blocked: square required, got {a.shape}")
    if bsz <= 0 or n % bsz:
        raise ValueError(f"rcm_order_blocked: bsz {bsz} must divide n {n}")
    indptr, cols = _host_structure(a)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    nb = n // bsz
    key = np.unique((rows // bsz) * nb + (cols // bsz))
    bptr = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount((key // nb).astype(np.int64), minlength=nb),
              out=bptr[1:])
    bcols = (key % nb).astype(np.int64)
    pb = plansort.rcm_order(bptr, bcols)
    if pb is None:
        pb = _rcm_numpy(bptr, bcols, nb)
    return (pb[:, None] * bsz + np.arange(bsz, dtype=np.int64)).reshape(-1)


def block_perm_pair(perm: np.ndarray, bsz: int = 2):
    """Forward/inverse BLOCK permutations from a block-preserving scalar
    permutation: ``perm_b[k]`` = old block at new position k, ``inv_b`` its
    inverse (both ends of a block-granule permute are gathers)."""
    perm = np.asarray(perm, np.int64)
    pb = (perm // bsz)[::bsz]
    inv = np.empty(pb.size, np.int64)
    inv[pb] = np.arange(pb.size)
    return pb, inv


def csr_bandwidth(a: CSR) -> int:
    """Maximum ``|i - j|`` over stored entries (host; 0 when empty)."""
    n, _ = a.shape
    indptr, cols = _host_structure(a)
    if cols.size == 0:
        return 0
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return int(np.abs(rows - cols).max())


# -- CSR permutation -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PermutePlan:
    """Pattern-bound CSR permutation plan (from :func:`permute_prepare`).

    ``indptr``/``indices``: the permuted matrix's structure; ``src``: for
    each new storage position, the old storage position whose value lands
    there (identity on the padding tail)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    src: torch.Tensor
    shape: tuple[int, int]
    capacity: int


def _is_permutation(p: np.ndarray, n: int) -> bool:
    if n == 0:
        return True
    if p.min() < 0 or p.max() >= n:
        return False
    return bool(np.bincount(p, minlength=n).max() == 1)


def permute_prepare(a: CSR, rperm, cperm=None) -> PermutePlan:
    """Host symbolic pass: plan ``A[rperm][:, cperm]`` for a fixed pattern
    (``perm[k]`` = old index at new position k; ``cperm=None`` keeps
    columns).  The plan lives on ``a``'s device."""
    n, m = a.shape
    rperm = np.asarray(rperm, np.int64)
    if rperm.shape != (n,) or not _is_permutation(rperm, n):
        raise ValueError("permute_prepare: rperm is not a permutation of rows")
    if cperm is None:
        inv_c = np.arange(m, dtype=np.int64)
    else:
        cperm = np.asarray(cperm, np.int64)
        if cperm.shape != (m,) or not _is_permutation(cperm, m):
            raise ValueError(
                "permute_prepare: cperm is not a permutation of columns")
        inv_c = np.empty(m, np.int64)
        inv_c[cperm] = np.arange(m, dtype=np.int64)

    indptr, cols = _host_structure(a)
    k = cols.size
    cap = a.nse
    counts = np.diff(indptr)
    new_counts = counts[rperm]
    new_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(new_counts, out=new_indptr[1:])
    starts_old = indptr[rperm]
    row_of = np.repeat(np.arange(n, dtype=np.int64), new_counts)
    src = (np.arange(k, dtype=np.int64)
           - np.repeat(new_indptr[:-1], new_counts)
           + np.repeat(starts_old, new_counts))
    new_cols = inv_c[cols[src]]
    order = plansort.argsort_u64(row_of * (m + 1) + new_cols)
    src = src[order]
    new_cols = new_cols[order]

    src_full = np.concatenate([src, np.arange(k, cap, dtype=np.int64)])
    ind_full = np.concatenate([new_cols, np.zeros(cap - k, np.int64)])
    dev = a.device
    return PermutePlan(
        indptr=torch.from_numpy(new_indptr).to(INDEX_DTYPE).to(dev),
        indices=torch.from_numpy(ind_full).to(INDEX_DTYPE).to(dev),
        src=torch.from_numpy(src_full).to(dev),
        shape=(n, m),
        capacity=cap,
    )


def permute_apply(plan: PermutePlan, a: CSR) -> CSR:
    """Numeric pass: the permuted CSR from a plan + current values (one
    gather); ``a`` must carry the plan's pattern (shape/capacity
    enforced)."""
    if a.shape != plan.shape or a.nse != plan.capacity:
        raise ValueError(
            f"permute_apply: matrix {a.shape}/nse={a.nse} does not match "
            f"plan {plan.shape}/nse={plan.capacity}")
    return CSR(data=a.data[plan.src], indices=plan.indices,
               indptr=plan.indptr, shape=plan.shape)


def csr_permute(a: CSR, rperm, cperm=None) -> CSR:
    """``A[rperm][:, cperm]`` in one shot (prepare + apply)."""
    return permute_apply(permute_prepare(a, rperm, cperm), a)


def _perm_tensor(perm, device) -> torch.Tensor:
    if isinstance(perm, torch.Tensor):
        return perm.to(device=device, dtype=torch.long)
    return torch.from_numpy(np.asarray(perm, np.int64)).to(device)


def permute_vector(v, perm) -> torch.Tensor:
    """``(P v)[k] = v[perm[k]]``."""
    v = torch.as_tensor(v)
    return v[_perm_tensor(perm, v.device)]


def unpermute_vector(v, perm) -> torch.Tensor:
    """Inverse of :func:`permute_vector` (a scatter of unique positions)."""
    v = torch.as_tensor(v)
    out = torch.zeros_like(v)
    out[_perm_tensor(perm, v.device)] = v
    return out


def reorder_for_locality(a: CSR) -> tuple[CSR, np.ndarray]:
    """Symmetric RCM reorder: ``(P A P^T, perm)``."""
    perm = rcm_order(a)
    return csr_permute(a, perm, perm), perm
