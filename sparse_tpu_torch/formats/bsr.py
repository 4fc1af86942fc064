"""BSR: blocked square regular sparse matrices (structure and conversions).

Port of the structural half of ``sparse_tpu/formats/bsr.py`` (reference
``blocked_square_regular``, blocked_square_regular.fut:156-639): an
``n x n`` matrix stored as a sparse set of dense ``bsz x bsz`` blocks.

* ``indices``: [nbz] flattened block coordinates ``r * nb + c``
  (``nb = n / bsz``), sorted ascending; padding slots carry the sentinel
  ``nb * nb``.  int32 while ``nb <= BSR_MAX_NB``, int64 beyond ("wide") —
  the port always has int64, so wide matrices need no mode switch (the
  reference requires jax x64 for them, which is how its tests run);
* ``blocks``: [nbz, bsz, bsz] values; padding blocks are all-zero.

The BSR algebra, SpGEMM and the LU solver are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.segmented import INDEX_DTYPE
from .coo import COO, coo_normalize

__all__ = [
    "BSR",
    "BSR_MAX_NB",
    "bsr_todense",
    "bsr_to_coo",
    "bsr_to_csr",
    "bsr_from_coo",
    "csr_to_bsr",
    "bsr_compact",
]


@dataclasses.dataclass(frozen=True)
class BSR:
    """Blocked square sparse matrix with static block capacity.

    Invariants: ``indices`` sorted ascending; valid entries are unique
    flattened block coords in ``[0, nb*nb)``; padding entries carry the
    sentinel ``nb*nb`` and all-zero blocks."""

    indices: torch.Tensor
    blocks: torch.Tensor
    n: int
    bsz: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nb(self) -> int:
        return self.n // self.bsz

    @property
    def nbz(self) -> int:
        return self.indices.shape[0]

    @property
    def sentinel(self) -> int:
        return self.nb * self.nb

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device


BSR_MAX_NB = 46340
"""Largest blocks-per-dimension whose flattened coordinates r*nb+c fit
int32; beyond it block coordinates are int64."""


def _bidx_dtype(nb: int) -> torch.dtype:
    return INDEX_DTYPE if nb <= BSR_MAX_NB else torch.int64


def _check_divides(n: int, bsz: int) -> None:
    # mirrors ERROR_block_size_must_divide_n (blocked_square_regular.fut:175)
    if bsz <= 0 or n % bsz != 0:
        raise ValueError(f"block size {bsz} must divide n={n}")


def _rc(a: BSR):
    """(valid, block_row, block_col) as int64, padding row=nb, col=0."""
    nb = a.nb
    idx = a.indices.long()
    valid = idx < a.sentinel
    r = torch.where(valid, idx // max(nb, 1), torch.full_like(idx, nb))
    c = torch.where(valid, idx % max(nb, 1), torch.zeros_like(idx))
    return valid, r, c


def bsr_todense(a: BSR) -> torch.Tensor:
    """Dense conversion (reference ``dense``, blocked_square_regular.fut:
    212-224)."""
    nb, bsz = a.nb, a.bsz
    dense = torch.zeros((nb * nb, bsz, bsz), dtype=a.dtype, device=a.device)
    idx = a.indices.long()
    valid = idx < a.sentinel
    dense[idx[valid]] = a.blocks[valid]  # valid coordinates are unique
    return (dense.reshape(nb, nb, bsz, bsz).permute(0, 2, 1, 3)
            .reshape(a.n, a.n))


def _scalar_coords(a: BSR):
    """Per-stored-element scalar (rows, cols) with the valid-block mask,
    each of shape (nbz, bsz, bsz)."""
    bsz = a.bsz
    valid, r, c = _rc(a)
    i = torch.arange(bsz, device=a.device)
    rows = r[:, None, None] * bsz + i[None, :, None]
    cols = c[:, None, None] * bsz + i[None, None, :]
    shape = a.blocks.shape
    return (valid[:, None, None].expand(shape), rows.expand(shape),
            cols.expand(shape))


def bsr_to_coo(a: BSR) -> COO:
    """Scalar COO of the stored elements; zero values inside blocks become
    padding, as in the reference's filtering ``coo``
    (blocked_square_regular.fut:605-614).  Capacity = nbz * bsz^2."""
    n = a.n
    valid, rows, cols = _scalar_coords(a)
    keep = valid & (a.blocks != 0)
    return coo_normalize(COO(
        row=torch.where(keep, rows, torch.full_like(rows, n)).reshape(-1)
        .to(INDEX_DTYPE),
        col=torch.where(keep, cols, torch.full_like(cols, n)).reshape(-1)
        .to(INDEX_DTYPE),
        data=torch.where(keep, a.blocks, torch.zeros_like(a.blocks))
        .reshape(-1),
        shape=(n, n)))


def bsr_to_csr(a: BSR):
    """Scalar CSR storing EVERY position of every stored block (explicit
    zeros inside blocks stay stored).  Capacity = nbz * bsz^2."""
    from .csr import csr_from_coo

    n = a.n
    valid, rows, cols = _scalar_coords(a)
    return csr_from_coo(COO(
        row=torch.where(valid, rows, torch.full_like(rows, n)).reshape(-1)
        .to(INDEX_DTYPE),
        col=torch.where(valid, cols, torch.full_like(cols, n)).reshape(-1)
        .to(INDEX_DTYPE),
        data=torch.where(valid, a.blocks, torch.zeros_like(a.blocks))
        .reshape(-1),
        shape=(n, n)))


def bsr_from_coo(a: COO, bsz: int, nbz: int | None = None) -> BSR:
    """Assemble blocks from scalar COO triples (reference ``from_coo``,
    blocked_square_regular.fut:616-637); capacity ``nbz`` defaults to one
    block per COO slot.  Runs on the COO's device."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"BSR matrices are square; got {a.shape}")
    _check_divides(n, bsz)
    nb = n // bsz
    sentinel = nb * nb
    a = coo_normalize(a)
    if nbz is None:
        nbz = a.nse
    dev = a.device
    row, col = a.row.long(), a.col.long()
    valid = row < n
    h = torch.where(valid, (row // bsz) * nb + col // bsz,
                    torch.full_like(row, sentinel))
    h, order = torch.sort(h, stable=True)
    row_l = torch.where(valid, row % bsz, torch.zeros_like(row))[order]
    col_l = torch.where(valid, col % bsz, torch.zeros_like(col))[order]
    data = a.data[order]
    live = h < sentinel
    is_head = torch.ones_like(live)
    is_head[1:] = h[1:] != h[:-1]
    is_head &= live
    group = torch.cumsum(is_head.long(), 0) - 1
    keep = live & (group < nbz)
    blocks = torch.zeros((nbz, bsz, bsz), dtype=a.dtype, device=dev)
    # normalized entries are unique, so every (block, i, j) target is too
    blocks[group[keep], row_l[keep], col_l[keep]] = data[keep]
    idxs = torch.full((nbz,), sentinel, dtype=torch.long, device=dev)
    heads = is_head & (group < nbz)
    idxs[group[heads]] = h[heads]
    return BSR(indices=idxs.to(_bidx_dtype(nb)), blocks=blocks, n=n, bsz=bsz)


def csr_to_bsr(a, bsz: int, nbz: int | None = None,
               compact: bool = True) -> BSR:
    """Re-block a scalar CSR into bsz x bsz BSR storage.  With ``nbz=None``
    the assembly runs on the host (one argsort) and uploads to ``a``'s
    device; with ``compact=False`` the result keeps one block slot per
    scalar slot of ``a``.  With ``nbz`` given it runs on the device through
    :func:`bsr_from_coo`."""
    if nbz is None:
        out = _csr_to_bsr_host(a, bsz)
        if not compact:
            pad = a.nse - out.nbz
            if pad > 0:
                out = BSR(
                    indices=torch.cat([out.indices, torch.full(
                        (pad,), out.sentinel, dtype=out.indices.dtype,
                        device=out.device)]),
                    blocks=torch.cat([out.blocks, torch.zeros(
                        (pad, bsz, bsz), dtype=out.dtype,
                        device=out.device)]),
                    n=out.n, bsz=bsz)
        return out
    from .csr import csr_to_coo

    out = bsr_from_coo(csr_to_coo(a), bsz, nbz=nbz)
    return bsr_compact(out) if compact else out


def _csr_to_bsr_host(a, bsz: int) -> BSR:
    """Host-side re-blocking (NumPy): CSR entries are unique and
    (row, col)-sorted, so blocks group by a stable argsort of the flattened
    block id."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"BSR matrices are square; got {a.shape}")
    _check_divides(n, bsz)
    nb = n // bsz
    dev = a.device
    indptr = a.indptr.cpu().numpy().astype(np.int64)
    k = int(indptr[-1]) if indptr.size else 0
    if k == 0:
        return BSR(indices=torch.zeros(0, dtype=_bidx_dtype(nb), device=dev),
                   blocks=torch.zeros((0, bsz, bsz), dtype=a.dtype,
                                      device=dev), n=n, bsz=bsz)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))[:k]
    cols = a.indices[:k].cpu().numpy().astype(np.int64)
    data = a.data[:k].cpu().numpy()
    h = (rows // bsz) * nb + cols // bsz
    from ..native.plansort import argsort_u64

    order = argsort_u64(h.astype(np.uint64))
    h_s = h[order]
    heads = np.ones(k, bool)
    heads[1:] = h_s[1:] != h_s[:-1]
    group = np.cumsum(heads) - 1
    blocks = np.zeros((int(group[-1]) + 1, bsz, bsz), data.dtype)
    blocks[group, rows[order] % bsz, cols[order] % bsz] = data[order]
    return BSR(indices=torch.from_numpy(h_s[heads]).to(_bidx_dtype(nb))
               .to(dev),
               blocks=torch.from_numpy(blocks).to(dev), n=n, bsz=bsz)


def bsr_compact(a: BSR) -> BSR:
    """Trim capacity to the exact valid block count (host sync)."""
    k = int(torch.sum(a.indices.long() < a.sentinel))
    return BSR(indices=a.indices[:k], blocks=a.blocks[:k], n=a.n, bsz=a.bsz)
