"""Preconditioners for the iterative solvers.

Port of ``sparse_tpu/solve/precond.py``.  Block-Jacobi: setup is one
scatter into batched dense diagonal blocks plus one batched inverse, and
the application is one batched (bs, bs) matvec.  ILU(0) reuses the BSR LU
stack: incomplete LU on the existing block pattern, applied as one forward
and one backward block-triangular sweep.
"""

from __future__ import annotations

import torch

from ..formats.csr import CSR
from ..ops.segmented import row_ids_from_indptr, segment_sum
from ..utils.precision import full_precision

__all__ = ["block_jacobi_prepare", "block_jacobi_apply",
           "bsr_ilu0_preconditioner"]


def block_jacobi_prepare(a: CSR, bs: int, padded_n: int | None = None
                         ) -> torch.Tensor:
    """Inverses of the ``bs x bs`` diagonal blocks of a square CSR.

    Returns ``(padded_n // bs, bs, bs)`` with ``padded_n`` rounded up to a
    multiple of ``bs`` (default: the matrix size).  Blocks beyond ``n`` and
    zero diagonal entries are patched to identity, so padding slots pass
    through unchanged.  A block that is singular after the patch inverts to
    inf/nan entries, as ``jnp.linalg.inv`` gives in the reference
    (``torch.linalg.inv_ex``, which does not raise)."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"block_jacobi_prepare: square matrix required, "
                         f"got {a.shape}")
    L = padded_n if padded_n is not None else n
    L = -(-max(L, 1) // bs) * bs
    if L < n:
        raise ValueError(f"block_jacobi_prepare: padded_n {L} < n {n}")
    nbk = L // bs
    rows = row_ids_from_indptr(a.indptr, a.nse).long()
    cols = a.indices.long()
    in_diag = (rows < n) & (rows // bs == cols // bs)
    flat = torch.where(in_diag,
                       (rows // bs) * (bs * bs) + (rows % bs) * bs + cols % bs,
                       torch.full_like(rows, nbk * bs * bs))
    blocks = segment_sum(a.data, flat, nbk * bs * bs).reshape(nbk, bs, bs)
    # patch zero diagonal entries (incl. all-padding blocks) to 1
    d = torch.diagonal(blocks, dim1=1, dim2=2)
    eye = torch.eye(bs, dtype=a.dtype, device=a.device)
    blocks = blocks + eye[None] * (d == 0)[:, :, None]
    with full_precision(blocks.dtype):
        return torch.linalg.inv_ex(blocks).inverse


def block_jacobi_apply(inv_blocks: torch.Tensor, v) -> torch.Tensor:
    """``z = diag(B_i^{-1}) v``; ``v`` has length ``nbk * bs`` (the padded
    length the blocks were prepared for)."""
    nbk, bs, _ = inv_blocks.shape
    v = torch.as_tensor(v, device=inv_blocks.device)
    if tuple(v.shape) != (nbk * bs,):
        raise ValueError(f"block_jacobi_apply: vector shape "
                         f"{tuple(v.shape)} != ({nbk * bs},)")
    with full_precision(inv_blocks.dtype):
        return torch.bmm(inv_blocks, v.reshape(nbk, bs, 1)).reshape(-1)


def bsr_ilu0_preconditioner(a, padded_n: int | None = None):
    """Block ILU(0) from the BSR LU stack: incomplete LU on the EXISTING
    block pattern (no fill, no pivoting: reference ``lu_nofill``,
    blocked_square_regular.fut:502-546), applied as one forward + one
    backward block-triangular sweep.

    Returns a callable ``M(v)``; ``padded_n`` (>= n) is the solver's padded
    vector length (pad slots come back as zeros).  The sweeps run block row
    by block row, so this is the strong but serial end of the
    preconditioner ladder.  ILU(0) of a non-SPD matrix is not symmetric."""
    from .bsr_lu import _tri_sweep, bsr_lu_nofill, bsr_tri_plan

    LU = bsr_lu_nofill(a)
    fplan = bsr_tri_plan(LU, lower=True)
    bplan = bsr_tri_plan(LU, lower=False)
    n = a.n
    L = padded_n if padded_n is not None else n
    if L < n:
        raise ValueError(f"bsr_ilu0_preconditioner: padded_n {L} < n {n}")

    def apply(v):
        if tuple(v.shape) != (L,):
            raise ValueError(f"bsr_ilu0_preconditioner: vector shape "
                             f"{tuple(v.shape)} != ({L},)")
        z = _tri_sweep(LU, _tri_sweep(LU, v[:n], fplan), bplan)
        if L == n:
            return z
        return torch.cat([z, z.new_zeros(L - n)])

    return apply
