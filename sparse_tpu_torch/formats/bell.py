"""BELL: blocked-ELL storage for block-sparse SpMV (the ``bell`` rung).

Port of ``sparse_tpu/formats/bell.py`` without SpMM: ``blocks[r, l]`` is the
l-th stored block of block row ``r`` (zero blocks pad short rows), with its
block-column id in ``cols[r, l]``.  SpMV streams the blocks and gathers
operand chunks at ``bsz`` granularity; it is plain PyTorch, as the reference
left it to XLA.  ``bell_spmm`` reaches the BELL kernels (K3-K5) and waits for
the SpMM slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.precision import full_precision
from .bsr import BSR

__all__ = ["BELL", "bell_from_bsr", "bell_from_csr", "bell_smvm"]


@dataclasses.dataclass(frozen=True)
class BELL:
    """Blocked-ELL matrix: ``blocks``: [nb, Lb, bsz, bsz]; ``cols``: [nb, Lb]
    block-column ids (0 for padding slots, whose blocks are all-zero)."""

    cols: torch.Tensor
    blocks: torch.Tensor
    n: int
    bsz: int

    @property
    def nb(self) -> int:
        return self.n // self.bsz

    @property
    def Lb(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device


def bell_from_bsr(a: BSR, Lb: int | None = None) -> BELL:
    """Lay a BSR out as blocked-ELL (host pass, once per pattern; the result
    lives on ``a``'s device)."""
    nb, bsz = a.nb, a.bsz
    idxs = a.indices.cpu().numpy().astype(np.int64)
    blocks = a.blocks.cpu().numpy()
    valid = idxs < nb * nb
    rs = idxs[valid] // max(nb, 1)
    cs = idxs[valid] % max(nb, 1)
    vals = blocks[valid]
    lens = np.bincount(rs, minlength=nb)
    if Lb is None:
        Lb = int(lens.max()) if lens.size else 0
    out_blocks = np.zeros((nb, Lb, bsz, bsz), blocks.dtype)
    out_cols = np.zeros((nb, Lb), np.int32)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    slot = np.arange(rs.size) - starts[rs]
    keep = slot < Lb
    out_blocks[rs[keep], slot[keep]] = vals[keep]
    out_cols[rs[keep], slot[keep]] = cs[keep]
    return BELL(cols=torch.from_numpy(out_cols).to(a.device),
                blocks=torch.from_numpy(out_blocks).to(a.device),
                n=a.n, bsz=bsz)


def bell_from_csr(a, bsz: int, Lb: int | None = None) -> BELL:
    """Re-block a CSR into blocked-ELL (explicit zeros fill touched
    blocks)."""
    from .bsr import bsr_compact, bsr_from_coo
    from .csr import csr_to_coo

    return bell_from_bsr(bsr_compact(bsr_from_coo(csr_to_coo(a), bsz)), Lb=Lb)


def bell_smvm(a: BELL, v) -> torch.Tensor:
    """Scatter-free SpMV: stream blocks, gather operand chunks, contract
    (full float32 for float32 operands, ``utils.precision``)."""
    v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (a.n,):
        raise ValueError(
            f"bell_smvm: vector shape {tuple(v.shape)} != ({a.n},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if a.n == 0 or a.Lb == 0:
        return torch.zeros(a.n, dtype=out_dtype, device=a.device)
    vb = v.to(out_dtype).reshape(a.nb, a.bsz)[a.cols.reshape(-1).long()] \
        .reshape(a.nb, a.Lb, a.bsz)
    with full_precision(out_dtype):
        out = torch.einsum("rlij,rlj->ri", a.blocks.to(out_dtype), vb)
    return out.reshape(a.n)
