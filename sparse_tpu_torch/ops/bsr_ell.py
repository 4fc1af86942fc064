"""Blocked-ELL paths for BSR SpMV / SpMM, without building a BELL.

Port of ``sparse_tpu/ops/bsr_ell.py`` in plain PyTorch (the reference is
plain XLA): each block row's stored blocks are viewed as a dense ``(nb,
Lb)`` window of the sorted BSR tensors, so the product is operand-chunk
gather -> batched block contraction (full float32, ``utils.precision``),
with no scatter.  Semantics match ``bsr_smvm`` (reference smvm,
blocked_square_regular.fut:307-331).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.bsr import BSR
from ..utils.precision import contract

__all__ = ["bsr_row_capacity", "bsr_smvm_ell", "bsr_spmm_ell"]


def bsr_row_capacity(a: BSR) -> int:
    """Max stored blocks in any block row (host sync): the static ELL
    width."""
    idxs = a.indices.cpu().numpy().astype(np.int64)
    nb = a.nb
    valid = idxs < nb * nb
    if not valid.any():
        return 0
    return int(np.bincount(idxs[valid] // nb, minlength=nb).max())


def _block_windows(a: BSR, Lb: int):
    """Dense (nb, Lb) windows over the sorted block tensors:
    ``(blocks (nb, Lb, bsz, bsz), cols (nb, Lb))``, masked slots zero."""
    nb, bsz = a.nb, a.bsz
    idx = a.indices.long()
    bounds = torch.arange(nb + 1, dtype=torch.long, device=idx.device) * nb
    row_ptr = torch.searchsorted(idx, bounds)
    starts = row_ptr[:-1]
    lens = row_ptr[1:] - starts
    offs = torch.arange(Lb, dtype=torch.long, device=idx.device)
    mask = offs[None, :] < lens[:, None]
    flat = (starts[:, None] + offs[None, :]).clamp(max=max(a.nbz - 1, 0))
    flat = flat.reshape(-1)
    cols = torch.where(mask, idx[flat].reshape(nb, Lb) % nb,
                       torch.zeros_like(mask, dtype=torch.long))
    blocks = a.blocks[flat].reshape(nb, Lb, bsz, bsz)
    blocks = torch.where(mask[:, :, None, None], blocks,
                         blocks.new_zeros(()))
    return blocks, cols


def bsr_smvm_ell(a: BSR, v, Lb: int) -> torch.Tensor:
    """Scatter-free BSR SpMV.  ``Lb`` bounds the fullest block row (see
    :func:`bsr_row_capacity`)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (a.n,):
        raise ValueError(
            f"bsr_smvm_ell: vector shape {tuple(v.shape)} != ({a.n},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if a.nbz == 0 or a.n == 0 or Lb == 0:
        return torch.zeros(a.n, dtype=out_dtype, device=a.device)
    blocks, cols = _block_windows(a, Lb)
    vb = v.to(out_dtype).reshape(a.nb, a.bsz)[cols.reshape(-1)].reshape(
        a.nb, Lb, a.bsz)
    return contract("rlij,rlj->ri", blocks.to(out_dtype), vb).reshape(a.n)


def bsr_spmm_ell(a: BSR, b, Lb: int) -> torch.Tensor:
    """Scatter-free BSR SpMM (BSR x dense (n, k)): block-panel gathers feed
    one batched (bsz x bsz) @ (bsz x k) contraction."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    if b.dim() != 2 or b.shape[0] != a.n:
        raise ValueError(
            f"bsr_spmm_ell: operand shape {tuple(b.shape)} != ({a.n}, k)")
    k = b.shape[1]
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if a.nbz == 0 or a.n == 0 or Lb == 0 or k == 0:
        return torch.zeros(a.n, k, dtype=out_dtype, device=a.device)
    blocks, cols = _block_windows(a, Lb)
    panels = b.to(out_dtype).reshape(a.nb, a.bsz, k)[cols.reshape(-1)] \
        .reshape(a.nb, Lb, a.bsz, k)
    return contract("rlij,rljk->rik", blocks.to(out_dtype),
                    panels).reshape(a.n, k)
