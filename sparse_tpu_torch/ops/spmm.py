"""SpMM: sparse x dense multiplication (CSR times tall-skinny dense).

Port of ``sparse_tpu/ops/spmm.py`` in plain PyTorch (the reference is plain
XLA): generalises the reference's ``smvm`` (compressed.fut:134-146) and
``dmsmm`` (mono.fut:161-162) to a dense matrix operand.  Row gather, scale,
and the port's deterministic :func:`~.segmented.segment_sum` — no float
atomics, so the result is bitwise repeatable on every device.
"""

from __future__ import annotations

import torch

from ..formats.csr import CSC, CSR, csc_transpose
from .segmented import row_ids_from_indptr, segment_sum

__all__ = ["spmm", "dsmm"]


def spmm(a: CSR, b) -> torch.Tensor:
    """C[n, k] = A[n, m] @ B[m, k] with A sparse CSR, B dense."""
    n, m = a.shape
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    if b.dim() != 2 or b.shape[0] != m:
        raise ValueError(
            f"spmm: dense operand shape {tuple(b.shape)} != ({m}, k)")
    k = b.shape[1]
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if a.nse == 0 or m == 0 or k == 0:
        return torch.zeros(n, k, dtype=out_dtype, device=a.device)
    rows = row_ids_from_indptr(a.indptr, a.nse)
    # padding entries have index 0 and value 0
    gathered = b.to(out_dtype)[a.indices.long()]
    prods = gathered * a.data.to(out_dtype)[:, None]
    return segment_sum(prods, rows, n, indices_are_sorted=True)


def dsmm(b, a: CSC) -> torch.Tensor:
    """C[k, m] = B[k, n] @ A[n, m] with B dense, A sparse CSC, through the
    transpose duality ``B @ A = (A^T @ B^T)^T`` (``A^T`` is the CSC's
    storage read as a CSR; reference ``vsmm``, compressed.fut:223-224)."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    n, _ = a.shape
    if b.dim() != 2 or b.shape[1] != n:
        raise ValueError(
            f"dsmm: dense operand shape {tuple(b.shape)} != (k, {n})")
    return spmm(csc_transpose(a), b.T).T
