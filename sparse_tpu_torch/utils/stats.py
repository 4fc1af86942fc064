"""Structure statistics used by the SpMV dispatch ladder.

Port of the block-structure half of ``sparse_tpu/utils/stats.py``
(``csr_block_fill``, ``detect_block_size``).  The roofline model and the
TPU's measured streaming ceiling are not ported yet (ROADMAP Queue 1,
item 11): the H100's own ceiling has to be measured first.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CSR

__all__ = ["csr_block_fill", "detect_block_size"]


def csr_block_fill(a: CSR, bsz: int) -> float:
    """Stored-entry density of the bsz x bsz blocks a CSR pattern touches
    (host-side): nnz / (touched_blocks * bsz^2).  1.0 means every touched
    block is fully stored, so re-blocking at this bsz is free and exact.
    Explicit zeros count as stored (compressed.fut:162-164's storage
    notion)."""
    n, m = a.shape
    if bsz <= 0 or n % bsz or m % bsz:
        return 0.0
    indptr = a.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    if nnz == 0:
        return 0.0
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = a.indices[:nnz].cpu().numpy().astype(np.int64)
    nbc = m // bsz
    key = (rows // bsz) * nbc + (cols // bsz)
    from ..native.plansort import argsort_u64

    ks = key[argsort_u64(key.astype(np.uint64))]
    blocks = 1 + int(np.count_nonzero(ks[1:] != ks[:-1]))
    return nnz / (blocks * bsz * bsz)


def detect_block_size(a: CSR, candidates=(8, 4, 2),
                      min_fill: float = 1.0) -> tuple[int, float]:
    """Largest candidate block size whose block fill reaches ``min_fill``,
    as ``(bsz, fill)``; ``(1, 1.0)`` when none qualifies."""
    for bsz in sorted(set(candidates), reverse=True):
        if bsz < 2:
            continue
        f = csr_block_fill(a, bsz)
        if f >= min_fill:
            return bsz, f
    return 1, 1.0
