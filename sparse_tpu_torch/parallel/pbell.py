"""Block-row partitioned blocked-ELL over a 1-D mesh.

Port of ``sparse_tpu/parallel/pbell.py``: the same communication structure
as ``pcsr`` (operand sharded over the mesh, one tiled ``all_gather``,
outputs row-sharded).  The per-shard product is a plain contraction of the
shard's blocks with the gathered operand panels, as in the reference (an
einsum there, not a Pallas kernel), in full float32 for float32 (no TF32;
``utils/precision.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import host_values
from ..formats.bell import BELL
from ..utils.precision import contract
from .mesh import Mesh
from .pcsr import _gathered, put_sharded

__all__ = [
    "PBELL",
    "pbell_from_bell",
    "pbell_shard_vector",
    "pbell_smvm",
    "pbell_spmm",
]


@dataclasses.dataclass(frozen=True)
class PBELL:
    """Block-row partitioned BELL: ``blocks``: [D, rows_p, Lb, bsz, bsz];
    ``cols``: [D, rows_p, Lb] global block-column ids.  Shard d owns block
    rows [d*rows_p, (d+1)*rows_p); padding rows hold zero blocks."""

    cols: torch.Tensor
    blocks: torch.Tensor
    n: int
    bsz: int
    axis: str
    rows_per_shard: int
    n_shards: int

    @property
    def Lb(self) -> int:
        return self.cols.shape[2]


def pbell_from_bell(a: BELL, mesh: Mesh, axis: str = "shards") -> PBELL:
    """Partition a BELL by contiguous block-row slabs (host pass)."""
    d = mesh.shape[axis]
    nb = a.nb
    rows_p = -(-max(nb, 1) // d)
    ac = a.cols.cpu().numpy()
    ab = host_values(a.blocks)
    cols = np.zeros((d, rows_p, a.Lb), np.int32)
    blocks = np.zeros((d, rows_p, a.Lb, a.bsz, a.bsz), ab.dtype)
    for i in range(d):
        lo, hi = min(i * rows_p, nb), min((i + 1) * rows_p, nb)
        cols[i, : hi - lo] = ac[lo:hi]
        blocks[i, : hi - lo] = ab[lo:hi]
    return PBELL(
        cols=put_sharded(cols, mesh, axis),
        blocks=put_sharded(blocks, mesh, axis, a.dtype),
        n=a.n,
        bsz=a.bsz,
        axis=axis,
        rows_per_shard=rows_p,
        n_shards=d,
    )


def pbell_shard_vector(v, a: PBELL, mesh: Mesh) -> torch.Tensor:
    """Pad a dense operand's leading axis to ``rows_p * D * bsz`` and shard
    it over the mesh (block-row padding, unlike ``shard_vector``'s
    scalar-row padding)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    total = a.rows_per_shard * a.n_shards * a.bsz
    pad = total - v.shape[0]
    if pad:
        v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
    return put_sharded(v, mesh, a.axis)


def _contract(blocks, panels, spec):
    dt = torch.promote_types(blocks.dtype, panels.dtype)
    return contract(spec, blocks.to(dt), panels.to(dt))


def pbell_smvm(a: PBELL, v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed blocked SpMV: ``v`` padded to ``rows_p*D*bsz`` and
    sharded (``pbell_shard_vector``); output row-sharded, same padding."""
    rows_p, Lb, bsz = a.rows_per_shard, a.Lb, a.bsz
    v2 = _gathered(v, mesh).reshape(-1, bsz)
    return torch.cat([
        _contract(a.blocks[i],
                  v2[a.cols[i].reshape(-1).long()].reshape(rows_p, Lb, bsz),
                  "rlij,rlj->ri").reshape(-1)
        for i in range(mesh.local)])


def pbell_spmm(a: PBELL, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed blocked SpMM; ``b`` row-sharded with the same padding."""
    rows_p, Lb, bsz = a.rows_per_shard, a.Lb, a.bsz
    k = b.shape[1]
    b3 = _gathered(b, mesh).reshape(-1, bsz, k)
    return torch.cat([
        _contract(a.blocks[i],
                  b3[a.cols[i].reshape(-1).long()].reshape(rows_p, Lb, bsz,
                                                            k),
                  "rlij,rljk->rik").reshape(-1, k)
        for i in range(mesh.local)])
