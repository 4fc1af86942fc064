"""Row-partitioned CSR over a 1-D mesh: the distributed layer's baseline.

Port of ``sparse_tpu/parallel/pcsr.py``.  ``PCSR`` holds one local CSR
slab per shard, stacked on a leading shard axis (``data``/``indices``:
``[D, nse_p]``; ``indptr``: ``[D, rows_p+1]``), cut to the shards this
process holds (:mod:`.mesh`).  ``pcsr_spmv`` / ``pcsr_spmm`` all-gather the
row-sharded operand and run the local slab product once per shard; outputs
stay row-sharded, padded to ``rows_p * D``.  Rows and capacities are padded
so every shard does the same static-shape work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import device_values, host_values
from ..formats.csr import CSR
from ..ops.segmented import row_ids_from_indptr, segment_sum
from .mesh import Mesh

__all__ = [
    "PCSR",
    "make_1d_mesh",
    "put_sharded",
    "pcsr_from_csr",
    "pcsr_spmv",
    "pcsr_spmm",
    "shard_vector",
    "pcsr_todense",
]


def make_1d_mesh(n_devices: int | None = None, axis: str = "shards", *,
                 device=None, group=None) -> Mesh:
    """A 1-D mesh of the first ``n_devices`` shards.  Without ``group``:
    all of them in this process, on ``device`` (the card by default;
    ``n_devices`` defaults to 1).  With an initialised
    ``torch.distributed`` group: spread evenly over its ranks
    (``n_devices`` defaults to the group's size).  ``axis`` is kept as the
    mesh's name."""
    if n_devices is None:
        if group is None:
            n_devices = 1
        else:
            import torch.distributed as dist

            n_devices = dist.get_world_size(group)
    return Mesh(n_devices, axis, device=device, group=group)


def put_sharded(x, mesh: Mesh, axis: str | None = None, dtype=None):
    """Shard a host-global array over ``mesh`` (leading axis, a multiple of
    the shard count): this process keeps the rows of its own shards, on the
    mesh's device.  Every process passes the same global array.  ``x`` is a
    tensor or a NumPy array; ``dtype`` reads a NumPy array's bits as that
    type (``torch.bfloat16`` from int16, as :func:`._device.host_values`
    gives it)."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"put_sharded: axis {axis!r} is not the mesh's "
                         f"{mesh.axis!r}")
    per = x.shape[0] // mesh.n_shards
    local = x[mesh.lo * per: mesh.hi * per]
    if isinstance(local, torch.Tensor):
        return local.to(mesh.device)
    local = np.ascontiguousarray(local)
    if dtype is not None:
        return device_values(local, dtype, mesh.device)
    return torch.from_numpy(local).to(mesh.device)


def _all_shards(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """Every shard's rows of a stacked field, on the host (the host passes
    of the plan builders read all of them; a process group gathers)."""
    return host_values(mesh.all_gather(x))


@dataclasses.dataclass(frozen=True)
class PCSR:
    """Row-partitioned CSR.  ``data``/``indices``: [D, nse_p]; ``indptr``:
    [D, rows_p+1] (local, exclusive prefix per shard), this process's
    shards only.  Shard d owns global rows [d*rows_p, (d+1)*rows_p); rows
    beyond ``shape[0]`` are padding with empty rows."""

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    n_shards: int

    @property
    def nse_per_shard(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype


def _csr_host(a: CSR):
    """(indptr, indices, values) of a CSR on the host (values as
    :func:`host_values` gives them)."""
    return (a.indptr.cpu().numpy().astype(np.int64), a.indices.cpu().numpy(),
            host_values(a.data))


def pcsr_from_csr(a: CSR, mesh: Mesh, axis: str = "shards") -> PCSR:
    """Partition a CSR by contiguous row slabs over ``mesh`` (one host pass
    sizes the per-shard capacity to the max slab nnz)."""
    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    indptr, indices, data = _csr_host(a)
    nse_p = 0
    slabs = []
    for i in range(d):
        lo, hi = min(i * rows_p, n), min((i + 1) * rows_p, n)
        s, e = int(indptr[lo]), int(indptr[hi])
        local_ptr = np.zeros(rows_p + 1, np.int64)
        local_ptr[: hi - lo + 1] = indptr[lo: hi + 1] - indptr[lo]
        local_ptr[hi - lo + 1:] = local_ptr[hi - lo]
        slabs.append((local_ptr, indices[s:e], data[s:e]))
        nse_p = max(nse_p, e - s)
    nse_p = max(nse_p, 1)
    ptrs = np.stack([s[0] for s in slabs]).astype(np.int32)
    idxs = np.zeros((d, nse_p), np.int32)
    vals = np.zeros((d, nse_p), data.dtype)
    for i, (_, ix, vl) in enumerate(slabs):
        idxs[i, : ix.size] = ix
        vals[i, : vl.size] = vl
    return PCSR(
        data=put_sharded(vals, mesh, axis, a.dtype),
        indices=put_sharded(idxs, mesh, axis),
        indptr=put_sharded(ptrs, mesh, axis),
        shape=(n, m),
        axis=axis,
        rows_per_shard=rows_p,
        n_shards=d,
    )


def _local_spmv(data, indices, indptr, v):
    """SpMV of one local row slab against the full dense operand (a vector,
    or a matrix whose rows are operand rows)."""
    rows_p = indptr.shape[0] - 1
    rows = row_ids_from_indptr(indptr, data.shape[0])
    trail = (1,) * (v.dim() - 1)
    prods = data.reshape(data.shape + trail) * v[indices.long()]
    return segment_sum(prods, rows, rows_p, indices_are_sorted=True)


def _slabs(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-sharded operand as ``[local, rows, ...]``: one slab per shard
    held here."""
    return v.reshape((mesh.local, -1) + tuple(v.shape[1:]))


def _gathered(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole row-sharded operand on every shard (tiled all_gather)."""
    full = mesh.all_gather(_slabs(v, mesh))
    return full.reshape((-1,) + tuple(v.shape[1:]))


def _gather_apply(a: PCSR, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x_full = _gathered(x, mesh)
    return torch.cat([_local_spmv(a.data[i], a.indices[i], a.indptr[i],
                                  x_full) for i in range(mesh.local)])


def pcsr_spmv(a: PCSR, v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed SpMV: ``v`` sharded over the mesh (``shard_vector``);
    all-gather, local slab SpMV per shard; output row-sharded.  Returns the
    padded (rows_p * D,) vector (this process's part of it) — slice to
    ``a.shape[0]`` for the logical result."""
    return _gather_apply(a, v, mesh)


def pcsr_spmm(a: PCSR, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed SpMM (CSR x dense tall-skinny): ``b`` row-sharded;
    output row-sharded with padded leading dim rows_p * D."""
    return _gather_apply(a, b, mesh)


def shard_vector(v, a, mesh: Mesh) -> torch.Tensor:
    """Pad a global (dense-operand) vector/matrix along its leading axis to
    a multiple of the shard count and shard it over the mesh.  For square
    matrices this equals the row padding ``rows_p * D``, so solver iterates
    can feed outputs straight back in."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    d = a.n_shards
    total = -(-v.shape[0] // d) * d
    pad = total - v.shape[0]
    if pad:
        v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
    return put_sharded(v, mesh, a.axis)


def pcsr_todense(a: PCSR) -> torch.Tensor:
    """The dense rows of the shards this process holds (all of them on an
    in-process mesh: the whole matrix), duplicates summed by the sorted
    ``segment_sum`` (bitwise repeatable on the card) — a check utility."""
    n, m = a.shape
    L, rows_p = a.indptr.shape[0], a.rows_per_shard
    size = L * rows_p * m
    flat = []
    for s in range(L):
        rows = row_ids_from_indptr(a.indptr[s], a.nse_per_shard).long()
        # padding carries the sentinel row: its id lands past the output
        flat.append(torch.where(rows < rows_p,
                                (s * rows_p + rows) * m
                                + a.indices[s].long(), size))
    out = segment_sum(a.data.reshape(-1), torch.cat(flat), size)
    out = out.reshape(L * rows_p, m)
    if L == a.n_shards:
        return out[:n]
    return out
