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

``BSR @ BSR`` is block SpGEMM (:func:`bsr_smsmm`, or the prepared pair
:func:`bsr_smsmm_prepare` / :func:`bsr_smsmm_apply`) and ``BSR @ vector`` is
:func:`bsr_smvm`.  Block products run as one batched matmul in the working
dtype (sub-float32 inputs summed in float32 and rounded once; integers
exactly); every duplicate sum is :func:`~..ops.segmented.segment_sum`, so no
float atomics and bitwise repeatable results.  The element-wise algebra and
the LU solver are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import device_values, host_values, resolve_device
from ..ops.segmented import INDEX_DTYPE, expand, segment_sum
from ..utils.precision import contract
from .coo import COO, coo_normalize

__all__ = [
    "BSR",
    "BSR_MAX_NB",
    "bsr_make",
    "bsr_zero",
    "bsr_eye",
    "bsr_diag",
    "bsr_from_dense",
    "bsr_transpose",
    "bsr_add",
    "bsr_sub",
    "bsr_mul",
    "bsr_scale",
    "bsr_nnz",
    "bsr_smvm",
    "bsr_smsmm",
    "bsr_smsmm_core",
    "BsrSmsmmPlan",
    "bsr_smsmm_prepare",
    "bsr_smsmm_apply",
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

    def __add__(self, other: "BSR") -> "BSR":
        return bsr_add(self, other)

    def __sub__(self, other: "BSR") -> "BSR":
        return bsr_sub(self, other)

    def __mul__(self, v) -> "BSR":
        if isinstance(v, BSR):
            return bsr_mul(self, v)
        return bsr_scale(v, self)

    def __rmul__(self, v) -> "BSR":
        return bsr_scale(v, self)

    def __matmul__(self, other):
        if isinstance(other, BSR):
            return bsr_smsmm(self, other)
        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(other, device=self.device)
        if other.dim() == 1:
            return bsr_smvm(self, other)
        return NotImplemented

    @property
    def T(self) -> "BSR":
        return bsr_transpose(self)

    def todense(self) -> torch.Tensor:
        return bsr_todense(self)

    def nnz(self) -> torch.Tensor:
        return bsr_nnz(self)


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


def _merge_blocks(n: int, bsz: int, idxs: torch.Tensor,
                  blocks: torch.Tensor) -> BSR:
    """Sort block entries by flattened index, sum duplicates, pack valid
    entries at the front; capacity preserved (the engine behind ``smsmm``
    accumulation, reference blocked_square_regular.fut:234-256, :349-359).
    Duplicates sum in input order through ``segment_sum``."""
    nb = n // bsz
    sentinel = nb * nb
    nbz = idxs.shape[0]
    if nbz == 0:
        return BSR(indices=idxs, blocks=blocks, n=n, bsz=bsz)
    key, order = torch.sort(idxs.long(), stable=True)
    valid = key < sentinel
    is_head = torch.ones_like(valid)
    is_head[1:] = key[1:] != key[:-1]
    is_head &= valid
    group = torch.cumsum(is_head.long(), 0) - 1
    target = torch.where(valid, group, torch.full_like(group, nbz))
    out_blocks = segment_sum(blocks[order], target, nbz,
                             indices_are_sorted=True)
    out_idx = torch.full((nbz,), sentinel, dtype=torch.long,
                         device=idxs.device)
    heads = torch.nonzero(is_head).reshape(-1)
    out_idx[group[heads]] = key[heads]
    return BSR(indices=out_idx.to(idxs.dtype), blocks=out_blocks, n=n,
               bsz=bsz)


def bsr_zero(n: int, bsz: int, nbz: int = 0, dtype=torch.float32, *,
             device=None) -> BSR:
    """Zero matrix with optional pre-allocated block capacity (reference
    ``zero``, blocked_square_regular.fut:189-193), on ``device`` (default
    CUDA)."""
    _check_divides(n, bsz)
    device = resolve_device(device)
    nb = n // bsz
    return BSR(indices=torch.full((nbz,), nb * nb, dtype=_bidx_dtype(nb),
                                  device=device),
               blocks=torch.zeros((nbz, bsz, bsz), dtype=dtype,
                                  device=device), n=n, bsz=bsz)


def _host_block(x):
    """One block entry as a NumPy array; a bf16 tensor as float32, which
    holds every bf16 value exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def bsr_make(n: int, bsz: int, entries, dtype=None, *, device=None) -> BSR:
    """Construction from ``[(r, c, block), ...]`` block triples with
    host-side bounds checks (reference ``mk``, blocked_square_regular.fut:
    195-201); duplicate coordinates are summed.  ``dtype`` defaults to the
    first block's tensor dtype, else NumPy's; builds on ``device``, else the
    first block's device when it is a tensor, else CUDA."""
    _check_divides(n, bsz)
    nb = n // bsz
    entries = list(entries)
    first = entries[0][2] if entries else None
    device = resolve_device(device, first)
    if dtype is None and isinstance(first, torch.Tensor):
        dtype = first.dtype
    if not entries:
        return bsr_zero(n, bsz, 0, dtype or torch.float32, device=device)
    rs = np.asarray([e[0] for e in entries], np.int64)
    cs = np.asarray([e[1] for e in entries], np.int64)
    blks = np.stack([_host_block(e[2]) for e in entries])
    if blks.shape[1:] != (bsz, bsz):
        raise ValueError(f"blocks must be {bsz}x{bsz}; got {blks.shape[1:]}")
    if rs.min() < 0 or rs.max() >= nb or cs.min() < 0 or cs.max() >= nb:
        raise ValueError(f"block coordinate out of bounds for {nb}x{nb} "
                         "blocks")
    blocks = torch.from_numpy(np.ascontiguousarray(blks))
    if dtype is not None:
        blocks = blocks.to(dtype)
    idxs = torch.from_numpy(rs * nb + cs).to(_bidx_dtype(nb))
    return _merge_blocks(n, bsz, idxs.to(device), blocks.to(device))


def bsr_eye(n: int, bsz: int, dtype=torch.float32, *, device=None) -> BSR:
    """Identity (reference ``eye``, blocked_square_regular.fut:208-210), on
    ``device`` (default CUDA)."""
    _check_divides(n, bsz)
    device = resolve_device(device)
    nb = n // bsz
    i = torch.arange(nb, dtype=_bidx_dtype(nb), device=device)
    blk = torch.eye(bsz, dtype=dtype, device=device)
    return BSR(indices=i * nb + i, blocks=blk.expand(nb, bsz, bsz).clone(),
               n=n, bsz=bsz)


def bsr_diag(v, bsz: int, *, device=None) -> BSR:
    """Diagonal matrix from a length-n vector (reference ``diag``,
    blocked_square_regular.fut:301-305), on ``device``, else ``v``'s
    device, else CUDA."""
    v = torch.as_tensor(v, device=resolve_device(device, v))
    n = v.shape[0]
    _check_divides(n, bsz)
    nb = n // bsz
    i = torch.arange(nb, dtype=_bidx_dtype(nb), device=v.device)
    eye = torch.eye(bsz, dtype=v.dtype, device=v.device)
    return BSR(indices=i * nb + i,
               blocks=v.reshape(nb, bsz)[:, :, None] * eye[None], n=n,
               bsz=bsz)


def bsr_from_dense(x, bsz: int, nbz: int | None = None, *,
                   device=None) -> BSR:
    """The non-zero blocks of a dense square matrix, in block-row-major
    order; ``nbz`` fixes the capacity (default: the non-zero block count).
    Builds on ``device``, else ``x``'s device when it is a tensor, else
    CUDA."""
    x = torch.as_tensor(x, device=resolve_device(device, x))
    n = x.shape[0]
    if tuple(x.shape) != (n, n):
        raise ValueError(f"BSR matrices are square; got {tuple(x.shape)}")
    _check_divides(n, bsz)
    nb = n // bsz
    total = nb * nb
    xb = x.reshape(nb, bsz, nb, bsz).permute(0, 2, 1, 3).reshape(
        total, bsz, bsz)
    nz = torch.any((xb != 0).reshape(total, -1), dim=1)
    if nbz is None:
        nbz = int(torch.sum(nz))
    order = torch.argsort((~nz).to(torch.int8), stable=True)
    if nbz <= total:
        idx = order[:nbz]
        taken = nz[idx]
    else:
        pad = nbz - total
        idx = torch.cat([order, order.new_zeros(pad)])
        taken = torch.cat([nz[order], nz.new_zeros(pad)])
    idxs = torch.where(taken, idx, torch.full_like(idx, total))
    blocks = torch.where(taken[:, None, None], xb[idx] if total else
                         xb.new_zeros((nbz, bsz, bsz)),
                         torch.zeros((), dtype=x.dtype, device=x.device))
    return _merge_blocks(n, bsz, idxs.to(_bidx_dtype(nb)), blocks)


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
    data = host_values(a.data[:k])
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
               blocks=device_values(blocks, a.dtype, dev), n=n, bsz=bsz)


def bsr_compact(a: BSR) -> BSR:
    """Trim capacity to the exact valid block count (host sync)."""
    k = int(torch.sum(a.indices.long() < a.sentinel))
    return BSR(indices=a.indices[:k], blocks=a.blocks[:k], n=a.n, bsz=a.bsz)


def bsr_transpose(a: BSR) -> BSR:
    """Swap block coordinates and transpose each block (reference
    ``transp``, blocked_square_regular.fut:226-232); one sort restores the
    sorted-indices invariant."""
    valid, r, c = _rc(a)
    new_idx = torch.where(valid, c * a.nb + r, torch.full_like(r, a.sentinel))
    return _merge_blocks(a.n, a.bsz, new_idx.to(a.indices.dtype),
                         a.blocks.transpose(1, 2))


def bsr_add(a: BSR, b: BSR) -> BSR:
    """Element-wise addition by block-set union (reference ``add``,
    blocked_square_regular.fut:258-275).  Capacity = nbz(a) + nbz(b)."""
    _check_compat(a, b, "add")
    return _merge_blocks(a.n, a.bsz, torch.cat([a.indices, b.indices]),
                         torch.cat([a.blocks, b.blocks]))


def bsr_sub(a: BSR, b: BSR) -> BSR:
    """Element-wise subtraction (reference ``sub``,
    blocked_square_regular.fut:277-278)."""
    return bsr_add(a, bsr_scale(-1, b))


def bsr_mul(a: BSR, b: BSR) -> BSR:
    """Element-wise (Hadamard) product by block-set intersection, a
    ``searchsorted`` of ``a``'s blocks in ``b``'s (reference ``mul``,
    blocked_square_regular.fut:280-290).  Capacity = nbz(a)."""
    _check_compat(a, b, "mul")
    if a.nbz == 0 or b.nbz == 0:
        return bsr_zero(a.n, a.bsz, a.nbz,
                        torch.promote_types(a.dtype, b.dtype),
                        device=a.device)
    ai, bi = a.indices.long(), b.indices.long()
    pos = torch.searchsorted(bi, ai).clamp(max=b.nbz - 1)
    found = (bi[pos] == ai) & (ai < a.sentinel)
    idxs = torch.where(found, ai, torch.full_like(ai, a.sentinel))
    prod = a.blocks * b.blocks[pos]
    blocks = torch.where(found[:, None, None], prod, torch.zeros_like(prod))
    return _merge_blocks(a.n, a.bsz, idxs.to(a.indices.dtype), blocks)


def bsr_scale(v, a: BSR) -> BSR:
    """Scale all elements (reference ``scale``, blocked_square_regular.fut:
    292-296)."""
    return dataclasses.replace(a, blocks=a.blocks * v)


def bsr_nnz(a: BSR) -> torch.Tensor:
    """Non-zero scalars inside valid blocks (the reference's zero-filtering
    ``coo``, blocked_square_regular.fut:614)."""
    valid, _, _ = _rc(a)
    return torch.sum((a.blocks != 0) & valid[:, None, None]).to(INDEX_DTYPE)


def _check_compat(a: BSR, b: BSR, op: str) -> None:
    if a.n != b.n or a.bsz != b.bsz:
        raise ValueError(
            f"bsr_{op}: incompatible operands n={a.n}/{b.n} "
            f"bsz={a.bsz}/{b.bsz}")


# -- matmul -------------------------------------------------------------------


def _block_products(x: torch.Tensor, y: torch.Tensor, out_dtype):
    """``x[f] @ y[f]`` for (F, bsz, bsz) stacks, cast to ``out_dtype``.
    Floating types multiply as one batched matmul in full precision, with
    sub-float32 inputs summed in float32 and rounded once (the reference's
    ``_flat_block_products`` / MXU einsum contract); integers sum exactly
    over the shared index (``utils.precision.contract``)."""
    acc = (torch.float32 if out_dtype.is_floating_point
           and torch.finfo(out_dtype).bits < 32 else out_dtype)
    return contract("fij,fjk->fik", x.to(acc), y.to(acc)).to(out_dtype)


def _flat_block_products(fa: torch.Tensor, fb: torch.Tensor, bsz: int,
                         out_dtype) -> torch.Tensor:
    """Batched block products in the flat (F, bsz^2) layout (the
    reference's small-block path): ``prods[:, i*bsz+j] = sum_k
    fa[:, i*bsz+k] * fb[:, k*bsz+j]``, one elementwise product of
    repeated / tiled columns per ``k``, summed in ``k`` order.  Sub-float32
    inputs sum in float32 and round once."""
    acc = (torch.float32 if out_dtype.is_floating_point
           and torch.finfo(out_dtype).bits < 32 else out_dtype)
    fa, fb = fa.to(acc), fb.to(acc)
    prods = sum(fa[:, k::bsz].repeat_interleave(bsz, dim=1)
                * fb[:, k * bsz:(k + 1) * bsz].repeat(1, bsz)
                for k in range(bsz))
    return prods.to(out_dtype)


def bsr_smvm(a: BSR, v) -> torch.Tensor:
    """Block sparse matrix-vector product: batched block matvec + block-row
    segment sum (reference ``smvm``, blocked_square_regular.fut:307-331)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (a.n,):
        raise ValueError(f"bsr_smvm: vector shape {tuple(v.shape)} != "
                         f"({a.n},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    nb, bsz = a.nb, a.bsz
    if a.nbz == 0 or a.n == 0:
        return torch.zeros(a.n, dtype=out_dtype, device=a.device)
    _, r, c = _rc(a)
    vb = v.to(out_dtype).reshape(nb, bsz)[c]  # padding: c=0, zero block
    w = _block_products(a.blocks.to(out_dtype), vb[:, :, None],
                        out_dtype)[:, :, 0]
    return segment_sum(w, r, nb, indices_are_sorted=True).reshape(a.n)


def bsr_smsmm_core(a: BSR, b: BSR, expansion_nbz: int) -> BSR:
    """Block SpGEMM with a static block-product capacity: expand the actual
    block pairs (A block column == B block row), one batched block product,
    merge by target coordinate (reference ``smsmm``,
    blocked_square_regular.fut:336-363).  Capacity = ``expansion_nbz``."""
    _check_compat(a, b, "smsmm")
    n, bsz, nb = a.n, a.bsz, a.nb
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if expansion_nbz == 0 or a.nbz == 0 or b.nbz == 0:
        return bsr_zero(n, bsz, expansion_nbz, out_dtype, device=a.device)
    valid_a, a_r, a_c = _rc(a)
    valid_b, b_r, b_c = _rc(b)
    b_row_counts = segment_sum(valid_b.long(), b_r, nb,
                               indices_are_sorted=True)
    b_row_ptr = torch.cumsum(b_row_counts, 0) - b_row_counts
    sizes = torch.where(valid_a, b_row_counts[a_c.clamp(max=nb - 1)],
                        torch.zeros_like(a_c))
    elem_ids, inner = expand(sizes, expansion_nbz)
    live = elem_ids.long() < a.nbz
    e = torch.where(live, elem_ids.long(), torch.zeros_like(elem_ids.long()))
    b_pos = b_row_ptr[a_c[e].clamp(max=nb - 1)] + inner.long()
    b_pos = b_pos.clamp(max=max(b.nbz - 1, 0))
    prods = _block_products(a.blocks[e], b.blocks[b_pos], out_dtype)
    keep = live & valid_a[e]
    target = torch.where(keep, a_r[e] * nb + b_c[b_pos],
                         torch.full_like(e, nb * nb))
    prods = torch.where(keep[:, None, None], prods, prods.new_zeros(()))
    return _merge_blocks(n, bsz, target.to(_bidx_dtype(nb)), prods)


@dataclasses.dataclass(frozen=True)
class BsrSmsmmPlan:
    """Pattern-static block-SpGEMM schedule from :func:`bsr_smsmm_prepare`:
    per block product, the storage positions of both factors and the
    (pre-sorted) output block slot; ``indices`` is the result's sorted
    block-coordinate array (capacity = exact stored block count)."""

    a_pos: torch.Tensor
    b_pos: torch.Tensor
    seg: torch.Tensor
    indices: torch.Tensor
    n: int
    bsz: int

    @property
    def nbz_out(self) -> int:
        return self.indices.shape[0]

    @property
    def n_products(self) -> int:
        return self.a_pos.shape[0]


def bsr_smsmm_prepare(a: BSR, b: BSR) -> BsrSmsmmPlan:
    """Symbolic block-SpGEMM pass (host NumPy, once per pattern pair; the
    reference's pass to the letter, so both packages build the same
    ``a_pos``/``b_pos``/``seg``/``indices``).  The plan lives on ``a``'s
    device."""
    _check_compat(a, b, "smsmm_prepare")
    nb = a.nb
    ai = a.indices.cpu().numpy().astype(np.int64)
    bi = b.indices.cpu().numpy().astype(np.int64)
    va = np.flatnonzero(ai < nb * nb)
    vb = np.flatnonzero(bi < nb * nb)
    a_r, a_c = ai[va] // nb, ai[va] % nb
    b_r, b_c = bi[vb] // nb, bi[vb] % nb
    # row-compress B's valid blocks (BSR indices are sorted, so vb is
    # already grouped by b_r)
    b_counts = np.bincount(b_r, minlength=nb)
    b_ptr = np.zeros(nb + 1, np.int64)
    np.cumsum(b_counts, out=b_ptr[1:])
    sizes = b_counts[a_c]
    F = int(sizes.sum())
    starts = np.cumsum(sizes) - sizes
    pa_ = np.repeat(np.arange(va.size, dtype=np.int64), sizes)
    inner = np.arange(F, dtype=np.int64) - starts[pa_]
    pb_ = b_ptr[a_c[pa_]] + inner
    target = a_r[pa_] * nb + b_c[pb_]
    from ..native.plansort import argsort_u64

    order = argsort_u64(target)
    t_o = target[order]
    head = np.ones(F, bool)
    head[1:] = t_o[1:] != t_o[:-1]
    seg = np.cumsum(head) - 1
    dev = a.device

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(dev)

    return BsrSmsmmPlan(
        a_pos=put(va[pa_[order]], INDEX_DTYPE),
        b_pos=put(vb[pb_[order]], INDEX_DTYPE),
        seg=put(seg, INDEX_DTYPE),
        indices=put(t_o[head] if F else np.zeros(0, np.int64),
                    _bidx_dtype(nb)),
        n=a.n,
        bsz=a.bsz,
    )


def bsr_smsmm_apply(plan: BsrSmsmmPlan, a: BSR, b: BSR) -> BSR:
    """Numeric block-SpGEMM pass for the pattern pair captured in ``plan``
    (values may change, block structure must not): gather both factors'
    blocks, one batched block product, one pre-sorted segment sum.
    Deterministic; the slab kernel (``ops.cuda_bsr``) computes the same
    without the gathered streams."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    bsz = plan.bsz
    if plan.n_products == 0:
        blocks = torch.zeros((plan.nbz_out, bsz, bsz), dtype=out_dtype,
                             device=a.device)
    else:
        prods = _block_products(a.blocks[plan.a_pos.long()],
                                b.blocks[plan.b_pos.long()], out_dtype)
        blocks = segment_sum(prods, plan.seg, plan.nbz_out,
                             indices_are_sorted=True)
    return BSR(indices=plan.indices, blocks=blocks, n=plan.n, bsz=bsz)


def bsr_smsmm(a: BSR, b: BSR, *, expansion_nbz: int | None = None,
              compact: bool = True) -> BSR:
    """Block sparse x sparse matmul (reference ``smsmm``,
    blocked_square_regular.fut:336-363).  With ``expansion_nbz=None`` the
    block-pair count is taken first (host sync) and the result is trimmed
    to its stored blocks unless ``compact=False``."""
    if expansion_nbz is None:
        _check_compat(a, b, "smsmm")
        valid_a, _, a_c = _rc(a)
        valid_b, b_r, _ = _rc(b)
        counts = segment_sum(valid_b.long(), b_r, max(a.nb, 1),
                             indices_are_sorted=True)
        f = int(torch.sum(torch.where(
            valid_a, counts[a_c.clamp(max=max(a.nb - 1, 0))],
            torch.zeros_like(a_c))))
        out = bsr_smsmm_core(a, b, f)
        return bsr_compact(out) if compact else out
    return bsr_smsmm_core(a, b, expansion_nbz)
