"""BELL: blocked-ELL storage for block-sparse SpMV and SpMM.

Port of ``sparse_tpu/formats/bell.py``: ``blocks[r, l]`` is the l-th stored
block of block row ``r`` (zero blocks pad short rows), with its block-column
id in ``cols[r, l]``.  SpMV (the ``bell`` rung) streams the blocks and
gathers operand chunks at ``bsz`` granularity; it is plain PyTorch, as the
reference left it to XLA.  :func:`bell_spmm` dispatches as the reference
does, with a CUDA device in the place of the TPU backend: on CUDA tensors a
banded kit goes to kernel K4 (``BandedKit``) or K5 (``BandedKitT``, small
k), a bare ``BandedPlan`` to K4 with the tiles densified in the call, and
no plan to the fused kernel K3 (``ops/cuda_bell.py``); on CPU tensors, or
with ``prefer_pallas=False``, it takes the gather-einsum path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import device_values, host_values
from ..ops.segmented import segment_sum
from ..utils.precision import contract
from .bsr import BSR

__all__ = ["BELL", "bell_from_bsr", "bell_from_csr", "bell_smvm", "bell_spmm",
           "bell_todense", "bell_smvm_hbm_bytes"]


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

    def __matmul__(self, other):
        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(other, device=self.device)
        if other.dim() == 1:
            return bell_smvm(self, other)
        if other.dim() == 2:
            return bell_spmm(self, other)
        return NotImplemented

    def todense(self) -> torch.Tensor:
        return bell_todense(self)


def bell_from_bsr(a: BSR, Lb: int | None = None) -> BELL:
    """Lay a BSR out as blocked-ELL (host pass, once per pattern; the result
    lives on ``a``'s device)."""
    nb, bsz = a.nb, a.bsz
    idxs = a.indices.cpu().numpy().astype(np.int64)
    blocks = host_values(a.blocks)
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
                blocks=device_values(out_blocks, a.dtype, a.device),
                n=a.n, bsz=bsz)


def bell_from_csr(a, bsz: int, Lb: int | None = None) -> BELL:
    """Re-block a CSR into blocked-ELL (explicit zeros fill touched
    blocks)."""
    from .bsr import bsr_compact, bsr_from_coo
    from .csr import csr_to_coo

    return bell_from_bsr(bsr_compact(bsr_from_coo(csr_to_coo(a), bsz)), Lb=Lb)


def bell_smvm_hbm_bytes(a: BELL) -> int:
    """Device-memory bytes one :func:`bell_smvm` moves: the block stream,
    the int32 block column ids, one gathered bsz-chunk of the operand per
    slot and the output, at the BELL's value width (the reference's
    formula, which counts 4-byte values)."""
    w = a.blocks.element_size()
    slots = a.nb * a.Lb
    return slots * (a.bsz * a.bsz * w + 4 + a.bsz * w) + a.n * w


def bell_smvm(a: BELL, v) -> torch.Tensor:
    """Scatter-free SpMV: stream blocks, gather operand chunks, contract
    (``utils.precision.contract``: full float32 for float32 operands,
    exact integer sums on every device)."""
    v = torch.as_tensor(v, device=a.device)
    if tuple(v.shape) != (a.n,):
        raise ValueError(
            f"bell_smvm: vector shape {tuple(v.shape)} != ({a.n},)")
    out_dtype = torch.promote_types(a.dtype, v.dtype)
    if a.n == 0 or a.Lb == 0:
        return torch.zeros(a.n, dtype=out_dtype, device=a.device)
    vb = v.to(out_dtype).reshape(a.nb, a.bsz)[a.cols.reshape(-1).long()] \
        .reshape(a.nb, a.Lb, a.bsz)
    return contract("rlij,rlj->ri", a.blocks.to(out_dtype), vb).reshape(a.n)


def bell_spmm(a: BELL, b, *, prefer_pallas: bool | None = None, plan=None,
              compute_dtype=None, precision=None) -> torch.Tensor:
    """Blocked-ELL SpMM: C[n, k] = A @ B, batched (bsz x bsz) @ (bsz x k).

    ``prefer_pallas`` (the reference's name) selects the kernels; None means
    the kernels for CUDA tensors and the gather-einsum path for CPU tensors,
    as the reference's default means the kernels on a TPU backend only.
    With the kernels, ``plan`` picks one: a ``BandedKit`` from
    ``ops.cuda_bell.bell_banded_prepare`` goes to K4 on the kit's tiles,
    which reads only the chunks its mask (``chunk_nz``) marks, a ``BandedKitT``
    (``bell_banded_prepare_t``, small k) to K5 through two n*k transposes, a
    bare ``BandedPlan`` to K4 densifying its tiles in the call, None to the
    fused kernel K3.  ``compute_dtype=torch.bfloat16`` streams both operands
    as bf16 with float32 sums; ``precision="bf16x3"`` takes the three-product
    split; float32 is otherwise full float32."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    if b.dim() != 2 or b.shape[0] != a.n:
        raise ValueError(
            f"bell_spmm: operand shape {tuple(b.shape)} != ({a.n}, k)")
    k = b.shape[1]
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if a.n == 0 or a.Lb == 0 or k == 0:
        return torch.zeros(a.n, k, dtype=out_dtype, device=b.device)
    from ..ops import cuda_bell as cb

    if prefer_pallas is None:
        prefer_pallas = a.device.type == "cuda"
    if not prefer_pallas:  # the gather-einsum
        return cb.bell_spmm_fused_plain(a, b, compute_dtype=compute_dtype,
                                        precision=precision)
    if plan is None:
        return cb.bell_spmm_fused(a, b, compute_dtype=compute_dtype,
                                  precision=precision)
    if isinstance(plan, cb.BandedKitT):
        # one-shot wrapper: iterative callers chain bell_spmm_banded_t in
        # transposed space and skip both transposes
        ct = cb.bell_spmm_banded_t(a, b.T.contiguous(), plan,
                                   precision=precision)
        return ct.T.contiguous()
    if isinstance(plan, cb.BandedKit):
        # K4 through the kit's chunk mask: it reads the marked chunks only
        return cb._bell_spmm_kit(a, b, plan, precision=precision)
    if isinstance(plan, cb.BandedPlan):
        return cb.bell_spmm_banded(a, b, plan, compute_dtype=compute_dtype,
                                   precision=precision)
    raise TypeError(f"bell_spmm: plan must be a BandedKit, BandedKitT or "
                    f"BandedPlan, got {type(plan).__name__}")


def bell_todense(a: BELL) -> torch.Tensor:
    """Dense (n, n) matrix; padding slots (zero blocks) add nothing.  Slots
    aimed at one block are summed by the sorted ``segment_sum`` (bitwise
    repeatable on the card, where ``index_add_`` is not)."""
    nb, bsz, Lb = a.nb, a.bsz, a.Lb
    r = torch.arange(nb, device=a.device).repeat_interleave(Lb)
    out = segment_sum(a.blocks.reshape(nb * Lb, bsz, bsz),
                      r * nb + a.cols.reshape(-1).long(), nb * nb)
    return out.reshape(nb, nb, bsz, bsz).permute(0, 2, 1, 3).reshape(a.n,
                                                                    a.n)
