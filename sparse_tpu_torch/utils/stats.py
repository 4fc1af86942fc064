"""Structure statistics and roofline accounting.

Port of ``sparse_tpu/utils/stats.py``: the block-structure pass the SpMV
dispatch ladder uses (``csr_block_fill``, ``detect_block_size``), per-matrix
summaries (``matrix_stats``, ``bell_stats``) and the roofline model
(``spmv_bytes``, ``roofline_report``, ``csr_min_bytes``,
``blocked_min_bytes``, ``nnz_roofline``).  Every function reads its inputs
on the host, wherever the tensors lie.

The ceilings are the H100's own data-sheet figures, not the TPU's: the
reference's ``HBM_CEILING_GBPS`` was a v5e measurement and does not carry
over, and its segment-tile issue-rate constants are not ported.  A
kernel's bound — the least time the card could take for its work — is
``kernel_bound_s`` of the bytes of ``csr_bound_bytes`` or
``blocked_bound_bytes`` (the minimum bytes above plus the index arrays any
kernel reading the format must read) and the useful operations, against
``HBM_CEILING_GBPS`` and ``PEAK_TFLOPS``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csr import CSR

__all__ = ["matrix_stats", "spmv_bytes", "roofline_report",
           "bell_stats", "BellStats", "csr_block_fill", "detect_block_size",
           "HBM_CEILING_GBPS", "F32_PEAK_TFLOPS", "csr_min_bytes",
           "blocked_min_bytes", "nnz_roofline", "PEAK_TFLOPS",
           "csr_bound_bytes", "blocked_bound_bytes", "kernel_bound_s",
           "I32_PEAK_TOPS"]

#: Device-memory rate of one NVIDIA H100 SXM (80 GB HBM3) from NVIDIA's data
#: sheet, at the card's full 700 W power limit: the denominator of every
#: roofline fraction.  A card set below 700 W streams slower under load.
HBM_CEILING_GBPS = 3350.0

#: Float32 rate of one H100 SXM outside the tensor cores (CUDA cores, data
#: sheet, 700 W): the operations ceiling of the full-float32 kernels.
F32_PEAK_TFLOPS = 67.0

#: Operations ceiling of one H100 SXM by input type (data sheet, dense, 700
#: W): float32 on the CUDA cores, float64 on the tensor cores (34 on the
#: CUDA cores), bf16 on the tensor cores.
PEAK_TFLOPS = {torch.float32: F32_PEAK_TFLOPS, torch.float64: 67.0,
               torch.bfloat16: 989.0}

#: int32 multiply-add rate of one H100 SXM, in tera-operations a second:
#: half the float32 CUDA-core rate (64 INT32 lanes an SM against 128
#: FP32), the operations ceiling of the int32 kinds.
I32_PEAK_TOPS = F32_PEAK_TFLOPS / 2
PEAK_TFLOPS[torch.int32] = I32_PEAK_TOPS


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    shape: tuple[int, int]
    nse: int
    nnz: int
    row_min: int
    row_max: int
    row_mean: float
    row_imbalance: float  # max / mean row length (1.0 = perfectly balanced)

    def __str__(self) -> str:
        return (
            f"{self.shape[0]}x{self.shape[1]}: nnz={self.nnz} (capacity "
            f"{self.nse}), rows [{self.row_min}, {self.row_max}] mean "
            f"{self.row_mean:.1f}, imbalance {self.row_imbalance:.2f}x"
        )


def matrix_stats(a: CSR) -> MatrixStats:
    """Host-side structural summary of a CSR matrix."""
    indptr = _host(a.indptr)
    lens = indptr[1:] - indptr[:-1]
    data = _host(a.data)
    valid = int(indptr[-1])
    mean = float(lens.mean()) if lens.size else 0.0
    return MatrixStats(
        shape=a.shape,
        nse=a.nse,
        nnz=int(np.count_nonzero(data[:valid])),
        row_min=int(lens.min()) if lens.size else 0,
        row_max=int(lens.max()) if lens.size else 0,
        row_mean=mean,
        row_imbalance=float(lens.max() / mean) if mean > 0 else 1.0,
    )


def spmv_bytes(a: CSR, k: int = 1, value_bytes: int | None = None) -> int:
    """Minimum device-memory traffic of one SpMV/SpMM: values + column
    indices + one gathered operand row per stored entry + row pointers +
    output."""
    vb = value_bytes or a.data.element_size()
    nse = int(_host(a.indptr)[-1])
    n, m = a.shape
    return nse * (vb + 4 + vb * k) + (n + 1) * 4 + n * k * vb


def roofline_report(a: CSR, seconds: float, k: int = 1,
                    hbm_gbps: float | None = None) -> dict:
    """Achieved effective bandwidth (and roofline fraction when the card's
    memory rate is supplied) for a measured SpMV/SpMM time."""
    b = spmv_bytes(a, k)
    gbps = b / seconds / 1e9
    nse = int(_host(a.indptr)[-1])
    out = {
        "bytes": b,
        "effective_gbps": gbps,
        "nnz_per_s": nse * k / seconds,
    }
    if hbm_gbps:
        out["roofline_fraction"] = gbps / hbm_gbps
    return out


def csr_min_bytes(a: CSR, k: int = 1) -> int:
    """Pattern-intrinsic minimum bytes of one SpMV/SpMM: every stored value
    read once, every distinct operand entry read once, every output entry
    written once.  Index traffic is plan-dependent and belongs to the plan
    term of :func:`nnz_roofline`."""
    vb = a.data.element_size()
    indptr = _host(a.indptr)
    nse = int(indptr[-1]) if indptr.size else 0
    uniq = int(np.unique(_host(a.indices)[:nse]).size)
    n, _ = a.shape
    return nse * vb + uniq * k * vb + n * k * vb


def blocked_min_bytes(stored_blocks: int, bsz: int, n: int, k: int = 1,
                      value_bytes: int = 4,
                      operand_entries: int | None = None) -> int:
    """Pattern-intrinsic minimum bytes for a blocked (BSR/BELL) SpMV/SpMM:
    stored block values once, each distinct operand entry once
    (``operand_entries`` defaults to ``n * k``), output once."""
    if operand_entries is None:
        operand_entries = n * k
    return (stored_blocks * bsz * bsz * value_bytes
            + operand_entries * value_bytes + n * k * value_bytes)


def csr_bound_bytes(a: CSR, k: int = 1) -> int:
    """Bytes term of a CSR SpMV/SpMM kernel's bound: :func:`csr_min_bytes`
    plus the CSR index arrays (a 4-byte column index per stored entry and
    the row pointers), which any kernel reading this CSR must read."""
    nse = int(_host(a.indptr)[-1])
    return csr_min_bytes(a, k) + nse * 4 + (a.shape[0] + 1) * 4


def blocked_bound_bytes(stored_blocks: int, bsz: int, n: int, k: int = 1,
                        value_bytes: int = 4, out_bytes: int = 4,
                        row_pointers: bool = False) -> int:
    """Bytes term of a blocked (BSR/BELL) SpMV/SpMM kernel's bound:
    :func:`blocked_min_bytes` with the output in ``out_bytes`` per entry,
    plus a 4-byte block-column index per stored block and, for BSR
    (``row_pointers``), its ``n / bsz + 1`` block row pointers."""
    return (blocked_min_bytes(stored_blocks, bsz, n, k, value_bytes)
            + n * k * (out_bytes - value_bytes) + stored_blocks * 4
            + ((n // bsz + 1) * 4 if row_pointers else 0))


def kernel_bound_s(nbytes: int, ops: int, dtype=torch.float32,
                   hbm_gbps: float = HBM_CEILING_GBPS) -> tuple[float, str]:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``ops`` operations on inputs of ``dtype``: the larger
    of the two over the ceilings, in seconds, with which of them binds
    (``"bytes"`` or ``"operations"``)."""
    t_b = nbytes / (hbm_gbps * 1e9)
    t_o = ops / (PEAK_TFLOPS[dtype] * 1e12)
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nnz_roofline(nnz: int, k: int = 1, *, min_bytes: int,
                 hbm_gbps: float = HBM_CEILING_GBPS,
                 plan_bytes: int | None = None,
                 issue_s: float | None = None,
                 seconds: float | None = None) -> dict:
    """The nnz/s roofline model.

    ``min_bytes`` (:func:`csr_min_bytes` / :func:`blocked_min_bytes`) sets
    the pattern-intrinsic ceiling ``ceiling_gnnzps = hbm_gbps * nnz * k /
    min_bytes``.  A plan adds optional floors on its time — ``plan_bytes``
    (the traffic it moves) and ``issue_s`` (a measured issue-rate wall) —
    giving ``plan_ceiling_gnnzps`` and ``structural_frac = plan_ceiling /
    ceiling``.  With ``seconds``: ``achieved_gnnzps``,
    ``frac_of_nnz_roofline`` and ``frac_of_plan_ceiling``."""
    eff = nnz * k
    t_intr = min_bytes / (hbm_gbps * 1e9)
    out = {
        "min_bytes": int(min_bytes),
        "min_bytes_per_nnz": min_bytes / max(eff, 1),
        "ceiling_gnnzps": eff / t_intr / 1e9 if t_intr else float("inf"),
    }
    t_plan = None
    if plan_bytes is not None or issue_s is not None:
        t_plan = max(
            (plan_bytes / (hbm_gbps * 1e9)) if plan_bytes is not None
            else 0.0,
            issue_s or 0.0,
        )
        out["plan_ceiling_gnnzps"] = (eff / t_plan / 1e9 if t_plan
                                      else float("inf"))
        out["structural_frac"] = t_intr / t_plan if t_plan else 1.0
    if seconds:
        out["achieved_gnnzps"] = eff / seconds / 1e9
        out["frac_of_nnz_roofline"] = t_intr / seconds
        if t_plan:
            out["frac_of_plan_ceiling"] = t_plan / seconds
    return out


def csr_block_fill(a: CSR, bsz: int) -> float:
    """Stored-entry density of the bsz x bsz blocks a CSR pattern touches
    (host-side): nnz / (touched_blocks * bsz^2).  1.0 means every touched
    block is fully stored, so re-blocking at this bsz is free and exact.
    Explicit zeros count as stored (compressed.fut:162-164's storage
    notion)."""
    n, m = a.shape
    if bsz <= 0 or n % bsz or m % bsz:
        return 0.0
    indptr = _host(a.indptr)
    nnz = int(indptr[-1])
    if nnz == 0:
        return 0.0
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = _host(a.indices[:nnz]).astype(np.int64)
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


@dataclasses.dataclass(frozen=True)
class BellStats:
    shape: tuple[int, int]
    nb: int
    bsz: int
    Lb: int
    stored_blocks: int
    nnz: int
    slot_fill: float   # stored blocks / (nb * Lb) — ELL padding overhead
    block_fill: float  # nonzero values / stored block elements

    def __str__(self) -> str:
        return (
            f"BELL {self.shape[0]}x{self.shape[1]} bsz={self.bsz} "
            f"Lb={self.Lb}: {self.stored_blocks} blocks (slot fill "
            f"{self.slot_fill:.2f}), nnz={self.nnz} (block fill "
            f"{self.block_fill:.2f})"
        )


def bell_stats(a) -> BellStats:
    """Host-side structural summary of a blocked-ELL matrix: the ELL slot
    padding and the in-block density."""
    blocks = _host(a.blocks.float() if a.blocks.dtype == torch.bfloat16
                   else a.blocks)
    stored = np.any(blocks != 0, axis=(2, 3))
    nstored = int(stored.sum())
    nnz = int(np.count_nonzero(blocks))
    slots = max(a.nb * a.Lb, 1)
    return BellStats(
        shape=(a.n, a.n),
        nb=a.nb,
        bsz=a.bsz,
        Lb=a.Lb,
        stored_blocks=nstored,
        nnz=nnz,
        slot_fill=nstored / slots,
        block_fill=nnz / max(nstored * a.bsz * a.bsz, 1),
    )
