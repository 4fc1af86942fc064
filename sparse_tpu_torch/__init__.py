"""sparse_tpu_torch: the PyTorch / CUDA port of ``sparse_tpu``.

This first slice carries the main path of the reference — build a CSR from
triples or COO (sort + duplicate sum), ``smvm_prepare`` it once, and
``plan.apply(v)`` for ``y = A v`` — through every rung of the SpMV dispatch
ladder.  The reference's two Pallas kernels on that path are hand-written
CUDA kernels for Hopper here (``csrc/``, built with ``nvcc`` at first use):
K1 (scalar segment tiles, ``ops/cuda_csr.py``) and K2 (2x2 block-granule
segment tiles, ``ops/cuda_csr_block.py``).  On CPU tensors every kernel
wrapper runs its plain PyTorch version instead.

Imports torch, numpy and ctypes only — never jax or ``sparse_tpu``.
"""

from .formats.bell import BELL, bell_from_bsr, bell_from_csr, bell_smvm
from .formats.bsr import (
    BSR,
    BSR_MAX_NB,
    bsr_compact,
    bsr_from_coo,
    bsr_to_coo,
    bsr_to_csr,
    bsr_todense,
    csr_to_bsr,
)
from .formats.coo import (
    COO,
    coo_from_dense,
    coo_from_triples,
    coo_make,
    coo_nnz,
    coo_normalize,
    coo_sort,
    coo_todense,
)
from .formats.csr import (
    CSC,
    CSR,
    csc_transpose,
    csc_vsmm,
    csr_from_coo,
    csr_from_dense,
    csr_from_triples,
    csr_nnz,
    csr_smvm,
    csr_to_coo,
    csr_todense,
    csr_transpose,
)
from .ops.cuda_csr import (
    SegTilePlan,
    build_seg_tiles,
    csr_smvm_auto,
    csr_smvm_segtile,
    seg_tiles_refresh,
    segtile_apply,
)
from .ops.cuda_csr_block import (
    BlockSegTilePlan,
    block_seg_tiles_refresh,
    bsr_smvm_segtile_block,
    build_seg_tiles_block,
)
from .ops.dispatch import SmvmAutoPlan, smvm_prepare
from .ops.hub_split import HubSplit, hub_split_prepare, hub_split_smvm
from .ops.reorder import rcm_order, rcm_order_blocked, reorder_for_locality
from .ops.spmv import build_spmv_plan, csr_smvm_fast

__all__ = [
    "BELL", "bell_from_bsr", "bell_from_csr", "bell_smvm",
    "BSR", "BSR_MAX_NB", "bsr_compact", "bsr_from_coo", "bsr_to_coo",
    "bsr_to_csr", "bsr_todense", "csr_to_bsr",
    "COO", "coo_from_dense", "coo_from_triples", "coo_make", "coo_nnz",
    "coo_normalize", "coo_sort", "coo_todense",
    "CSC", "CSR", "csc_transpose", "csc_vsmm", "csr_from_coo",
    "csr_from_dense", "csr_from_triples", "csr_nnz", "csr_smvm",
    "csr_to_coo", "csr_todense", "csr_transpose",
    "SegTilePlan", "build_seg_tiles", "csr_smvm_auto", "csr_smvm_segtile",
    "seg_tiles_refresh", "segtile_apply",
    "BlockSegTilePlan", "block_seg_tiles_refresh", "bsr_smvm_segtile_block",
    "build_seg_tiles_block",
    "SmvmAutoPlan", "smvm_prepare",
    "HubSplit", "hub_split_prepare", "hub_split_smvm",
    "rcm_order", "rcm_order_blocked", "reorder_for_locality",
    "build_spmv_plan", "csr_smvm_fast",
]
