"""sparse_tpu_torch: the PyTorch / CUDA port of ``sparse_tpu``.

The first slice carries the main path of the reference — build a CSR from
triples or COO (sort + duplicate sum), ``smvm_prepare`` it once, and
``plan.apply(v)`` for ``y = A v`` — through every rung of the SpMV dispatch
ladder; the second, the sparse x dense product: ``spmm``/``dsmm`` on CSR,
the row-binned ``csr_spmm_*`` and ``bsr_spmm_ell``, and ``bell_spmm`` on the
blocked-ELL format with its banded kits.  The reference's Pallas kernels on
those paths are hand-written CUDA kernels for Hopper here (``csrc/``, built
with ``nvcc`` at first use): K1 (scalar segment tiles, ``ops/cuda_csr.py``),
K2 (2x2 block-granule segment tiles, ``ops/cuda_csr_block.py``) and K3-K6
(blocked-ELL SpMM, ``ops/cuda_bell.py``).  The third slice is SpGEMM:
``spgemm`` (ESC, dense-accumulator and block cores), ``spgemm_prepare`` /
``spgemm_apply``, ``CSR @ CSC``, and block SpGEMM on BSR (``bsr_smsmm``,
``bsr_smsmm_prepare`` / ``bsr_smsmm_apply``, ``BSR @``), whose slab apply
is K7 (``ops/cuda_bsr.py``).  The fourth slice ports the reference's last
Pallas kernels and what measures them: ``build_seg_tiles`` at ``rows=32``
and ``layout="rigid"`` with ``csr_smvm_segtile(..., reduce="mxu")`` (K1-r32
and K1-mxu), the dense-band SpMM of ``benchmarks/measure_dband.py`` (K8,
``ops/cuda_dband.py``), Matrix Market input (``io/``) and the roofline
model on the H100's own figures (``utils/stats.py``, ``utils/profiling.py``).
On CPU tensors every kernel wrapper runs its plain PyTorch version instead.
The fifth slice is plain PyTorch, as the reference is plain XLA there: the
element-wise algebra of COO/CSR/CSC/BSR, the mono (MSR/MSC), packed
triangular and trapezoidal formats, ``utils/validate.py``, the dense LU
(``linalg/``) and the block-LU direct solver with its preconditioners
(``solve/``: ``bsr_lup``, ``bsr_factorize(a).solve(b)``, ``bsr_ols``,
block-Jacobi and ILU(0)).

Constructors that take host data (lists, NumPy arrays, files) build on the
card unless asked otherwise: ``device="cpu"``, or CPU tensors, for the CPU.

Imports torch, numpy and ctypes only — never jax or ``sparse_tpu``.
"""

from .formats.bell import (
    BELL,
    bell_from_bsr,
    bell_from_csr,
    bell_smvm,
    bell_spmm,
    bell_todense,
)
from .formats.bsr import (
    BSR,
    BSR_MAX_NB,
    BsrSmsmmPlan,
    bsr_add,
    bsr_compact,
    bsr_diag,
    bsr_eye,
    bsr_from_coo,
    bsr_from_dense,
    bsr_make,
    bsr_mul,
    bsr_nnz,
    bsr_scale,
    bsr_smsmm,
    bsr_smsmm_apply,
    bsr_smsmm_core,
    bsr_smsmm_prepare,
    bsr_smvm,
    bsr_sub,
    bsr_to_coo,
    bsr_to_csr,
    bsr_todense,
    bsr_transpose,
    bsr_zero,
    csr_to_bsr,
)
from .formats.coo import (
    COO,
    coo_compact,
    coo_concatenate,
    coo_from_dense,
    coo_from_triples,
    coo_make,
    coo_nnz,
    coo_normalize,
    coo_pad_to,
    coo_scale,
    coo_sort,
    coo_todense,
    coo_transpose,
)
from .formats.csr import (
    CSC,
    CSR,
    csc_add,
    csc_diag,
    csc_empty,
    csc_eye,
    csc_from_coo,
    csc_from_dense,
    csc_from_triples,
    csc_nnz,
    csc_scale,
    csc_sub,
    csc_to_coo,
    csc_todense,
    csc_transpose,
    csc_vsmm,
    csr_add,
    csr_compact,
    csr_diag,
    csr_diagonal,
    csr_empty,
    csr_eye,
    csr_from_coo,
    csr_from_dense,
    csr_from_triples,
    csr_nnz,
    csr_scale,
    csr_smvm,
    csr_sub,
    csr_to_coo,
    csr_todense,
    csr_transpose,
)
from .formats.mono import (
    MSC,
    MSR,
    debug_checks,
    msc_add,
    msc_diag,
    msc_empty,
    msc_eye,
    msc_from_coo,
    msc_from_triples,
    msc_nnz,
    msc_scale,
    msc_sub,
    msc_to_coo,
    msc_todense,
    msc_transpose,
    msc_vsmm,
    msr_add,
    msr_diag,
    msr_dmsmm,
    msr_empty,
    msr_eye,
    msr_from_coo,
    msr_from_triples,
    msr_nnz,
    msr_scale,
    msr_smvm,
    msr_sub,
    msr_to_coo,
    msr_todense,
    msr_transpose,
    msr_vsmm,
)
from .formats.trapezoidal import (
    Trapezoidal,
    trap_add,
    trap_diag,
    trap_elements,
    trap_eye,
    trap_from_dense,
    trap_idx,
    trap_map,
    trap_nnz,
    trap_scale,
    trap_smm,
    trap_sub,
    trap_todense,
    trap_transpose,
    trap_zero,
)
from .formats.triangular import (
    Triangular,
    tri_add,
    tri_diag,
    tri_elements,
    tri_eye,
    tri_from_dense,
    tri_idx,
    tri_map,
    tri_nnz,
    tri_scale,
    tri_smm,
    tri_sub,
    tri_todense,
    tri_transpose,
    tri_zero,
)
from .io import mm_read, mm_read_coo, mm_write
from .linalg.dense import (
    backsolve_dense,
    forsolve_dense,
    lu_dense,
    lup_dense,
    perm_compose,
    perm_id,
    perm_inverse,
    perm_to_matrix,
    permute,
    rowsolve_upper,
)
from .ops.bsr_ell import bsr_row_capacity, bsr_smvm_ell, bsr_spmm_ell
from .ops.cuda_bell import (
    BandedKit,
    BandedKitT,
    BandedPlan,
    bell_banded_prepare,
    bell_banded_prepare_t,
    bell_banded_refresh,
    build_banded_plan,
)
from .ops.cuda_bsr import (
    BsrSlabPlan,
    BsrSlabPlanAD,
    bsr_smsmm_apply_slab,
    bsr_smsmm_apply_slab_ad,
    bsr_smsmm_slab_prepare,
    bsr_smsmm_slab_prepare_ad,
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
from .ops.reorder import (
    PermutePlan,
    csr_bandwidth,
    csr_permute,
    permute_apply,
    permute_prepare,
    permute_vector,
    rcm_order,
    rcm_order_blocked,
    reorder_for_locality,
    unpermute_vector,
)
from .ops.spgemm import (
    SpgemmPlan,
    spgemm,
    spgemm_apply,
    spgemm_csr_csr,
    spgemm_flops,
    spgemm_mxu_csr_csr,
    spgemm_mxu_nse,
    spgemm_prepare,
)
from .ops.spmm import dsmm, spmm
from .ops.spmv import (
    SpmvPlan,
    build_spmv_plan,
    csr_smvm_ell,
    csr_smvm_fast,
    csr_spmm_ell,
    csr_spmm_fast,
    row_capacity,
)
from .solve.bsr_lu import (
    BSRFactorization,
    LuNumericPlan,
    TriSolvePlan,
    bsr_backsolve,
    bsr_factorize,
    bsr_forsolve,
    bsr_lower,
    bsr_lu,
    bsr_lu_find_fills,
    bsr_lu_nofill,
    bsr_lu_numeric_apply,
    bsr_lu_numeric_prepare,
    bsr_lup,
    bsr_lup_nofill,
    bsr_ols,
    bsr_tri_plan,
    bsr_upper,
)
from .solve.precond import (
    block_jacobi_apply,
    block_jacobi_prepare,
    bsr_ilu0_preconditioner,
)

__all__ = [
    "BELL", "bell_from_bsr", "bell_from_csr", "bell_smvm", "bell_spmm",
    "bell_todense",
    "BSR", "BSR_MAX_NB", "BsrSmsmmPlan", "bsr_add", "bsr_compact",
    "bsr_diag", "bsr_eye", "bsr_from_coo", "bsr_from_dense", "bsr_make",
    "bsr_mul", "bsr_nnz", "bsr_scale", "bsr_smsmm", "bsr_smsmm_apply",
    "bsr_smsmm_core", "bsr_smsmm_prepare", "bsr_smvm", "bsr_sub",
    "bsr_to_coo", "bsr_to_csr", "bsr_todense", "bsr_transpose", "bsr_zero",
    "csr_to_bsr",
    "COO", "coo_compact", "coo_concatenate", "coo_from_dense",
    "coo_from_triples", "coo_make", "coo_nnz", "coo_normalize", "coo_pad_to",
    "coo_scale", "coo_sort", "coo_todense", "coo_transpose",
    "CSC", "CSR", "csc_add", "csc_diag", "csc_empty", "csc_eye",
    "csc_from_coo", "csc_from_dense", "csc_from_triples", "csc_nnz",
    "csc_scale", "csc_sub", "csc_to_coo", "csc_todense", "csc_transpose",
    "csc_vsmm", "csr_add", "csr_compact", "csr_diag", "csr_diagonal",
    "csr_empty", "csr_eye", "csr_from_coo", "csr_from_dense",
    "csr_from_triples", "csr_nnz", "csr_scale", "csr_smvm", "csr_sub",
    "csr_to_coo", "csr_todense", "csr_transpose",
    "MSC", "MSR", "debug_checks", "msc_add", "msc_diag", "msc_empty",
    "msc_eye", "msc_from_coo", "msc_from_triples", "msc_nnz", "msc_scale",
    "msc_sub", "msc_to_coo", "msc_todense", "msc_transpose", "msc_vsmm",
    "msr_add", "msr_diag", "msr_dmsmm", "msr_empty", "msr_eye",
    "msr_from_coo", "msr_from_triples", "msr_nnz", "msr_scale", "msr_smvm",
    "msr_sub", "msr_to_coo", "msr_todense", "msr_transpose", "msr_vsmm",
    "Trapezoidal", "trap_add", "trap_diag", "trap_elements", "trap_eye",
    "trap_from_dense", "trap_idx", "trap_map", "trap_nnz", "trap_scale",
    "trap_smm", "trap_sub", "trap_todense", "trap_transpose", "trap_zero",
    "Triangular", "tri_add", "tri_diag", "tri_elements", "tri_eye",
    "tri_from_dense", "tri_idx", "tri_map", "tri_nnz", "tri_scale",
    "tri_smm", "tri_sub", "tri_todense", "tri_transpose", "tri_zero",
    "backsolve_dense", "forsolve_dense", "lu_dense", "lup_dense",
    "perm_compose", "perm_id", "perm_inverse", "perm_to_matrix", "permute",
    "rowsolve_upper",
    "BSRFactorization", "LuNumericPlan", "TriSolvePlan", "bsr_backsolve",
    "bsr_factorize", "bsr_forsolve", "bsr_lower", "bsr_lu",
    "bsr_lu_find_fills", "bsr_lu_nofill", "bsr_lu_numeric_apply",
    "bsr_lu_numeric_prepare", "bsr_lup", "bsr_lup_nofill", "bsr_ols",
    "bsr_tri_plan", "bsr_upper",
    "block_jacobi_apply", "block_jacobi_prepare", "bsr_ilu0_preconditioner",
    "BsrSlabPlan", "BsrSlabPlanAD", "bsr_smsmm_apply_slab",
    "bsr_smsmm_apply_slab_ad", "bsr_smsmm_slab_prepare",
    "bsr_smsmm_slab_prepare_ad",
    "SpgemmPlan", "spgemm", "spgemm_apply", "spgemm_csr_csr",
    "spgemm_flops", "spgemm_mxu_csr_csr", "spgemm_mxu_nse",
    "spgemm_prepare",
    "SegTilePlan", "build_seg_tiles", "csr_smvm_auto", "csr_smvm_segtile",
    "seg_tiles_refresh", "segtile_apply",
    "BlockSegTilePlan", "block_seg_tiles_refresh", "bsr_smvm_segtile_block",
    "build_seg_tiles_block",
    "SmvmAutoPlan", "smvm_prepare",
    "HubSplit", "hub_split_prepare", "hub_split_smvm",
    "rcm_order", "rcm_order_blocked", "reorder_for_locality",
    "PermutePlan", "csr_bandwidth", "csr_permute", "permute_apply",
    "permute_prepare", "permute_vector", "unpermute_vector",
    "SpmvPlan", "build_spmv_plan", "csr_smvm_ell", "csr_smvm_fast",
    "csr_spmm_ell", "csr_spmm_fast", "row_capacity",
    "spmm", "dsmm",
    "bsr_row_capacity", "bsr_smvm_ell", "bsr_spmm_ell",
    "BandedPlan", "BandedKit", "BandedKitT", "build_banded_plan",
    "bell_banded_prepare", "bell_banded_prepare_t", "bell_banded_refresh",
    "mm_read", "mm_read_coo", "mm_write",
]
