"""Every public callable of the PyTorch port runs on the card somewhere.

A public callable of ``sparse_tpu_torch`` or ``sparse_tpu_torch.parallel``
must be in one of three places: the ``SURFACE`` table of
``tests/test_torch_cuda_surface.py`` (a case per dtype on the card), a
card run by name (``CARD_RUNS``: the card test file or ``chip_smoke.py``
phase, or the example that phase 20 runs, each checked to name it), or
``EXEMPT``, the classes and constants, each with its reason.  One test per
public module, so a new public name of a module without a card case fails
here, on the CPU, with no card.  Imports no JAX.
"""

import importlib.util
import inspect
import re
from pathlib import Path

import pytest

import sparse_tpu_torch as pt
import sparse_tpu_torch.parallel as tpar

ROOT = Path(__file__).resolve().parents[1]


def _surface():
    spec = importlib.util.spec_from_file_location(
        "card_surface", ROOT / "tests" / "test_torch_cuda_surface.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SURFACE


SURFACE = _surface()

#: Names the card runs by name elsewhere: {file: names}.  The examples run
#: on the card in ``chip_smoke.py`` phase 20.
CARD_RUNS = {
    "tests/test_torch_cuda.py": """
        bell_banded_prepare bell_banded_prepare_t bell_spmm
        bsr_backsolve bsr_forsolve bsr_lu bsr_lu_numeric_apply
        bsr_lu_numeric_prepare bsr_smsmm_apply bsr_smsmm_apply_slab
        bsr_smsmm_apply_slab_ad bsr_smsmm_prepare bsr_smsmm_slab_prepare
        bsr_smsmm_slab_prepare_ad bsr_smvm_segtile_block bsr_zero
        build_banded_plan build_seg_tiles build_seg_tiles_block coo_make
        csr_empty csr_from_coo csr_from_triples csr_smvm_segtile
        csr_to_bsr mm_read segtile_apply smvm_prepare spgemm
        """,
    "tests/test_torch_cuda_transforms.py": """
        bell_from_bsr bsr_from_dense bsr_smsmm bsr_todense
        """,
    "tests/test_torch_parallel_cuda.py": """
        build_pbsr_smsmm_plan_slab cg_solve halo_partition_segtile
        halo_spmv_segtile make_1d_mesh pbsr_from_bsr pbsr_smsmm_slab
        shard_vector
        """,
    "chip_smoke.py": """
        bicgstab_solve block_jacobi_apply block_jacobi_prepare
        block_seg_tiles_refresh bsr_add bsr_factorize
        bsr_ilu0_preconditioner bsr_lu_find_fills bsr_lup bsr_mul
        bsr_nnz bsr_ols bsr_to_csr build_pbsr_smsmm_plan
        build_pspgemm_plan build_spmv_plan build_transpose_plan
        chebyshev_preconditioner csr_add csr_eye csr_from_dense csr_nnz
        csr_scale csr_smvm_fast csr_sub gmres_solve halo_partition
        halo_partition_overlapped halo_spmm halo_spmv
        halo_spmv_overlapped msr_from_triples msr_smvm pbell_from_bell
        pbell_shard_vector pbsr_to_bsr pcg_solve pcsr_from_csr
        pcsr_spgemm_aa pcsr_spmv pcsr_transpose_device phub_partition
        phub_spmv put_sharded seg_tiles_refresh trap_elements
        trap_todense tri_elements tri_todense
        """,
    "examples/torch_block_lu_solve.py": "bsr_lower bsr_to_coo bsr_upper",
    "examples/torch_fast_distributed_cg.py": "dist_spmv",
    "examples/torch_galerkin_reuse.py": "spgemm_apply spgemm_prepare",
    "examples/torch_poisson_cg.py": "csr_diagonal estimate_lmax",
}
RUN_BY_NAME = {n: f for f, names in CARD_RUNS.items() for n in names.split()}

_FORMAT = "a format's dataclass: built and read by its functions' cases"
_PLAN = "a plan's dataclass: built and read by the cases of its functions"
EXEMPT = {
    **{name: _FORMAT for name in (
        "BELL", "BSR", "COO", "CSC", "CSR", "MSC", "MSR", "Triangular",
        "Trapezoidal", "PCSR", "PBELL", "PBSR", "HaloPCSR",
        "HaloPCSROverlap", "HaloSegtile", "PHubSplit", "HubSplit")},
    **{name: _PLAN for name in (
        "BsrSmsmmPlan", "BSRFactorization", "LuNumericPlan", "TriSolvePlan",
        "BsrSlabPlan", "BsrSlabPlanAD", "SpgemmPlan", "SegTilePlan",
        "BlockSegTilePlan", "SmvmAutoPlan", "PermutePlan", "SpmvPlan",
        "BandedPlan", "BandedKit", "BandedKitT", "PBsrSlabPlan",
        "PBsrSmsmmPlan", "PSpGEMMPlan", "PTransposePlan")},
    "Mesh": "the shards' container: every distributed case builds one",
    "BSR_MAX_NB": "a constant (the block-index cap), not a callable",
}


def _public():
    """{name: defining module} of both namespaces' public names."""
    out = {}
    par = [n for n in dir(tpar) if not n.startswith("_")
           and not inspect.ismodule(getattr(tpar, n))]
    for ns, names in ((pt, pt.__all__), (tpar, par)):
        for n in names:
            obj = getattr(ns, n)
            out[n] = getattr(obj, "__module__", None) or ns.__name__
    return out


PUBLIC = _public()
MODULES = sorted(set(PUBLIC.values()))


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_of_the_module_runs_on_the_card(module):
    names = [n for n, m in PUBLIC.items() if m == module]
    assert names
    missing = [n for n in names if n not in SURFACE
               and n not in RUN_BY_NAME and n not in EXEMPT]
    assert not missing, f"{module}: no card case for {missing}"


def test_every_entry_is_a_public_name():
    for table in (SURFACE, RUN_BY_NAME, EXEMPT):
        assert not set(table) - set(PUBLIC), set(table) - set(PUBLIC)


def test_exempt_holds_only_classes_and_constants():
    for name in EXEMPT:
        obj = getattr(pt, name, None) or getattr(tpar, name)
        assert inspect.isclass(obj) or not callable(obj), name


def test_card_runs_name_what_they_run():
    for path, names in CARD_RUNS.items():
        text = (ROOT / path).read_text()
        for name in names.split():
            assert re.search(rf"\b{name}\b", text), (path, name)
