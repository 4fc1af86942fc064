"""SpGEMM in the PyTorch port against the reference: ``spgemm`` and its
three cores, ``spgemm_prepare``/``spgemm_apply`` (``sparse_tpu/ops/
spgemm.py``), ``CSR @ CSC``, the CSC constructors, and block SpGEMM on BSR
(``bsr_smsmm*``, ``BSR @``, ``sparse_tpu/formats/bsr.py``).

Inputs are numpy-seeded and given to both packages.  Stored structure
(``indices``/``indptr``), plan arrays and integer values must match
exactly; float values within 1e-5 relative (float32) or 1e-12 (float64) of
the reference — the cores sum in other orders than XLA.
"""

import dataclasses
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.formats import bsr as jbsr
from sparse_tpu.ops import spgemm as jsg
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.ops import cuda_bsr as tcb
from sparse_tpu_torch.ops import spgemm as tsg

RTOL = {np.float32: 1e-5, np.float64: 1e-12}

# reference compressed_test.fut:158-170 golden cases (tests/test_spgemm_
# spmm.py:24-40): (n, m, k, A triples, B triples, expected)
SMSMM_CASES = [
    (2, 2, 2, [(0, 1, 1)], [(1, 0, 1)], [[1, 0], [0, 0]]),
    (2, 2, 2, [(1, 0, 1)], [(0, 1, 1)], [[0, 0], [0, 1]]),
    (2, 3, 4, [(1, 0, 5)], [], [[0, 0, 0, 0], [0, 0, 0, 0]]),
    (2, 2, 2, [(0, 0, 1), (1, 1, 1)], [(0, 1, 8), (1, 0, 9)],
     [[0, 8], [9, 0]]),
    (2, 2, 2, [(0, 0, 1), (0, 1, 7), (1, 0, 2), (1, 1, 4)],
     [(0, 0, 3), (0, 1, 3), (1, 0, 5), (1, 1, 2)], [[38, 17], [26, 14]]),
]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _csr_pair(x):
    """(reference CSR, port CSR) of the dense matrix ``x`` from the same
    arrays: its non-zeros in row-major order, as both packages'
    ``csr_from_dense`` store them (built in numpy, which saves the
    reference's eager compiles)."""
    s = sp.csr_matrix(x)
    s.sort_indices()
    indices, indptr = s.indices.astype(np.int32), s.indptr.astype(np.int32)
    ja = st.CSR(data=jnp.asarray(s.data), indices=jnp.asarray(indices),
                indptr=jnp.asarray(indptr), shape=x.shape)
    return ja, interop.csr_from_arrays(s.data, indices, indptr, x.shape,
                                       device="cpu")


def _csc_pair(x):
    """(reference CSC, port CSC) of ``x``: the CSR of ``x.T``, read by
    columns, as both packages' ``csc_from_dense`` store it."""
    ja, ta = _csr_pair(np.ascontiguousarray(x.T))
    return st.csr_transpose(ja), pt.csr_transpose(ta)


def _random(n, m, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)) * (rng.random((n, m)) < density)
    if np.issubdtype(dtype, np.integer):
        x = np.round(x * 4)
    return x.astype(dtype)


def _assert_same_csr(got, ref, dtype, exact_capacity=True):
    """Stored structure exactly, values to the dtype's tolerance."""
    ref_indptr = np.asarray(ref.indptr)
    k = int(ref_indptr[-1])
    np.testing.assert_array_equal(_np(got.indptr), ref_indptr)
    if exact_capacity:
        assert got.nse == ref.nse
    np.testing.assert_array_equal(_np(got.indices)[:k],
                                  np.asarray(ref.indices)[:k])
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(_np(got.data)[:k],
                                      np.asarray(ref.data)[:k])
    else:
        np.testing.assert_allclose(_np(got.data)[:k], np.asarray(ref.data)[:k],
                                   rtol=RTOL[dtype], atol=RTOL[dtype])


# -- goldens, CSR @ CSC, the CSC constructors ---------------------------------


@pytest.mark.parametrize("n,m,k,at,bt,expected", SMSMM_CASES)
def test_smsmm_golden(n, m, k, at, bt, expected):
    ja = st.csr_from_triples(n, m, at, dtype=np.int64)
    jb = st.csc_from_triples(m, k, bt, dtype=np.int64)
    ta = pt.csr_from_triples(n, m, at, dtype=torch.int64, device="cpu")
    tb = pt.csc_from_triples(m, k, bt, dtype=torch.int64, device="cpu")
    np.testing.assert_array_equal(_np(tb.indptr), np.asarray(jb.indptr))
    ref = jsg.spgemm(ja, jb)
    for got in (pt.spgemm(ta, tb), ta @ tb):
        assert isinstance(got, pt.CSR) and got.dtype == torch.int64
        np.testing.assert_array_equal(_np(got.todense()), expected)
        _assert_same_csr(got, ref, np.int64)


def test_csc_constructors_match_reference():
    x = _random(7, 5, 0.4, seed=3)
    jc, tc = st.csc_from_dense(jnp.asarray(x)), pt.csc_from_dense(
        torch.from_numpy(x), device="cpu")
    assert tc.shape == jc.shape == (7, 5)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    np.testing.assert_array_equal(_np(pt.csc_todense(tc)), x)
    jo, to = st.csc_to_coo(jc), pt.csc_to_coo(tc)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(_np(getattr(to, f)),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    tc2 = pt.csc_from_coo(to)
    np.testing.assert_array_equal(_np(pt.csc_todense(tc2)), x)
    empty = pt.csr_empty(3, 4, 2, torch.float64, device="cpu")
    assert empty.nse == 2 and int(empty.indptr[-1]) == 0
    np.testing.assert_array_equal(_np(empty.todense()), np.zeros((3, 4)))


def test_csr_matmul_csc_operator():
    """``CSR @ CSC`` is SpGEMM, as in the reference (sparse_tpu/formats/
    csr.py:112-116)."""
    A = pt.csr_from_triples(2, 2, [(0, 0, 1.0), (0, 1, 7.0), (1, 0, 2.0),
                                   (1, 1, 4.0)], device="cpu")
    B = pt.csc_from_triples(2, 2, [(0, 0, 3.0), (0, 1, 3.0), (1, 0, 5.0),
                                   (1, 1, 2.0)], device="cpu")
    np.testing.assert_array_equal(_np((A @ B).todense()),
                                  [[38.0, 17.0], [26.0, 14.0]])


# -- the three cores against the reference ------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_esc_core_matches_reference(dtype):
    x, y = _random(30, 25, 0.15, 1, dtype), _random(25, 35, 0.15, 2, dtype)
    (ja, ta), (jb, tb) = _csr_pair(x), _csr_pair(y)
    ref = jsg.spgemm(ja, jb, method="esc")
    got = pt.spgemm(ta, tb, method="esc")
    _assert_same_csr(got, ref, dtype)
    # the static-capacity core and the symbolic pass
    f = int(pt.spgemm_flops(ta, tb))
    assert f == int(jsg.spgemm_flops(ja, jb))
    _assert_same_csr(pt.spgemm_csr_csr(ta, tb, f),
                     jsg.spgemm_csr_csr(ja, jb, f), dtype)
    # a CSC operand is re-compressed by rows first
    jbc, tbc = _csc_pair(y)
    _assert_same_csr(pt.spgemm(ta, tbc, method="esc"),
                     jsg.spgemm(ja, jbc, method="esc"), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dense_core_matches_reference(dtype):
    x, y = _random(30, 25, 0.15, 5, dtype), _random(25, 35, 0.15, 6, dtype)
    (ja, ta), (jb, tb) = _csr_pair(x), _csr_pair(y)
    ref = jsg.spgemm(ja, jb, method="mxu")
    got = pt.spgemm(ta, tb, method="mxu")
    _assert_same_csr(got, ref, dtype)
    assert int(pt.spgemm_mxu_nse(ta, tb)) == int(jsg.spgemm_mxu_nse(ja, jb))
    # ESC and the dense core store the same structure
    _assert_same_csr(got, jsg.spgemm(ja, jb, method="esc"), dtype,
                     exact_capacity=False)
    # over-capacity pads, short capacity truncates row-major
    nse = got.nse
    for cap in (nse + 5, nse - 3):
        _assert_same_csr(pt.spgemm_mxu_csr_csr(ta, tb, cap),
                         jsg.spgemm_mxu_csr_csr(ja, jb, cap), dtype)


def _block_dense(n, bsz, block_density, seed):
    """Fully dense bsz x bsz blocks at sparse block positions (every masked
    position stored and non-zero, so the block fill is exactly 1.0), as the
    reference's tests/test_spgemm_spmm.py::_block_dense draws it."""
    rng = np.random.default_rng(seed)
    nb = n // bsz
    mask = np.kron((rng.random((nb, nb)) < block_density)
                   | np.eye(nb, dtype=bool), np.ones((bsz, bsz), bool))
    x = rng.standard_normal((n, n)) * mask
    return np.where(mask & (x == 0), 1.0, x)


@pytest.mark.parametrize("bsz", [4, 8])
def test_block_core_matches_reference(bsz):
    """The block route (re-block, block product, back to scalar CSR) on the
    CPU: ``bsr_smsmm_apply``, as the reference off its TPU."""
    n = 48
    x, y = _block_dense(n, bsz, 0.25, 3), _block_dense(n, bsz, 0.25, 4)
    (ja, ta), (jb, tb) = _csr_pair(x), _csr_pair(y)
    ref = jsg.spgemm(ja, jb, method="block", block_bsz=bsz)
    got = pt.spgemm(ta, tb, method="block", block_bsz=bsz)
    _assert_same_csr(got, ref, np.float64)
    _assert_same_csr(got, pt.spgemm(ta, tb, method="esc"), np.float64)
    np.testing.assert_allclose(_np(got.todense()), x @ y, rtol=1e-9,
                               atol=1e-9)
    with pytest.raises(ValueError, match="square"):
        pt.spgemm(_csr_pair(x[:n - 4])[1], tb, method="block")


# -- symbolic/numeric split ---------------------------------------------------


def _assert_same_plan(tp, jp):
    for f in ("a_pos", "b_pos", "seg", "indices", "indptr"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.shape == jp.shape


@pytest.mark.parametrize("operand", ["csr", "csc"])
def test_plan_matches_reference_and_updates(operand):
    x, y = _random(12, 18, 0.3, 29), _random(18, 9, 0.3, 30)
    ja, ta = _csr_pair(x)
    jb, tb = _csc_pair(y) if operand == "csc" else _csr_pair(y)
    jp, tp = jsg.spgemm_prepare(ja, jb), pt.spgemm_prepare(ta, tb)
    _assert_same_plan(tp, jp)
    got = pt.spgemm_apply(tp, ta, tb)
    _assert_same_csr(got, jsg.spgemm_apply(jp, ja, jb), np.float64)
    np.testing.assert_allclose(_np(got.todense()), x @ y, rtol=1e-12,
                               atol=1e-12)
    # same pattern, fresh values: no re-prepare
    ta2 = dataclasses.replace(ta, data=ta.data * 3.0)
    tb2 = dataclasses.replace(tb, data=tb.data * -0.5)
    np.testing.assert_allclose(_np(pt.spgemm_apply(tp, ta2, tb2).todense()),
                               -1.5 * (x @ y), rtol=1e-12, atol=1e-12)
    # the reference's plan carried across
    carried = interop.spgemm_plan_from_arrays(
        jp.a_pos, jp.b_pos, jp.seg, jp.indices, jp.indptr, shape=jp.shape,
            device="cpu")
    _assert_same_csr(pt.spgemm_apply(carried, ta, tb), got, np.float64)


def test_plan_native_matches_numpy_path():
    """The native schedule and the NumPy branch give identical plans."""
    x, y = _random(60, 45, 0.15, 33), _random(45, 70, 0.15, 34)
    _, ta = _csr_pair(x)
    for tb in (_csr_pair(y)[1], pt.csc_from_dense(torch.from_numpy(y),
                                                  device="cpu")):
        p_native = pt.spgemm_prepare(ta, tb)
        with mock.patch("sparse_tpu_torch.native.plansort._lib", None), \
             mock.patch("sparse_tpu_torch.native.plansort._tried", True):
            p_np = pt.spgemm_prepare(ta, tb)
        _assert_same_plan(p_native, p_np)


def test_cancellation_empty_and_truncation():
    # cancellation keeps the stored slot (explicit zero), nnz counts 0
    A = pt.csr_from_triples(1, 2, [(0, 0, 1.0), (0, 1, 1.0)], device="cpu")
    B = pt.csc_from_triples(2, 1, [(0, 0, 1.0), (1, 0, -1.0)], device="cpu")
    for C in (pt.spgemm(A, B), pt.spgemm(A, B, method="mxu"),
              pt.spgemm(A, B, method="esc"),
              pt.spgemm_apply(pt.spgemm_prepare(A, B), A, B)):
        np.testing.assert_array_equal(_np(C.todense()), [[0.0]])
        assert int(pt.csr_nnz(C)) == 0 and int(C.indptr[-1]) == 1
    # an empty operand
    E = pt.csr_from_triples(3, 4, [], dtype=torch.float64, device="cpu")
    B4 = pt.csr_from_triples(4, 2, [(0, 0, 1.0)], dtype=torch.float64,
                             device="cpu")
    plan = pt.spgemm_prepare(E, B4)
    assert plan.nse_out == 0 and plan.n_products == 0
    np.testing.assert_array_equal(_np(pt.spgemm_apply(plan, E, B4).todense()),
                                  np.zeros((3, 2)))
    np.testing.assert_array_equal(_np(pt.spgemm(E, B4).todense()),
                                  np.zeros((3, 2)))
    # the dense core's capacity truncation drops the last row-major entry
    A2 = pt.csr_from_triples(2, 2, [(0, 0, 1.0), (0, 1, 7.0), (1, 0, 2.0),
                                    (1, 1, 4.0)], device="cpu")
    B2 = pt.csr_from_triples(2, 2, [(0, 0, 3.0), (0, 1, 3.0), (1, 0, 5.0),
                                    (1, 1, 2.0)], device="cpu")
    C = pt.spgemm_mxu_csr_csr(A2, B2, 3)
    np.testing.assert_array_equal(_np(C.todense()), [[38.0, 17.0],
                                                     [26.0, 0.0]])
    assert int(C.indptr[-1]) == 3
    # ints go to ESC under auto, exactly
    Ai = pt.csr_from_triples(2, 2, [(0, 0, 3), (1, 1, 4)], dtype=torch.int64,
                             device="cpu")
    Ci = pt.spgemm(Ai, Ai)
    assert Ci.dtype == torch.int64
    np.testing.assert_array_equal(_np(Ci.todense()), [[9, 0], [0, 16]])


# -- routing ------------------------------------------------------------------


def _route_both(x, y, mxu_budget):
    (ja, ta), (jb, tb) = _csr_pair(x), _csr_pair(y)
    got = tsg._spgemm_route(ta, tb, mxu_budget=mxu_budget)
    assert got == jsg._spgemm_route(ja, jb, mxu_budget=mxu_budget)
    return got


@pytest.fixture
def route_floor_one():
    """The block route's nnz floor lowered to 1 in both packages (the
    reference's routing tests emulate production sizes so)."""
    with mock.patch.object(jsg, "_BLOCK_ROUTE_MIN_NNZ", 1), \
         mock.patch.object(tsg, "_BLOCK_ROUTE_MIN_NNZ", 1):
        yield


def test_route_picks_mxu_block_esc(route_floor_one):
    n = 64
    x = _block_dense(n, 2, 0.3, seed=0)
    assert _route_both(x, x, None) == ("mxu", 0)
    assert _route_both(x, x, 10) == ("block", 2)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    assert _route_both(u, u, 10)[0] == "esc"
    assert _route_both(x, u, 10)[0] == "esc"  # both must be blocked


def test_route_bsz32_and_partial_fill(route_floor_one):
    n = 256
    x = _block_dense(n, 32, 0.3, seed=2)
    assert _route_both(x, x, 10) == ("block", 32)
    xp = x * (np.random.default_rng(7).random((n, n)) < 0.6)
    assert _route_both(xp, xp, 10)[0] == "esc"


# -- block SpGEMM on BSR ------------------------------------------------------


def _bsr_pair(x, bsz):
    """(reference BSR, port BSR) of the non-zero blocks of ``x``, in
    block-coordinate order, as ``bsr_from_dense`` stores them."""
    nb = x.shape[0] // bsz
    xb = x.reshape(nb, bsz, nb, bsz).transpose(0, 2, 1, 3).reshape(
        nb * nb, bsz, bsz)
    idx = np.flatnonzero(np.any(xb != 0, axis=(1, 2))).astype(np.int32)
    jx = jbsr.BSR(indices=jnp.asarray(idx), blocks=jnp.asarray(xb[idx]),
                  n=x.shape[0], bsz=bsz)
    return jx, interop.bsr_from_arrays(idx, xb[idx], x.shape[0], bsz,
                                       device="cpu")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_bsr_smvm_smsmm_golden(n):
    """blocked_square_regular_test.fut:144-166 (tests/test_bsr.py:178-189):
    the corner block times a diagonal, as matrix and as vector."""
    c = np.zeros((n, n))
    c[0, 0], c[0, 1], c[1, 0] = 1.0, 2.0, 3.0  # block (0, 0) at BSZ 2
    v = np.arange(n) + 2.0
    v[0] = 10.0
    (_, tc), (_, tk) = _bsr_pair(c, 2), _bsr_pair(np.diag(v), 2)
    np.testing.assert_allclose(_np(pt.bsr_smsmm(tc, tk).todense()),
                               c @ np.diag(v), rtol=1e-12)
    np.testing.assert_allclose(_np((tc @ tk).todense()), c @ np.diag(v),
                               rtol=1e-12)
    np.testing.assert_allclose(_np(tc @ torch.from_numpy(v)), c @ v,
                               rtol=1e-12)


@pytest.mark.parametrize("n,bsz,density", [(8, 2, 0.5), (16, 4, 0.3),
                                           (32, 8, 0.2)])
def test_bsr_matmul_matches_reference(n, bsz, density):
    rng = np.random.default_rng(int(n * bsz * density * 100))
    nb = n // bsz
    xa = rng.standard_normal((n, n)) * np.kron(rng.random((nb, nb)) < density,
                                               np.ones((bsz, bsz)))
    xb = rng.standard_normal((n, n)) * np.kron(rng.random((nb, nb)) < density,
                                               np.ones((bsz, bsz)))
    (ja, ta), (jb, tb) = _bsr_pair(xa, bsz), _bsr_pair(xb, bsz)
    ref = jbsr.bsr_smsmm(ja, jb)
    got = pt.bsr_smsmm(ta, tb)
    np.testing.assert_array_equal(_np(got.indices), np.asarray(ref.indices))
    np.testing.assert_allclose(_np(got.blocks), np.asarray(ref.blocks),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(got.todense()), xa @ xb, rtol=1e-10,
                               atol=1e-10)
    # static capacity: padded with sentinel blocks
    core = pt.bsr_smsmm_core(ta, tb, 64)
    assert core.nbz == 64
    np.testing.assert_allclose(_np(core.todense()), xa @ xb, rtol=1e-10,
                               atol=1e-10)
    v = rng.standard_normal(n)
    np.testing.assert_allclose(_np(pt.bsr_smvm(ta, torch.from_numpy(v))),
                               np.asarray(jbsr.bsr_smvm(ja, jnp.asarray(v))),
                               rtol=1e-12, atol=1e-12)


def test_bsr_plan_matches_and_updates():
    """tests/test_bsr.py:277-311: the prepared pair against ``bsr_smsmm``,
    a value update, and an empty operand."""
    rng = np.random.default_rng(71)
    n, bsz = 24, 4
    nb = n // bsz
    xa = rng.standard_normal((n, n)) * np.kron(rng.random((nb, nb)) < 0.4,
                                               np.ones((bsz, bsz)))
    xb = rng.standard_normal((n, n)) * np.kron(rng.random((nb, nb)) < 0.4,
                                               np.ones((bsz, bsz)))
    (ja, ta), (jb, tb) = _bsr_pair(xa, bsz), _bsr_pair(xb, bsz)
    jp, tp = jbsr.bsr_smsmm_prepare(ja, jb), pt.bsr_smsmm_prepare(ta, tb)
    for f in ("a_pos", "b_pos", "seg", "indices"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    c = pt.bsr_smsmm_apply(tp, ta, tb)
    np.testing.assert_allclose(_np(c.blocks),
                               np.asarray(jbsr.bsr_smsmm_apply(jp, ja,
                                                               jb).blocks),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(c.todense()),
                               _np(pt.bsr_smsmm(ta, tb).todense()),
                               rtol=1e-12)
    ta2 = dataclasses.replace(ta, blocks=ta.blocks * -2.0)
    np.testing.assert_allclose(_np(pt.bsr_smsmm_apply(tp, ta2, tb).todense()),
                               -2.0 * (xa @ xb), rtol=1e-10, atol=1e-10)
    carried = interop.bsr_smsmm_plan_from_arrays(
        jp.a_pos, jp.b_pos, jp.seg, jp.indices, n=jp.n, bsz=jp.bsz,
            device="cpu")
    torch.testing.assert_close(pt.bsr_smsmm_apply(carried, ta, tb).blocks,
                               c.blocks, rtol=0, atol=0)
    z = pt.bsr_zero(n, bsz, device="cpu")
    pz = pt.bsr_smsmm_prepare(z, tb)
    assert pz.n_products == 0 and pz.nbz_out == 0
    np.testing.assert_array_equal(_np(pt.bsr_smsmm_apply(pz, z, tb).todense()),
                                  np.zeros((n, n)))
    # integer blocks sum exactly
    ti = dataclasses.replace(ta, blocks=(ta.blocks * 8).round().long())
    want = (_np(ti.todense()).astype(np.int64) @ np.round(xb).astype(
        np.int64))
    tbi = dataclasses.replace(tb, blocks=tb.blocks.round().long())
    np.testing.assert_array_equal(_np(pt.bsr_smsmm_apply(tp, ti,
                                                         tbi).todense()),
                                  want)


# -- the slice as a whole -----------------------------------------------------


def test_spgemm_block_path_runs_the_slab_apply(route_floor_one):
    """``spgemm(a, a)`` on a CSR of dense 8x8 blocks takes the block route
    and, with the slab backend on (as on a CUDA device), runs the slab
    apply: here its plain version, since the tensors lie on the CPU.  The
    reference's stored structure exactly, its values at 1e-5."""
    n, bsz = 64, 8
    x = _block_dense(n, bsz, 0.3, seed=11).astype(np.float32)
    ja, ta = _csr_pair(x)
    calls = []
    plain = tcb.run_slabs_arrays_plain

    def spy(*args, **kw):
        calls.append(kw["bsz"])
        return plain(*args, **kw)

    with mock.patch.object(jsg, "_MXU_DENSE_ELEMS", 10), \
         mock.patch.object(tsg, "_MXU_DENSE_ELEMS", 10), \
         mock.patch.object(tsg, "_spgemm_block", functools.partial(
             tsg._spgemm_block, use_slab=True)), \
         mock.patch.object(tcb, "run_slabs_arrays_plain", spy):
        assert tsg._spgemm_route(ta, ta) == ("block", bsz)
        got = pt.spgemm(ta, ta)
        ref = jsg.spgemm(ja, ja)
    assert calls == [bsz]
    _assert_same_csr(got, ref, np.float32)
    _assert_same_csr(got, pt.spgemm(ta, ta, method="esc"), np.float32,
                     exact_capacity=False)
    dx = x.astype(np.float64)
    np.testing.assert_allclose(_np(got.todense()), dx @ dx, rtol=1e-4,
                               atol=1e-4)
