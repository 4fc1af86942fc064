"""The PyTorch port's COO/CSR core against the reference package.

Same inputs, made from numpy seeds, go through ``sparse_tpu`` (JAX, CPU,
x64 as set by conftest) and ``sparse_tpu_torch`` (CPU tensors); integer
structure must match exactly and float64 values within 1e-12.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.ops import segmented as jseg
from sparse_tpu_torch import _kernels, interop
from sparse_tpu_torch.ops import segmented as tseg
from sparse_tpu_torch.ops.dispatch import smvm_prepare

ROOT = Path(__file__).resolve().parents[1]
DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_coo(n, m, nse, seed, dup_frac=0.4, pad=3):
    """Random triples with duplicates plus sentinel padding entries."""
    rng = np.random.default_rng(seed)
    base = nse - int(nse * dup_frac)
    r = rng.integers(0, n, base)
    c = rng.integers(0, m, base)
    dup = rng.integers(0, base, nse - base)
    r = np.concatenate([r, r[dup], np.full(pad, n)])
    c = np.concatenate([c, c[dup], np.full(pad, m)])
    v = np.concatenate([rng.standard_normal(nse), np.zeros(pad)])
    p = rng.permutation(r.size)
    return r[p], c[p], v[p]


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_readme_fixture(np_dt, t_dt):
    """README / BASELINE config 1: sparse 2 3 [(0,0,2),(1,2,3)] . [10,20,30]
    = [20, 90], through csr_smvm and through the dispatch main path."""
    triples = [(0, 0, 2), (1, 2, 3)]
    a = pt.csr_from_triples(2, 3, triples, dtype=np_dt)
    v = torch.tensor([10, 20, 30], dtype=t_dt)
    ref = st.csr_smvm(st.csr_from_triples(2, 3, triples, dtype=np_dt),
                      jnp.asarray(_np(v)))
    for y in (pt.csr_smvm(a, v), smvm_prepare(a).apply(v),
              smvm_prepare(a, prefer="segtile").apply(v)):
        assert y.dtype == t_dt
        np.testing.assert_array_equal(_np(y), [20, 90])
    np.testing.assert_array_equal(np.asarray(ref), [20, 90])


@pytest.mark.parametrize("np_dt,t_dt", DTYPES + [(np.int32, torch.int32)])
def test_smvm_5x5_golden(np_dt, t_dt):
    """compressed_test.fut:48-59: [71, 11, 59, 48, 104]."""
    rows = [0, 0, 0, 1, 1, 2, 2, 2, 3, 4, 4]
    cols = [0, 1, 3, 1, 2, 1, 2, 3, 3, 3, 4]
    vals = [1, 2, 11, 3, 4, 5, 6, 7, 8, 9, 10]
    a = pt.csr_from_triples(5, 5, zip(rows, cols, vals), dtype=np_dt)
    v = torch.tensor([3, 1, 2, 6, 5], dtype=t_dt)
    np.testing.assert_array_equal(_np(pt.csr_smvm(a, v)),
                                  [71, 11, 59, 48, 104])
    if t_dt != torch.int32:
        for kind in ("segtile", "xla", "blockseg"):
            p = smvm_prepare(a, prefer=kind)
            np.testing.assert_array_equal(_np(p.apply(v)),
                                          [71, 11, 59, 48, 104])


def test_duplicates_sum_and_bounds():
    a = pt.csr_from_triples(2, 2, [(0, 0, 1.0), (0, 0, 2.5), (1, 1, -1.0),
                                   (0, 0, 0.5)])
    np.testing.assert_array_equal(_np(pt.csr_todense(a)),
                                  [[4.0, 0.0], [0.0, -1.0]])
    assert a.nse == 4 and int(a.indptr[-1]) == 2
    with pytest.raises(ValueError, match="out of bounds"):
        pt.csr_from_triples(2, 3, [(2, 0, 1.0)])
    with pytest.raises(ValueError, match="out of bounds"):
        pt.csr_from_triples(2, 3, [(0, 3, 1.0)])


def test_stored_zero_nnz():
    """Entries summing to zero stay stored but do not count in nnz
    (PARITY.md C2/C3, compressed.fut:162-164)."""
    triples = [(0, 0, 1.0), (0, 0, -1.0), (1, 2, 3.0), (1, 0, 0.0)]
    a = pt.csr_from_triples(2, 3, triples)
    ja = st.csr_from_triples(2, 3, triples)
    assert int(pt.csr_nnz(a)) == int(st.csr_nnz(ja)) == 1
    assert int(a.indptr[-1]) == int(ja.indptr[-1]) == 3
    coo, jcoo = pt.coo_from_triples(2, 3, triples), \
        st.coo_from_triples(2, 3, triples)
    assert int(pt.coo_nnz(coo)) == int(st.coo_nnz(jcoo)) == 3
    assert int(pt.coo_nnz(pt.coo_normalize(coo))) == 1


def test_transpose_is_o1():
    a = pt.csr_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)])
    t = pt.csr_transpose(a)
    assert t.shape == (3, 2)
    assert t.data is a.data and t.indices is a.indices \
        and t.indptr is a.indptr
    assert pt.csc_transpose(t).shape == (2, 3)
    np.testing.assert_array_equal(_np(t.todense()), _np(a.todense()).T)
    v = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    np.testing.assert_array_equal(_np(pt.csc_vsmm(v, t)),
                                  _np(v) @ _np(t.todense()))


@pytest.mark.parametrize("n,m,nse,seed", [
    (7, 5, 40, 0),
    (30, 45, 200, 1),
    (64, 3, 100, 2),
    (1, 1, 6, 3),
])
def test_normalize_and_csr_match_reference(n, m, nse, seed):
    r, c, v = _random_coo(n, m, nse, seed)
    ta = pt.coo_make((n, m), r, c, torch.from_numpy(v))
    ja = st.coo_make((n, m), r, c, jnp.asarray(v))
    tn, jn = pt.coo_normalize(ta), st.coo_normalize(ja)
    # the reference's own COO carried across normalizes the same way
    cn = pt.coo_normalize(interop.coo_from_arrays(ja.row, ja.col, ja.data,
                                                  ja.shape))
    for t in (tn, cn):
        np.testing.assert_array_equal(_np(t.row), np.asarray(jn.row))
        np.testing.assert_array_equal(_np(t.col), np.asarray(jn.col))
        np.testing.assert_allclose(_np(t.data), np.asarray(jn.data), rtol=0,
                                   atol=1e-12)
    tc, jc = pt.csr_from_coo(ta), st.csr_from_coo(ja)
    np.testing.assert_array_equal(_np(tc.indptr), np.asarray(jc.indptr))
    np.testing.assert_array_equal(_np(tc.indices), np.asarray(jc.indices))
    np.testing.assert_allclose(_np(tc.data), np.asarray(jc.data), rtol=0,
                               atol=1e-12)
    ts = pt.coo_sort(ta)
    js = st.coo_sort(ja)
    np.testing.assert_array_equal(_np(ts.row), np.asarray(js.row))
    np.testing.assert_array_equal(_np(ts.col), np.asarray(js.col))
    np.testing.assert_allclose(_np(pt.coo_todense(ta)),
                               np.asarray(st.coo_todense(ja)), atol=1e-12)
    x = np.random.default_rng(seed).standard_normal(m)
    np.testing.assert_allclose(
        _np(pt.csr_smvm(tc, torch.from_numpy(x))),
        np.asarray(st.csr_smvm(jc, jnp.asarray(x))), rtol=0, atol=1e-12)
    tco, jco = pt.csr_to_coo(tc), st.csr_to_coo(jc)
    np.testing.assert_array_equal(_np(tco.row), np.asarray(jco.row))
    np.testing.assert_array_equal(_np(tco.col), np.asarray(jco.col))


@pytest.mark.parametrize("nse", [None, 30])
def test_from_dense_matches_reference(nse):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4)) * (rng.random((6, 4)) < 0.4)
    tc = pt.coo_from_dense(torch.from_numpy(x), nse=nse)
    jc = st.coo_from_dense(jnp.asarray(x), nse=nse)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)))
    np.testing.assert_array_equal(_np(pt.csr_from_dense(
        torch.from_numpy(x)).todense()), x)


def test_smvm_bitwise_repeatable():
    """tests/test_determinism.py's bar, on the port."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.3)
    a = pt.csr_from_dense(torch.from_numpy(x))
    v = torch.from_numpy(rng.standard_normal(64))
    outs = [_np(pt.csr_smvm(a, v)) for _ in range(3)]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_primitives_match_reference(sorted_ids):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 12, 200)
    if sorted_ids:
        ids = np.sort(ids)
    ids[-3:] = 12  # sentinel: dropped
    data = rng.standard_normal((200, 3))
    got = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 12,
                           indices_are_sorted=sorted_ids)
    ref = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 12,
                           indices_are_sorted=sorted_ids)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-12)
    sizes = np.array([2, 0, 3, 1, 0], np.int32)
    for total in (6, 9):
        np.testing.assert_array_equal(
            _np(tseg.repeated_iota(torch.from_numpy(sizes), total)),
            np.asarray(jseg.repeated_iota(jnp.asarray(sizes), total)))
        te, ti = tseg.expand(torch.from_numpy(sizes), total)
        je, ji = jseg.expand(jnp.asarray(sizes), total)
        np.testing.assert_array_equal(_np(te), np.asarray(je))
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(
        _np(tseg.cumsum_exclusive(torch.from_numpy(sizes))),
        np.asarray(jseg.cumsum_exclusive(jnp.asarray(sizes))))
    indptr = np.array([0, 2, 2, 5], np.int32)
    np.testing.assert_array_equal(
        _np(tseg.row_ids_from_indptr(torch.from_numpy(indptr), 7)),
        np.asarray(jseg.row_ids_from_indptr(jnp.asarray(indptr), 7)))


def test_import_loads_no_jax():
    code = ("import sys, sparse_tpu_torch, sparse_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sparse_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building or loading the kernels raises — nothing falls
    back to the plain versions."""
    monkeypatch.setattr(_kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path)
    monkeypatch.setattr(_kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.load()
    assert not any(tmp_path.iterdir())
