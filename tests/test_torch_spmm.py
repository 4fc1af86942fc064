"""The sparse x dense products of the PyTorch port against the reference:
``spmm``/``dsmm`` (``sparse_tpu/ops/spmm.py``), the row-binned
``csr_spmm_ell``/``csr_spmm_fast`` and the ``row_chunk`` of
``csr_smvm_fast``/``csr_spmm_fast`` (``sparse_tpu/ops/spmv.py``), and
``bsr_smvm_ell``/``bsr_spmm_ell`` (``sparse_tpu/ops/bsr_ell.py``).

Inputs are numpy-seeded and carried to the port through ``interop``.
Tolerances, times ``|A||B|`` per element: float32 1e-5, float64 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.ops import bsr_ell as jbe
from sparse_tpu.ops import spmm as jsm
from sparse_tpu.ops import spmv as jsv
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import csr as tcsr

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, ref, x, b, dtype):
    bound = TOL[dtype] * (np.abs(x).astype(np.float64) @ np.abs(
        np.asarray(b, np.float64)))
    err = np.abs(_np(got).astype(np.float64) - _np(ref).astype(np.float64))
    assert err.shape == bound.shape
    assert np.all(err <= bound), (err - bound).max()


def _matrix(n, m, density, seed, dtype, long_rows=()):
    """Dense (n, m) with a few long rows (several length bins) and empty
    rows; returns (dense, reference CSR, port CSR) from the same arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)) * (rng.random((n, m)) < density)
    for r in long_rows:
        x[r] = rng.standard_normal(m)
    x[1::7] = 0.0
    x = x.astype(dtype)
    ja = st.csr_from_dense(jnp.asarray(x))
    ta = interop.csr_from_arrays(ja.data, ja.indices, ja.indptr, ja.shape,
                                 device="cpu")
    return x, ja, ta


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,k", [(40, 30, 5), (64, 64, 1)])
def test_spmm_and_dsmm_match_reference(n, m, k, dtype):
    x, ja, ta = _matrix(n, m, 0.2, seed=n + k, dtype=dtype)
    b = np.random.default_rng(k).standard_normal((m, k)).astype(dtype)
    got = pt.spmm(ta, torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(b).dtype
    _assert_close(got, jsm.spmm(ja, jnp.asarray(b)), x, b, dtype)
    _assert_close(got, x.astype(np.float64) @ b, x, b, dtype)
    _assert_close(ta @ torch.from_numpy(b), got, x, b, dtype)
    # dense x sparse through the CSC view of the same storage
    bl = np.random.default_rng(k + 1).standard_normal((k, m)).astype(dtype)
    xc = x.T  # a CSC of shape (m, n) stores the CSR of its transpose
    tc, jc = tcsr.csr_transpose(ta), st.csr_transpose(ja)
    got = pt.dsmm(torch.from_numpy(bl), tc)
    ref = np.asarray(jsm.dsmm(jnp.asarray(bl), jc))
    assert got.shape == ref.shape == (k, n)
    _assert_close(got.T, ref.T, xc.T, bl.T, dtype)
    with pytest.raises(ValueError, match="operand shape"):
        pt.spmm(ta, torch.zeros(m + 1, k))
    with pytest.raises(ValueError, match="operand shape"):
        pt.dsmm(torch.zeros(k, m + 1), tc)


def test_spmm_at_the_entry_shape():
    """``__graft_entry__.entry()``'s forward step: 512 x 512 at 5 % fill,
    k = 64, float32."""
    fn, (ja, jb) = __graft_entry__.entry()
    ta = interop.csr_from_arrays(ja.data, ja.indices, ja.indptr, ja.shape,
                                 device="cpu")
    b = np.array(jb)
    got = pt.spmm(ta, torch.from_numpy(b))
    assert got.shape == (512, 64) and got.dtype == torch.float32
    x = np.asarray(st.csr_todense(ja))
    _assert_close(got, fn(ja, jb), x, b, np.float32)
    _assert_close(got, x.astype(np.float64) @ b, x, b, np.float32)
    again = pt.spmm(ta, torch.from_numpy(b))
    assert torch.equal(got, again)  # deterministic segment sums


@pytest.mark.parametrize("row_chunk", [None, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_row_binned_spmm_and_row_chunk_match_reference(row_chunk, dtype):
    x, ja, ta = _matrix(50, 40, 0.15, seed=3, dtype=dtype,
                        long_rows=(4, 30))
    b = np.random.default_rng(4).standard_normal((40, 6)).astype(dtype)
    v = np.random.default_rng(5).standard_normal(40).astype(dtype)
    jplan = jsv.build_spmv_plan(ja)
    assert len(jplan.bin_sizes) >= 3
    got = pt.csr_spmm_fast(ta, torch.from_numpy(b), row_chunk=row_chunk)
    ref = jsv.csr_spmm_fast(ja, jnp.asarray(b), jplan, row_chunk=row_chunk)
    _assert_close(got, ref, x, b, dtype)
    _assert_close(got, x.astype(np.float64) @ b, x, b, dtype)
    # the SpMV row_chunk the port lacked: same call as the reference
    got_v = pt.csr_smvm_fast(ta, torch.from_numpy(v), row_chunk=row_chunk)
    ref = jsv.csr_smvm_fast(ja, jnp.asarray(v), jplan, row_chunk=row_chunk)
    _assert_close(got_v[:, None], np.asarray(ref)[:, None], x, v[:, None],
                  dtype)
    # chunks of one row, and one chunk larger than every bin
    for chunk in (1, 1000):
        _assert_close(pt.csr_spmm_fast(ta, torch.from_numpy(b),
                                       row_chunk=chunk), got, x, b, dtype)
        _assert_close(pt.csr_smvm_fast(ta, torch.from_numpy(v),
                                       row_chunk=chunk)[:, None],
                      got_v[:, None], x, v[:, None], dtype)
    L = pt.row_capacity(ta)
    assert L == jsv.row_capacity(ja) == 40
    got = pt.csr_spmm_ell(ta, torch.from_numpy(b), L)
    _assert_close(got, jsv.csr_spmm_ell(ja, jnp.asarray(b), L), x, b, dtype)


def test_row_chunk_rejects_nonpositive_and_bad_operands():
    x, _, ta = _matrix(10, 10, 0.3, seed=6, dtype=np.float64)
    with pytest.raises(ValueError, match="row_chunk"):
        pt.csr_smvm_fast(ta, torch.ones(10, dtype=torch.float64),
                         row_chunk=0)
    with pytest.raises(ValueError, match="operand shape"):
        pt.csr_spmm_fast(ta, torch.ones(9, 2))
    assert pt.csr_spmm_fast(ta, torch.ones(10, 0)).shape == (10, 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_ell_matches_reference(dtype):
    rng = np.random.default_rng(8)
    nb, bsz = 12, 4
    mask = rng.random((nb, nb)) < 0.3
    mask[3] = False  # an empty block row
    x = (rng.standard_normal((nb * bsz, nb * bsz))
         * np.kron(mask, np.ones((bsz, bsz)))).astype(dtype)
    jb = st.bsr_from_dense(jnp.asarray(x), bsz)
    tb = interop.bsr_from_arrays(jb.indices, jb.blocks, jb.n, jb.bsz,
                                 device="cpu")
    Lb = pt.bsr_row_capacity(tb)
    assert Lb == jbe.bsr_row_capacity(jb) == int(mask.sum(1).max())
    b = rng.standard_normal((nb * bsz, 7)).astype(dtype)
    v = b[:, 0].copy()
    got = pt.bsr_spmm_ell(tb, torch.from_numpy(b), Lb)
    _assert_close(got, jbe.bsr_spmm_ell(jb, jnp.asarray(b), Lb), x, b, dtype)
    _assert_close(got, x.astype(np.float64) @ b, x, b, dtype)
    got = pt.bsr_smvm_ell(tb, torch.from_numpy(v), Lb)
    _assert_close(got[:, None], np.asarray(jbe.bsr_smvm_ell(
        jb, jnp.asarray(v), Lb))[:, None], x, v[:, None], dtype)
    with pytest.raises(ValueError, match="operand shape"):
        pt.bsr_spmm_ell(tb, torch.from_numpy(b[:-1]), Lb)
    with pytest.raises(ValueError, match="vector shape"):
        pt.bsr_smvm_ell(tb, torch.from_numpy(v[:-1]), Lb)
