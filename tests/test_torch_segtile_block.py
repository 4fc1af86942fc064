"""K2 — the 2x2 block-granule segment-tile SpMV — and the BSR / reorder
modules of the PyTorch port against the reference
(``sparse_tpu/ops/pallas_csr_block.py`` in interpret mode).

Tolerances: float64 1e-12 and float32 1e-5, both times ``|A||v|`` per row.
The kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.formats import bsr as jbsr
from sparse_tpu.ops import pallas_csr_block as jpb
from sparse_tpu.ops import reorder as jro
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.ops import cuda_csr_block as tpb
from sparse_tpu_torch.ops import reorder as tro

TOL = {np.float32: 1e-5, np.float64: 1e-12}
PLAN_META = ("n", "nb", "bsz", "n_tiles", "fill", "chunks", "wsub", "kstep")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _block_matrix(nb, seed, per_row=4, bw=6, scramble=True, bsz=2):
    """Fully-dense-block banded pattern, optionally node-scrambled."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((nb, nb), bool)
    for i in range(nb):
        js = np.clip(i + rng.integers(-bw, bw + 1, size=per_row), 0, nb - 1)
        mask[i, js] = True
    full = np.kron(mask, np.ones((bsz, bsz), bool))
    x = np.where(full, rng.standard_normal((nb * bsz, nb * bsz)), 0.0)
    x = np.where(full & (x == 0), 0.5, x)
    if scramble:
        pb = rng.permutation(nb)
        ps = (pb[:, None] * bsz + np.arange(bsz)).reshape(-1)
        x = x[np.ix_(ps, ps)]
    return x


def _pair(x, dtype=np.float64):
    s = sp.csr_matrix(x.astype(dtype))
    ja = st.CSR(data=jnp.asarray(s.data), indices=jnp.asarray(
        s.indices.astype(np.int32)), indptr=jnp.asarray(
        s.indptr.astype(np.int32)), shape=s.shape)
    ta = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                 device="cpu")
    return s, ja, ta


def _assert_close(got, ref, s, v, dtype):
    bound = TOL[dtype] * (abs(s) @ np.abs(v))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= bound), (err - bound).max()


def _assert_same_plan(tp, jp):
    for f in ("vals", "q", "seg_of", "rb"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in PLAN_META:
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("wsub", [8, 16])
@pytest.mark.parametrize("nb,bw", [(64, 6), (300, 200)])
def test_block_plan_matches_reference(nb, bw, wsub):
    _, ja, ta = _pair(_block_matrix(nb, seed=nb, bw=bw, scramble=False))
    tab, jab = tbsr.csr_to_bsr(ta, 2), jbsr.csr_to_bsr(ja, 2)
    np.testing.assert_array_equal(_np(tab.indices), np.asarray(jab.indices))
    np.testing.assert_array_equal(_np(tab.blocks), np.asarray(jab.blocks))
    tp = tpb.build_seg_tiles_block(tab, wsub=wsub, refreshable=True)
    jp = jpb.build_seg_tiles_block(jab, wsub=wsub, refreshable=True)
    _assert_same_plan(tp, jp)
    np.testing.assert_array_equal(_np(tp.pos), np.asarray(jp.pos))
    np.testing.assert_array_equal(_np(tp.eidx), np.asarray(jp.eidx))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_smvm_matches_reference(dtype):
    x = _block_matrix(64, seed=1, bw=20, scramble=False)
    s, ja, ta = _pair(x, dtype)
    tab, jab = tbsr.csr_to_bsr(ta, 2), jbsr.csr_to_bsr(ja, 2)
    v = np.random.default_rng(2).standard_normal(128).astype(dtype)
    tp = tpb.build_seg_tiles_block(tab, wsub=16)
    got = _np(tpb.bsr_smvm_segtile_block(tab, torch.from_numpy(v), tp))
    ref = np.asarray(jpb.bsr_smvm_segtile_block(
        jab, jnp.asarray(v), jpb.build_seg_tiles_block(jab, wsub=16),
        interpret=True))
    assert got.dtype == dtype
    _assert_close(got, ref, s, v, dtype)
    _assert_close(got, x @ v.astype(np.float64), s, v, dtype)
    with pytest.raises(ValueError, match="shape"):
        tpb.bsr_smvm_segtile_block(tab, torch.zeros(5), tp)


def test_reference_block_plan_through_interop():
    x = _block_matrix(48, seed=3, scramble=False)
    s, ja, _ = _pair(x)
    jab = jbsr.csr_to_bsr(ja, 2)
    jp = jpb.build_seg_tiles_block(jab, wsub=8)
    tab = interop.bsr_from_arrays(jab.indices, jab.blocks, jab.n, jab.bsz,
                                  device="cpu")
    tp = interop.block_seg_tile_plan_from_arrays(
        jp.vals, jp.q, jp.seg_of, jp.rb,
        **{f: getattr(jp, f) for f in PLAN_META}, device="cpu")
    v = np.random.default_rng(4).standard_normal(96)
    got = _np(tpb.bsr_smvm_segtile_block(tab, torch.from_numpy(v), tp))
    ref = np.asarray(jpb.bsr_smvm_segtile_block(jab, jnp.asarray(v), jp,
                                                interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_block_refresh_and_length_check():
    x = _block_matrix(40, seed=5, scramble=False)
    _, ja, ta = _pair(x)
    tab, jab = tbsr.csr_to_bsr(ta, 2), jbsr.csr_to_bsr(ja, 2)
    tp = tpb.build_seg_tiles_block(tab, refreshable=True)
    jp = jpb.build_seg_tiles_block(jab, refreshable=True)
    new = np.asarray(jab.blocks) * 1.75
    tp2 = tpb.block_seg_tiles_refresh(tp, torch.from_numpy(new))
    jp2 = jpb.block_seg_tiles_refresh(jp, jnp.asarray(new))
    np.testing.assert_array_equal(_np(tp2.vals), np.asarray(jp2.vals))
    with pytest.raises(ValueError, match="refreshable"):
        tpb.block_seg_tiles_refresh(tpb.build_seg_tiles_block(tab),
                                    torch.from_numpy(new))
    with pytest.raises(ValueError, match="entries"):
        tpb.block_seg_tiles_refresh(tp, torch.from_numpy(new[:-1]))
    with pytest.raises(ValueError, match="bsz"):
        tpb.build_seg_tiles_block(tbsr.csr_to_bsr(ta, 4))


def test_rcm_blocked_and_permute_match_reference():
    x = _block_matrix(48, seed=0)
    _, ja, ta = _pair(x)
    perm = tro.rcm_order_blocked(ta, 2)
    np.testing.assert_array_equal(perm, jro.rcm_order_blocked(ja, 2))
    pairs = perm.reshape(-1, 2)
    assert np.array_equal(pairs[:, 1], pairs[:, 0] + 1)
    ap, jap = tro.csr_permute(ta, perm, perm), jro.csr_permute(ja, perm, perm)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(_np(getattr(ap, f)),
                                      np.asarray(getattr(jap, f)))
    assert tro.csr_bandwidth(ap) == jro.csr_bandwidth(jap) \
        < tro.csr_bandwidth(ta) / 3
    for a, b in zip(tro.block_perm_pair(perm, 2),
                    jro.block_perm_pair(perm, 2)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        tro.rcm_order_blocked(ta, 5)


def test_rcm_and_vector_permutes_match_reference():
    rng = np.random.default_rng(8)
    n = 150
    order = rng.permutation(n)
    x = np.zeros((n, n))
    for i in range(n):
        js = np.clip(i + rng.integers(-5, 6, size=4), 0, n - 1)
        x[order[i], order[js]] = rng.standard_normal(js.size)
    _, ja, ta = _pair(x)
    perm = tro.rcm_order(ta)
    np.testing.assert_array_equal(perm, jro.rcm_order(ja))
    indptr = _np(ta.indptr).astype(np.int64)
    cols = _np(ta.indices)[:indptr[-1]].astype(np.int64)
    np.testing.assert_array_equal(tro._rcm_numpy(indptr, cols, n), perm)
    tplan = tro.permute_prepare(ta, perm, perm)
    jplan = jro.permute_prepare(ja, perm, perm)
    np.testing.assert_array_equal(_np(tplan.src), np.asarray(jplan.src))
    v = rng.standard_normal(n)
    pv = tro.permute_vector(torch.from_numpy(v), perm)
    np.testing.assert_array_equal(_np(pv), np.asarray(
        jro.permute_vector(jnp.asarray(v), perm)))
    np.testing.assert_array_equal(_np(tro.unpermute_vector(pv, perm)), v)
    ap, p2 = tro.reorder_for_locality(ta)
    np.testing.assert_array_equal(p2, perm)
    with pytest.raises(ValueError, match="permutation"):
        tro.permute_prepare(ta, np.zeros(n, np.int64))


def test_bsr_conversions_match_reference():
    rng = np.random.default_rng(9)
    x = _block_matrix(20, seed=9, scramble=False)
    x[rng.random(x.shape) < 0.2] = 0.0  # zeros inside stored blocks
    _, ja, ta = _pair(x)
    for compact in (True, False):
        tb = tbsr.csr_to_bsr(ta, 2, compact=compact)
        jb = jbsr.csr_to_bsr(ja, 2, compact=compact)
        np.testing.assert_array_equal(_np(tb.indices), np.asarray(jb.indices))
        np.testing.assert_array_equal(_np(tb.blocks), np.asarray(jb.blocks))
    tb, jb = tbsr.csr_to_bsr(ta, 2), jbsr.csr_to_bsr(ja, 2)
    np.testing.assert_array_equal(_np(tbsr.bsr_todense(tb)), x)
    tc, jc = tbsr.bsr_to_csr(tb), jbsr.bsr_to_csr(jb)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)))
    to, jo = tbsr.bsr_to_coo(tb), jbsr.bsr_to_coo(jb)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(_np(getattr(to, f)),
                                      np.asarray(getattr(jo, f)))
    tf = tbsr.bsr_from_coo(pt.csr_to_coo(ta), 2)
    jf = jbsr.bsr_from_coo(st.csr_to_coo(ja), 2)
    np.testing.assert_array_equal(_np(tf.indices), np.asarray(jf.indices))
    np.testing.assert_array_equal(_np(tf.blocks), np.asarray(jf.blocks))
    tdev = tbsr.csr_to_bsr(ta, 2, nbz=tb.nbz)
    np.testing.assert_array_equal(_np(tdev.indices), _np(tb.indices))
    np.testing.assert_array_equal(_np(tbsr.bsr_compact(tf).blocks),
                                  _np(tb.blocks))


def test_wide_block_coordinates():
    """nb > BSR_MAX_NB: int64 block coordinates, as the reference under
    x64."""
    nb = tbsr.BSR_MAX_NB + 3
    n = 2 * nb
    r = np.array([0, 1, n - 2, n - 1, n - 1, 7])
    c = np.array([n - 1, n - 2, 0, 1, n - 1, 7])
    v = np.arange(1.0, 7.0)
    ta = pt.csr_from_coo(pt.coo_make((n, n), r, c, torch.from_numpy(v),
                                     device="cpu"))
    ja = st.csr_from_coo(st.coo_make((n, n), r, c, jnp.asarray(v)))
    tb, jb = tbsr.csr_to_bsr(ta, 2), jbsr.csr_to_bsr(ja, 2)
    assert tb.indices.dtype == torch.int64
    np.testing.assert_array_equal(_np(tb.indices), np.asarray(jb.indices))
    np.testing.assert_array_equal(_np(tb.blocks), np.asarray(jb.blocks))
    tp = tpb.build_seg_tiles_block(tb, wsub=8)
    xv = np.random.default_rng(10).standard_normal(n)
    s = sp.csr_matrix((v, (r, c)), shape=(n, n))
    got = _np(tpb.bsr_smvm_segtile_block(tb, torch.from_numpy(xv), tp))
    _assert_close(got, s @ xv, s, xv, np.float64)
