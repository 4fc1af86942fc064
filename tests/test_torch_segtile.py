"""K1 — the scalar segment-tile SpMV — in the PyTorch port against the
reference (``sparse_tpu/ops/pallas_csr.py``, Pallas in interpret mode).

On the CPU the port's wrappers run their plain versions; the kernel itself
is tested on the card by ``tests/test_torch_cuda.py``.
Tolerances: float64 1e-12 and float32 1e-5, both times ``|A||v|`` per row
(the two packages sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.ops import pallas_csr as jpc
from sparse_tpu.ops.hub_split import hub_split_prepare as j_hub_prepare
from sparse_tpu.ops.hub_split import hub_split_smvm as j_hub_smvm
from sparse_tpu_torch import interop
from sparse_tpu_torch.ops import cuda_csr as tpc
from sparse_tpu_torch.ops.hub_split import hub_split_prepare, hub_split_smvm

TOL = {np.float32: 1e-5, np.float64: 1e-12}
PLAN_ARRAYS = ("vals", "q", "seg_of", "rb")
PLAN_META = ("n", "m", "n_tiles", "fill", "chunks", "wsub", "rows", "kstep")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scipy_csr(n, m, nnz, seed, band=None):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    if band is None:
        c = rng.integers(0, m, nnz)
    else:
        c = np.clip(r + rng.integers(-band, band + 1, nnz), 0, m - 1)
    s = sp.coo_matrix((rng.standard_normal(nnz), (r, c)),
                      shape=(n, m)).tocsr()
    s.sum_duplicates()
    return s


def _pair(s, dtype):
    """The same CSR in both packages."""
    ja = st.CSR(data=jnp.asarray(s.data.astype(dtype)),
                indices=jnp.asarray(s.indices.astype(np.int32)),
                indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=s.shape)
    ta = interop.csr_from_arrays(s.data.astype(dtype), s.indices, s.indptr,
                                 s.shape)
    return ja, ta


def _assert_close(got, ref, s, v, dtype):
    bound = TOL[dtype] * (abs(s) @ np.abs(v))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= bound), (err - bound).max()


def _assert_same_plan(tp, jp, meta=PLAN_META):
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in meta:
        assert getattr(tp, f) == getattr(jp, f), f


def _spill_matrix():
    # 16 entries of one row sharing lane 5: first-fit spill tiles
    c = np.arange(16) % 8 * 128 + 5 + (np.arange(16) // 8) * 1024
    return sp.csr_matrix((np.ones(16), (np.zeros(16, int), c)),
                         shape=(8, 2048))


def _empty_rows_matrix():
    s = sp.lil_matrix((64, 200))
    s[3, 7] = 2.5
    s[40, 199] = -1.0
    return s.tocsr()


CASES = {
    "random": lambda: _scipy_csr(300, 1100, 4000, 0),
    "band": lambda: _scipy_csr(200, 200, 2500, 1, band=60),
    "spill": _spill_matrix,
    "empty_rows": _empty_rows_matrix,
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("wsub", [8, 16, 32, "auto"])
def test_plan_arrays_match_reference(case, wsub):
    s = CASES[case]()
    ja, ta = _pair(s, np.float64)
    _assert_same_plan(tpc.build_seg_tiles(ta, wsub=wsub),
                      jpc.build_seg_tiles(ja, wsub=wsub))


def test_plan_of_empty_matrix():
    s = sp.csr_matrix((16, 40))
    ja, ta = _pair(s, np.float32)
    tp, jp = tpc.build_seg_tiles(ta), jpc.build_seg_tiles(ja)
    _assert_same_plan(tp, jp)
    np.testing.assert_array_equal(_np(tpc.csr_smvm_segtile(
        ta, torch.ones(40), tp)), np.zeros(16))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case,wsub", [("random", 8), ("band", 16),
                                       ("spill", 8), ("empty_rows", 32)])
def test_smvm_matches_reference(case, wsub, dtype):
    s = CASES[case]()
    ja, ta = _pair(s, dtype)
    v = np.random.default_rng(3).standard_normal(s.shape[1]).astype(dtype)
    tp = tpc.build_seg_tiles(ta, wsub=wsub)
    got = _np(tpc.csr_smvm_segtile(ta, torch.from_numpy(v), tp))
    ref = np.asarray(jpc.csr_smvm_segtile(
        ja, jnp.asarray(v), jpc.build_seg_tiles(ja, wsub=wsub),
        interpret=True))
    assert got.dtype == dtype
    _assert_close(got, ref, s, v, dtype)
    _assert_close(got, s @ v.astype(np.float64), s, v, dtype)


def test_reference_plan_through_interop():
    """The reference's own plan arrays drive the port's raw-array SpMV:
    the kernel function is checked apart from the planner."""
    s = CASES["band"]()
    ja, _ = _pair(s, np.float64)
    jp = jpc.build_seg_tiles(ja, wsub=16, refreshable=True)
    fields = {f: getattr(jp, f) for f in PLAN_META + ("pos", "eidx")}
    tp = interop.seg_tile_plan_from_arrays(jp.vals, jp.q, jp.seg_of, jp.rb,
                                           **fields)
    v = np.random.default_rng(4).standard_normal(s.shape[1])
    raw = dict(n=jp.n, wsub=jp.wsub, rows=jp.rows, kstep=jp.kstep,
               chunks=jp.chunks)
    got = _np(tpc.segtile_apply(tp.vals, tp.q, tp.seg_of, tp.rb,
                                torch.from_numpy(v), **raw))
    ref = np.asarray(jpc.segtile_apply(jp.vals, jp.q, jp.seg_of, jp.rb,
                                       jnp.asarray(v), interpret=True, **raw))
    assert got.shape == ref.shape == (-(-s.shape[0] // 8) * 8,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # refresh works on the carried plan (nse unknown: eidx bounds it)
    tp2 = tpc.seg_tiles_refresh(tp, torch.from_numpy(s.data * 2.0))
    np.testing.assert_array_equal(_np(tp2.vals), 2.0 * _np(tp.vals))


def test_raw_apply_any_tile_order():
    """Padded tail tiles (rb 0, zero values) and a shuffled tile order —
    as per-shard plans arrive — give the same sums."""
    s = _scipy_csr(100, 300, 1500, 5, band=80)
    _, ta = _pair(s, np.float64)
    tp = tpc.build_seg_tiles(ta, wsub=8)
    assert tp.n_tiles > int((tp.rb > 0).sum())  # has padding tiles
    v = torch.from_numpy(np.random.default_rng(6).standard_normal(300))
    raw = dict(n=100, wsub=8, rows=8, kstep=tp.kstep, chunks=tp.chunks)
    base = _np(tpc.segtile_apply(tp.vals, tp.q, tp.seg_of, tp.rb, v, **raw))
    p = torch.from_numpy(np.random.default_rng(7).permutation(tp.n_tiles))
    got = _np(tpc.segtile_apply(tp.vals[p], tp.q[p], tp.seg_of[p], tp.rb[p],
                                v, **raw))
    _assert_close(got[:100], base[:100], s, _np(v), np.float64)
    np.testing.assert_array_equal(got[100:], 0)


def test_refresh_matches_rebuild_and_checks_length():
    s = CASES["band"]()
    ja, ta = _pair(s, np.float64)
    tp = tpc.build_seg_tiles(ta, refreshable=True)
    jp = jpc.build_seg_tiles(ja, refreshable=True)
    np.testing.assert_array_equal(_np(tp.pos), np.asarray(jp.pos))
    np.testing.assert_array_equal(_np(tp.eidx), np.asarray(jp.eidx))
    new = s.data * -3.25
    tp2 = tpc.seg_tiles_refresh(tp, torch.from_numpy(new))
    jp2 = jpc.seg_tiles_refresh(jp, jnp.asarray(new))
    np.testing.assert_array_equal(_np(tp2.vals), np.asarray(jp2.vals))
    ta2 = interop.csr_from_arrays(new, s.indices, s.indptr, s.shape)
    np.testing.assert_array_equal(_np(tp2.vals),
                                  _np(tpc.build_seg_tiles(ta2).vals))
    with pytest.raises(ValueError, match="refreshable"):
        tpc.seg_tiles_refresh(tpc.build_seg_tiles(ta), torch.from_numpy(new))
    # the reference never checks the length (ROADMAP Queue 3); the port does
    for bad in (new[:-1], np.concatenate([new, [1.0]])):
        with pytest.raises(ValueError, match="entries"):
            tpc.seg_tiles_refresh(tp, torch.from_numpy(bad))


def test_hub_split_matches_reference():
    rng = np.random.default_rng(0)
    n = 400
    rows = np.repeat(np.arange(n), 5)
    cols = np.minimum(rng.zipf(1.3, rows.size), n) - 1
    s = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n)).tocsr()
    s.sum_duplicates()
    ja, ta = _pair(s, np.float64)
    tsplit = hub_split_prepare(ta, max_hub_cols=128, wsub=8)
    jsplit = j_hub_prepare(ja, max_hub_cols=128, wsub=8)
    np.testing.assert_array_equal(_np(tsplit.hub_cols),
                                  np.asarray(jsplit.hub_cols))
    assert (tsplit.hub_nnz, tsplit.tail_nnz) == (jsplit.hub_nnz,
                                                 jsplit.tail_nnz)
    _assert_same_plan(tsplit.hub_plan, jsplit.hub_plan)
    v = rng.standard_normal(n)
    got = _np(hub_split_smvm(tsplit, torch.from_numpy(v)))
    ref = np.asarray(j_hub_smvm(jsplit, jnp.asarray(v), interpret=True))
    _assert_close(got, ref, s, v, np.float64)
    with pytest.raises(ValueError, match="shape"):
        hub_split_smvm(tsplit, torch.zeros(5))


def test_auto_on_cpu_takes_row_binned_path():
    s = _scipy_csr(40, 60, 200, 1)
    _, ta = _pair(s, np.float64)
    v = np.random.default_rng(2).standard_normal(60)
    got = _np(tpc.csr_smvm_auto(ta, torch.from_numpy(v)))
    _assert_close(got, s @ v, s, v, np.float64)


def test_unported_variants_raise():
    _, ta = _pair(CASES["band"](), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpc.build_seg_tiles(ta, rows=32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpc.build_seg_tiles(ta, layout="rigid")
    tp = tpc.build_seg_tiles(ta)
    v = torch.zeros(200)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpc.csr_smvm_segtile(ta, v, tp, reduce="mxu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpc.segtile_apply(tp.vals, tp.q, tp.seg_of, tp.rb, v, n=200, wsub=8,
                          rows=32, kstep=tp.kstep, chunks=tp.chunks)
    with pytest.raises(ValueError):
        tpc.build_seg_tiles(ta, wsub=12)


def test_hbm_bytes_matches_reference():
    s = CASES["random"]()
    ja, ta = _pair(s, np.float32)
    assert tpc.segtile_hbm_bytes(tpc.build_seg_tiles(ta, wsub=16)) == \
        jpc.segtile_hbm_bytes(jpc.build_seg_tiles(ja, wsub=16))
