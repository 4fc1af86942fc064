"""The segment-tile variants — 32-row tiles, the rigid layout, the
tensor-core lane reduction (``reduce="mxu"``) — in the PyTorch port against
the reference (``sparse_tpu/ops/pallas_csr.py``, Pallas in interpret mode).

On the CPU the port's wrappers run their plain versions; the kernels
themselves (K1-r32, K1-mxu) are tested on the card by
``tests/test_torch_cuda.py``.  Plans must equal the reference's array for
array and field for field.  Tolerances: float64 1e-12 and float32 1e-5,
both times ``|A||v|`` per row (the packages sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu as st
from sparse_tpu.ops import pallas_csr as jpc
from sparse_tpu_torch import interop
from sparse_tpu_torch.native import plansort
from sparse_tpu_torch.ops import cuda_csr as tpc

TOL = {np.float32: 1e-5, np.float64: 1e-12}
PLAN_ARRAYS = ("vals", "q", "seg_of", "rb")
PLAN_META = ("n", "m", "n_tiles", "fill", "chunks", "wsub", "rows", "kstep")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _band(n, nnz, seed, half):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = np.clip(r + rng.integers(-half, half + 1, nnz), 0, n - 1)
    s = sp.coo_matrix((rng.standard_normal(nnz), (r, c)),
                      shape=(n, n)).tocsr()
    s.sum_duplicates()
    return s


def _spill():
    """Row 0: 16 entries on lane 5 within 2048 columns (spill tiers), the
    rest a narrow band with an empty row block."""
    b = _band(96, 600, 2, 40).tocoo()
    keep = (b.row < 40) | (b.row >= 48)
    rows = np.r_[b.row[keep], np.zeros(16, int)]
    cols = np.r_[b.col[keep], 5 + 128 * np.arange(16)]
    vals = np.r_[b.data[keep], np.ones(16)]
    s = sp.coo_matrix((vals, (rows, cols)), shape=(96, 2100)).tocsr()
    s.sum_duplicates()
    return s


CASES = {"band": lambda: _band(300, 4000, 1, 700), "spill": _spill}


def _pair(s, dtype):
    """The same CSR in both packages."""
    ja = st.CSR(data=jnp.asarray(s.data.astype(dtype)),
                indices=jnp.asarray(s.indices.astype(np.int32)),
                indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=s.shape)
    ta = interop.csr_from_arrays(s.data.astype(dtype), s.indices, s.indptr,
                                 s.shape, device="cpu")
    return ja, ta


def _assert_close(got, ref, s, v, dtype):
    bound = TOL[dtype] * (abs(s) @ np.abs(v.astype(np.float64)))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= bound), (err - bound).max()


def _assert_same_plan(tp, jp, extra=()):
    for f in PLAN_ARRAYS + extra:
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in PLAN_META:
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("wsub", [8, 16, 32, "auto"])
@pytest.mark.parametrize("rows,layout", [(8, "rigid"), (32, "ff"),
                                         (32, "rigid")])
def test_plan_matches_reference(case, wsub, rows, layout):
    s = CASES[case]()
    ja, ta = _pair(s, np.float64)
    tp = tpc.build_seg_tiles(ta, wsub=wsub, rows=rows, layout=layout,
                             refreshable=True)
    jp = jpc.build_seg_tiles(ja, wsub=wsub, rows=rows, layout=layout,
                             refreshable=True)
    _assert_same_plan(tp, jp, extra=("pos", "eidx"))
    assert tp.vals.shape == (tp.n_tiles, rows, 128)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rows,layout,wsub", [(8, "ff", 16),
                                              (8, "rigid", 8),
                                              (32, "ff", 32),
                                              (32, "rigid", 16)])
@pytest.mark.parametrize("reduce", ["vpu", "mxu"])
def test_smvm_matches_reference(reduce, rows, layout, wsub, dtype):
    s = CASES["band"]()
    ja, ta = _pair(s, dtype)
    v = np.random.default_rng(3).standard_normal(s.shape[1]).astype(dtype)
    tp = tpc.build_seg_tiles(ta, wsub=wsub, rows=rows, layout=layout)
    got = _np(tpc.csr_smvm_segtile(ta, torch.from_numpy(v), tp,
                                   reduce=reduce))
    jp = jpc.build_seg_tiles(ja, wsub=wsub, rows=rows, layout=layout)
    ref = np.asarray(jpc.csr_smvm_segtile(ja, jnp.asarray(v), jp,
                                          reduce=reduce, interpret=True))
    assert got.dtype == dtype and got.shape == (s.shape[0],)
    _assert_close(got, ref, s, v, dtype)
    _assert_close(got, s @ v.astype(np.float64), s, v, dtype)


def test_mxu_spill_and_empty_rows_match_scipy():
    """The mxu reduction over spill tiers and an empty row block, at both
    heights, matches SciPy; the raw-array call keeps the padded rows 0."""
    s = _spill()
    _, ta = _pair(s, np.float64)
    v = np.random.default_rng(8).standard_normal(s.shape[1])
    for rows in (8, 32):
        tp = tpc.build_seg_tiles(ta, wsub=8, rows=rows, layout="rigid")
        y = _np(tpc.segtile_apply(tp.vals, tp.q, tp.seg_of, tp.rb,
                                  torch.from_numpy(v), n=s.shape[0], wsub=8,
                                  rows=rows, kstep=tp.kstep,
                                  chunks=tp.chunks, reduce="mxu"))
        assert y.shape == (-(-s.shape[0] // rows) * rows,)
        _assert_close(y[:s.shape[0]], s @ v, s, v, np.float64)
        np.testing.assert_array_equal(y[40:48], 0)


@pytest.mark.parametrize("rows", [8, 32])
@pytest.mark.parametrize("wsub", [8, 32])
def test_rigid_numpy_fallback_matches_native(monkeypatch, rows, wsub):
    """The rigid layout's NumPy pass (taken without the native library)
    builds the native sweep's plan, refresh arrays included."""
    s = _spill()
    _, ta = _pair(s, np.float64)
    native = tpc.build_seg_tiles(ta, wsub=wsub, rows=rows, layout="rigid",
                                 refreshable=True)
    assert plansort.seg_tile_layout(
        s.indptr.astype(np.int64), s.indices.astype(np.int64), wsub,
        rows=rows) is not None
    monkeypatch.setattr(plansort, "seg_tile_layout", lambda *a, **k: None)
    fallback = tpc.build_seg_tiles(ta, wsub=wsub, rows=rows, layout="rigid",
                                   refreshable=True)
    _assert_same_plan(fallback, native, extra=("pos", "eidx"))


def test_batch_keyword():
    """``batch`` is the reference's emission group of the TPU kernel: any
    value >= 1 gives the same result; below 1 raises, as the reference's
    ``range(0, kstep, batch)`` fails at 0."""
    s = CASES["band"]()
    _, ta = _pair(s, np.float64)
    tp = tpc.build_seg_tiles(ta, wsub=16)
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(300))
    base = tpc.csr_smvm_segtile(ta, v, tp)
    for batch in (1, 7, tp.kstep, None):
        assert torch.equal(tpc.csr_smvm_segtile(ta, v, tp, batch=batch),
                           base)
    raw = dict(n=300, wsub=16, rows=8, kstep=tp.kstep, chunks=tp.chunks)
    assert torch.equal(tpc.segtile_apply(tp.vals, tp.q, tp.seg_of, tp.rb, v,
                                         batch=3, **raw)[:300], base)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="batch"):
            tpc.csr_smvm_segtile(ta, v, tp, batch=bad)
        with pytest.raises(ValueError, match="batch"):
            tpc.segtile_apply(tp.vals, tp.q, tp.seg_of, tp.rb, v, batch=bad,
                              **raw)


def test_hbm_bytes_of_variant_plans_match_reference():
    s = CASES["band"]()
    ja, ta = _pair(s, np.float32)
    for rows, layout in ((32, "ff"), (8, "rigid")):
        assert tpc.segtile_hbm_bytes(tpc.build_seg_tiles(
            ta, wsub=16, rows=rows, layout=layout)) == jpc.segtile_hbm_bytes(
                jpc.build_seg_tiles(ja, wsub=16, rows=rows, layout=layout))
