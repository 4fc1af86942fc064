"""The compact stream of the segment-tile plans — what the card's kernels
K1, K1-r32, K1-mxu and K2 read — against the CSR it was built from and
against the reference (``sparse_tpu/ops/pallas_csr.py`` and
``pallas_csr_block.py``, Pallas in interpret mode).

On the CPU the port's wrappers run the stream's plain versions; the
kernels themselves are tested on the card by ``tests/test_torch_cuda.py``.
Tolerances: float64 1e-12 and float32 1e-5, both times ``|A||v|`` per row
(the packages sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu as st
from sparse_tpu.formats import bsr as jbsr
from sparse_tpu.ops import pallas_csr as jpc
from sparse_tpu.ops import pallas_csr_block as jpb
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.ops import cuda_csr as tpc
from sparse_tpu_torch.ops import cuda_csr_block as tpb
from sparse_tpu_torch.ops.dispatch import smvm_prepare
from sparse_tpu_torch.ops.hub_split import hub_split_prepare, hub_split_smvm
from tests.test_torch_segtile_block import _block_matrix

TOL = {np.float32: 1e-5, np.float64: 1e-12}
VARIANTS = [(8, "ff"), (8, "rigid"), (32, "ff"), (32, "rigid")]
PLAN_META = ("n", "m", "n_tiles", "fill", "chunks", "wsub", "rows", "kstep")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _band(n, m, nnz, seed, half, zeros=0):
    """A band with ``zeros`` of its stored values set to 0 (still
    stored)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = np.clip(r + rng.integers(-half, half + 1, nnz), 0, m - 1)
    s = sp.coo_matrix((rng.standard_normal(nnz), (r, c)),
                      shape=(n, m)).tocsr()
    s.sum_duplicates()
    s.data[rng.choice(s.nnz, zeros, replace=False)] = 0.0
    return s


def _long_row():
    """Row 3 holds 3,000 entries, rows 10-19 are empty, 200 x 4,000."""
    rng = np.random.default_rng(9)
    base = sp.random(200, 4000, density=0.01, random_state=9, format="coo")
    rows = np.r_[base.row, np.full(3000, 3)]
    cols = np.r_[base.col, rng.choice(4000, 3000, replace=False)]
    keep = (rows < 10) | (rows >= 20)
    s = sp.coo_matrix((rng.standard_normal(keep.sum()),
                       (rows[keep], cols[keep])), shape=(200, 4000)).tocsr()
    s.sum_duplicates()
    return s


CASES = {
    "band_zeros": lambda: _band(300, 300, 4000, 1, 700, zeros=40),
    "rectangular": lambda: _band(120, 1500, 2500, 2, 600, zeros=10),
    "long_row": _long_row,
}


def _csr(s, dtype=np.float64):
    return interop.csr_from_arrays(s.data.astype(dtype), s.indices, s.indptr,
                                   s.shape, device="cpu")


def _jcsr(s, dtype=np.float64):
    return st.CSR(data=jnp.asarray(s.data.astype(dtype)),
                  indices=jnp.asarray(s.indices.astype(np.int32)),
                  indptr=jnp.asarray(s.indptr.astype(np.int32)),
                  shape=s.shape)


def _triples(stream):
    """(row, column, value) of every stream entry, sorted by row, column."""
    k = stream.nnz
    rows = np.repeat(np.arange(stream.n_rows), np.diff(_np(stream.row_ptr)))
    cols = _np(stream.cols)[:k]
    vals = _np(stream.vals)[:k]
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def _assert_close(got, ref, s, v, dtype):
    bound = TOL[dtype] * (abs(s) @ np.abs(np.asarray(v, np.float64)))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= bound), (err - bound).max()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rows,layout", VARIANTS)
def test_stream_holds_every_stored_entry(case, rows, layout):
    """Exactly the CSR's stored entries, stored zeros included, each row
    one segment in (tile, lane) order."""
    s = CASES[case]()
    plan = tpc.build_seg_tiles(_csr(s), wsub=16, rows=rows, layout=layout)
    stream = plan.stream
    assert stream.nnz == s.nnz and stream.n_rows == s.shape[0]
    assert stream.vals.numel() % 4 == 0 and stream.cols.dtype == torch.int32
    np.testing.assert_array_equal(_np(stream.row_ptr), s.indptr)
    r, c, v = _triples(stream)
    coo = s.tocoo()
    order = np.lexsort((coo.col, coo.row))
    np.testing.assert_array_equal(r, coo.row[order])
    np.testing.assert_array_equal(c, coo.col[order])
    np.testing.assert_array_equal(v, coo.data[order])
    # within a row, entries follow the slot order of the plan
    tiled = tpc.build_seg_tiles(_csr(s), wsub=16, rows=rows, layout=layout,
                                refreshable=True)
    spos = _np(tiled.pos)[_np(tiled.stream.perm)]
    for a, b in zip(s.indptr[:-1], s.indptr[1:]):
        assert np.all(np.diff(spos[a:b]) > 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("wsub", [8, 16, 32])
@pytest.mark.parametrize("rows,layout", VARIANTS)
def test_stream_plain_matches_reference(rows, layout, wsub, dtype):
    """The stream's plain version against the reference's ``segtile_apply``
    (interpret mode) and SciPy's ``csr_smvm``."""
    s = CASES["band_zeros"]()
    ta = _csr(s, dtype)
    v = np.random.default_rng(3).standard_normal(s.shape[1]).astype(dtype)
    tp = tpc.build_seg_tiles(ta, wsub=wsub, rows=rows, layout=layout)
    got = _np(tpc.segtile_stream_plain(tp.stream, torch.from_numpy(v)))
    jp = jpc.build_seg_tiles(_jcsr(s, dtype), wsub=wsub, rows=rows,
                             layout=layout)
    ref = np.asarray(jpc.segtile_apply(
        jp.vals, jp.q, jp.seg_of, jp.rb, jnp.asarray(v), n=jp.n,
        wsub=jp.wsub, rows=jp.rows, kstep=jp.kstep, chunks=jp.chunks,
        interpret=True))[:s.shape[0]]
    assert got.dtype == dtype and got.shape == (s.shape[0],)
    _assert_close(got, ref, s, v, dtype)
    _assert_close(got, s @ v.astype(np.float64), s, v, dtype)
    for reduce in ("vpu", "mxu"):  # the entry point on the CPU: the same
        np.testing.assert_array_equal(_np(tpc.csr_smvm_segtile(
            ta, torch.from_numpy(v), tp, reduce=reduce)), got)


@pytest.mark.parametrize("case", ["rectangular", "long_row"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stream_plain_matches_scipy_at_odd_shapes(case, dtype):
    s = CASES[case]()
    ta = _csr(s, dtype)
    v = np.random.default_rng(5).standard_normal(s.shape[1]).astype(dtype)
    for rows, layout in VARIANTS:
        tp = tpc.build_seg_tiles(ta, wsub="auto", rows=rows, layout=layout)
        got = _np(tpc.csr_smvm_segtile(ta, torch.from_numpy(v), tp))
        _assert_close(got, s @ v.astype(np.float64), s, v, dtype)


def test_row_classes():
    """The lane group is the mean row length in 4-entry units rounded up to
    a power of two; rows past 8 group passes are long, cut into 512-entry
    pieces in order."""
    s = _long_row()
    stream = tpc.build_seg_tiles(_csr(s), wsub=32).stream
    lens = np.diff(s.indptr)
    s_, e_ = s.indptr[:-1], s.indptr[1:]
    units = np.where(lens > 0, (e_ + 3) // 4 - s_ // 4, 0)
    group = 1
    while group < min(units.mean(), 32):
        group *= 2
    assert stream.group == group
    assert stream.long_min == 8 * group * 4 and stream.piece == 512
    long_rows = np.flatnonzero(lens > stream.long_min)
    assert 3 in long_rows
    np.testing.assert_array_equal(_np(stream.long_rows), long_rows)
    pieces = -(-lens[long_rows] // 512)
    np.testing.assert_array_equal(_np(stream.piece_ptr),
                                  np.r_[0, np.cumsum(pieces)])
    np.testing.assert_array_equal(_np(stream.piece_row),
                                  np.repeat(np.arange(long_rows.size), pieces))
    empty = tpc.build_seg_tiles(_csr(sp.csr_matrix((16, 40)))).stream
    assert (empty.nnz, empty.group, empty.n_long) == (0, 1, 0)
    assert empty.vals.numel() == 0 and empty.row_ptr.numel() == 17


def _float64_edges(rng):
    """600 rows of 3000 columns: ~20 band entries a row, empty rows (a run
    of them), one-entry rows, rows of 256 and 257 entries (the float64
    kernel's long_min at lane group 8, and one past it), odd lengths that
    start the next row mid-unit, a last row of 7 entries."""
    n, m = 600, 3000
    lens = rng.integers(14, 27, n)
    lens[[5, 6, 7, 400]] = 0
    lens[[100, 101]] = 1
    lens[[300, 301]] = (256, 257)
    lens[[102, 103]] = (3, 5)
    lens[-1] = 7
    cols = [np.sort(rng.choice(m, k, replace=False)) if k > 200 else
            np.sort(np.clip(i + rng.choice(np.arange(-300, 300), k,
                                           replace=False), 0, m - 1))
            for i, k in enumerate(lens)]
    s = sp.csr_matrix((rng.standard_normal(lens.sum()),
                       (np.repeat(np.arange(n), lens), np.concatenate(cols))),
                      shape=(n, m))
    s.sum_duplicates()
    return s


@pytest.mark.parametrize("rows", [8, 32])
def test_float64_row_edges_match_reference(rows):
    """The float64 stream K1 and K1-r32 read, at the row lengths their
    float64 kernel treats apart (empty, one entry, long_min and one past
    it, a mid-unit start, the last row): the classes are the ones the
    kernel keys on, and the entry point's result on the CPU matches the
    reference's ``segtile_apply`` (interpret mode) and SciPy at 1e-12
    (|A||v|)."""
    rng = np.random.default_rng(230 + rows)
    s = _float64_edges(rng)
    lens = np.diff(s.indptr)
    ta = _csr(s)
    tp = tpc.build_seg_tiles(ta, wsub=32, rows=rows)
    stream = tp.stream
    assert stream.group == 8 and stream.long_min == 256
    assert (lens == 256).any() and (lens == 257).any()
    np.testing.assert_array_equal(_np(stream.long_rows),
                                  np.flatnonzero(lens > 256))
    assert stream.n_pieces == 1  # 257 entries: one 512-entry piece
    v = rng.standard_normal(s.shape[1])
    got = _np(tpc.csr_smvm_segtile(ta, torch.from_numpy(v), tp))
    jp = jpc.build_seg_tiles(_jcsr(s), wsub=32, rows=rows)
    ref = np.asarray(jpc.segtile_apply(
        jp.vals, jp.q, jp.seg_of, jp.rb, jnp.asarray(v), n=jp.n,
        wsub=jp.wsub, rows=jp.rows, kstep=jp.kstep, chunks=jp.chunks,
        interpret=True))[:s.shape[0]]
    assert got.dtype == np.float64
    _assert_close(got, ref, s, v, np.float64)
    _assert_close(got, s @ v, s, v, np.float64)
    assert not got[lens == 0].any()


@pytest.mark.parametrize("rows,layout", VARIANTS)
def test_refresh_equals_rebuild(rows, layout):
    s = CASES["band_zeros"]()
    plan = tpc.build_seg_tiles(_csr(s), wsub=16, rows=rows, layout=layout,
                               refreshable=True)
    new = s.data * -2.5 + 0.125
    s2 = sp.csr_matrix((new, s.indices, s.indptr), shape=s.shape)
    fresh = tpc.seg_tiles_refresh(plan, torch.from_numpy(new))
    rebuilt = tpc.build_seg_tiles(_csr(s2), wsub=16, rows=rows,
                                  layout=layout)
    for f in ("vals", "cols", "row_ptr"):
        np.testing.assert_array_equal(_np(getattr(fresh.stream, f)),
                                      _np(getattr(rebuilt.stream, f)))
    v = torch.from_numpy(np.random.default_rng(6).standard_normal(300))
    np.testing.assert_array_equal(
        _np(tpc.csr_smvm_segtile(_csr(s2), v, fresh)),
        _np(tpc.csr_smvm_segtile(_csr(s2), v, rebuilt)))


@pytest.mark.parametrize("with_pos", [True, False])
def test_interop_plan_stream(with_pos):
    """A plan carried from the reference: with ``pos`` its stream is the
    port's own (stored zeros included), without it the non-zero slots;
    both give the port's result."""
    s = CASES["band_zeros"]()
    jp = jpc.build_seg_tiles(_jcsr(s), wsub=16, refreshable=True)
    extra = ("pos", "eidx") if with_pos else ()
    tp = interop.seg_tile_plan_from_arrays(
        jp.vals, jp.q, jp.seg_of, jp.rb, device="cpu",
        **{f: getattr(jp, f) for f in PLAN_META + extra})
    own = tpc.build_seg_tiles(_csr(s), wsub=16)
    v = torch.from_numpy(np.random.default_rng(7).standard_normal(300))
    got = _np(tpc.csr_smvm_segtile(_csr(s), v, tp))
    if with_pos:
        assert tp.stream.nnz == s.nnz
        np.testing.assert_array_equal(got, _np(tpc.csr_smvm_segtile(
            _csr(s), v, own)))
        tp2 = tpc.seg_tiles_refresh(tp, torch.from_numpy(s.data * 3.0))
        np.testing.assert_array_equal(_np(tp2.stream.vals)[:s.nnz],
                                      3.0 * _np(tp.stream.vals)[:s.nnz])
    else:
        assert tp.stream.nnz == np.count_nonzero(s.data)
        _assert_close(got, s @ _np(v), s, _np(v), np.float64)


def test_hubsplit_plan_stream():
    """The hub strip's plan carries a stream of the hub entries; the split
    matches SciPy, directly and through ``smvm_prepare``."""
    rng = np.random.default_rng(0)
    n = 400
    rows = np.repeat(np.arange(n), 5)
    cols = np.minimum(rng.zipf(1.3, rows.size), n) - 1
    s = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n)).tocsr()
    s.sum_duplicates()
    split = hub_split_prepare(_csr(s), max_hub_cols=128, wsub=8)
    assert split.hub_plan.stream.nnz == split.hub_nnz
    v = rng.standard_normal(n)
    got = _np(hub_split_smvm(split, torch.from_numpy(v)))
    _assert_close(got, s @ v, s, v, np.float64)
    plan = smvm_prepare(_csr(s), prefer="hubsplit")
    _assert_close(_np(plan.apply(torch.from_numpy(v))), s @ v, s, v,
                  np.float64)


@pytest.mark.parametrize("rows", [8, 32])
def test_raw_route_equals_plan_route(rows):
    """The raw-array route compacts the non-zero slots per call: with no
    stored zero and n a multiple of the tile height it is the plan's
    stream, so the results agree bit for bit."""
    s = _band(256, 256, 3000, 4, 100)
    ta = _csr(s)
    tp = tpc.build_seg_tiles(ta, wsub=8, rows=rows)
    v = torch.from_numpy(np.random.default_rng(8).standard_normal(256))
    raw = tpc.segtile_apply(tp.vals, tp.q, tp.seg_of, tp.rb, v, n=256,
                            wsub=8, rows=rows, kstep=tp.kstep,
                            chunks=tp.chunks)
    np.testing.assert_array_equal(_np(raw),
                                  _np(tpc.csr_smvm_segtile(ta, v, tp)))


# -- K2: the 2x2 block stream -------------------------------------------------


def _block_pair(nb=64, seed=1, dtype=np.float64):
    x = _block_matrix(nb, seed=seed, bw=20, scramble=False)
    s = sp.csr_matrix(x.astype(dtype))
    ta = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                 device="cpu")
    ja = _jcsr(s, dtype)
    return s, tbsr.csr_to_bsr(ta, 2), jbsr.csr_to_bsr(ja, 2)


@pytest.mark.parametrize("wsub", [8, 16])
def test_block_stream_holds_every_block(wsub):
    s, tab, _ = _block_pair()
    stream = tpb.build_seg_tiles_block(tab, wsub=wsub).stream
    nb = tab.nb
    idx = _np(tab.indices).astype(np.int64)
    stored = idx < nb * nb
    assert stream.nnz == stored.sum() and tuple(stream.vals.shape) == (
        stream.nnz, 4)
    rows = np.repeat(np.arange(nb), np.diff(_np(stream.row_ptr)))
    got = sorted(zip(rows, _np(stream.cols).tolist(),
                     map(tuple, _np(stream.vals).tolist())))
    blocks = _np(tab.blocks)[stored].reshape(-1, 4)
    want = sorted(zip(idx[stored] // nb, (idx[stored] % nb).tolist(),
                      map(tuple, blocks.tolist())))
    assert got == want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("wsub", [8, 16])
def test_block_stream_plain_matches_reference(wsub, dtype):
    s, tab, jab = _block_pair(dtype=dtype)
    v = np.random.default_rng(2).standard_normal(128).astype(dtype)
    tp = tpb.build_seg_tiles_block(tab, wsub=wsub)
    got = _np(tpb.block_stream_plain(tp.stream, torch.from_numpy(v)))
    ref = np.asarray(jpb.bsr_smvm_segtile_block(
        jab, jnp.asarray(v), jpb.build_seg_tiles_block(jab, wsub=wsub),
        interpret=True))
    assert got.dtype == dtype
    _assert_close(got, ref, s, v, dtype)
    _assert_close(got, s.astype(np.float64) @ v.astype(np.float64), s, v,
                  dtype)
    np.testing.assert_array_equal(
        _np(tpb.bsr_smvm_segtile_block(tab, torch.from_numpy(v), tp)), got)


def test_block_refresh_and_interop_stream():
    s, tab, jab = _block_pair()
    plan = tpb.build_seg_tiles_block(tab, refreshable=True)
    new = _np(tab.blocks) * 1.75 - 0.5
    fresh = tpb.block_seg_tiles_refresh(plan, torch.from_numpy(new))
    tab2 = tbsr.BSR(indices=tab.indices, blocks=torch.from_numpy(new),
                    n=tab.n, bsz=2)
    rebuilt = tpb.build_seg_tiles_block(tab2)
    np.testing.assert_array_equal(_np(fresh.stream.vals),
                                  _np(rebuilt.stream.vals))
    jp = jpb.build_seg_tiles_block(jab, wsub=8)
    tp = interop.block_seg_tile_plan_from_arrays(
        jp.vals, jp.q, jp.seg_of, jp.rb, device="cpu",
        **{f: getattr(jp, f) for f in ("n", "nb", "bsz", "n_tiles", "fill",
                                       "chunks", "wsub", "kstep")})
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(128))
    _assert_close(_np(tpb.bsr_smvm_segtile_block(tab, v, tp)), s @ _np(v),
                  s, _np(v), np.float64)
