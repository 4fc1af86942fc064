"""K2 — the 2x2 block-granule segment-tile SpMV — and the BSR / reorder
modules of the PyTorch port against the reference
(``sparse_tpu/ops/pallas_csr_block.py`` in interpret mode).

Tolerances: float64 1e-12 and float32 1e-5, both times ``|A||v|`` per row.
The kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""

import dataclasses

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


# -- the folded view of a block plan (the dispatcher's block RCM) -------------


def _fold_matrix():
    """A node-scrambled 2x2 block band (nb 400), block row 5 holding 300
    blocks (long: three pieces) and block row 9 empty."""
    x = _block_matrix(400, seed=3)
    x[10:12, :600] = 1.25
    x[18:20, :] = 0.0
    return x


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _kind_csr(x, kind):
    """The pattern of dense ``x`` as a CPU CSR of ``kind`` and an operand
    (int32: values x 1000 rounded, an integer operand)."""
    s = sp.csr_matrix(x)
    rng = np.random.default_rng(11)
    if kind == "int32":
        data = np.round(s.data * 1000).astype(np.int32)
        v = torch.from_numpy(rng.integers(-9, 10, s.shape[0]).astype(
            np.int32))
    else:
        data = s.data
        v = torch.from_numpy(rng.standard_normal(s.shape[0]))
    ta = interop.csr_from_arrays(data, s.indices, s.indptr, s.shape,
                                 device="cpu")
    dt = {"float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32, "bf16": torch.bfloat16}[kind]
    return (dataclasses.replace(ta, data=ta.data.to(dt)), v.to(dt))


def _unfolded(plan, v):
    """The blockseg apply before the fold: v gathered through the block
    RCM, K2's plain version on the permuted stream, y gathered back."""
    ab, bp = plan.state
    vp = v.reshape(-1, 2)[plan.perm].reshape(-1)
    return tpb.bsr_smvm_segtile_block(ab, vp, bp).reshape(-1, 2)[
        plan.inv_perm].reshape(-1)


@pytest.mark.parametrize("case", ["scrambled", "long_rows"])
def test_folded_view_follows_the_permutation(case):
    """The folded view maps the stream's block columns and rows through the
    block permutation and shares the stream's values, offsets and long-row
    arrays."""
    x = _fold_matrix() if case == "long_rows" else _block_matrix(64, seed=2)
    ta, _ = _kind_csr(x, "float64")
    plan = pt.smvm_prepare(ta, prefer="blockseg")
    bp, perm = plan.state[1], plan.perm
    st, fv = bp.stream, bp.folded
    assert perm is not None and fv is not None
    assert fv.cols.dtype == fv.out_rows.dtype == fv.out_long.dtype \
        == torch.int32
    np.testing.assert_array_equal(_np(fv.cols), _np(perm[st.cols.long()]))
    np.testing.assert_array_equal(_np(fv.out_rows), _np(perm))
    np.testing.assert_array_equal(_np(fv.out_long),
                                  _np(perm[st.long_rows.long()]))
    for f in ("vals", "row_ptr", "long_rows", "piece_ptr", "piece_row"):
        assert getattr(fv, f) is getattr(st, f), f
    assert (fv.n_rows, fv.nnz, fv.group, fv.long_min, fv.piece) == \
        (st.n_rows, st.nnz, st.group, st.long_min, st.piece)
    assert st.out_rows is None and st.out_long is None
    assert (st.n_long > 0) == (case == "long_rows")
    with pytest.raises(ValueError, match="block rows"):
        tpb.block_seg_tiles_fold(bp, perm[:-1])


@pytest.mark.parametrize("case", ["scrambled", "reorder_false", "refresh"])
@pytest.mark.parametrize("kind", ["float32", "float64", "int32", "bf16"])
def test_folded_apply_is_the_unfolded_apply(kind, case):
    """``plan.apply`` on the folded view returns the bits of the unfolded
    ``inv(apply_permuted(perm(v)))``: long block rows in pieces and an
    empty block row included; without a reorder there is no view and the
    apply is ``apply_permuted``; after a kernel-level refresh both views
    agree with a rebuild."""
    ta, v = _kind_csr(_fold_matrix(), kind)
    plan = pt.smvm_prepare(ta, prefer="blockseg",
                           reorder=case != "reorder_false")
    ab, bp = plan.state
    if case == "reorder_false":
        assert plan.perm is None and bp.folded is None
        assert torch.equal(_bits(plan.apply(v)),
                           _bits(plan.apply_permuted(v)))
        return
    assert bp.stream.n_pieces >= 2
    if case == "refresh":
        rp = tpb.block_seg_tiles_fold(
            tpb.build_seg_tiles_block(ab, wsub=16, refreshable=True),
            plan.perm)
        new = ab.blocks * 3 + 1 if kind == "int32" else ab.blocks * -1.5
        ab = pt.BSR(indices=ab.indices, blocks=new, n=ab.n, bsz=2)
        bp = tpb.block_seg_tiles_refresh(rp, new)
        assert bp.folded.vals is bp.stream.vals
        plan = dataclasses.replace(plan, state=(ab, bp))
        rebuilt = tpb.block_seg_tiles_fold(
            tpb.build_seg_tiles_block(ab, wsub=16), plan.perm)
        assert torch.equal(_bits(tpb.block_folded_apply(ab, v, rebuilt)),
                           _bits(plan.apply(v)))
    y = plan.apply(v)
    assert y.dtype == v.dtype
    assert torch.equal(_bits(y), _bits(_unfolded(plan, v)))
    assert torch.equal(_bits(y), _bits(tpb.block_folded_apply(ab, v, bp)))
    assert bool((y[18:20] == 0).all())
