"""The whole slice: triples -> CSR -> smvm_prepare -> apply, in the PyTorch
port against the reference (``sparse_tpu/ops/dispatch.py``; Pallas rungs in
interpret mode), for every rung of the ladder.

Plans must match exactly (rung, permutations, plan arrays); products within
1e-12 * ``|A||v|`` in float64.  On CPU tensors the default ladder must pick
the rung the reference picks off-TPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.ops.dispatch import smvm_prepare as j_prepare
from sparse_tpu_torch import interop
from sparse_tpu_torch.ops.dispatch import smvm_prepare

from tests.test_torch_segtile_block import _block_matrix


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _band(n, seed, per_row=4, half=8, scramble=False):
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if scramble else np.arange(n)
    r = np.repeat(np.arange(n), per_row)
    c = np.clip(r + rng.integers(-half, half + 1, r.size), 0, n - 1)
    return order[r], order[c], rng.standard_normal(r.size)


def _zipf(n, seed, per_row=3, a=1.2):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), per_row)
    c = np.minimum(rng.zipf(a, r.size), n) - 1
    return r, c, rng.standard_normal(r.size)


def _dense_triples(x):
    r, c = np.nonzero(x)
    return r, c, x[r, c]


MATRICES = {
    "band": lambda: (120, _band(120, 3)),
    "blocks2": lambda: (128, _dense_triples(_block_matrix(64, seed=0))),
    "blocks8": lambda: (96, _dense_triples(_block_matrix(
        12, seed=4, per_row=3, bw=4, scramble=False, bsz=8))),
    "powerlaw": lambda: (500, _zipf(500, 9)),
}


def _build(name):
    """The same triples (with duplicates) through both packages'
    constructors: csr_from_triples, as a user of either would."""
    n, (r, c, v) = MATRICES[name]()
    triples = list(zip(r.tolist(), c.tolist(), v.tolist()))
    ta = pt.csr_from_triples(n, n, triples, dtype=np.float64, device="cpu")
    ja = st.csr_from_triples(n, n, triples, dtype=np.float64)
    s = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    return ta, ja, s


def _assert_close(got, ref, s, v):
    bound = 1e-12 * (abs(s) @ np.abs(v))
    err = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.all(err <= bound), (err - bound).max()


def _assert_same_state(kind, tp, jp):
    """The port's plan carries the reference's arrays."""
    for a, b in ((tp.perm, jp.perm), (tp.inv_perm, jp.inv_perm),
                 (tp.value_src, jp.value_src)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    if kind in ("segtile", "blockseg"):
        for f in ("q", "seg_of", "rb"):
            np.testing.assert_array_equal(_np(getattr(tp.state[1], f)),
                                          np.asarray(getattr(jp.state[1], f)))
        # values went through two duplicate sums of different order
        np.testing.assert_allclose(_np(tp.state[1].vals),
                                   np.asarray(jp.state[1].vals), rtol=0,
                                   atol=1e-12)
    elif kind == "bell":
        np.testing.assert_array_equal(_np(tp.state[0].cols),
                                      np.asarray(jp.state[0].cols))
        np.testing.assert_array_equal(_np(tp.state[0].blocks),
                                      np.asarray(jp.state[0].blocks))
    elif kind == "hubsplit":
        np.testing.assert_array_equal(_np(tp.state[0].hub_cols),
                                      np.asarray(jp.state[0].hub_cols))
    else:
        np.testing.assert_array_equal(_np(tp.state[1].perm),
                                      np.asarray(jp.state[1].perm))
        assert tp.state[1].bin_caps == jp.state[1].bin_caps


RUNGS = [("segtile", "band"), ("blockseg", "blocks2"), ("bell", "blocks8"),
         ("hubsplit", "powerlaw"), ("xla", "band")]


@pytest.mark.parametrize("kind,name", RUNGS)
def test_each_rung_matches_reference(kind, name):
    ta, ja, s = _build(name)
    n = s.shape[0]
    tp = smvm_prepare(ta, prefer=kind)
    jp = j_prepare(ja, prefer=kind)
    assert tp.kind == jp.kind == kind
    _assert_same_state(kind, tp, jp)
    v = np.random.default_rng(1).standard_normal(n)
    got = _np(tp.apply(torch.from_numpy(v)))
    _assert_close(got, np.asarray(jp.apply(jnp.asarray(v))), s, v)
    _assert_close(got, s @ v, s, v)
    if tp.perm is not None:
        gp = _np(tp.apply_permuted(torch.from_numpy(v)))
        # permuted space: bound by the largest row of |A| times max |v|
        atol = 1e-12 * abs(s).sum(1).max() * np.abs(v).max()
        np.testing.assert_allclose(
            gp, np.asarray(jp.apply_permuted(jnp.asarray(v))), rtol=0,
            atol=atol)
    # the same plan carried over from the reference's arrays
    cp = interop.smvm_plan_from_arrays(
        jp.kind, jp.state, shape=jp.shape, perm=jp.perm,
        inv_perm=jp.inv_perm, value_src=jp.value_src, device="cpu")
    _assert_close(_np(cp.apply(torch.from_numpy(v))), got, s, v)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_default_ladder_matches_reference_off_device(name):
    ta, ja, _ = _build(name)
    assert smvm_prepare(ta).kind == j_prepare(ja).kind


@pytest.mark.parametrize("kind", ["segtile", "xla"])
def test_refresh_matches_reference(kind):
    ta, ja, s = _build("band")
    tp = smvm_prepare(ta, prefer=kind, refreshable=True)
    jp = j_prepare(ja, prefer=kind, refreshable=True)
    new = _np(ta.data) * -1.5
    v = np.random.default_rng(2).standard_normal(s.shape[0])
    got = _np(tp.refresh(torch.from_numpy(new)).apply(torch.from_numpy(v)))
    ref = np.asarray(jp.refresh(jnp.asarray(new)).apply(jnp.asarray(v)))
    _assert_close(got, ref, s, v)
    _assert_close(got, (s * -1.5) @ v, s, v)
    with pytest.raises(ValueError, match="shape"):
        tp.refresh(torch.from_numpy(new[:-1]))


def test_refresh_through_composed_reorder():
    """A scrambled band wide enough for dispatch to compose RCM: the
    refresh maps original-order values through ``value_src``."""
    n = 2600
    r, c, v0 = _band(n, 5, per_row=3, half=4, scramble=True)
    ta = pt.csr_from_coo(pt.coo_make((n, n), r, c, torch.from_numpy(v0),
                                     device="cpu"))
    ja = st.csr_from_coo(st.coo_make((n, n), r, c, jnp.asarray(v0)))
    s = sp.coo_matrix((v0, (r, c)), shape=(n, n)).tocsr()
    tp = smvm_prepare(ta, prefer="segtile", refreshable=True)
    jp = j_prepare(ja, prefer="segtile", refreshable=True)
    assert tp.perm is not None
    _assert_same_state("segtile", tp, jp)
    v = np.random.default_rng(6).standard_normal(n)
    _assert_close(_np(tp.apply(torch.from_numpy(v))), s @ v, s, v)
    new = _np(ta.data) * 2.0
    got = _np(tp.refresh(torch.from_numpy(new)).apply(torch.from_numpy(v)))
    _assert_close(got, (s * 2.0) @ v, s, v)


@pytest.mark.parametrize("kind", ["blockseg", "bell", "hubsplit"])
def test_refresh_refused_on_reblocking_rungs(kind):
    name = dict(RUNGS)[kind]
    ta, _, _ = _build(name)
    tp = smvm_prepare(ta, prefer=kind)
    with pytest.raises(NotImplementedError, match="re-run smvm_prepare"):
        tp.refresh(ta.data)


def test_non_refreshable_segtile_refuses():
    ta, _, _ = _build("band")
    tp = smvm_prepare(ta, prefer="segtile")
    with pytest.raises(ValueError, match="refreshable"):
        tp.refresh(ta.data)


def test_spmv_plan_and_ell_match_reference():
    from sparse_tpu.ops import spmv as jspmv
    from sparse_tpu_torch.ops import spmv as tspmv

    ta, ja, s = _build("powerlaw")
    tpl, jpl = tspmv.build_spmv_plan(ta), jspmv.build_spmv_plan(ja)
    np.testing.assert_array_equal(_np(tpl.perm), np.asarray(jpl.perm))
    assert (tpl.bin_sizes, tpl.bin_caps) == (jpl.bin_sizes, jpl.bin_caps)
    L = tspmv.row_capacity(ta)
    assert L == jspmv.row_capacity(ja)
    v = np.random.default_rng(3).standard_normal(s.shape[0])
    for got in (tspmv.csr_smvm_ell(ta, torch.from_numpy(v), L),
                tspmv.csr_smvm_fast(ta, torch.from_numpy(v))):
        _assert_close(_np(got), np.asarray(
            jspmv.csr_smvm_ell(ja, jnp.asarray(v), L)), s, v)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["blocks2", "scrambled_long"])
def test_blockseg_folded_apply_matches_reference(name, dtype):
    """The blockseg apply on the plan's folded view (one K2 pass in the
    caller's numbering) against the reference's ``apply`` (its gathers
    around K2 in interpret mode) on the same seeded inputs: within
    1e-12 (float64) / 1e-5 (float32) of ``|A||v|``, and equal to the
    port's own apply_permuted gathered back, bit for bit."""
    if name == "blocks2":
        x = _block_matrix(64, seed=0)
    else:  # node-scrambled, block row 5 long (three pieces)
        x = _block_matrix(400, seed=3)
        x[10:12, :600] = 1.25
    s = sp.csr_matrix(x.astype(dtype))
    ta = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                 device="cpu")
    ja = st.CSR(data=jnp.asarray(s.data), indices=jnp.asarray(
        s.indices.astype(np.int32)), indptr=jnp.asarray(
        s.indptr.astype(np.int32)), shape=s.shape)
    tp = smvm_prepare(ta, prefer="blockseg")
    jp = j_prepare(ja, prefer="blockseg")
    assert tp.kind == jp.kind == "blockseg"
    assert tp.perm is not None and tp.state[1].folded is not None
    np.testing.assert_array_equal(_np(tp.perm), np.asarray(jp.perm))
    v = np.random.default_rng(7).standard_normal(s.shape[0]).astype(dtype)
    got = tp.apply(torch.from_numpy(v))
    assert got.dtype == torch.from_numpy(v).dtype
    tol = 1e-12 if dtype == np.float64 else 1e-5
    bound = tol * (abs(s).astype(np.float64) @ np.abs(v.astype(np.float64)))
    err = np.abs(_np(got).astype(np.float64)
                 - np.asarray(jp.apply(jnp.asarray(v)), np.float64))
    assert np.all(err <= bound), (err - bound).max()
    vp = torch.from_numpy(v).reshape(-1, 2)[tp.perm].reshape(-1)
    want = tp.apply_permuted(vp).reshape(-1, 2)[tp.inv_perm].reshape(-1)
    assert torch.equal(got, want)
