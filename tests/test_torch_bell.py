"""K3-K6 — the blocked-ELL SpMM kernels — and the banded planner of the
PyTorch port against the reference (``sparse_tpu/ops/pallas_bell.py`` in
interpret mode, ``sparse_tpu/formats/bell.py``).

The reference's plan and densified tiles are carried across by ``interop``,
so each kernel's plain version is checked apart from its planner; the
planners are checked field by field.  Tolerances, times ``|A||B|`` per
element (the two packages sum in different orders): float32 1e-5, float64
1e-12, and for a bf16 stream the float32 bound on the bf16-rounded inputs.
The kernels themselves are tested on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.formats import bell as jbell
from sparse_tpu.ops import pallas_bell as jpb
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bell as tbell
from sparse_tpu_torch.ops import cuda_bell as tcb

TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 1e-5}
PLAN_FIELDS = ("offs", "start", "rel", "sup")
PLAN_META = ("W", "rt", "S", "SW")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _pair(x, bsz):
    """(reference BELL, port BELL) of the dense matrix ``x`` from the same
    arrays: each block row stores its non-zero blocks in column order, short
    rows padded with zero blocks at column 0 (``bell_from_bsr``'s layout)."""
    nb = x.shape[0] // bsz
    xb = x.reshape(nb, bsz, nb, bsz).transpose(0, 2, 1, 3)
    nz = np.any(xb != 0, axis=(2, 3))
    Lb = max(int(nz.sum(1).max()), 1)
    cols = np.zeros((nb, Lb), np.int32)
    blocks = np.zeros((nb, Lb, bsz, bsz), x.dtype)
    for r in range(nb):
        (c,) = np.nonzero(nz[r])
        cols[r, :c.size] = c
        blocks[r, :c.size] = xb[r, c]
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=x.shape[0], bsz=bsz)
    return ja, interop.bell_from_arrays(cols, blocks, x.shape[0], bsz,
                                        device="cpu")


def banded(nb, bsz, hb, seed, empty_rows=(), dtype=np.float32):
    rng = np.random.default_rng(seed)
    mask = np.zeros((nb, nb), bool)
    for off in range(-hb, hb + 1):
        mask |= np.eye(nb, k=off, dtype=bool)
    for r in empty_rows:
        mask[r] = False
    x = (rng.standard_normal((nb * bsz, nb * bsz))
         * np.kron(mask, np.ones((bsz, bsz)))).astype(dtype)
    return (x,) + _pair(x, bsz)


def scattered(nb, bsz, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mask = np.kron(rng.random((nb, nb)) < density, np.ones((bsz, bsz)))
    x = (rng.standard_normal((nb * bsz, nb * bsz)) * mask).astype(dtype)
    return (x,) + _pair(x, bsz)


def _operand(n, k, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_close(got, ref, x, b, tol):
    bound = tol * (np.abs(x).astype(np.float64) @ np.abs(b).astype(
        np.float64))
    err = np.abs(_np(got).astype(np.float64) - _np(ref).astype(np.float64))
    assert err.shape == bound.shape
    assert np.all(err <= bound), (err - bound).max()


def _assert_same_plan(tp, jp):
    for f in PLAN_FIELDS:
        t, j = _np(getattr(tp, f)), np.asarray(getattr(jp, f))
        assert t.dtype == j.dtype == np.int32, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    for f in PLAN_META:
        assert getattr(tp, f) == getattr(jp, f), f
    start, sup, rel = (_np(getattr(tp, f)) for f in ("start", "sup", "rel"))
    np.testing.assert_array_equal(start, np.repeat(sup, tp.S) + rel)


def _ref_kit(jpb_kit, transposed=False):
    tiles = jpb_kit.tiles_t if transposed else jpb_kit.tiles
    make = (interop.banded_kit_t_from_arrays if transposed
            else interop.banded_kit_from_arrays)
    return make(jpb_kit.plan, tiles, device="cpu")


# -- the planner --------------------------------------------------------------


@pytest.mark.parametrize("nb,bsz,hb,rt,align,empty", [
    (40, 8, 2, 4, False, ()),        # S > 1
    (37, 8, 2, 4, False, (18,)),     # nb % rt != 0, an empty row
    (16, 8, 1, 4, False, (8,)),
    (24, 16, 1, 2, False, ()),
    (12, 16, 1, 3, False, ()),
    (15, 32, 2, 5, False, ()),       # the bench's rt and band at small nb
    (16, 32, 1, 4, True, ()),        # transposed plans: lane-aligned starts
    (33, 8, 1, 16, True, (0, 32)),
    (12, 64, 1, 2, True, ()),
])
def test_banded_plan_and_tiles_match_reference(nb, bsz, hb, rt, align,
                                               empty):
    _, ja, ta = banded(nb, bsz, hb, seed=nb + rt, empty_rows=empty)
    jp = jpb.build_banded_plan(ja, row_tile=rt, align_start=align)
    tp = tcb.build_banded_plan(ta, row_tile=rt, align_start=align)
    assert jp is not None and tp is not None
    _assert_same_plan(tp, jp)
    sv = np.any(np.asarray(ja.blocks) != 0, axis=(2, 3))
    _assert_same_plan(tcb.build_banded_plan(ta, row_tile=rt, slot_valid=sv,
                                            align_start=align), jp)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        tt = tcb._densify_band_tiles(ta, tp, dt)
        jt = jpb._densify_band_tiles(ja, jp, jdt)
        assert tt.dtype == dt
        np.testing.assert_array_equal(_np(tt), np.asarray(
            jt.astype(jnp.float32)))


def test_prepare_kits_match_reference():
    _, ja, ta = banded(40, 32, 2, seed=11)
    for prep, field in ((tcb.bell_banded_prepare, "tiles"),
                        (tcb.bell_banded_prepare_t, "tiles_t")):
        jprep = getattr(jpb, prep.__name__)
        for rt in (None, 4):
            tk, jk = prep(ta, row_tile=rt), jprep(ja, row_tile=rt)
            _assert_same_plan(tk.plan, jk.plan)
            np.testing.assert_array_equal(_np(getattr(tk, field)),
                                          np.asarray(getattr(jk, field)))
    assert tcb.bell_banded_prepare_t(ta, row_tile=3) is None  # 96 % 128
    assert jpb.bell_banded_prepare_t(ja, row_tile=3) is None


def test_banded_plan_fallbacks_match_reference():
    n, bsz = 64, 8
    y = np.zeros((n, n), np.float32)
    y[:bsz, -bsz:] = 1.0
    y[:bsz, :bsz] = 1.0  # non-consecutive block columns
    ja, ta = _pair(y, bsz)
    assert tcb.build_banded_plan(ta, row_tile=2) is None
    assert jpb.build_banded_plan(ja, row_tile=2) is None
    _, ja, ta = banded(8, bsz, 1, seed=1)
    assert tcb.build_banded_plan(ta, row_tile=2, max_window=2) is None
    assert jpb.build_banded_plan(ja, row_tile=2, max_window=2) is None
    assert tcb.bell_banded_prepare(ta, max_window=2) is None
    sv = np.ones((8, ta.Lb), bool)
    with pytest.raises(ValueError, match="slot_valid"):
        tcb.build_banded_plan(ta, row_tile=2, slot_valid=sv[:, :1])


# -- the kernels' plain versions against the reference kernels ----------------


# bsz 80: past the persistent body's 64, where K6 runs K3's band body on
# the card (at k 33); bsz 128 (one 128-row tile) and 192 (two, the second
# ragged) at k 16, where its float64 kind runs the wide-block body; these
# hold the plain versions the card tests compare the kernels with
@pytest.mark.parametrize("n,bsz,k,dtype", [
    (32, 8, 128, np.float32),
    (64, 16, 8, np.float64),
    (36, 4, 1, np.float32),
    (160, 80, 33, np.float32),
    (160, 80, 33, np.float64),
    (384, 128, 16, np.float32),
    (384, 128, 16, np.float64),
    (384, 192, 16, np.float32),
    (384, 192, 16, np.float64),
])
def test_k6_block_matches_reference(n, bsz, k, dtype):
    x, ja, ta = scattered(n // bsz, bsz, 0.4, seed=n + k, dtype=dtype)
    b = _operand(n, k, seed=k, dtype=dtype)
    got = tcb.bell_spmm_block(ta, torch.from_numpy(b))
    ref = jpb.bell_spmm_pallas(ja, jnp.asarray(b), interpret=True)
    assert got.dtype == torch.from_numpy(b).dtype
    _assert_close(got, ref, x, b, TOL[np.dtype(dtype).name])
    _assert_close(got, x.astype(np.float64) @ b, x, b,
                  TOL[np.dtype(dtype).name])
    _assert_close(tcb.bell_spmm_block_plain(ta, torch.from_numpy(b)), got,
                  x, b, TOL[np.dtype(dtype).name])


@pytest.mark.parametrize("n,bsz,k,dtype,compute", [
    (32, 8, 128, np.float32, None),
    (64, 16, 32, np.float64, None),
    (32, 8, 128, np.float32, "bfloat16"),
    (160, 80, 33, np.float32, None),
    (160, 80, 33, np.float64, None),
])
def test_k3_fused_matches_reference(n, bsz, k, dtype, compute):
    x, ja, ta = scattered(n // bsz, bsz, 0.4, seed=n * 2 + k, dtype=dtype)
    b = _operand(n, k, seed=k + 1, dtype=dtype)
    got = tcb.bell_spmm_fused(
        ta, torch.from_numpy(b),
        compute_dtype=getattr(torch, compute) if compute else None)
    ref = jpb.bell_spmm_pallas_fused(
        ja, jnp.asarray(b), interpret=True,
        compute_dtype=getattr(jnp, compute) if compute else None)
    assert got.dtype == torch.from_numpy(b).dtype
    if compute:
        x, b = _bf16(x), _bf16(b)
    tol = TOL[compute or np.dtype(dtype).name]
    _assert_close(got, ref, x, b, tol)
    _assert_close(got, x.astype(np.float64) @ b, x, b, tol)


@pytest.mark.parametrize("nb,bsz,hb,rt,k,tier,S", [
    (40, 8, 2, 4, 128, None, 5),
    (27, 8, 2, 4, 64, None, 1),        # nb % rt != 0: 7 tiles
    (40, 8, 2, 4, 128, "bf16x3", 5),
    (24, 16, 1, 2, 32, "bfloat16", 4),
    (20, 8, 1, 4, 16, "float64", 1),
])
def test_k4_banded_matches_reference(nb, bsz, hb, rt, k, tier, S):
    dtype = np.float64 if tier == "float64" else np.float32
    x, ja, ta = banded(nb, bsz, hb, seed=nb * 3 + rt, empty_rows=(nb // 2,),
                       dtype=dtype)
    jdt = jnp.bfloat16 if tier == "bfloat16" else None
    jk = jpb.bell_banded_prepare(ja, row_tile=rt, compute_dtype=jdt)
    assert jk.plan.S == S
    tk = _ref_kit(jk)
    b = _operand(nb * bsz, k, seed=rt + k, dtype=dtype)
    prec = "bf16x3" if tier == "bf16x3" else None
    got = tcb.bell_spmm_banded(ta, torch.from_numpy(b), tk.plan,
                               tiles=tk.tiles, compute_dtype=tk.tiles.dtype,
                               precision=prec)
    ref = jpb.bell_spmm_pallas_banded(ja, jnp.asarray(b), jk.plan,
                                      tiles=jk.tiles,
                                      compute_dtype=jk.tiles.dtype,
                                      precision=prec, interpret=True)
    assert got.shape == (nb * bsz, k) and got.dtype == torch.from_numpy(
        b).dtype
    if tier == "bfloat16":
        x, b = _bf16(x), _bf16(b)
    tol = TOL["float64" if tier == "float64" else "float32"]
    _assert_close(got, ref, x, b, tol)
    # bf16x3 drops the lo*lo term and rounds the residuals: ~3 * 2^-16
    _assert_close(got, x.astype(np.float64) @ b, x, b,
                  1e-4 if tier == "bf16x3" else tol)
    # the port's own kit and the in-call densify give the same product
    own = tcb.bell_spmm_banded(ta, torch.from_numpy(b).to(tk.tiles.dtype)
                               if tier == "bfloat16" else torch.from_numpy(b),
                               tcb.build_banded_plan(ta, row_tile=rt),
                               compute_dtype=tk.tiles.dtype, precision=prec)
    _assert_close(own, got, x, b, tol)


@pytest.mark.parametrize("nb,bsz,hb,k,padded,prec", [
    (16, 32, 1, 32, False, None),
    (24, 16, 2, 64, True, None),
    (33, 8, 1, 8, False, "bf16x3"),
    (33, 8, 1, 8, True, None),
])
def test_k5_banded_t_matches_reference(nb, bsz, hb, k, padded, prec):
    x, ja, ta = banded(nb, bsz, hb, seed=nb + k)
    jk = jpb.bell_banded_prepare_t(ja)
    tk = _ref_kit(jk, transposed=True)
    n = nb * bsz
    n_pad = jk.plan.offs.shape[0] * bsz
    b = _operand(n, k, seed=3)
    bt = b.T.copy()
    if padded:
        bt = np.concatenate([bt, np.zeros((k, n_pad - n), np.float32)], 1)
    got = tcb.bell_spmm_banded_t(ta, torch.from_numpy(bt), tk,
                                 precision=prec)
    ref = jpb.bell_spmm_pallas_banded_t(ja, jnp.asarray(bt), jk,
                                        precision=prec, interpret=True)
    assert got.shape == ref.shape == (k, n_pad if padded else n)
    tol = 1e-4 if prec else TOL["float32"]
    _assert_close(got[:, :n].T, np.asarray(ref)[:, :n].T, x, b,
                  TOL["float32"])
    _assert_close(got[:, :n].T, x.astype(np.float64) @ b, x, b, tol)
    if padded:
        assert not got[:, n:].any()
    with pytest.raises(ValueError, match="operand shape"):
        tcb.bell_spmm_banded_t(ta, torch.from_numpy(bt[:, :-1]), tk)


# -- bell_spmm and the BELL surface -------------------------------------------


def test_bell_spmm_dispatch_by_plan_type(monkeypatch):
    x, ja, ta = banded(24, 32, 1, seed=5)
    b = _operand(ta.n, 32, seed=0)
    tb = torch.from_numpy(b)
    ref = x.astype(np.float64) @ b
    kit = tcb.bell_banded_prepare(ta)
    kit_t = tcb.bell_banded_prepare_t(ta)
    calls = []
    # a BandedKit goes to K4 through its chunk mask (_bell_spmm_kit)
    for name in ("bell_spmm_fused", "bell_spmm_banded", "bell_spmm_banded_t",
                 "_bell_spmm_kit"):
        orig = getattr(tcb, name)
        monkeypatch.setattr(tcb, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    cases = [(None, "bell_spmm_fused"), (kit, "_bell_spmm_kit"),
             (kit.plan, "bell_spmm_banded"), (kit_t, "bell_spmm_banded_t")]
    for plan, want in cases:
        calls.clear()
        got = tbell.bell_spmm(ta, tb, prefer_pallas=True, plan=plan)
        assert calls == [want]
        assert got.shape == (ta.n, 32) and got.is_contiguous()
        _assert_close(got, ref, x, b, TOL["float32"])
    # CPU tensors default to the gather-einsum path, as the reference does
    # off-TPU
    calls.clear()
    for prefer in (None, False):
        got = tbell.bell_spmm(ta, tb, prefer_pallas=prefer, plan=kit)
        _assert_close(got, ref, x, b, TOL["float32"])
    assert calls == []
    _assert_close(got, jbell.bell_spmm(ja, jnp.asarray(b)), x, b,
                  TOL["float32"])
    with pytest.raises(TypeError, match="plan"):
        tbell.bell_spmm(ta, tb, prefer_pallas=True, plan="banded")
    with pytest.raises(ValueError, match="operand shape"):
        tbell.bell_spmm(ta, tb[:-1])


@pytest.mark.parametrize("prefer", [None, True])
def test_bell_spmm_tiers_and_empty(prefer):
    x, ja, ta = scattered(8, 8, 0.5, seed=77)
    b = _operand(64, 16, seed=7)
    tb = torch.from_numpy(b)
    got = tbell.bell_spmm(ta, tb, prefer_pallas=prefer,
                          compute_dtype=torch.bfloat16)
    ref = jbell.bell_spmm(ja, jnp.asarray(b), compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    _assert_close(got, ref, _bf16(x), _bf16(b), TOL["bfloat16"])
    got = tbell.bell_spmm(ta, tb, prefer_pallas=prefer, precision="bf16x3")
    _assert_close(got, x.astype(np.float64) @ b, x, b, 1e-4)
    got = tbell.bell_spmm(ta, tb.double(), prefer_pallas=prefer)
    assert got.dtype == torch.float64
    _assert_close(got, x.astype(np.float64) @ b, x, b, TOL["float32"])
    assert tbell.bell_spmm(ta, tb[:, :0], prefer_pallas=prefer).shape == (
        64, 0)
    with pytest.raises(ValueError, match="stream dtype"):
        tbell.bell_spmm(ta, tb, prefer_pallas=prefer,
                        compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="precision"):
        tbell.bell_spmm(ta, tb, prefer_pallas=prefer, precision="fast")
    with pytest.raises(ValueError, match="bf16x3"):
        tbell.bell_spmm(ta, tb.double(), prefer_pallas=prefer,
                        precision="bf16x3")


def test_bell_banded_refresh_matches_reference():
    _, ja, ta = banded(20, 8, 1, seed=3)
    tk, jk = tcb.bell_banded_prepare(ta), jpb.bell_banded_prepare(ja)
    ja2 = jbell.BELL(cols=ja.cols, blocks=ja.blocks * 2.0, n=ja.n, bsz=ja.bsz)
    ta2 = interop.bell_from_arrays(ja2.cols, ja2.blocks, ja2.n, ja2.bsz,
                                   device="cpu")
    tk2 = tcb.bell_banded_refresh(tk, ta2)
    np.testing.assert_array_equal(_np(tk2.tiles), np.asarray(
        jpb.bell_banded_refresh(jk, ja2).tiles))
    np.testing.assert_array_equal(_np(tk2.tiles), _np(
        tcb.bell_banded_prepare(ta2).tiles))
    _, _, other = banded(20, 16, 1, seed=3)
    with pytest.raises(ValueError, match="does not fit"):
        tcb.bell_banded_refresh(tk, other)


def test_bell_todense_and_matmul_match_reference():
    x, ja, ta = scattered(6, 4, 0.5, seed=9, dtype=np.float64)
    np.testing.assert_array_equal(_np(tbell.bell_todense(ta)), x)
    np.testing.assert_array_equal(_np(ta.todense()),
                                  np.asarray(jbell.bell_todense(ja)))
    v = np.random.default_rng(1).standard_normal(24)
    b = _operand(24, 3, seed=2, dtype=np.float64)
    _assert_close(ta @ torch.from_numpy(v), x @ v, x, v, TOL["float64"])
    _assert_close(ta @ torch.from_numpy(b), np.asarray(ja @ jnp.asarray(b)),
                  x, b, TOL["float64"])
    assert ta.__matmul__(torch.zeros(24, 2, 2)) is NotImplemented
