"""The mono (MSR/MSC), packed triangular and packed trapezoidal formats of
the PyTorch port, held against the reference.

The goldens of ``tests/test_mono.py``, ``test_triangular.py`` and
``test_trapezoidal.py`` (mono_test.fut, triangular_test.fut,
trapezoidal_test.fut), zero sizes included, run through the port.  Against
the reference on the same numpy-seeded inputs: packed data and products
within 1e-12 in float64 (integers and structure exactly); the blocked
packed ``tri_smm`` / ``trap_smm`` paths at small forced thresholds; one
``tri_smm`` just above 4096 on the blocked path, against a float64 oracle
on sampled entries (float32 tolerance 1e-4 relative to ``|A||B|``); and
``tri_smm``'s gradient through ``torch.autograd`` against ``jax.grad``
within 1e-12 (after ``tests/test_autodiff.py``).  Every port call runs on
the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as jst
import sparse_tpu_torch as tst
from sparse_tpu.formats import trapezoidal as jtrap_mod
from sparse_tpu.formats import triangular as jtri_mod
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import mono as tmono
from sparse_tpu_torch.formats import trapezoidal as ttrap_mod
from sparse_tpu_torch.formats import triangular as ttri_mod

CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _dense(a):
    return _np(a.todense())


def _i32(x):
    return torch.tensor(x, dtype=torch.int32).reshape(len(x), -1) \
        if len(x) else torch.zeros((0, 0), dtype=torch.int32)


# -- mono (tests/test_mono.py, mono_test.fut) ----------------------------------

_SHAPES = [(2, 2), (2, 3), (3, 2), (1, 3), (0, 0), (0, 1), (1, 0)]


@pytest.mark.parametrize("n,m", _SHAPES)
def test_msr_msc_eye(n, m):
    np.testing.assert_array_equal(
        _dense(tst.msr_eye(n, m, torch.int32, device=CPU)),
        np.eye(n, m, dtype=np.int32))
    np.testing.assert_array_equal(
        _dense(tst.msc_eye(n, m, torch.int32, device=CPU)),
        np.eye(n, m, dtype=np.int32))


_MONO_CASES = [
    (2, 3, [0, 1], [0, 2], [2, 3], [[2, 0, 0], [0, 0, 3]]),
    (2, 3, [1, 0], [2, 0], [3, 2], [[2, 0, 0], [0, 0, 3]]),
    (2, 3, [], [], [], [[0, 0, 0], [0, 0, 0]]),
]


@pytest.mark.parametrize("n,m,rows,cols,vals,expected", _MONO_CASES)
@pytest.mark.parametrize("fmt", ["msr", "msc"])
def test_mono_sparse(fmt, n, m, rows, cols, vals, expected):
    build = tst.msr_from_triples if fmt == "msr" else tst.msc_from_triples
    a = build(n, m, zip(rows, cols, vals), dtype=torch.int32, device=CPU)
    np.testing.assert_array_equal(_dense(a), expected)


def test_msr_one_per_row_and_goldens():
    """mono.fut:122-125; mono_test.fut:46-53, 78-89."""
    with pytest.raises(ValueError, match="more than one"):
        tst.msr_from_triples(2, 3, [(0, 0, 1), (0, 2, 5)], device=CPU)
    a = tst.msr_from_triples(2, 3, [(0, 0, 1), (0, 0, 5)],
                             dtype=torch.int32, device=CPU)
    np.testing.assert_array_equal(_dense(a), [[6, 0, 0], [0, 0, 0]])
    a = tst.msr_from_triples(5, 5, zip([0, 1, 2, 3, 4], [0, 1, 1, 4, 3],
                                       [1, 3, 8, 6, 9]),
                             dtype=torch.int32, device=CPU)
    y = tst.msr_smvm(a, torch.tensor([3, 10, 2, 6, 5], dtype=torch.int32))
    np.testing.assert_array_equal(_np(y), [3, 30, 80, 30, 54])
    b = tst.msr_from_triples(4, 2, zip([0, 1, 2, 3], [0, 0, 1, 0],
                                       [1, 2, 3, 4]),
                             dtype=torch.int32, device=CPU)
    y = tst.msr_vsmm(torch.tensor([10, 20, 30, 40], dtype=torch.int32), b)
    np.testing.assert_array_equal(_np(y), [210, 90])


def test_msr_nnz_coo_transpose():
    a = tst.msr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)],
                             dtype=torch.int32, device=CPU)
    assert int(tst.msr_nnz(a)) == 2
    c = tst.coo_compact(tst.msr_to_coo(a))
    assert _np(c.row).tolist() == [0, 1] and _np(c.col).tolist() == [0, 2]
    assert _np(c.data).tolist() == [2, 3]
    assert int(tst.msr_nnz(tst.msr_from_triples(
        2, 3, [], dtype=torch.int32, device=CPU))) == 0
    t = tst.msr_transpose(a)
    assert isinstance(t, tst.MSC)
    np.testing.assert_array_equal(_dense(t), [[2, 0], [0, 0], [0, 3]])
    b = tst.msc_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)],
                             dtype=torch.int32, device=CPU)
    assert isinstance(b.T, tst.MSR)
    np.testing.assert_array_equal(_dense(b.T), [[2, 0], [0, 0], [0, 3]])
    c = tst.coo_compact(tst.msc_to_coo(b))
    assert _np(c.row).tolist() == [0, 1] and _np(c.col).tolist() == [0, 2]
    assert int(tst.msc_nnz(b)) == 2


def test_msr_add_sub_dmsmm_vsmm():
    a = tst.msr_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)], device=CPU)
    b = tst.msr_scale(2.0, a)
    np.testing.assert_array_equal(_dense(a + b), [[6, 0, 0], [0, 0, 9]])
    np.testing.assert_array_equal(_dense(b - a), [[2, 0, 0], [0, 0, 3]])
    c = tst.msr_from_triples(2, 3, [(0, 1, 2.0), (1, 2, 3.0)], device=CPU)
    with pytest.raises(ValueError, match="identical stored structure"):
        tst.msr_add(a, c)
    s = tst.msr_from_triples(4, 2, zip([0, 1, 2, 3], [0, 0, 1, 0],
                                       [1.0, 2.0, 3.0, 4.0]),
                             dtype=torch.float64, device=CPU)
    d = torch.arange(8, dtype=torch.float64).reshape(2, 4)
    np.testing.assert_array_equal(_np(tst.msr_dmsmm(d, s)),
                                  _np(d) @ _dense(s))
    np.testing.assert_array_equal(_np(d @ s), _np(d) @ _dense(s))
    m = tst.msc_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)],
                             dtype=torch.float64, device=CPU)
    np.testing.assert_array_equal(_np(tst.msc_vsmm(
        torch.tensor([10.0, 100.0], dtype=torch.float64), m)),
        [20.0, 0.0, 300.0])
    np.testing.assert_array_equal(_dense(m + m), 2 * _dense(m))
    np.testing.assert_array_equal(_dense(tst.msc_sub(m, m)), 0 * _dense(m))
    np.testing.assert_array_equal(_dense(tst.msc_diag(torch.tensor(
        [1.0, 2.0]))), np.diag([1.0, 2.0]))
    np.testing.assert_array_equal(_dense(tst.msc_empty(2, 3, device=CPU)),
                                  np.zeros((2, 3)))


def test_mono_vs_reference():
    """``msr_from_coo`` (the last normalized entry of a row wins),
    ``msr_smvm``/``vsmm`` and ``interop.msr_from_arrays``, against the
    reference; ``debug_checks`` toggles the module switch."""
    rng = np.random.default_rng(4)
    n, m = 30, 20
    r = rng.integers(0, n, 40)
    c = rng.integers(0, m, 40)
    d = rng.standard_normal(40)
    j = jst.msr_from_coo(jst.coo_make((n, m), r, c, jnp.asarray(d)))
    t = tst.msr_from_coo(tst.coo_make((n, m), r, c, torch.from_numpy(d),
                                      device=CPU))
    np.testing.assert_array_equal(_np(t.col_idx), np.asarray(j.col_idx))
    np.testing.assert_array_equal(_np(t.vals), np.asarray(j.vals))
    v, w = rng.standard_normal(m), rng.standard_normal(n)
    np.testing.assert_allclose(_np(t @ torch.from_numpy(v)),
                               np.asarray(jst.msr_smvm(j, jnp.asarray(v))),
                               rtol=1e-12)
    np.testing.assert_allclose(_np(torch.from_numpy(w) @ t),
                               np.asarray(jst.msr_vsmm(jnp.asarray(w), j)),
                               rtol=1e-12)
    tc = interop.msr_from_arrays(j.col_idx, j.vals, j.shape, device=CPU)
    np.testing.assert_array_equal(_dense(tc), np.asarray(j.todense()))
    tmono.debug_checks(True)
    try:
        assert tmono._DEBUG_CHECKS
    finally:
        tmono.debug_checks(False)
    assert not tmono._DEBUG_CHECKS


# -- triangular (tests/test_triangular.py, triangular_test.fut) ----------------


@pytest.mark.parametrize("n", [0, 2, 4])
@pytest.mark.parametrize("lower", [True, False])
def test_tri_eye(n, lower):
    np.testing.assert_array_equal(
        _dense(tst.tri_eye(n, lower=lower, dtype=torch.int32, device=CPU)),
        np.eye(n, dtype=np.int32))


@pytest.mark.parametrize("x, expect", [
    ([[1, 2, 3], [0, 4, 5], [0, 0, 6]], 6), ([], 0),
    ([[0, 0, 0], [0, 0, 0], [0, 0, 0]], 0)])
def test_tri_upper_nnz(x, expect):
    assert int(tst.tri_nnz(tst.tri_from_dense(_i32(x), lower=False))) \
        == expect


def test_tri_from_dense_transpose():
    """triangular_test.fut:33-94."""
    x = _i32([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    np.testing.assert_array_equal(_dense(tst.tri_from_dense(x, lower=False)),
                                  [[1, 2, 3], [0, 5, 6], [0, 0, 9]])
    np.testing.assert_array_equal(_dense(tst.tri_from_dense(x)),
                                  [[1, 0, 0], [4, 5, 0], [7, 8, 9]])
    for n in (0, 3):
        rng = np.random.default_rng(0)
        u = np.triu(rng.integers(1, 9, (n, n))).astype(np.int32)
        t = tst.tri_from_dense(torch.from_numpy(u), lower=False)
        lo = tst.tri_transpose(t)
        assert lo.lower and lo.data is t.data
        np.testing.assert_array_equal(_dense(lo), u.T)
        np.testing.assert_array_equal(_dense(lo.T), u)


@pytest.mark.parametrize("lower,a,b,expect", [
    (True, [[1, 0], [0, 1]], [[1, 0], [0, 1]], [[1, 0], [0, 1]]),
    (True, [[1, 0], [3, 4]], [[1, 0], [3, 4]], [[1, 0], [15, 16]]),
    (False, [[1, 0], [0, 1]], [[1, 0], [0, 1]], [[1, 0], [0, 1]]),
    (False, [[1, 2], [0, 4]], [[10, 20], [0, 40]], [[10, 100], [0, 160]]),
])
def test_tri_smm_goldens(lower, a, b, expect):
    """triangular_test.fut:96-112."""
    got = tst.tri_smm(tst.tri_from_dense(_i32(a), lower=lower),
                      tst.tri_from_dense(_i32(b), lower=lower))
    assert got.lower == lower and got.dtype == torch.int32
    np.testing.assert_array_equal(_dense(got), expect)


@pytest.mark.parametrize("n", [1, 5, 17])
@pytest.mark.parametrize("lower", [True, False])
def test_tri_vs_reference(n, lower):
    rng = np.random.default_rng(n)
    mask = np.tril if lower else np.triu
    xa, xb = mask(rng.standard_normal((n, n))), mask(rng.standard_normal(
        (n, n)))
    ja, jb = (jst.tri_from_dense(jnp.asarray(x), lower=lower)
              for x in (xa, xb))
    ta, tb = (tst.tri_from_dense(torch.from_numpy(x), lower=lower)
              for x in (xa, xb))
    np.testing.assert_array_equal(_np(ta.data), np.asarray(ja.data))
    np.testing.assert_allclose(_np(tst.tri_smm(ta, tb).data),
                               np.asarray(jst.tri_smm(ja, jb).data),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_dense(ta @ tb), xa @ xb, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_dense(ta + tb), xa + xb, rtol=1e-12)
    np.testing.assert_allclose(_dense(ta - tb), xa - xb, rtol=1e-12)
    np.testing.assert_allclose(_dense(2.0 * ta), 2 * xa, rtol=1e-12)
    np.testing.assert_allclose(_dense(tst.tri_map(torch.exp, ta)),
                               mask(np.exp(xa)), rtol=1e-12)
    tc = interop.triangular_from_arrays(ja.data, n, lower, device=CPU)
    np.testing.assert_array_equal(_dense(tc), np.asarray(ja.todense()))


def test_tri_zero_diag_idx():
    z = tst.tri_zero(4, device=CPU)
    assert tuple(z.data.shape) == (tst.tri_elements(4),)
    np.testing.assert_array_equal(_dense(z), np.zeros((4, 4)))
    v = torch.tensor([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(_dense(tst.tri_diag(v)), np.diag([1, 2, 3]))
    a = tst.tri_from_dense(torch.tensor([[1.0, 0], [2, 3]]))
    assert float(tst.tri_idx(a, 1, 0)) == 2.0
    assert float(tst.tri_idx(a, 0, 1)) == 0.0
    u = a.T
    assert float(tst.tri_idx(u, 0, 1)) == 2.0
    assert float(tst.tri_idx(u, 1, 0)) == 0.0
    with pytest.raises(ValueError, match="cannot mix"):
        tst.tri_add(a, u)
    with pytest.raises(ValueError, match="square"):
        tst.tri_from_dense(torch.zeros(2, 3))


def test_unrank_rows_exact_to_the_cap():
    """The float32 square root plus the integer fix-up is exact up to the
    last packed slot of n = 46340, and equals the reference's rows where
    the reference's int32 fix-up does not overflow (its last row's slots
    but one come out as 46341: a known defect of the reference)."""
    P = tst.tri_elements(ttri_mod._TRI_N_MAX)
    p = np.array([0, 1, 2, 12345678, P - 46340, P - 2, P - 1], np.int64)
    rows = _np(ttri_mod._unrank_rows(torch.from_numpy(p)))
    for pi, ri in zip(p, rows):
        assert ri * (ri + 1) // 2 <= pi < (ri + 1) * (ri + 2) // 2
    assert rows[-1] == ttri_mod._TRI_N_MAX - 1
    np.testing.assert_array_equal(rows[:5], np.asarray(
        jtri_mod._unrank_rows(jnp.asarray(p[:5], jnp.int32))))


@pytest.mark.parametrize("lower", [True, False])
def test_tri_smm_blocked_vs_reference(monkeypatch, lower):
    """Both packages on their blocked packed paths at a forced small
    threshold (B = 8, n = 37): the same packed product."""
    for mod in (jtri_mod, ttri_mod):
        monkeypatch.setattr(mod, "_TRI_DENSE_MAX", 20)
        monkeypatch.setattr(mod, "_TRI_BLOCK", 8)
    rng = np.random.default_rng(9)
    mask = np.tril if lower else np.triu
    x, y = mask(rng.standard_normal((37, 37))), mask(
        rng.standard_normal((37, 37)))
    j = jst.tri_smm(jst.tri_from_dense(jnp.asarray(x), lower=lower),
                    jst.tri_from_dense(jnp.asarray(y), lower=lower))
    t = tst.tri_smm(tst.tri_from_dense(torch.from_numpy(x), lower=lower),
                    tst.tri_from_dense(torch.from_numpy(y), lower=lower))
    assert t.lower == lower
    np.testing.assert_allclose(_np(t.data), np.asarray(j.data), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_dense(t), x @ y, rtol=1e-12, atol=1e-12)


def test_tri_smm_blocked_above_4096():
    """n = 4097 takes the blocked path at its real thresholds (B = 512);
    sampled entries against a float64 oracle."""
    n = ttri_mod._TRI_DENSE_MAX + 1
    rng = np.random.default_rng(17)
    P = tst.tri_elements(n)
    ad = rng.standard_normal(P).astype(np.float32)
    bd = rng.standard_normal(P).astype(np.float32)
    c = tst.tri_smm(tst.Triangular(torch.from_numpy(ad), n, True),
                    tst.Triangular(torch.from_numpy(bd), n, True))
    assert c.data.shape == (P,) and c.lower
    rows = np.concatenate([[0, n - 1, n - 1, 4096, 511, 512],
                           rng.integers(0, n, 60)])
    cols = np.concatenate([[0, 0, n - 1, 511, 511, 0],
                           [rng.integers(0, r + 1) for r in rows[6:]]])
    got = _np(c.data)[rows * (rows + 1) // 2 + cols]
    for r, col, g in zip(rows, cols, got):
        k = np.arange(col, r + 1)
        a_row = ad[r * (r + 1) // 2 + k].astype(np.float64)
        b_col = bd[k * (k + 1) // 2 + col].astype(np.float64)
        assert abs(g - a_row @ b_col) <= 1e-4 * (np.abs(a_row) @ np.abs(
            b_col)) + 1e-6


def test_tri_smm_grad_vs_jax():
    """d/d(a.data) of sum(dense(tri_smm(a, b))^2) through torch.autograd,
    against jax.grad on the reference (tests/test_autodiff.py:70-91)."""
    n = 6
    rng = np.random.default_rng(5)
    xa, xb = np.tril(rng.standard_normal((n, n))), np.tril(
        rng.standard_normal((n, n)))

    def jloss(data):
        a = dataclasses.replace(jst.tri_from_dense(jnp.asarray(xa)),
                                data=data)
        b = jst.tri_from_dense(jnp.asarray(xb))
        return jnp.sum(jst.tri_todense(jst.tri_smm(a, b)) ** 2)

    want = np.asarray(jax.grad(jloss)(jst.tri_from_dense(
        jnp.asarray(xa)).data))
    data = tst.tri_from_dense(torch.from_numpy(xa)).data.clone()
    data.requires_grad_(True)
    a = tst.Triangular(data, n, True)
    b = tst.tri_from_dense(torch.from_numpy(xb))
    loss = torch.sum(tst.tri_todense(tst.tri_smm(a, b)) ** 2)
    loss.backward()
    np.testing.assert_allclose(_np(data.grad), want, rtol=1e-12, atol=1e-12)


# -- trapezoidal (tests/test_trapezoidal.py, trapezoidal_test.fut) -------------


@pytest.mark.parametrize("n,m", [(0, 0), (2, 2), (4, 4), (4, 2), (2, 4),
                                 (3, 5), (5, 3), (0, 3), (3, 0)])
@pytest.mark.parametrize("lower", [True, False])
def test_trap_eye(n, m, lower):
    np.testing.assert_array_equal(
        _dense(tst.trap_eye(n, m, lower=lower, dtype=torch.int32,
                            device=CPU)), np.eye(n, m, dtype=np.int32))


@pytest.mark.parametrize("x, lower, expect", [
    ([[1, 2, 3], [4, 5, 6], [7, 8, 9]], True,
     [[1, 0, 0], [4, 5, 0], [7, 8, 9]]),
    ([[1, 0], [3, 4], [5, 6], [7, 8]], True,
     [[1, 0], [3, 4], [5, 6], [7, 8]]),
    ([[1, 0, 0], [4, 5, 0]], True, [[1, 0, 0], [4, 5, 0]]),
    ([[1, 2, 3], [4, 5, 6], [7, 8, 9]], False,
     [[1, 2, 3], [0, 5, 6], [0, 0, 9]]),
])
def test_trap_from_dense(x, lower, expect):
    """trapezoidal_test.fut:35-67."""
    a = tst.trap_from_dense(_i32(x), lower=lower)
    np.testing.assert_array_equal(_dense(a), expect)
    if not lower:
        assert int(tst.trap_nnz(a)) == 6


def test_trap_transpose():
    """trapezoidal_test.fut:73-93; the rectangular transpose moves no
    data."""
    x = _i32([[1, 2, 3], [0, 4, 5], [0, 0, 6]])
    lo = tst.trap_transpose(tst.trap_from_dense(x, lower=False))
    assert lo.lower and lo.shape == (3, 3)
    np.testing.assert_array_equal(_dense(lo), _np(x).T)
    np.testing.assert_array_equal(_dense(lo.T), _np(x))
    y = np.tril(np.arange(1, 13).reshape(4, 3)).astype(np.int32)
    a = tst.trap_from_dense(torch.from_numpy(y))
    t = tst.trap_transpose(a)
    assert t.shape == (3, 4) and not t.lower and t.data is a.data
    np.testing.assert_array_equal(_dense(t), y.T)


@pytest.mark.parametrize("lower,a,b,expect", [
    (True, [[1, 0], [3, 4]], [[1, 0], [3, 4]], [[1, 0], [15, 16]]),
    (True, [[1, 0], [3, 4], [5, 6], [7, 8]], [[1, 0, 0], [4, 5, 0]],
     [[1, 0, 0], [19, 20, 0], [29, 30, 0], [39, 40, 0]]),
    (True, [[1, 0, 0], [4, 5, 0], [7, 8, 9]], [[1, 0], [3, 4], [5, 6]],
     [[1, 0], [19, 20], [76, 86]]),
    (False, [[1, 0], [0, 1]], [[1, 0], [0, 1]], [[1, 0], [0, 1]]),
    (False, [[1, 2], [0, 4]], [[10, 20], [0, 40]], [[10, 100], [0, 160]]),
])
def test_trap_smm_goldens(lower, a, b, expect):
    """trapezoidal_test.fut:95-116, rectangular cases included."""
    got = tst.trap_smm(tst.trap_from_dense(_i32(a), lower=lower),
                       tst.trap_from_dense(_i32(b), lower=lower))
    assert got.lower == lower and got.shape == (len(a), len(b[0]))
    np.testing.assert_array_equal(_dense(got), expect)


@pytest.mark.parametrize("n,m,k", [(5, 3, 4), (3, 5, 2), (1, 7, 1)])
@pytest.mark.parametrize("lower", [True, False])
def test_trap_vs_reference(n, m, k, lower):
    rng = np.random.default_rng(n * 100 + m * 10 + k)
    mask = np.tril if lower else np.triu
    xa, xb = mask(rng.standard_normal((n, m))), mask(rng.standard_normal(
        (m, k)))
    ja, jb = (jst.trap_from_dense(jnp.asarray(x), lower=lower)
              for x in (xa, xb))
    ta, tb = (tst.trap_from_dense(torch.from_numpy(x), lower=lower)
              for x in (xa, xb))
    np.testing.assert_array_equal(_np(ta.data), np.asarray(ja.data))
    np.testing.assert_allclose(_np((ta @ tb).data),
                               np.asarray(jst.trap_smm(ja, jb).data),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_dense(ta + ta), 2 * xa, rtol=1e-12)
    np.testing.assert_allclose(_dense(ta - 3.0 * ta), -2 * xa, rtol=1e-12)
    np.testing.assert_allclose(_dense(tst.trap_map(lambda d: d * d, ta)),
                               xa * xa, rtol=1e-12)
    tc = interop.trapezoidal_from_arrays(ja.data, n, m, lower, device=CPU)
    np.testing.assert_array_equal(_dense(tc), np.asarray(ja.todense()))
    with pytest.raises(ValueError, match="inner dims"):
        tst.trap_smm(ta, ta) if m != n else tst.trap_smm(ta, tb.T)


def test_trap_zero_diag_idx():
    np.testing.assert_array_equal(_dense(tst.trap_zero(3, 2, device=CPU)),
                                  np.zeros((3, 2)))
    assert tuple(tst.trap_zero(2, 3, lower=False, device=CPU).data.shape) \
        == (tst.trap_elements(3, 2),)
    np.testing.assert_array_equal(
        _dense(tst.trap_diag(torch.tensor([1.0, 2.0]))), np.diag([1.0, 2.0]))
    a = tst.trap_from_dense(torch.tensor([[1.0, 0], [2, 3], [4, 5]]))
    assert float(tst.trap_idx(a, 2, 1)) == 5.0
    assert float(tst.trap_idx(a, 0, 1)) == 0.0
    u = a.T
    assert float(tst.trap_idx(u, 1, 2)) == 5.0
    assert float(tst.trap_idx(u, 1, 0)) == 0.0
    with pytest.raises(ValueError, match="shape mismatch"):
        tst.trap_add(a, tst.trap_zero(2, 2, device=CPU))


@pytest.mark.parametrize("n,m,k", [(37, 21, 30), (19, 40, 26)])
@pytest.mark.parametrize("lower", [True, False])
def test_trap_smm_blocked_vs_reference(monkeypatch, n, m, k, lower):
    """Both packages on their blocked packed paths at a forced small
    threshold (B = 8): the same packed product, tall and wide."""
    for mod, name in ((jtrap_mod, "_TRAP"), (ttrap_mod, "_TRAP")):
        monkeypatch.setattr(mod, f"{name}_DENSE_MAX", 20)
        monkeypatch.setattr(mod, f"{name}_BLOCK", 8)
    rng = np.random.default_rng(n + m + k)
    mask = np.tril if lower else np.triu
    x, y = mask(rng.standard_normal((n, m))), mask(rng.standard_normal(
        (m, k)))
    j = jst.trap_smm(jst.trap_from_dense(jnp.asarray(x), lower=lower),
                     jst.trap_from_dense(jnp.asarray(y), lower=lower))
    t = tst.trap_smm(tst.trap_from_dense(torch.from_numpy(x), lower=lower),
                     tst.trap_from_dense(torch.from_numpy(y), lower=lower))
    assert t.shape == (n, k) and t.lower == lower
    np.testing.assert_allclose(_np(t.data), np.asarray(j.data), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_dense(t), x @ y, rtol=1e-12, atol=1e-12)
