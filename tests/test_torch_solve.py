"""The dense LU, the block-LU direct solver and the preconditioners of the
PyTorch port, held against the reference.

Goldens of ``tests/test_linalg_dense.py`` and ``tests/test_bsr_lu.py``
(blocked_square_regular_test.fut: ``P·A ≈ L·U`` at the reference's eps
6e-5, the ``[3, 4, -6, -1]`` solve, the forward/backward goldens, the g14
fill fixture) run through the port.  Against the reference on the same
numpy-seeded float64 inputs: ``bsr_lu_find_fills`` exactly, order
included; the LU plans and triangular-solve plans exactly; LU factors and
solves within 1e-10 and pivot vectors exactly; a zero pivot and a singular
block-Jacobi block behave as the reference's (non-finite entries in the
same places, the rest within 1e-12); a plan built by the reference and
carried over by ``interop`` gives the reference's factors.  Every port
call runs on the CPU.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as jst
import sparse_tpu_torch as tst
from sparse_tpu.linalg import dense as jdense
from sparse_tpu_torch import interop

jlu = importlib.import_module("sparse_tpu.solve.bsr_lu")
tlu = importlib.import_module("sparse_tpu_torch.solve.bsr_lu")
jpre = importlib.import_module("sparse_tpu.solve.precond")

CPU = "cpu"
BSZ = 2
EPS = 6e-5  # the reference's tolerance (blocked_square_regular_test.fut:250)
TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _split(lu):
    lu = _np(lu)
    return np.tril(lu, -1) + np.eye(lu.shape[0]), np.triu(lu)


def _same_nonfinite(got, want, rtol=1e-12):
    """Non-finite entries equal (inf sign, NaN) and the rest within
    ``rtol``."""
    got, want = _np(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(got[bad], want[bad])
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=rtol, atol=1e-14)


# -- dense LU (tests/test_linalg_dense.py) -------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 17, 32])
def test_lup_dense_vs_reference(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    lu, p = tst.lup_dense(_t(a))
    jlu_, jp = jdense.lup_dense(jnp.asarray(a))
    np.testing.assert_array_equal(_np(p), np.asarray(jp))
    assert p.dtype == torch.int32
    np.testing.assert_allclose(_np(lu), np.asarray(jlu_), rtol=TOL, atol=TOL)
    L, U = _split(lu)
    assert np.max(np.abs(a[_np(p)] - L @ U)) < EPS
    assert np.max(np.abs(np.tril(_np(lu), -1))) <= 1.0 + 1e-12


def test_lup_dense_batched_equals_one_by_one():
    """One column loop over a stack gives each block's own factors."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((5, 6, 6))
    lu, p = tst.lup_dense(_t(a))
    for i in range(5):
        li, pi = tst.lup_dense(_t(a[i]))
        np.testing.assert_array_equal(_np(lu[i]), _np(li))
        np.testing.assert_array_equal(_np(p[i]), _np(pi))
    lu0 = tst.lu_dense(_t(a + 6 * np.eye(6)))
    np.testing.assert_array_equal(_np(lu0[2]),
                                  _np(tst.lu_dense(_t(a[2] + 6 * np.eye(6)))))


def test_lup_needs_pivoting():
    a = np.array([[0.0, 1.0], [2.0, 3.0]])
    lu, p = tst.lup_dense(_t(a))
    L, U = _split(lu)
    np.testing.assert_allclose(a[_np(p)], L @ U, rtol=1e-12)
    assert _np(p).tolist() == [1, 0]


@pytest.mark.parametrize("case", ["zero_column", "zero_pivot_nopivot",
                                  "nan"])
def test_zero_pivot_as_reference(case):
    """A zero pivot does not raise: the factors carry the reference's
    zeros, infs and NaNs, entry for entry."""
    if case == "zero_column":  # lup: every candidate pivot is 0
        a = np.array([[0.0, 1, 2], [0, 3, 1], [0, 2, 5]])
        lu, p = tst.lup_dense(_t(a))
        jl, jp = jdense.lup_dense(jnp.asarray(a))
        np.testing.assert_array_equal(_np(p), np.asarray(jp))
    elif case == "zero_pivot_nopivot":  # lu: 1/0 multipliers
        a = np.array([[0.0, 1, 2], [4, 3, 1], [0, 2, 5]])
        lu, jl = tst.lu_dense(_t(a)), jdense.lu_dense(jnp.asarray(a))
    else:
        a = np.array([[1.0, np.nan, 2], [4, 3, 1], [0, 2, 5]])
        lu, p = tst.lup_dense(_t(a))
        jl, jp = jdense.lup_dense(jnp.asarray(a))
        np.testing.assert_array_equal(_np(p), np.asarray(jp))
    _same_nonfinite(lu, jl)


def test_lu_nopivot_and_solves():
    rng = np.random.default_rng(5)
    n = 9
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    np.testing.assert_allclose(_np(tst.lu_dense(_t(a))),
                               np.asarray(jdense.lu_dense(jnp.asarray(a))),
                               rtol=TOL, atol=TOL)
    L, U = np.tril(a, -1) + np.eye(n), np.triu(a)
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, 3))
    np.testing.assert_allclose(_np(tst.forsolve_dense(_t(a), _t(b))),
                               np.linalg.solve(L, b), rtol=TOL)
    np.testing.assert_allclose(_np(tst.backsolve_dense(_t(a), _t(B))),
                               np.linalg.solve(U, B), rtol=TOL)
    np.testing.assert_allclose(_np(tst.rowsolve_upper(_t(a), _t(b))) @ U, b,
                               rtol=1e-9)
    np.testing.assert_allclose(_np(tst.rowsolve_upper(_t(a), _t(B.T))),
                               np.asarray(jdense.rowsolve_upper(
                                   jnp.asarray(a), jnp.asarray(B.T))),
                               rtol=TOL)


def test_permutations():
    p0 = torch.tensor([2, 0, 1], dtype=torch.int32)
    p1 = torch.tensor([1, 0], dtype=torch.int32)
    assert _np(tst.perm_id(4, device=CPU)).tolist() == [0, 1, 2, 3]
    assert _np(tst.perm_compose(p0, p1)).tolist() == [2, 0, 1, 4, 3]
    inv = tst.perm_inverse(p0)
    assert _np(tst.permute(inv, tst.permute(p0, torch.arange(3)))).tolist() \
        == [0, 1, 2]
    x = torch.tensor([10.0, 20.0, 30.0])
    np.testing.assert_array_equal(_np(tst.perm_to_matrix(p0) @ x),
                                  _np(tst.permute(p0, x)))
    np.testing.assert_array_equal(
        _np(tst.perm_to_matrix(p0, torch.float64)),
        np.asarray(jdense.perm_to_matrix(jnp.asarray(_np(p0)), jnp.float64)))


# -- block LU (tests/test_bsr_lu.py) ---------------------------------------------


def _mk_blkdiag(nblk, make, bsz=BSZ):
    """mk_blkdiag (blocked_square_regular_test.fut:234-237)."""
    blocks = []
    for i in range(nblk):
        a = np.arange(bsz * bsz, dtype=np.float64)
        blocks.append((i, i, (np.sqrt(i + 1) + 28.0 * np.sin(a + i))
                       .reshape(bsz, bsz)))
    return make(nblk * bsz, bsz, blocks)


def _t_make(n, bsz, entries):
    return tst.bsr_make(n, bsz, entries, device=CPU)


def _with_offdiag(n, pkg=tst, make=_t_make):
    m = pkg.bsr_add(_mk_blkdiag(n, make), pkg.bsr_transpose(
        _mk_blkdiag(n, make)))
    if n >= 5:
        m = pkg.bsr_add(m, make(n * BSZ, BSZ, [(3, 4, [[3.0, 2.0],
                                                        [7.0, -1.0]])]))
    return m


def _dense(a):
    return _np(a.todense())


def test_simple_lup_nofill_and_full_golden():
    """blocked_square_regular_test.fut:40-53, 193-209."""
    a = _t_make(4, BSZ, [(0, 0, [[1.0, 2], [3, 4]]),
                         (1, 1, [[1.0, 2], [3, 4]])])
    lu, p = tst.bsr_lup_nofill(a)
    L, U = _split(_dense(lu))
    np.testing.assert_allclose(_dense(a)[_np(p)], L @ U, rtol=1e-12)
    a = _t_make(4, BSZ, [(0, 0, [[3.0, -7], [-3.0, 5]]),
                         (0, 1, [[-2.0, 2], [1.0, 0]]),
                         (1, 0, [[6.0, -4], [-9.0, 5]]),
                         (1, 1, [[0.0, -5], [-5.0, 12]])])
    x = tst.bsr_ols(a, _t([-9.0, 5, 7, 11]))
    np.testing.assert_allclose(_np(x), [3.0, 4, -6, -1], rtol=1e-10)


@pytest.mark.parametrize("n", [3, 4, 5])
@pytest.mark.parametrize("kind", ["blkdiag", "offdiag", "nopivot"])
def test_reconstruction(n, kind):
    """blocked_square_regular_test.fut:239-317: P·A ≈ L·U at eps."""
    if kind == "blkdiag":
        m = _mk_blkdiag(n, _t_make)
        if n >= 5:
            m = tst.bsr_add(m, _t_make(n * BSZ, BSZ,
                                       [(3, 4, [[3.0, 2], [7.0, -1]])]))
    elif kind == "offdiag":
        m = _with_offdiag(n)
    else:
        m = tst.bsr_add(_mk_blkdiag(n, _t_make),
                        tst.bsr_transpose(_mk_blkdiag(n, _t_make)))
    md = _dense(m)
    if kind == "nopivot":
        lu, p = tst.bsr_lu(m), np.arange(md.shape[0])
    else:
        lu, p = tst.bsr_lup(m)
    LU = tst.bsr_smsmm(tst.bsr_lower(lu), tst.bsr_upper(lu))
    assert np.max(np.abs(md[_np(p)] - _dense(LU))) < EPS


@pytest.mark.parametrize("n", [3, 5])
def test_ols_residual(n):
    """blocked_square_regular_test.fut:281-298."""
    m = _with_offdiag(n)
    b = _t(np.arange(n * BSZ) + 2.0)
    x = tst.bsr_ols(m, b)
    np.testing.assert_allclose(_np(tst.bsr_smvm(m, x)), _np(b), atol=EPS)


@pytest.mark.parametrize("which", ["forsolve", "backsolve"])
def test_triangular_goldens(which):
    """blocked_square_regular_test.fut:319-341."""
    if which == "forsolve":
        m = _t_make(4, BSZ, [(0, 0, [[1.0, 0], [2.0, 1]]),
                             (1, 0, [[3.0, 4], [-1.0, -3]]),
                             (1, 1, [[1.0, 0], [0.0, 1]])])
        y = tst.bsr_forsolve(m, _t([8.0, 7, 14, -7]))
        np.testing.assert_allclose(_np(y), [8.0, -9, 26, -26], rtol=1e-12)
        plan = tst.bsr_tri_plan(m, lower=True)
        np.testing.assert_array_equal(_np(tst.bsr_forsolve(
            m, _t([8.0, 7, 14, -7]), plan)), _np(y))
    else:
        m = _t_make(4, BSZ, [(0, 0, [[1.0, 1], [0.0, -1]]),
                             (0, 1, [[0.0, 3], [-1.0, -5]]),
                             (1, 1, [[3.0, 13], [0.0, -13]])])
        x = tst.bsr_backsolve(m, _t([8.0, -9, 26, -26]))
        np.testing.assert_allclose(_np(x), [3.0, -1, 0, 2], rtol=1e-12)


def test_missing_diagonals_raise():
    a = _t_make(4, BSZ, [(1, 0, [[1.0, 0], [0, 1]]), (1, 1, np.eye(2))])
    with pytest.raises(ValueError, match="diagonal block"):
        tst.bsr_lu_nofill(a)
    m = _t_make(4, BSZ, [(0, 1, [[1.0, 2], [3.0, 4]])])
    with pytest.raises(ValueError, match="diagonal"):
        tst.bsr_backsolve(m, torch.arange(4.0))


def test_find_fills_golden():
    """g14 (blocked_square_regular_test.fut:227-232, 343-349)."""
    blk = np.arange(1.0, 5.0).reshape(2, 2)
    d = tst.bsr_diag(torch.arange(14.0, dtype=torch.float64), BSZ)
    u = _t_make(14, BSZ, [(0, 2, blk), (0, 5, blk), (1, 3, blk),
                          (0, 6, blk)])
    lo = _t_make(14, BSZ, [(3, 1, blk), (4, 0, blk), (5, 1, blk)])
    fills = tst.bsr_lu_find_fills(tst.bsr_add(d, tst.bsr_add(u, lo)))
    np.testing.assert_array_equal(fills[:, 0], [4, 4, 4, 5])
    np.testing.assert_array_equal(fills[:, 1], [2, 5, 6, 3])


def _random_pattern(n, bsz, density, seed, shift=4.0):
    rng = np.random.default_rng(seed)
    nb = n // bsz
    mask = np.kron((rng.random((nb, nb)) < density)
                   | np.eye(nb, dtype=bool), np.ones((bsz, bsz)))
    return rng.standard_normal((n, n)) * mask + shift * np.eye(n), rng


@pytest.mark.parametrize("n,bsz,density,seed", [(24, 3, 0.3, 42),
                                                (40, 4, 0.15, 7)])
def test_lu_vs_reference(n, bsz, density, seed):
    """Fills (order included), the LU and solve plans exactly; factors and
    solves within 1e-10; pivots exactly."""
    xa, rng = _random_pattern(n, bsz, density, seed)
    ja = jst.bsr_from_dense(jnp.asarray(xa), bsz)
    ta = tst.bsr_from_dense(_t(xa), bsz)
    np.testing.assert_array_equal(tst.bsr_lu_find_fills(ta),
                                  jlu.bsr_lu_find_fills(ja))
    jf, tf = jlu._with_fills(ja), tlu._with_fills(ta)
    np.testing.assert_array_equal(_np(tf.indices), np.asarray(jf.indices))
    for got, want in zip(tlu._lu_plan(tf), jlu._lu_plan(jf)):
        np.testing.assert_array_equal(got, np.asarray(want))
    (jl, jp), (tl, tp) = jlu.bsr_lup(ja), tst.bsr_lup(ta)
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_allclose(_np(tl.blocks), np.asarray(jl.blocks),
                               rtol=TOL, atol=TOL)
    jplans = {}
    for lower in (True, False):
        jt, tt = jlu.bsr_tri_plan(jl, lower), tst.bsr_tri_plan(tl, lower)
        jplans[lower] = jt
        for f in ("off_pos", "off_col", "diag_pos"):
            np.testing.assert_array_equal(_np(getattr(tt, f)),
                                          np.asarray(getattr(jt, f)))
    for part in ("bsr_lower", "bsr_upper"):
        jpart, tpart = getattr(jlu, part)(jl), getattr(tst, part)(tl)
        np.testing.assert_array_equal(_np(tpart.indices),
                                      np.asarray(jpart.indices))
        np.testing.assert_allclose(_np(tpart.blocks),
                                   np.asarray(jpart.blocks), rtol=TOL,
                                   atol=TOL)
    x_true = rng.standard_normal((n, 2))
    b = xa @ x_true
    fact = tst.bsr_factorize(ta)
    jfact = jlu.BSRFactorization(jl, jp, jplans[True], jplans[False])
    for rhs in (b[:, 0], b):
        x = fact.solve(_t(rhs))
        np.testing.assert_allclose(_np(x), np.asarray(jfact.solve(
            jnp.asarray(rhs))), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(x), x_true[:, 0] if rhs.ndim == 1
                                   else x_true, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(_np(tst.bsr_lu(ta).blocks),
                               np.asarray(jlu.bsr_lu(ja).blocks),
                               rtol=TOL, atol=TOL)


def test_plans_carried_from_the_reference():
    """``interop.lu_plan_from_arrays`` / ``tri_plan_from_arrays``: the
    reference's plans drive the port's numeric phase and sweeps."""
    xa, rng = _random_pattern(30, 3, 0.25, 11)
    ja = jlu._with_fills(jst.bsr_from_dense(jnp.asarray(xa), 3))
    ta = interop.bsr_from_arrays(ja.indices, ja.blocks, ja.n, ja.bsz,
                                 device=CPU)
    jplan = jlu.bsr_lu_numeric_prepare(ja)
    plan = interop.lu_plan_from_arrays(
        jplan.diag, jplan.p21, jplan.p12, jplan.s1, jplan.s2, jplan.st,
        jplan.pleft, nb=jplan.nb, bsz=jplan.bsz, device=CPU)
    for pivot in (True, False):
        (tl, tp), (jl, jp) = (tst.bsr_lu_numeric_apply(plan, ta, pivot),
                              jlu.bsr_lu_numeric_apply(jplan, ja, pivot))
        np.testing.assert_array_equal(_np(tp), np.asarray(jp))
        np.testing.assert_allclose(_np(tl.blocks), np.asarray(jl.blocks),
                                   rtol=TOL, atol=TOL)
    b = rng.standard_normal(30)
    for lower, tf, jf in ((True, tst.bsr_forsolve, jlu.bsr_forsolve),
                          (False, tst.bsr_backsolve, jlu.bsr_backsolve)):
        jt = jlu.bsr_tri_plan(jl, lower)
        tt = interop.tri_plan_from_arrays(jt.off_pos, jt.off_col,
                                          jt.diag_pos, lower=lower,
                                          device=CPU)
        np.testing.assert_allclose(_np(tf(tl, _t(b), tt)),
                                   np.asarray(jf(jl, jnp.asarray(b), jt)),
                                   rtol=TOL, atol=TOL)


# -- preconditioners -----------------------------------------------------------


@pytest.mark.parametrize("bs,padded_n", [(3, None), (4, 24)])
def test_block_jacobi_vs_reference(bs, padded_n):
    x = np.zeros((20, 20))
    rng = np.random.default_rng(bs)
    x[rng.random((20, 20)) < 0.3] = 1.0
    x *= rng.standard_normal((20, 20))
    x += 3 * np.eye(20)
    x[5, 5] = 0.0  # a zero diagonal entry, patched to 1
    ja = jst.csr_from_dense(jnp.asarray(x))
    ta = interop.csr_from_arrays(ja.data, ja.indices, ja.indptr, ja.shape,
                                 device=CPU)
    inv = tst.block_jacobi_prepare(ta, bs, padded_n)
    jinv = jpre.block_jacobi_prepare(ja, bs, padded_n)
    np.testing.assert_allclose(_np(inv), np.asarray(jinv), rtol=1e-12,
                               atol=1e-14)
    v = rng.standard_normal(inv.shape[0] * bs)
    np.testing.assert_allclose(_np(tst.block_jacobi_apply(inv, _t(v))),
                               np.asarray(jpre.block_jacobi_apply(
                                   jinv, jnp.asarray(v))), rtol=1e-12)
    with pytest.raises(ValueError, match="vector shape"):
        tst.block_jacobi_apply(inv, _t(v[:-1]))


def test_block_jacobi_singular_block_as_reference():
    """A stored singular block (rank 1, non-zero diagonal) inverts to the
    reference's inf/nan entries instead of raising."""
    x = np.eye(6) * 2.0
    x[2:4, 2:4] = [[1.0, 2.0], [2.0, 4.0]]
    ja = jst.csr_from_dense(jnp.asarray(x))
    ta = interop.csr_from_arrays(ja.data, ja.indices, ja.indptr, ja.shape,
                                 device=CPU)
    inv = tst.block_jacobi_prepare(ta, 2)
    jinv = jpre.block_jacobi_prepare(ja, 2)
    assert not np.isfinite(_np(inv)[1]).all()
    _same_nonfinite(inv, jinv)


@pytest.mark.parametrize("padded_n", [None, 40])
def test_ilu0_vs_reference(padded_n):
    """ILU(0) = the no-pivot LU on the existing pattern, two sweeps; on a
    pattern without fill it is the exact inverse."""
    xa, rng = _random_pattern(36, 3, 0.25, 21, shift=8.0)
    ja = jst.bsr_from_dense(jnp.asarray(xa), 3)
    ta = tst.bsr_from_dense(_t(xa), 3)
    M, jM = (tst.bsr_ilu0_preconditioner(ta, padded_n),
             jpre.bsr_ilu0_preconditioner(ja, padded_n))
    v = rng.standard_normal(padded_n or 36)
    z = M(_t(v))
    np.testing.assert_allclose(_np(z), np.asarray(jM(jnp.asarray(v))),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="vector shape"):
        M(_t(v[:-1]))
    band = np.eye(12) * 5 + np.eye(12, k=1) + np.eye(12, k=-1)
    tb = tst.bsr_from_dense(_t(band), 2)
    assert tst.bsr_lu_find_fills(tb).size == 0
    w = rng.standard_normal(12)
    np.testing.assert_allclose(band @ _np(tst.bsr_ilu0_preconditioner(tb)(
        _t(w))), w, rtol=1e-12, atol=1e-12)
