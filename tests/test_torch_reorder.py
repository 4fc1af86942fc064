"""RCM reordering and CSR permutation in the PyTorch port, against the
reference's ``tests/test_reorder.py``.

Oracles: SciPy's ``reverse_cuthill_mckee`` for the ordering's quality,
dense NumPy for the permutations (rtol 1e-12, float64), the native C++
core against the NumPy fallback bit for bit, and the reference's
``rcm_order`` / ``csr_permute`` on the same numpy-seeded inputs (the same
order exactly; the same stored structure).  The reference's breadth case
(``-m slow``) is slow here too.  Everything runs on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu_torch.native import plansort
from sparse_tpu_torch.ops.reorder import _rcm_numpy


def _random_dense(rng, n, m, density=0.05, symmetric=False):
    d = (rng.random((n, m)) < density).astype(np.float64)
    d *= rng.standard_normal((n, m))
    return d + d.T if symmetric else d


def _csr(d):
    return pt.csr_from_dense(torch.from_numpy(np.ascontiguousarray(d)),
                             device="cpu")


def _host_structure(a):
    indptr = a.indptr.numpy().astype(np.int64)
    return indptr, a.indices.numpy()[:int(indptr[-1])].astype(np.int64)


# -- RCM core -----------------------------------------------------------------


def test_rcm_is_permutation_and_reduces_bandwidth():
    rng = np.random.default_rng(0)
    n = 200
    band = np.zeros((n, n))
    for off in (-3, -1, 0, 1, 3):
        band += np.diag(rng.standard_normal(n - abs(off)), off)
    sh = rng.permutation(n)
    shuffled = band[sh][:, sh]
    a = _csr(shuffled)
    perm = pt.rcm_order(a)
    assert sorted(perm) == list(range(n))
    ap = pt.csr_permute(a, perm, perm)
    assert pt.csr_bandwidth(ap) <= 10  # the band's half-width is 3
    assert pt.csr_bandwidth(ap) < pt.csr_bandwidth(a)
    np.testing.assert_array_equal(
        perm, np.asarray(st.rcm_order(st.csr_from_dense(
            jnp.asarray(shuffled)))))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rcm_quality_matches_scipy(seed):
    rng = np.random.default_rng(seed)
    d = _random_dense(rng, 150, 150, density=0.03, symmetric=True)
    a = _csr(d)
    perm = pt.rcm_order(a)
    sperm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(d),
                                             symmetric_mode=True), np.int64)
    ours = pt.csr_bandwidth(pt.csr_permute(a, perm, perm))
    theirs = pt.csr_bandwidth(pt.csr_permute(a, sperm, sperm))
    # the same algorithm, maybe other tie-breaks: orderings of equal quality
    assert ours <= max(int(theirs * 1.2), theirs + 5)
    np.testing.assert_array_equal(perm, np.asarray(st.rcm_order(
        st.csr_from_dense(jnp.asarray(d)))))


def test_rcm_native_matches_numpy_fallback():
    rng = np.random.default_rng(7)
    for n, density, symmetric in [
        (1, 1.0, False),
        (17, 0.2, False),    # asymmetric pattern: the symmetrized path
        (64, 0.05, True),
        (120, 0.02, False),  # sparse enough for several components
        (40, 0.0, False),    # empty: every node its own component
    ]:
        d = rng.random((n, n)) < density
        if symmetric:
            d = d | d.T
        s = sp.csr_matrix(d)
        indptr = s.indptr.astype(np.int32)
        cols = s.indices.astype(np.int32)
        native = plansort.rcm_order(indptr, cols)
        assert native is not None, "the native plan core did not build"
        np.testing.assert_array_equal(native, _rcm_numpy(indptr, cols, n))


def test_rcm_self_loops_and_empty():
    a = _csr(np.diag(np.arange(1.0, 6.0)))
    perm = pt.rcm_order(a)
    assert sorted(perm) == list(range(5))
    np.testing.assert_array_equal(perm, np.asarray(st.rcm_order(
        st.csr_from_dense(jnp.asarray(np.diag(np.arange(1.0, 6.0)))))))
    assert pt.rcm_order(_csr(np.zeros((0, 0)))).size == 0


def test_rcm_rejects_nonsquare():
    with pytest.raises(ValueError, match="square"):
        pt.rcm_order(_csr(np.ones((2, 3))))
    with pytest.raises(ValueError, match="square"):
        st.rcm_order(st.csr_from_dense(jnp.ones((2, 3))))


# -- permutation -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_csr_permute_matches_dense(seed):
    rng = np.random.default_rng(seed)
    n, m = 37, 23
    d = _random_dense(rng, n, m, density=0.15)
    a = _csr(d)
    rperm, cperm = rng.permutation(n), rng.permutation(m)
    got = pt.csr_permute(a, rperm, cperm)
    np.testing.assert_allclose(got.todense().numpy(), d[rperm][:, cperm],
                               rtol=1e-12)
    np.testing.assert_allclose(pt.csr_permute(a, rperm).todense().numpy(),
                               d[rperm], rtol=1e-12)
    ref = st.csr_permute(st.csr_from_dense(jnp.asarray(d)), rperm, cperm)
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(ref.indptr))
    k = int(got.indptr[-1])
    np.testing.assert_array_equal(got.indices.numpy()[:k],
                                  np.asarray(ref.indices)[:k])
    np.testing.assert_array_equal(got.data.numpy()[:k],
                                  np.asarray(ref.data)[:k])


def test_csr_permute_preserves_canonical_structure():
    rng = np.random.default_rng(3)
    a = _csr(_random_dense(rng, 29, 31, density=0.2))
    ap = pt.csr_permute(a, rng.permutation(29), rng.permutation(31))
    indptr, cols = _host_structure(ap)
    for r in range(29):
        assert (np.diff(cols[indptr[r]:indptr[r + 1]]) > 0).all()


def test_permute_plan_reuse():
    """A plan on a padded CSR (capacity past the stored entries) applied
    to new values of the same pattern, without preparing again."""
    rng = np.random.default_rng(11)
    d = _random_dense(rng, 20, 20, density=0.3)
    a = _csr(d)
    apad = a + a
    assert apad.nse > int(apad.indptr[-1])
    rperm, cperm = rng.permutation(20), rng.permutation(20)
    plan = pt.permute_prepare(apad, rperm, cperm)
    out = pt.permute_apply(plan, apad)
    np.testing.assert_allclose(out.todense().numpy(),
                               (2 * d)[rperm][:, cperm], rtol=1e-12)
    out2 = pt.permute_apply(plan, dataclasses.replace(apad,
                                                      data=apad.data * 3))
    np.testing.assert_allclose(out2.todense().numpy(),
                               (6 * d)[rperm][:, cperm], rtol=1e-12)
    ja = st.csr_from_dense(jnp.asarray(d))
    jout = st.permute_apply(st.permute_prepare(ja + ja, rperm, cperm),
                            ja + ja)
    np.testing.assert_allclose(out.todense().numpy(),
                               np.asarray(jout.todense()), rtol=1e-12)


@pytest.mark.slow  # breadth: validation messages, as the reference
def test_permute_rejects_bad_perms():
    a = _csr(np.ones((3, 3)))
    with pytest.raises(ValueError, match="rperm"):
        pt.permute_prepare(a, np.array([0, 1, 1]))
    with pytest.raises(ValueError, match="rperm"):
        pt.permute_prepare(a, np.array([0, 1, 5]))
    with pytest.raises(ValueError, match="cperm"):
        pt.permute_prepare(a, np.arange(3), np.array([2, 2, 0]))
    plan = pt.permute_prepare(a, np.arange(3))
    with pytest.raises(ValueError, match="does not match"):
        pt.permute_apply(plan, _csr(np.ones((3, 4))))


# -- reorder around SpMV --------------------------------------------------


def test_reorder_for_locality_spmv_roundtrip():
    rng = np.random.default_rng(21)
    n = 300
    band = np.zeros((n, n))
    for off in (-2, 0, 2):
        band += np.diag(rng.standard_normal(n - abs(off)), off)
    sh = rng.permutation(n)
    a = _csr(band[sh][:, sh])
    ap, perm = pt.reorder_for_locality(a)
    assert pt.csr_bandwidth(ap) < pt.csr_bandwidth(a) // 4
    x = torch.from_numpy(rng.standard_normal(n))
    y_direct = pt.csr_smvm(a, x)
    y_perm = pt.unpermute_vector(pt.csr_smvm(ap, pt.permute_vector(x, perm)),
                                 perm)
    np.testing.assert_allclose(y_perm.numpy(), y_direct.numpy(), rtol=1e-10,
                               atol=1e-12)
    _, jperm = st.reorder_for_locality(st.csr_from_dense(jnp.asarray(
        band[sh][:, sh])))
    np.testing.assert_array_equal(perm, np.asarray(jperm))
