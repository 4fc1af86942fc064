"""The BSR sweep in the PyTorch port, against the reference's
``tests/test_bsr_sweep.py`` (the reference's
blocked_square_regular_mktest.fut): the op battery for bsz in {2, 3, 4}
and block counts 0..8.

Structure is held exactly to the dense oracle (the reference asserts the
same); products and sums within rtol 1e-12 of it and of the reference on
the same inputs; the LU and the solve within the reference's EPS = 6e-5,
with the pivots equal to the reference's.  The reference's breadth cases
(``-m slow``) are slow here too.  Everything runs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt

EPS = 6e-5  # the reference's tolerance (mktest eq_eps usage)


def dense(a):
    if isinstance(a, st.BSR):
        return np.asarray(st.bsr_todense(a))
    return pt.bsr_todense(a).numpy()


def diag_blk_entries(nb, bsz):
    """The mktest generator (blocked_square_regular_mktest.fut:70-75)."""
    return [(i, i, np.array(
        [[c + 1 + 2 * i + r * (c * (r % 2)) - r for c in range(bsz)]
         for r in range(bsz)], np.float64)) for i in range(nb)]


def make(n, bsz, entries):
    """The same BSR in both packages."""
    return (pt.bsr_make(n, bsz, entries, dtype=torch.float64, device="cpu"),
            st.bsr_make(n, bsz, entries, dtype=jnp.float64))


@pytest.mark.parametrize("bsz", [2, 3, 4])
@pytest.mark.parametrize("nb", [0, 1, 2, 5, 8])
def test_structure_sweep(bsz, nb):
    n = nb * bsz
    np.testing.assert_array_equal(
        dense(pt.bsr_eye(n, bsz, torch.float64, device="cpu")), np.eye(n))
    v = np.arange(1.0, n + 1)
    d = pt.bsr_diag(torch.from_numpy(v), bsz, device="cpu")
    np.testing.assert_array_equal(dense(d), np.diag(v))
    np.testing.assert_array_equal(dense(pt.bsr_transpose(d)), np.diag(v))


@pytest.mark.parametrize("bsz", [2, 3, 4])
@pytest.mark.parametrize("nb", [1, 2, 5, 8])
def test_ops_sweep(bsz, nb):
    n = nb * bsz
    d, jd = make(n, bsz, diag_blk_entries(nb, bsz))
    blk = np.arange(1.0, bsz * bsz + 1).reshape(bsz, bsz)
    c, jc = make(n, bsz, [(nb - 1, 0, blk)])
    dd, dc = dense(d), dense(c)
    v = np.arange(n) + 2.0
    # block-level Hadamard (patterns disjoint unless nb == 1)
    cases = [(pt.bsr_add(c, d), dc + dd), (pt.bsr_sub(c, d), dc - dd),
             (pt.bsr_mul(c, d), dc * dd if nb == 1 else np.zeros((n, n))),
             (pt.bsr_smsmm(c, d), dc @ dd)]
    for got, want in cases:
        np.testing.assert_allclose(dense(got), want, rtol=1e-12)
    y = pt.bsr_smvm(c, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(y, dc @ v, rtol=1e-12)
    if nb in (1, 5):  # the reference on the same inputs (compiles per shape)
        for (got, _), ref in zip(cases, (st.bsr_add(jc, jd),
                                         st.bsr_sub(jc, jd),
                                         st.bsr_mul(jc, jd),
                                         st.bsr_smsmm(jc, jd))):
            np.testing.assert_allclose(dense(got), dense(ref), rtol=1e-12)
        np.testing.assert_allclose(y, np.asarray(st.bsr_smvm(
            jc, jnp.asarray(v))), rtol=1e-12)


def blkdiag_entries(nb, bsz):
    out = []
    for i in range(nb):
        a = np.arange(bsz * bsz, dtype=np.float64)
        out.append((i, i, (np.sqrt(i + 1) + 28.0 * np.sin(a + i)).reshape(
            bsz, bsz)))
    return out


@pytest.mark.parametrize("bsz", [2, 3, 4])
@pytest.mark.parametrize("nb", [
    3,
    pytest.param(5, marks=pytest.mark.slow),  # breadth, as the reference
    pytest.param(8, marks=pytest.mark.slow),
])
def test_solver_sweep(bsz, nb):
    n = nb * bsz
    m0, jm0 = make(n, bsz, blkdiag_entries(nb, bsz))
    m, jm = pt.bsr_add(m0, pt.bsr_transpose(m0)), \
        st.bsr_add(jm0, st.bsr_transpose(jm0))
    if nb >= 5:
        blk = np.arange(1.0, bsz * bsz + 1).reshape(bsz, bsz)
        e, je = make(n, bsz, [(3, 4, blk)])
        m, jm = pt.bsr_add(m, e), st.bsr_add(jm, je)
    md = dense(m)
    lu, p = pt.bsr_lup(m)
    recon = dense(pt.bsr_smsmm(pt.bsr_lower(lu), pt.bsr_upper(lu)))
    assert np.max(np.abs(md[p.numpy()] - recon)) < EPS
    b = np.arange(n) + 2.0
    x = pt.bsr_ols(m, torch.from_numpy(b))
    np.testing.assert_allclose(pt.bsr_smvm(m, x).numpy(), b, atol=EPS)
    jlu, jp = st.bsr_lup(jm)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(dense(lu), dense(jlu), atol=EPS)
    np.testing.assert_allclose(x.numpy(), np.asarray(st.bsr_ols(
        jm, jnp.asarray(b))), atol=EPS)
