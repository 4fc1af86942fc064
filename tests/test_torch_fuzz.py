"""Randomized cross-format consistency in the PyTorch port, against the
reference's ``tests/test_fuzz.py``: for seeded random shapes and
densities, every format's round trips and products agree with the dense
oracle (rtol 1e-10 / atol 1e-12 in float64 for products, 1e-12 for round
trips, the reference's tolerances) and with the reference's products on
the same inputs (the same tolerances).

The reference keeps a degenerate and a sparse case per test in the default
tier and moves its breadth to ``-m slow`` (each shape costs it seconds of
compiles); the port keeps the same split.  Everything runs on the CPU; the
card runs the default cases through the kernels
(``tests/test_torch_cuda_transforms.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.formats.bell import bell_from_bsr as j_bell_from_bsr
from sparse_tpu.formats.bell import bell_smvm as j_bell_smvm
from sparse_tpu_torch.formats.bell import bell_from_bsr, bell_smvm, \
    bell_todense
from sparse_tpu_torch.ops.spmv import build_spmv_plan, csr_smvm_fast

CASES = [(1, 1, 1.0), (13, 13, 0.08)]
SLOW_CASES = [(31, 17, 0.33), (64, 64, 0.02), (5, 40, 0.9), (2, 7, 0.5),
              (40, 5, 0.15)]
PRODUCT = dict(rtol=1e-10, atol=1e-12)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "n,m,density",
    CASES + [pytest.param(*c, marks=pytest.mark.slow) for c in SLOW_CASES],
)
def test_csr_consistency(n, m, density):
    rng = np.random.default_rng(hash((n, m, int(density * 100))) % 2**32)
    x = rng.standard_normal((n, m)) * (rng.random((n, m)) < density)
    a = pt.csr_from_dense(_t(x), device="cpu")
    np.testing.assert_allclose(_np(pt.csr_todense(a)), x, rtol=1e-12)
    np.testing.assert_allclose(_np(pt.csc_todense(pt.csr_transpose(a))),
                               x.T, rtol=1e-12)
    v = rng.standard_normal(m)
    y = _np(pt.csr_smvm(a, _t(v)))
    np.testing.assert_allclose(y, x @ v, **PRODUCT)
    np.testing.assert_allclose(
        _np(csr_smvm_fast(a, _t(v), build_spmv_plan(a))), x @ v, **PRODUCT)
    b = rng.standard_normal((m, 3))
    np.testing.assert_allclose(_np(pt.spmm(a, _t(b))), x @ b, **PRODUCT)
    yy = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    c = _np(pt.csr_todense(pt.spgemm(
        a, pt.csr_from_dense(_t(yy), device="cpu"))))
    np.testing.assert_allclose(c, x @ yy, rtol=1e-10, atol=1e-10)
    # the reference on the same inputs
    ja = st.csr_from_dense(jnp.asarray(x))
    np.testing.assert_allclose(y, np.asarray(st.csr_smvm(ja, jnp.asarray(v))),
                               **PRODUCT)
    np.testing.assert_allclose(c, np.asarray(st.csr_todense(st.spgemm(
        ja, st.csr_from_dense(jnp.asarray(yy))))), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("nb,bsz,density", [
    (1, 2, 1.0),
    pytest.param(3, 4, 0.6, marks=pytest.mark.slow),  # breadth
    pytest.param(7, 3, 0.2, marks=pytest.mark.slow),  # breadth
    (5, 8, 0.1),
])
def test_bsr_bell_consistency(nb, bsz, density):
    n = nb * bsz
    rng = np.random.default_rng(hash((nb, bsz)) % 2**32)
    mask = np.kron(rng.random((nb, nb)) < density, np.ones((bsz, bsz)))
    x = rng.standard_normal((n, n)) * mask
    a = pt.bsr_from_dense(_t(x), bsz, device="cpu")
    np.testing.assert_allclose(_np(pt.bsr_todense(a)), x, rtol=1e-12)
    e = bell_from_bsr(a)
    np.testing.assert_allclose(_np(bell_todense(e)), x, rtol=1e-12)
    v = rng.standard_normal(n)
    y = _np(pt.bsr_smvm(a, _t(v)))
    np.testing.assert_allclose(y, x @ v, **PRODUCT)
    ye = _np(bell_smvm(e, _t(v)))
    np.testing.assert_allclose(ye, x @ v, **PRODUCT)
    np.testing.assert_allclose(_np(pt.bsr_todense(pt.bsr_smsmm(a, a))),
                               x @ x, rtol=1e-9, atol=1e-9)
    ja = st.bsr_from_dense(jnp.asarray(x), bsz)
    np.testing.assert_allclose(y, np.asarray(st.bsr_smvm(ja, jnp.asarray(v))),
                               **PRODUCT)
    np.testing.assert_allclose(ye, np.asarray(j_bell_smvm(
        j_bell_from_bsr(ja), jnp.asarray(v))), **PRODUCT)


@pytest.mark.parametrize("n,m,k,da,db", [
    pytest.param(17, 23, 11, 0.25, 0.2, marks=pytest.mark.slow),
    pytest.param(40, 8, 31, 0.1, 0.5, marks=pytest.mark.slow),
    (9, 9, 9, 0.6, 0.6),
])
def test_spgemm_plan_consistency(n, m, k, da, db):
    """prepare / apply against the dense oracle and the reference, plus
    one value update on the same plan."""
    rng = np.random.default_rng(hash((n, m, k)) % 2**32)
    xa = rng.standard_normal((n, m)) * (rng.random((n, m)) < da)
    xb = rng.standard_normal((m, k)) * (rng.random((m, k)) < db)
    a = pt.csr_from_dense(_t(xa), device="cpu")
    b = pt.csr_from_dense(_t(xb), device="cpu")
    plan = pt.spgemm_prepare(a, b)
    c = _np(pt.csr_todense(pt.spgemm_apply(plan, a, b)))
    np.testing.assert_allclose(c, xa @ xb, **PRODUCT)
    a2 = dataclasses.replace(a, data=a.data * -0.5)
    c2 = _np(pt.csr_todense(pt.spgemm_apply(plan, a2, b)))
    np.testing.assert_allclose(c2, -0.5 * (xa @ xb), **PRODUCT)
    ja = st.csr_from_dense(jnp.asarray(xa))
    jb = st.csr_from_dense(jnp.asarray(xb))
    jplan = st.spgemm_prepare(ja, jb)
    tc = pt.spgemm_apply(plan, a, b)
    jc = st.spgemm_apply(jplan, ja, jb)
    np.testing.assert_array_equal(_np(tc.indptr), np.asarray(jc.indptr))
    k_ = int(_np(tc.indptr)[-1])
    np.testing.assert_array_equal(_np(tc.indices)[:k_],
                                  np.asarray(jc.indices)[:k_])
    np.testing.assert_allclose(_np(tc.data)[:k_], np.asarray(jc.data)[:k_],
                               **PRODUCT)
