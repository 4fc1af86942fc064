"""Determinism in the PyTorch port, against the reference's
``tests/test_determinism.py``: repeated runs agree bit for bit, and the
port's results agree with the reference's on the same numpy-seeded inputs
(rtol 1e-12 in float64: the two packages may sum in different orders).
Everything runs on the CPU; ``tests/test_torch_cuda.py`` holds the kernels
to the same rule on the card."""

import jax.numpy as jnp
import numpy as np
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_smvm_bitwise_repeatable():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.3)
    v = rng.standard_normal(64)
    a = pt.csr_from_dense(torch.from_numpy(x), device="cpu")
    outs = [_np(pt.csr_smvm(a, torch.from_numpy(v))) for _ in range(3)]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    plan = pt.smvm_prepare(a)
    outs_p = [_np(plan.apply(torch.from_numpy(v))) for _ in range(3)]
    assert all(np.array_equal(outs_p[0], o) for o in outs_p[1:])
    ref = np.asarray(st.csr_smvm(st.csr_from_dense(jnp.asarray(x)),
                                 jnp.asarray(v)))
    np.testing.assert_allclose(outs[0], ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(outs_p[0], ref, rtol=1e-12, atol=1e-14)


def test_duplicate_summation_order_independent():
    """100 duplicates of one coordinate, shuffled three ways: each
    shuffle repeatable bit for bit, all within 1e-12 of each other and of
    the reference's sum of the same shuffle."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(100)
    rows = np.zeros(100, np.int64)
    cols = np.zeros(100, np.int64)
    base = None

    def build(perm):
        return _np(pt.csr_todense(pt.csr_from_coo(pt.coo_make(
            (2, 2), rows[perm], cols[perm], torch.from_numpy(vals[perm]),
            device="cpu"))))

    for _ in range(3):
        perm = rng.permutation(100)
        d = build(perm)
        base = d if base is None else base
        np.testing.assert_allclose(d, base, rtol=1e-12)
        assert np.array_equal(d, build(perm))
        ref = np.asarray(st.csr_todense(st.csr_from_coo(st.coo_make(
            (2, 2), rows[perm], cols[perm], jnp.asarray(vals[perm])))))
        np.testing.assert_allclose(d, ref, rtol=1e-12)


def test_spgemm_and_bsr_repeatable():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 32)) * (rng.random((32, 32)) < 0.2)
    a = pt.csr_from_dense(torch.from_numpy(x), device="cpu")
    c1 = _np(pt.csr_todense(pt.spgemm(a, a)))
    c2 = _np(pt.csr_todense(pt.spgemm(a, a)))
    assert np.array_equal(c1, c2)
    np.testing.assert_allclose(c1, x @ x, rtol=1e-12, atol=1e-12)
    b = pt.bsr_from_dense(torch.from_numpy(x), 4, device="cpu")
    v = torch.from_numpy(rng.standard_normal(32))
    y = _np(pt.bsr_smvm(b, v))
    assert np.array_equal(y, _np(pt.bsr_smvm(b, v)))
    ref = np.asarray(st.bsr_smvm(st.bsr_from_dense(jnp.asarray(x), 4),
                                 jnp.asarray(_np(v))))
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-14)
    ja = st.csr_from_dense(jnp.asarray(x))
    np.testing.assert_allclose(c1, np.asarray(st.csr_todense(
        st.spgemm(ja, ja))), rtol=1e-12, atol=1e-14)
