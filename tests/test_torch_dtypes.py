"""Dtype genericity in the PyTorch port, against the reference's
``tests/test_dtypes.py``: one code path serves float32, float64, bfloat16
and int32 through CSR, BSR, BELL, ``tri_smm`` and ``spgemm``.

Both packages get the same numpy-seeded inputs on the CPU.  Tolerances, as
the reference states them: float32 1e-5, float64 1e-12, bfloat16 5e-2
(rtol and atol, against float64 of the dtype-rounded inputs and against
the reference's result); int32 exactly.  The card runs the float cases
through the kernels (``tests/test_torch_cuda_transforms.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.formats.bell import bell_from_bsr as j_bell_from_bsr
from sparse_tpu.formats.bell import bell_smvm as j_bell_smvm
from sparse_tpu_torch.formats.bell import bell_from_bsr, bell_smvm

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "float64": (torch.float64, jnp.float64, 1e-12),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def pattern(n, density, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) * (rng.random((n, n)) < density)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_csr_float_dtypes(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    x = pattern(24, 0.3, 0)
    a = pt.csr_from_dense(torch.from_numpy(x).to(tdt), device="cpu")
    assert a.dtype == tdt
    v = torch.ones(24, dtype=tdt)
    got = _f64(pt.csr_smvm(a, v))
    xr = _f64(torch.from_numpy(x).to(tdt))  # the dtype-rounded matrix
    np.testing.assert_allclose(got, xr @ np.ones(24), rtol=tol, atol=tol)
    ref = _f64(st.csr_smvm(st.csr_from_dense(jnp.asarray(x, jdt)),
                           jnp.ones(24, jdt)))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_csr_int_dtype_exact():
    x = np.asarray(pattern(12, 0.5, 1) * 10, np.int32)
    a = pt.csr_from_dense(torch.from_numpy(x), device="cpu")
    assert a.dtype == torch.int32
    v = np.arange(12, dtype=np.int32)
    got = pt.csr_smvm(a, torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, x @ v)
    c = pt.csr_todense(pt.spgemm(a, a)).numpy()
    np.testing.assert_array_equal(c, x @ x)
    ja = st.csr_from_dense(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(st.csr_smvm(
        ja, jnp.asarray(v))))
    np.testing.assert_array_equal(c, np.asarray(st.csr_todense(
        st.spgemm(ja, ja))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_formats_dtypes(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    x = pattern(16, 0.5, 2)
    a = pt.bsr_from_dense(torch.from_numpy(x).to(tdt), 4, device="cpu")
    v = torch.ones(16, dtype=tdt)
    ref = _f64(torch.from_numpy(x).to(tdt)) @ np.ones(16)
    got = _f64(pt.bsr_smvm(a, v))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    e = bell_from_bsr(a)
    got_e = _f64(bell_smvm(e, v))
    np.testing.assert_allclose(got_e, ref, rtol=tol, atol=tol)
    ja = st.bsr_from_dense(jnp.asarray(x, jdt), 4)
    jv = jnp.ones(16, jdt)
    np.testing.assert_allclose(got, _f64(st.bsr_smvm(ja, jv)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got_e, _f64(j_bell_smvm(j_bell_from_bsr(ja),
                                                       jv)),
                               rtol=tol, atol=tol)


def test_triangular_int():
    x = np.tril(np.arange(1, 17).reshape(4, 4)).astype(np.int32)
    a = pt.tri_from_dense(torch.from_numpy(x), device="cpu")
    got = pt.tri_todense(pt.tri_smm(a, a)).numpy()
    np.testing.assert_array_equal(got, x @ x)
    ja = st.tri_from_dense(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(st.tri_todense(
        st.tri_smm(ja, ja))))
