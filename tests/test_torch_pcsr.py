"""The port's row-partitioned CSR (``sparse_tpu_torch.parallel.pcsr``) held
against the reference's ``sparse_tpu.parallel.pcsr``.

Both packages take the same numpy-seeded matrices and vectors: the
reference on its virtual 8-device CPU mesh (``tests/conftest.py``) with
``make_1d_mesh(D)``, the port on an in-process mesh of D shards on the CPU.
For D = 1, 2 and 8, float32 and float64, on a square matrix with uneven row
slabs, a rectangular one and one whose rows after the first quarter are
empty (empty shards at D = 8): the stacked fields exactly, SpMV and SpMM
within f32 rtol 1e-5 / atol 1e-6 or f64 rtol 1e-12, the padding rows zero;
and the reference's own ``tests/test_parallel.py`` checks through the port
(dense oracle, uneven rows, power iteration, pbell's SpMV/SpMM).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu.parallel as jpar
import sparse_tpu_torch.parallel as tpar
from sparse_tpu.formats.csr import CSR as JCSR
from sparse_tpu.parallel.pcsr import shard_vector as j_shard_vector
from sparse_tpu_torch import interop

CPU = "cpu"
DS = (1, 2, 8)
DTYPES = (np.float32, np.float64)


def tol(dt):
    return dict(rtol=1e-5, atol=1e-6) if dt == np.float32 else \
        dict(rtol=1e-12, atol=1e-12)


def matrix(case, dt, seed=0):
    """A dense numpy matrix of one of the three cases."""
    rng = np.random.default_rng(seed)
    n, m = {"uneven": (37, 37), "rect": (29, 45), "empty": (40, 40)}[case]
    x = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.3)
    if case == "empty":
        x[n // 4:] = 0
    return x.astype(dt)


def both_csr(x):
    s = sp.csr_matrix(x)
    ref = JCSR(data=jnp.asarray(s.data),
               indices=jnp.asarray(s.indices.astype(np.int32)),
               indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=x.shape)
    port = interop.csr_from_arrays(s.data, s.indices, s.indptr, x.shape,
                                   device=CPU)
    return ref, port


def meshes(d):
    return jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)


def same_fields(ref, port, names):
    for f in names:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(port, f).numpy(), err_msg=f)


@pytest.mark.parametrize("case", ["uneven", "rect", "empty"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", DS)
def test_pcsr_fields_spmv_spmm(d, dt, case):
    x = matrix(case, dt, seed=d)
    n, m = x.shape
    ja, ta = both_csr(x)
    jm, tm = meshes(d)
    jp, tp = jpar.pcsr_from_csr(ja, jm), tpar.pcsr_from_csr(ta, tm)
    same_fields(jp, tp, ("data", "indices", "indptr"))
    assert (tp.shape, tp.rows_per_shard, tp.n_shards) == \
        (jp.shape, jp.rows_per_shard, jp.n_shards)
    assert tp.nse_per_shard == jp.nse_per_shard
    rng = np.random.default_rng(7)
    v = rng.standard_normal(m).astype(dt)
    jv = j_shard_vector(jnp.asarray(v), jp, jm)
    tv = tpar.shard_vector(torch.from_numpy(v), tp, tm)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    yj = np.asarray(jpar.pcsr_spmv(jp, jv, jm))
    yt = tpar.pcsr_spmv(tp, tv, tm).numpy()
    assert yt.shape == yj.shape == (d * tp.rows_per_shard,)
    np.testing.assert_allclose(yt, yj, **tol(dt))
    assert np.all(yt[n:] == 0)
    b = rng.standard_normal((m, 5)).astype(dt)
    bj = np.asarray(jpar.pcsr_spmm(jp, j_shard_vector(jnp.asarray(b), jp, jm),
                                   jm))
    bt = tpar.pcsr_spmm(tp, tpar.shard_vector(torch.from_numpy(b), tp, tm),
                        tm).numpy()
    np.testing.assert_allclose(bt, bj, **tol(dt))
    np.testing.assert_array_equal(tpar.pcsr_todense(tp).numpy(), x)


@pytest.mark.parametrize("k", [8, 32])
def test_pcsr_spmm_dense_oracle(k):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((48, 56)) * (rng.random((48, 56)) < 0.15)
    _, ta = both_csr(x)
    tm = tpar.make_1d_mesh(8, device=CPU)
    tp = tpar.pcsr_from_csr(ta, tm)
    b = rng.standard_normal((56, k))
    got = tpar.pcsr_spmm(tp, tpar.shard_vector(torch.from_numpy(b), tp, tm),
                         tm)[:48]
    np.testing.assert_allclose(got.numpy(), x @ b, rtol=1e-10, atol=1e-12)


def test_uneven_rows_padding_stays_zero():
    # 10 rows over 8 shards (the reference's test_uneven_rows_padding)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((10, 12)) * (rng.random((10, 12)) < 0.6)
    _, ta = both_csr(x)
    tm = tpar.make_1d_mesh(8, device=CPU)
    tp = tpar.pcsr_from_csr(ta, tm)
    v = rng.standard_normal(12)
    got = tpar.pcsr_spmv(tp, tpar.shard_vector(torch.from_numpy(v), tp, tm),
                         tm).numpy()
    np.testing.assert_allclose(got[:10], x @ v, rtol=1e-10)
    assert np.all(got[10:] == 0)


@pytest.mark.parametrize("d", DS)
def test_power_iteration_matches_reference(d):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 32))
    spd = x @ x.T
    ja, ta = both_csr(spd)
    jm, tm = meshes(d)
    jp, tp = jpar.pcsr_from_csr(ja, jm), tpar.pcsr_from_csr(ta, tm)
    v0 = np.ones(32) / np.sqrt(32)
    jv = j_shard_vector(jnp.asarray(v0), jp, jm)
    tv = tpar.shard_vector(torch.from_numpy(v0), tp, tm)
    for _ in range(3):
        jv, jl = jpar.power_iteration_step(jp, jv, jm)
        tv, tl = tpar.power_iteration_step(tp, tv, tm)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-12)
    for _ in range(200):
        tv, tl = tpar.power_iteration_step(tp, tv, tm)
    np.testing.assert_allclose(float(tl), np.linalg.eigvalsh(spd).max(),
                               rtol=1e-6)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", DS)
def test_pbell_matches_reference(d, dt):
    from sparse_tpu.formats.bell import BELL as JBELL

    from sparse_tpu_torch.formats.bell import bell_from_bsr

    rng = np.random.default_rng(31)
    n, bsz = 72, 4  # 18 block rows: uneven slabs over 8 shards
    nb = n // bsz
    mask = np.kron(rng.random((nb, nb)) < 0.3, np.ones((bsz, bsz)))
    x = (rng.standard_normal((n, n)) * mask).astype(dt)
    e = bell_from_bsr(tst_bsr_from_dense(x, bsz))
    je = JBELL(cols=jnp.asarray(e.cols.numpy()),
               blocks=jnp.asarray(e.blocks.numpy()), n=n, bsz=bsz)
    jm, tm = meshes(d)
    jp, tp = jpar.pbell_from_bell(je, jm), tpar.pbell_from_bell(e, tm)
    same_fields(jp, tp, ("cols", "blocks"))
    assert tp.rows_per_shard == jp.rows_per_shard and tp.Lb == jp.Lb
    v = rng.standard_normal(n).astype(dt)
    jv = jpar.pbell_shard_vector(jnp.asarray(v), jp, jm)
    tv = tpar.pbell_shard_vector(torch.from_numpy(v), tp, tm)
    yt = tpar.pbell_smvm(tp, tv, tm).numpy()
    np.testing.assert_allclose(yt, np.asarray(jpar.pbell_smvm(jp, jv, jm)),
                               **tol(dt))
    np.testing.assert_allclose(yt[:n], x.astype(np.float64) @ v, rtol=1e-4,
                               atol=1e-5)
    b = rng.standard_normal((n, 8)).astype(dt)
    jb = jpar.pbell_shard_vector(jnp.asarray(b), jp, jm)
    tb = tpar.pbell_shard_vector(torch.from_numpy(b), tp, tm)
    np.testing.assert_allclose(tpar.pbell_spmm(tp, tb, tm).numpy(),
                               np.asarray(jpar.pbell_spmm(jp, jb, jm)),
                               **tol(dt))


def tst_bsr_from_dense(x, bsz):
    from sparse_tpu_torch import bsr_from_dense

    return bsr_from_dense(torch.from_numpy(x), bsz, device=CPU)


def test_interop_pcsr_runs_reference_layout():
    x = matrix("uneven", np.float64, seed=3)
    ja, ta = both_csr(x)
    jm, tm = meshes(8)
    jp = jpar.pcsr_from_csr(ja, jm)
    tp = interop.pcsr_from_arrays(jp.data, jp.indices, jp.indptr,
                                  shape=jp.shape,
                                  rows_per_shard=jp.rows_per_shard, mesh=tm)
    v = np.arange(37.0)
    got = tpar.pcsr_spmv(tp, tpar.shard_vector(torch.from_numpy(v), tp, tm),
                         tm)
    np.testing.assert_allclose(got[:37].numpy(), x @ v, rtol=1e-12)


def test_make_1d_mesh_in_process():
    m = tpar.make_1d_mesh(4, axis="rows", device=CPU)
    assert m.shape == {"rows": 4} and (m.lo, m.hi, m.local) == (0, 4, 4)
    assert tpar.make_1d_mesh(device=CPU).n_shards == 1
    x = torch.arange(24.0).reshape(4, 3, 2)
    np.testing.assert_array_equal(m.all_to_all(x).numpy(),
                                  x.transpose(0, 1).numpy())
    assert m.all_gather(x) is x and m.all_reduce(x) is x
    with pytest.raises(ValueError):
        tpar.put_sharded(np.zeros(4), m, "shards")
