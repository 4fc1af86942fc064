"""The port's halo-exchange SpMV plans (``HaloPCSR``, ``HaloPCSROverlap``)
held against the reference's ``sparse_tpu.parallel.halo``.

Same inputs for both packages (numpy-seeded; reference on its virtual
8-device mesh, port on an in-process CPU mesh): for D = 1, 2 and 8,
float32 and float64, a square matrix with uneven slabs, a rectangular one
and one with empty shards — every plan field exactly (remapped indices,
send tables, halo width, padding, ``comm_entries_per_device``), SpMV and
SpMM values within f32 rtol 1e-5 / atol 1e-6 or f64 rtol 1e-12.  The
reference's ``tests/test_halo.py`` bounds (halo width on a band) run on the
port's plans; a reference plan carried over by ``interop`` gives the
reference's result through the port's apply; ``dist_spmv`` refuses a
``PHubSplit`` as the reference does.
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
    rng = np.random.default_rng(seed)
    n, m = {"uneven": (37, 37), "rect": (29, 45), "empty": (40, 40),
            "band": (100, 100)}[case]
    if case == "band":
        x = sum(np.diag(rng.standard_normal(n - abs(o)), o)
                for o in range(-5, 6))
    else:
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


def same_fields(ref, port, names, meta=()):
    for f in names:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(port, f).numpy(), err_msg=f)
    for f in meta:
        assert getattr(port, f) == getattr(ref, f), f


def operands(x, d, jm, tm, k=None, seed=7):
    """The same operand sharded for both packages (cols padded to D)."""
    rng = np.random.default_rng(seed)
    m = x.shape[1]
    v = rng.standard_normal((m,) if k is None else (m, k)).astype(x.dtype)
    total = -(-m // d) * d
    vp = np.concatenate([v, np.zeros((total - m,) + v.shape[1:], v.dtype)])
    return jnp.asarray(vp), tpar.put_sharded(vp, tm), v


META = ("shape", "rows_per_shard", "cols_per_shard", "halo", "n_shards",
        "comm_entries_per_device")


@pytest.mark.parametrize("case", ["uneven", "rect", "empty"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", DS)
def test_halo_plans_and_spmv(d, dt, case):
    x = matrix(case, dt, seed=d + 10)
    n = x.shape[0]
    ja, ta = both_csr(x)
    jm, tm = meshes(d)
    jv, tv, v = operands(x, d, jm, tm)
    jh, th = jpar.halo_partition(ja, jm), tpar.halo_partition(ta, tm)
    same_fields(jh, th, ("data", "indices", "indptr", "send_idx"), META)
    yt = tpar.halo_spmv(th, tv, tm).numpy()
    np.testing.assert_allclose(yt, np.asarray(jpar.halo_spmv(jh, jv, jm)),
                               **tol(dt))
    np.testing.assert_allclose(yt[:n], x.astype(np.float64) @ v, rtol=1e-4,
                               atol=1e-5)
    jo = jpar.halo_partition_overlapped(ja, jm)
    to = tpar.halo_partition_overlapped(ta, tm)
    same_fields(jo, to, ("int_data", "int_idx", "int_rows", "fr_data",
                         "fr_idx", "fr_rows", "send_idx"), META)
    np.testing.assert_allclose(
        tpar.halo_spmv_overlapped(to, tv, tm).numpy(),
        np.asarray(jpar.halo_spmv_overlapped(jo, jv, jm)), **tol(dt))
    np.testing.assert_allclose(tpar.dist_spmv(to, tv, tm).numpy(), yt,
                               **tol(dt))


@pytest.mark.parametrize("d", [2, 8])
def test_halo_spmm_both_plans(d):
    x = matrix("band", np.float64, seed=77)
    ja, ta = both_csr(x)
    jm, tm = meshes(d)
    jb, tb, b = operands(x, d, jm, tm, k=8)
    jh, th = jpar.halo_partition(ja, jm), tpar.halo_partition(ta, tm)
    jo = jpar.halo_partition_overlapped(ja, jm)
    to = tpar.halo_partition_overlapped(ta, tm)
    got = tpar.halo_spmm(th, tb, tm).numpy()
    np.testing.assert_allclose(got, np.asarray(jpar.halo_spmm(jh, jb, jm)),
                               rtol=1e-12, atol=1e-12)
    got_o = tpar.halo_spmm_overlapped(to, tb, tm).numpy()
    np.testing.assert_allclose(
        got_o, np.asarray(jpar.halo_spmm_overlapped(jo, jb, jm)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[:100], x @ b, rtol=1e-10, atol=1e-12)


def test_band_halo_bounds():
    # tests/test_halo.py:38 and :90 bounds, on the port's plans
    for n, bw in [(64, 3), (100, 5), (17, 2)]:
        rng = np.random.default_rng(n)
        x = sum(np.diag(rng.standard_normal(n - abs(o)), o)
                for o in range(-bw, bw + 1))
        _, ta = both_csr(x)
        tm = tpar.make_1d_mesh(8, device=CPU)
        th = tpar.halo_partition(ta, tm)
        assert th.halo <= th.cols_per_shard + 2 * bw
        to = tpar.halo_partition_overlapped(ta, tm)
        assert to.halo <= 2 * bw + 1
        v = rng.standard_normal(n)
        vs = tpar.shard_vector(torch.from_numpy(v), tpar.pcsr_from_csr(ta, tm),
                               tm)
        for y in (tpar.halo_spmv(th, vs, tm),
                  tpar.halo_spmv_overlapped(to, vs, tm)):
            np.testing.assert_allclose(y[:n].numpy(), x @ v, rtol=1e-10,
                                       atol=1e-12)


def test_overlapped_empty_rows_exact():
    # tests/test_halo.py::test_halo_overlapped_empty_rows_and_uneven
    n = 21
    x = np.zeros((n, n))
    x[0, 20], x[13, 0], x[20, 20] = 2.0, -1.5, 4.0
    _, ta = both_csr(x)
    tm = tpar.make_1d_mesh(8, device=CPU)
    to = tpar.halo_partition_overlapped(ta, tm)
    v = torch.arange(1.0, n + 1.0, dtype=torch.float64)
    vs = tpar.shard_vector(v, tpar.pcsr_from_csr(ta, tm), tm)
    np.testing.assert_array_equal(
        tpar.halo_spmv_overlapped(to, vs, tm)[:n].numpy(), x @ v.numpy())


def test_interop_plans_run_in_the_port():
    x = matrix("uneven", np.float64, seed=5)
    ja, _ = both_csr(x)
    jm, tm = meshes(8)
    jv, tv, _ = operands(x, 8, jm, tm)
    jh = jpar.halo_partition(ja, jm)
    th = interop.halo_pcsr_from_arrays(
        jh.data, jh.indices, jh.indptr, jh.send_idx, shape=jh.shape,
        rows_per_shard=jh.rows_per_shard, cols_per_shard=jh.cols_per_shard,
        halo=jh.halo, mesh=tm)
    np.testing.assert_allclose(tpar.halo_spmv(th, tv, tm).numpy(),
                               np.asarray(jpar.halo_spmv(jh, jv, jm)),
                               rtol=1e-12, atol=1e-12)
    jo = jpar.halo_partition_overlapped(ja, jm)
    to = interop.halo_overlap_from_arrays(
        jo.int_data, jo.int_idx, jo.int_rows, jo.fr_data, jo.fr_idx,
        jo.fr_rows, jo.send_idx, shape=jo.shape,
        rows_per_shard=jo.rows_per_shard, cols_per_shard=jo.cols_per_shard,
        halo=jo.halo, mesh=tm)
    np.testing.assert_allclose(tpar.halo_spmv_overlapped(to, tv, tm).numpy(),
                               np.asarray(jpar.halo_spmv_overlapped(jo, jv,
                                                                    jm)),
                               rtol=1e-12, atol=1e-12)


def test_dist_spmv_refuses_phub_like_the_reference():
    x = matrix("uneven", np.float64, seed=1)
    ja, ta = both_csr(x)
    jm, tm = meshes(2)
    jv, tv, _ = operands(x, 2, jm, tm)
    with pytest.raises(TypeError, match="dist_spmv"):
        jpar.dist_spmv(jpar.phub_partition(ja, jm, max_hub_cols=4), jv, jm)
    with pytest.raises(TypeError, match="dist_spmv"):
        tpar.dist_spmv(tpar.phub_partition(ta, tm, max_hub_cols=4), tv, tm)
    with pytest.raises(TypeError, match="dist_spmv"):
        tpar.dist_spmv(object(), tv, tm)
