"""The port's ``halo_spmv_segtile`` (K1 per shard) held against the
reference's, which runs its Pallas kernel per shard in interpret mode.

For D = 1, 2 and 8, float32 and float64, on a square matrix with uneven
slabs, a rectangular one and one with empty shards: the halo plan (send
table, halo width, ``comm_entries_per_device``) and the shared meta
(``wsub``, ``rows``, ``kstep``, ``chunks``, ``n_tiles``, ``fill``)
exactly; each shard's segment-tile plan slot for slot against the
reference's stacked slots (the reference pads every shard to the common
tile count with zero tiles); the SpMV within f32 rtol 1e-5 / atol 1e-6 or
f64 rtol 1e-12.  Also ``wsub="auto"``, the reference's
``tests/test_dist_fast.py`` fixtures (a band, skewed shards), and a
reference plan carried over by ``interop`` through the port's apply.  On
the CPU the port runs K1's plain version over each shard's compact stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu.parallel as jpar
import sparse_tpu_torch.parallel as tpar
from sparse_tpu.formats.csr import CSR as JCSR
from sparse_tpu_torch import interop

CPU = "cpu"


def tol(dt):
    return dict(rtol=1e-5, atol=1e-6) if dt == np.float32 else \
        dict(rtol=1e-12, atol=1e-12)


def matrix(case, dt, seed=0):
    rng = np.random.default_rng(seed)
    if case == "band":  # tests/test_dist_fast.py::banded_csr
        n = 200
        x = np.zeros((n, n))
        for i in range(n):
            js = np.clip(i + rng.integers(-12, 13, size=6), 0, n - 1)
            x[i, js] = rng.standard_normal(js.size)
        return x.astype(dt)
    if case == "skew":  # entries only in the first quarter of the rows
        n = 160
        x = np.zeros((n, n))
        for i in range(n // 4):
            js = np.clip(i + rng.integers(-9, 10, size=5), 0, n - 1)
            x[i, js] = rng.standard_normal(js.size)
        return x.astype(dt)
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


def operands(x, d, tm, seed=7):
    rng = np.random.default_rng(seed)
    m = x.shape[1]
    v = rng.standard_normal(m).astype(x.dtype)
    vp = np.concatenate([v, np.zeros(-(-m // d) * d - m, v.dtype)])
    return jnp.asarray(vp), tpar.put_sharded(vp, tm), v


def same_segtile_plan(jh, th):
    for f in ("shape", "rows_per_shard", "cols_per_shard", "halo", "wsub",
              "rows", "kstep", "chunks", "n_tiles", "fill", "n_shards",
              "comm_entries_per_device"):
        assert getattr(th, f) == getattr(jh, f), f
    np.testing.assert_array_equal(np.asarray(jh.send_idx),
                                  th.send_idx.numpy())
    assert len(th.plans) == jh.n_shards
    for i, p in enumerate(th.plans):
        for f in ("vals", "q", "seg_of", "rb"):
            ref = np.asarray(getattr(jh, f)[i])
            np.testing.assert_array_equal(ref[: p.n_tiles],
                                          getattr(p, f).numpy(), err_msg=f)
            assert not np.any(ref[p.n_tiles:]), f  # the common padding
        assert p.n == jh.rows_per_shard
        assert p.m == jh.cols_per_shard + jh.n_shards * jh.halo


@pytest.mark.parametrize("case", ["uneven", "rect", "empty"])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_segtile_plans_and_spmv(d, dt, case):
    x = matrix(case, dt, seed=d + 20)
    ja, ta = both_csr(x)
    jm, tm = jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)
    jh = jpar.halo_partition_segtile(ja, jm)
    th = tpar.halo_partition_segtile(ta, tm)
    same_segtile_plan(jh, th)
    jv, tv, v = operands(x, d, tm)
    yt = tpar.halo_spmv_segtile(th, tv, tm).numpy()
    np.testing.assert_allclose(
        yt, np.asarray(jpar.halo_spmv_segtile(jh, jv, jm)), **tol(dt))
    np.testing.assert_allclose(yt[: x.shape[0]], x.astype(np.float64) @ v,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tpar.dist_spmv(th, tv, tm).numpy(), yt)


@pytest.mark.parametrize("case,d", [("band", 8), ("skew", 8), ("band", 2)])
def test_dist_fast_fixtures(case, d):
    x = matrix(case, np.float32, seed=3)
    ja, ta = both_csr(x)
    jm, tm = jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)
    jh = jpar.halo_partition_segtile(ja, jm, wsub="auto")
    th = tpar.halo_partition_segtile(ta, tm, wsub="auto")
    same_segtile_plan(jh, th)
    assert th.fill > 0 or case == "skew"
    assert th.comm_entries_per_device <= x.shape[0] * (1 if d == 8 else 2)
    jv, tv, v = operands(x, d, tm, seed=1)
    yt = tpar.halo_spmv_segtile(th, tv, tm).numpy()
    np.testing.assert_allclose(
        yt, np.asarray(jpar.halo_spmv_segtile(jh, jv, jm)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(yt[: x.shape[0]], x @ v, rtol=1e-5, atol=1e-5)


def test_interop_segtile_plan_runs_in_the_port():
    x = matrix("band", np.float64, seed=9)
    ja, ta = both_csr(x)
    jm, tm = jpar.make_1d_mesh(8), tpar.make_1d_mesh(8, device=CPU)
    jh = jpar.halo_partition_segtile(ja, jm)
    th = interop.halo_segtile_from_arrays(
        jh.vals, jh.q, jh.seg_of, jh.rb, jh.send_idx, shape=jh.shape,
        rows_per_shard=jh.rows_per_shard, cols_per_shard=jh.cols_per_shard,
        halo=jh.halo, wsub=jh.wsub, rows=jh.rows, kstep=jh.kstep,
        chunks=jh.chunks, n_tiles=jh.n_tiles, fill=jh.fill, mesh=tm)
    jv, tv, v = operands(x, 8, tm)
    np.testing.assert_allclose(
        tpar.halo_spmv_segtile(th, tv, tm).numpy(),
        np.asarray(jpar.halo_spmv_segtile(jh, jv, jm)), rtol=1e-12,
        atol=1e-12)
    own = tpar.halo_partition_segtile(ta, tm)
    for p, q in zip(own.plans, th.plans):
        assert p.stream.nnz == q.stream.nnz  # no stored zeros here
