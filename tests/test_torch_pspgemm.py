"""The port's distributed SpGEMM and transpose
(``sparse_tpu_torch.parallel.pspgemm``) held against the reference's.

Same numpy-seeded matrices for both packages, D = 1, 2 and 8, float32 and
float64, a rectangular pair with uneven slabs and a pair whose rows after
the first quarter are empty: the all-to-all plans (``send_pos``,
``bi_gath``, ``starts``, ``lens``, ``exch``, ``cap``; the transpose's
``send_pos``, ``perm`` and A^T structure) exactly, and the products' stored
structure exactly with values within f32 rtol 1e-5 / atol 1e-6 or f64 rtol
1e-12.  The reference's ``tests/test_parallel.py`` SpGEMM / transpose
checks (dense oracles, the banded comm bound, a round trip) run on the
port, and a reference plan carried over by ``interop`` runs in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparse_tpu.parallel as jpar
import sparse_tpu_torch.parallel as tpar
from sparse_tpu.formats.csr import CSR as JCSR
from sparse_tpu_torch import interop

CPU = "cpu"


def tol(dt):
    return dict(rtol=1e-5, atol=1e-6) if dt == np.float32 else \
        dict(rtol=1e-12, atol=1e-12)


def both_csr(x):
    s = sp.csr_matrix(x)
    ref = JCSR(data=jnp.asarray(s.data),
               indices=jnp.asarray(s.indices.astype(np.int32)),
               indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=x.shape)
    port = interop.csr_from_arrays(s.data, s.indices, s.indptr, x.shape,
                                   device=CPU)
    return ref, port


def pair(case, dt, seed):
    rng = np.random.default_rng(seed)
    n, m, k = 40, 32, 24
    xa = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.2)
    xb = rng.standard_normal((m, k)) * (rng.random((m, k)) < 0.2)
    if case == "empty":
        xa[n // 4:] = 0
        xb[m // 4:] = 0
    return xa.astype(dt), xb.astype(dt)


def partitioned(x, d):
    ja, ta = both_csr(x)
    jm, tm = jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)
    return jm, tm, jpar.pcsr_from_csr(ja, jm), tpar.pcsr_from_csr(ta, tm)


def same_pcsr(jc, tc, dt):
    np.testing.assert_array_equal(np.asarray(jc.indices), tc.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jc.indptr), tc.indptr.numpy())
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               **tol(dt))
    assert (tc.shape, tc.rows_per_shard) == (jc.shape, jc.rows_per_shard)


@pytest.mark.parametrize("case", ["uneven", "empty"])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_spgemm_plans_and_products(d, dt, case):
    xa, xb = pair(case, dt, seed=41 + d)
    jm, tm, ja, ta = partitioned(xa, d)
    _, _, jb, tb = partitioned(xb, d)
    jc = jpar.pcsr_spgemm(ja, jb, jm)
    tc = tpar.pcsr_spgemm(ta, tb, tm)
    same_pcsr(jc, tc, dt)
    jp = jpar.build_pspgemm_plan(ja, jb, jm)
    tp = tpar.build_pspgemm_plan(ta, tb, tm)
    for f in ("send_pos", "bi_gath", "starts", "lens"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)
    assert (tp.exch, tp.cap, tp.k, tp.comm_entries_per_device) == \
        (jp.exch, jp.cap, jp.k, jp.comm_entries_per_device)
    same_pcsr(jpar.pcsr_spgemm_aa(ja, jb, jm, jp),
              tpar.pcsr_spgemm_aa(ta, tb, tm, tp), dt)
    dense = tpar.pcsr_todense(tpar.pcsr_spgemm_aa(ta, tb, tm, tp)).numpy()
    np.testing.assert_allclose(dense, xa.astype(np.float64) @ xb, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(17, 53), (24, 40), (8, 8)])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_transpose_plan_and_values(d, shape):
    rng = np.random.default_rng(54 + d)
    n, m = shape
    x = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.25)
    jm, tm, ja, ta = partitioned(x, d)
    jp, tp = jpar.build_transpose_plan(ja, jm), tpar.build_transpose_plan(ta,
                                                                          tm)
    for f in ("send_pos", "perm", "indices", "indptr"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)
    assert (tp.exch, tp.shape, tp.rows_per_shard,
            tp.comm_entries_per_device) == \
        (jp.exch, jp.shape, jp.rows_per_shard, jp.comm_entries_per_device)
    same_pcsr(jpar.pcsr_transpose_device(ja, jm, jp),
              tpar.pcsr_transpose_device(ta, tm, tp), np.float64)
    pt = tpar.pcsr_transpose(ta, tm)
    np.testing.assert_array_equal(tpar.pcsr_todense(pt).numpy(), x.T)


def test_banded_aa_comm_small_and_round_trip():
    # tests/test_parallel.py::test_pcsr_spgemm_aa_banded_comm_small and
    # ::test_pcsr_transpose_roundtrip_device, on the port
    rng = np.random.default_rng(52)
    n = 64
    x = sum(np.diag(rng.standard_normal(n - abs(o)), o) for o in range(-2, 3))
    _, tm, _, ta = partitioned(x, 8)
    plan = tpar.build_pspgemm_plan(ta, ta, tm)
    assert plan.comm_entries_per_device * 4 <= 8 * ta.nse_per_shard
    np.testing.assert_allclose(
        tpar.pcsr_todense(tpar.pcsr_spgemm_aa(ta, ta, tm, plan)).numpy(),
        x @ x, rtol=1e-10, atol=1e-12)
    y = rng.standard_normal((33, 21)) * (rng.random((33, 21)) < 0.3)
    _, tm, _, ty = partitioned(y, 8)
    pt = tpar.pcsr_transpose_device(ty, tm, tpar.build_transpose_plan(ty, tm))
    ptt = tpar.pcsr_transpose_device(pt, tm, tpar.build_transpose_plan(pt, tm))
    np.testing.assert_array_equal(tpar.pcsr_todense(ptt).numpy(), y)


def test_interop_plans_run_in_the_port():
    xa, xb = pair("uneven", np.float64, seed=51)
    jm, tm, ja, ta = partitioned(xa, 8)
    _, _, jb, tb = partitioned(xb, 8)
    jp = jpar.build_pspgemm_plan(ja, jb, jm)
    tp = interop.pspgemm_plan_from_arrays(jp.send_pos, jp.bi_gath, jp.starts,
                                          jp.lens, exch=jp.exch, cap=jp.cap,
                                          k=jp.k, mesh=tm)
    pa = interop.pcsr_from_arrays(ja.data, ja.indices, ja.indptr,
                                  shape=ja.shape,
                                  rows_per_shard=ja.rows_per_shard, mesh=tm)
    same_pcsr(jpar.pcsr_spgemm_aa(ja, jb, jm, jp),
              tpar.pcsr_spgemm_aa(pa, tb, tm, tp), np.float64)
    jt = jpar.build_transpose_plan(ja, jm)
    tt = interop.ptranspose_plan_from_arrays(
        jt.send_pos, jt.perm, jt.indices, jt.indptr, exch=jt.exch,
        shape=jt.shape, rows_per_shard=jt.rows_per_shard, mesh=tm)
    np.testing.assert_array_equal(
        tpar.pcsr_todense(tpar.pcsr_transpose_device(pa, tm, tt)).numpy(),
        xa.T)


def test_aa_plan_with_a_shard_past_the_last_row():
    # 17 B rows over 8 shards of 3: shard 6 starts past the last row.  The
    # reference's plan builder fails there (it assigns the shard's padded
    # row lengths into an empty slice, parallel/pspgemm.py:212); the
    # port's takes the rows that exist.
    rng = np.random.default_rng(60)
    xa = rng.standard_normal((12, 17)) * (rng.random((12, 17)) < 0.5)
    xb = rng.standard_normal((17, 5)) * (rng.random((17, 5)) < 0.5)
    jm, tm, ja, ta = partitioned(xa, 8)
    _, _, jb, tb = partitioned(xb, 8)
    with pytest.raises(ValueError, match="broadcast"):
        jpar.build_pspgemm_plan(ja, jb, jm)
    plan = tpar.build_pspgemm_plan(ta, tb, tm)
    np.testing.assert_allclose(
        tpar.pcsr_todense(tpar.pcsr_spgemm_aa(ta, tb, tm, plan)).numpy(),
        xa @ xb, rtol=1e-12, atol=1e-12)
