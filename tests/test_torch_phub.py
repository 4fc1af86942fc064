"""The port's distributed hub/tail SpMV (``sparse_tpu_torch.parallel.phub``)
held against the reference's ``sparse_tpu.parallel.phub``.

The reference's ``tests/test_phub.py`` power-law fixture (zipf columns,
scrambled ids) goes to both packages: for D = 1, 2 and 8, float32 and
float64, the split (hub and tail triples, owned hub positions, hub width)
exactly and the SpMV within f32 rtol 1e-5 / atol 1e-6 or f64 rtol 1e-12;
the O(H) hub comm bound and the hub mass routing on the port's split.
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
FIELDS = ("hub_data", "hub_idx", "hub_rows", "tail_data", "tail_idx",
          "tail_rows", "own_hub_idx")


def powerlaw(n, seed, dt, per_row=5):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = (np.minimum(rng.zipf(1.3, rows.size), n) - 1).astype(np.int64)
    cols = rng.permutation(n)[cols]
    s = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n)).tocsr()
    s.sum_duplicates()
    s.data = s.data.astype(dt)
    return s


def both(s):
    ref = JCSR(data=jnp.asarray(s.data), indices=jnp.asarray(s.indices),
               indptr=jnp.asarray(s.indptr.astype(np.int64)), shape=s.shape)
    port = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                   device=CPU)
    return ref, port


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_phub_split_and_spmv(d, dt):
    n = 300
    s = powerlaw(n, seed=d, dt=dt)
    ja, ta = both(s)
    jm, tm = jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)
    jh = jpar.phub_partition(ja, jm, max_hub_cols=24)
    th = tpar.phub_partition(ta, tm, max_hub_cols=24)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jh, f)),
                                      getattr(th, f).numpy(), err_msg=f)
    for f in ("shape", "rows_per_shard", "cols_per_shard",
              "hub_cols_per_shard", "n_hub", "n_shards",
              "hub_comm_entries_per_device"):
        assert getattr(th, f) == getattr(jh, f), f
    v = np.random.default_rng(1).standard_normal(n).astype(dt)
    vp = np.concatenate([v, np.zeros(-(-n // d) * d - n, dt)])
    yt = tpar.phub_spmv(th, tpar.put_sharded(vp, tm), tm).numpy()
    yj = np.asarray(jpar.phub_spmv(jh, jnp.asarray(vp), jm))
    tol = dict(rtol=1e-5, atol=1e-6) if dt == np.float32 else \
        dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yt, yj, **tol)
    np.testing.assert_allclose(yt[:n], s.astype(np.float64) @ v, rtol=1e-4,
                               atol=1e-4)


def test_phub_comm_bound_and_hub_mass():
    # tests/test_phub.py's two checks, on the port
    s = powerlaw(2048, seed=0, dt=np.float32)
    _, ta = both(s)
    tm = tpar.make_1d_mesh(8, device=CPU)
    th = tpar.phub_partition(ta, tm, max_hub_cols=128)
    assert th.hub_comm_entries_per_device <= 3 * 128
    assert th.hub_comm_entries_per_device < 2048 // 2
    s = powerlaw(1024, seed=3, dt=np.float32)
    _, ta = both(s)
    th = tpar.phub_partition(ta, tm, max_hub_cols=64)
    hub_nnz = int((th.hub_rows < th.rows_per_shard).sum())
    tail_nnz = int((th.tail_rows < th.rows_per_shard).sum())
    assert hub_nnz + tail_nnz == s.nnz
    assert hub_nnz > 0.05 * s.nnz
