"""Wide (int64) BSR block coordinates in the PyTorch port, against the
reference's ``tests/test_bsr_wide.py``: nb = 50,000 block rows, beyond
``BSR_MAX_NB`` = 46,340, where a flattened block coordinate r*nb+c passes
2^31.  The port switches ``indices`` to int64 there as the reference does
(with x64), and every op keeps working.

Both packages get the same numpy-seeded blocks on the CPU; results within
rtol/atol 1e-12 of a manual float64 oracle and of the reference (1e-10
for products against SciPy, the reference's tolerances), stored
structures exactly."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.formats.bell import bell_from_bsr as j_bell_from_bsr
from sparse_tpu.formats.bell import bell_smvm as j_bell_smvm
from sparse_tpu.formats.bsr import _bidx_dtype as j_bidx_dtype
from sparse_tpu_torch.formats.bell import bell_from_bsr, bell_smvm
from sparse_tpu_torch.formats.bsr import BSR_MAX_NB, _bidx_dtype
from sparse_tpu_torch.ops import cuda_bsr as tcb
from sparse_tpu_torch.ops.spgemm import _spgemm_route

BSZ = 2
NB = 50_000  # > BSR_MAX_NB = 46340
N = NB * BSZ
TIGHT = dict(rtol=1e-12, atol=1e-12)


def wide_entries(seed=0, nblk=12):
    """A few blocks scattered across the wide coordinate space, some with a
    flattened coordinate past 2^31."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.choice(NB, nblk, replace=False))
    c = (r + rng.integers(-3, 4, nblk)) % NB
    blocks = rng.standard_normal((nblk, BSZ, BSZ))
    return [(int(ri), int(ci), blocks[i])
            for i, (ri, ci) in enumerate(zip(r, c))]


def wide_bsr(seed=0, nblk=12):
    entries = wide_entries(seed, nblk)
    return (pt.bsr_make(N, BSZ, entries, dtype=torch.float64, device="cpu"),
            entries)


def manual(entries, v):
    ref = np.zeros(N)
    for r, c, blk in entries:
        ref[r * BSZ:(r + 1) * BSZ] += blk @ v[c * BSZ:(c + 1) * BSZ]
    return ref


def to_scipy(m):
    coo = pt.bsr_to_coo(m)
    row, col, data = coo.row.numpy(), coo.col.numpy(), coo.data.numpy()
    keep = row < m.n
    return sp.coo_matrix((data[keep], (row[keep], col[keep])),
                         shape=(m.n, m.n)).tocsr()


def test_dtype_switches_wide():
    assert _bidx_dtype(BSR_MAX_NB) == torch.int32
    assert _bidx_dtype(BSR_MAX_NB + 1) == torch.int64
    assert j_bidx_dtype(BSR_MAX_NB + 1) == jnp.int64  # the same switch
    a, entries = wide_bsr()
    assert a.indices.dtype == torch.int64
    idx = a.indices.numpy()
    assert idx[idx < a.sentinel].max() > 2**31
    ja = st.bsr_make(N, BSZ, entries, dtype=jnp.float64)
    np.testing.assert_array_equal(idx, np.asarray(ja.indices))


def test_smvm_matches_manual_and_reference():
    a, entries = wide_bsr()
    v = np.random.default_rng(1).standard_normal(N)
    got = pt.bsr_smvm(a, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, manual(entries, v), **TIGHT)
    ja = st.bsr_make(N, BSZ, entries, dtype=jnp.float64)
    np.testing.assert_allclose(got, np.asarray(st.bsr_smvm(
        ja, jnp.asarray(v))), **TIGHT)


def test_transpose_roundtrip_and_add():
    a, entries = wide_bsr()
    at = pt.bsr_transpose(a)
    jat = st.bsr_transpose(st.bsr_make(N, BSZ, entries, dtype=jnp.float64))
    np.testing.assert_array_equal(at.indices.numpy(), np.asarray(jat.indices))
    np.testing.assert_array_equal(at.blocks.numpy(), np.asarray(jat.blocks))
    att = pt.bsr_transpose(at)
    assert torch.equal(att.indices, a.indices)
    np.testing.assert_allclose(att.blocks.numpy(), a.blocks.numpy())
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(N))
    np.testing.assert_allclose(pt.bsr_smvm(pt.bsr_add(a, a), v).numpy(),
                               2 * pt.bsr_smvm(a, v).numpy(), rtol=1e-12)
    m = pt.bsr_mul(a, a)
    assert m.indices.dtype == torch.int64
    np.testing.assert_allclose(m.blocks.numpy(), a.blocks.numpy() ** 2,
                               rtol=1e-12)


def test_smsmm_prepared_and_slab():
    """A @ A^T (some products exist: the product's diagonal) through the
    prepared apply and the slab apply (K7's plain version on the CPU),
    against SciPy and the reference."""
    a, entries = wide_bsr(seed=3, nblk=10)
    b = pt.bsr_transpose(a)
    plan = pt.bsr_smsmm_prepare(a, b)
    assert plan.indices.dtype == torch.int64 and plan.n_products > 0
    c = pt.bsr_smsmm_apply(plan, a, b)
    assert abs(to_scipy(c) - to_scipy(a) @ to_scipy(b)).max() < 1e-10
    pp = tcb.bsr_smsmm_slab_prepare(plan, a.nbz, b.nbz, g=4, p=8)
    cp = tcb.bsr_smsmm_apply_slab(pp, a, b)
    np.testing.assert_allclose(cp.blocks.numpy(), c.blocks.numpy(),
                               rtol=1e-10, atol=1e-12)
    ja = st.bsr_make(N, BSZ, entries, dtype=jnp.float64)
    jb = st.bsr_transpose(ja)
    jc = st.bsr_smsmm_apply(st.bsr_smsmm_prepare(ja, jb), ja, jb)
    np.testing.assert_array_equal(c.indices.numpy(), np.asarray(jc.indices))
    np.testing.assert_allclose(c.blocks.numpy(), np.asarray(jc.blocks),
                               rtol=1e-10, atol=1e-12)


def test_from_coo_to_csr_roundtrip():
    a, entries = wide_bsr(seed=4)
    coo = pt.bsr_to_coo(a)
    jcoo = st.bsr_to_coo(st.bsr_make(N, BSZ, entries, dtype=jnp.float64))
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(coo, f).numpy(),
                                      np.asarray(getattr(jcoo, f)))
    back = pt.bsr_from_coo(coo, BSZ)
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(N))
    want = pt.bsr_smvm(a, v).numpy()
    np.testing.assert_allclose(pt.bsr_smvm(back, v).numpy(), want,
                               rtol=1e-12)
    np.testing.assert_allclose((pt.bsr_to_csr(a) @ v).numpy(), want,
                               rtol=1e-12)


def test_spgemm_auto_routes_wide():
    """A clustered scalar CSR beyond the int32 block range takes the block
    route (dense 2x2 blocks, nnz above the route floor), as in the
    reference, with the reference's product."""
    rng = np.random.default_rng(6)
    nb_used = 1200  # 4800 nnz >= _BLOCK_ROUTE_MIN_NNZ
    r = np.sort(rng.choice(NB, nb_used, replace=False))
    rows = np.repeat(r * BSZ, 2 * BSZ) + np.tile([0, 0, 1, 1], nb_used)
    cols = np.repeat(r * BSZ, 2 * BSZ) + np.tile([0, 1, 0, 1], nb_used)
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(N, N)).tocsr()
    a = pt.CSR(data=torch.from_numpy(A.data),
               indices=torch.from_numpy(A.indices.astype(np.int32)),
               indptr=torch.from_numpy(A.indptr.astype(np.int32)),
               shape=(N, N))
    assert _spgemm_route(a, a) == ("block", BSZ)
    c = pt.spgemm(a, a, method="auto")
    got = sp.csr_matrix((c.data.numpy(), c.indices.numpy(),
                         c.indptr.numpy()), shape=(N, N))
    assert abs(got - A @ A).max() < 1e-10
    ja = st.CSR(data=jnp.asarray(A.data),
                indices=jnp.asarray(A.indices.astype(np.int32)),
                indptr=jnp.asarray(A.indptr.astype(np.int32)), shape=(N, N))
    jc = st.spgemm(ja, ja, method="auto")
    np.testing.assert_array_equal(c.indptr.numpy(), np.asarray(jc.indptr))
    k = int(c.indptr[-1])
    np.testing.assert_allclose(c.data.numpy()[:k], np.asarray(jc.data)[:k],
                               rtol=1e-12, atol=1e-12)


def test_bell_from_wide_bsr():
    """BELL keeps per-axis block columns, so its SpMV works past the int32
    nb range too."""
    a, entries = wide_bsr(seed=9, nblk=8)
    v = np.random.default_rng(10).standard_normal(N)
    got = bell_smvm(bell_from_bsr(a), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, manual(entries, v), **TIGHT)
    ja = st.bsr_make(N, BSZ, entries, dtype=jnp.float64)
    np.testing.assert_allclose(got, np.asarray(j_bell_smvm(
        j_bell_from_bsr(ja), jnp.asarray(v))), **TIGHT)


def test_narrow_unaffected():
    a = pt.bsr_eye(64, 8, device="cpu")
    assert a.indices.dtype == torch.int32
    m = pt.bsr_make(64, 8, [(0, 1, np.ones((8, 8))), (3, 2, np.eye(8))],
                    device="cpu")
    assert m.indices.dtype == torch.int32
    jm = st.bsr_make(64, 8, [(0, 1, np.ones((8, 8))), (3, 2, np.eye(8))])
    np.testing.assert_array_equal(m.indices.numpy(), np.asarray(jm.indices))
