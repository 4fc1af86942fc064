"""Communication volume of the port's distributed plans, held against the
reference's (``tests/test_comm_volume.py``).

The scaling claims of the distributed layer are asserted structurally: each
plan reports its all_to_all payload (``comm_entries_per_device``).  On the
reference's banded and dense-coupled fixtures at D = 8 (and D = 2), the
port's halo, overlapped-halo, segment-tile halo, SpGEMM and transpose
plans report exactly the reference's payload and padded pair widths, and
the reference's bounds (O(halo) against O(m), O(nnz/D) against O(nnz))
hold on them.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_tpu.parallel as jpar
import sparse_tpu_torch.parallel as tpar
from sparse_tpu.formats.csr import CSR as JCSR
from sparse_tpu_torch import interop

CPU = "cpu"


def banded(n, half_width, seed=0, per_row=8):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = np.clip(rows + rng.integers(-half_width, half_width + 1,
                                       rows.size), 0, n - 1)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    keep = np.ones(rows.size, bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return vals, cols.astype(np.int32), indptr.astype(np.int32), (n, n)


def dense_coupled(n, seed=1, density=0.4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
         ).astype(np.float32)
    r, c = np.nonzero(x)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return x[r, c], c.astype(np.int32), indptr.astype(np.int32), (n, n)


def both(arrays):
    vals, cols, ptr, shape = arrays
    ref = JCSR(data=jnp.asarray(vals), indices=jnp.asarray(cols),
               indptr=jnp.asarray(ptr), shape=shape)
    return ref, interop.csr_from_arrays(vals, cols, ptr, shape, device=CPU)


def meshes(d):
    return jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("pattern", ["band", "dense"])
def test_halo_payloads_equal_reference(pattern, d):
    arrays = banded(1024, 16) if pattern == "band" else dense_coupled(512)
    ja, ta = both(arrays)
    jm, tm = meshes(d)
    for part in ("halo_partition", "halo_partition_overlapped",
                 "halo_partition_segtile"):
        jp, tp = getattr(jpar, part)(ja, jm), getattr(tpar, part)(ta, tm)
        assert (tp.halo, tp.comm_entries_per_device) == \
            (jp.halo, jp.comm_entries_per_device), part


def test_halo_comm_is_o_halo_not_o_m():
    n, w = 1024, 16
    _, ta = both(banded(n, w))
    tm = tpar.make_1d_mesh(8, device=CPU)
    plan = tpar.halo_partition_overlapped(ta, tm)
    assert plan.halo <= 2 * w + 2
    assert plan.comm_entries_per_device <= 8 * (2 * w + 2)
    assert plan.comm_entries_per_device < n // 2
    full = tpar.halo_partition(ta, tm)
    assert full.comm_entries_per_device <= 8 * full.cols_per_shard
    assert full.halo <= full.cols_per_shard
    seg = tpar.halo_partition_segtile(ta, tm)
    assert seg.comm_entries_per_device == plan.comm_entries_per_device


def test_halo_comm_degrades_with_coupling():
    tm = tpar.make_1d_mesh(8, device=CPU)
    band = tpar.halo_partition_overlapped(both(banded(512, 8))[1], tm)
    dense = tpar.halo_partition_overlapped(both(dense_coupled(512))[1], tm)
    assert dense.comm_entries_per_device > 7 * dense.cols_per_shard // 2
    assert band.comm_entries_per_device * 4 < dense.comm_entries_per_device


@pytest.mark.parametrize("pattern", ["band", "dense"])
def test_spgemm_and_transpose_payloads(pattern):
    arrays = banded(1024, 16, seed=3) if pattern == "band" else \
        dense_coupled(512, seed=4)
    ja, ta = both(arrays)
    jm, tm = meshes(8)
    jp, tp = jpar.pcsr_from_csr(ja, jm), tpar.pcsr_from_csr(ta, tm)
    js, ts = jpar.build_pspgemm_plan(jp, jp, jm), \
        tpar.build_pspgemm_plan(tp, tp, tm)
    assert (ts.exch, ts.comm_entries_per_device) == \
        (js.exch, js.comm_entries_per_device)
    jt, tt = jpar.build_transpose_plan(jp, jm), \
        tpar.build_transpose_plan(tp, tm)
    assert (tt.exch, tt.comm_entries_per_device) == \
        (jt.exch, jt.comm_entries_per_device)
    nnz = int(arrays[2][-1])
    if pattern == "band":
        assert ts.comm_entries_per_device < nnz // 2
        assert ts.exch <= (-(-1024 // 8) + 2 * 16 + 2) * 9
    else:
        assert ts.comm_entries_per_device > nnz // 4
        assert tt.comm_entries_per_device > nnz // 10


def test_transpose_comm_is_o_nnz_over_d():
    n, w, per_row = 1024, 4, 8
    arrays = banded(n, w, seed=5, per_row=per_row)
    tm = tpar.make_1d_mesh(8, device=CPU)
    tp = tpar.pcsr_from_csr(both(arrays)[1], tm)
    plan = tpar.build_transpose_plan(tp, tm)
    nnz = int(arrays[2][-1])
    assert plan.exch <= (2 * w + 2) * per_row
    assert plan.comm_entries_per_device < nnz // 4
    dense = dense_coupled(512, seed=6)
    td = tpar.pcsr_from_csr(both(dense)[1], tm)
    pland = tpar.build_transpose_plan(td, tm)
    nnz_d = int(dense[2][-1])
    assert pland.comm_entries_per_device > nnz_d // 10
    assert plan.comm_entries_per_device / nnz * 4 < \
        pland.comm_entries_per_device / nnz_d
