"""The port's distributed block SpGEMM (``sparse_tpu_torch.parallel.pbsr``)
held against the reference's ``sparse_tpu.parallel.pbsr``.

Same numpy-seeded block matrices for both packages: for D = 1, 2 and 8,
float32 and float64, on random patterns with uneven block-row slabs
(nb = 9 and 24) and one confined to a block row (empty shards): the
partition, the exchange plan and the stacked slab schedule
(``schedule_stacked``) exactly; ``pbsr_smsmm`` (flat products at bsz 4,
batched products at bsz 16) and ``pbsr_smsmm_slab`` (K7 per shard; its
plain version on the CPU) against the reference's ``pbsr_smsmm`` and
``pbsr_smsmm_pallas`` (interpret mode) within f32 rtol 1e-5 / atol 1e-6
or f64 rtol 1e-12.  The two helpers this slice ported
(``_flat_block_products``, ``schedule_stacked``) are held against the
reference's directly, and the reference's ``tests/test_pbsr.py`` checks
(comm volume on a band, value updates) run on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu.parallel as jpar
import sparse_tpu_torch.parallel as tpar
from sparse_tpu.formats.bsr import BSR as JBSR
from sparse_tpu.formats.bsr import _flat_block_products as j_flat
from sparse_tpu.ops.pallas_bsr import schedule_stacked as j_schedule
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats.bsr import _flat_block_products as t_flat
from sparse_tpu_torch.formats.bsr import bsr_todense
from sparse_tpu_torch.ops.cuda_bsr import schedule_stacked as t_schedule

CPU = "cpu"


def tol(dt):
    return dict(rtol=1e-5, atol=1e-6) if dt == np.float32 else \
        dict(rtol=1e-12, atol=1e-12)


def rand_pattern(case, nb, rng, density):
    if case == "empty":
        return np.zeros(3, np.int64), np.array([0, 5 % nb, nb - 1])
    return np.nonzero(rng.random((nb, nb)) < density)


def both_bsr(rows, cols, nb, bsz, dt, rng):
    """The BSR in both packages, N(0, 1/bsz) entries (sums of products stay
    O(1) at every block size), and its dense float64 form."""
    blocks = (rng.standard_normal((rows.size, bsz, bsz))
              / np.sqrt(bsz)).astype(dt)
    idx = (rows * nb + cols).astype(np.int32)
    ref = JBSR(indices=jnp.asarray(idx), blocks=jnp.asarray(blocks),
               n=nb * bsz, bsz=bsz)
    port = interop.bsr_from_arrays(idx, blocks, nb * bsz, bsz, device=CPU)
    dense = bsr_todense(port).double().numpy()
    return ref, port, dense


def operands(case, nb, bsz, dt, seed):
    rng = np.random.default_rng(seed)
    a = both_bsr(*rand_pattern(case, nb, rng, 0.3), nb, bsz, dt, rng)
    b = both_bsr(*rand_pattern(case, nb, rng, 0.4), nb, bsz, dt, rng)
    return a, b


def same(ref, port, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(port, f).numpy(), err_msg=f)


CASES = [("uneven", 9, 4), ("uneven", 24, 4), ("empty", 16, 4),
         ("uneven", 10, 16)]


@pytest.mark.parametrize("case,nb,bsz", CASES)
@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_pbsr_plan_and_smsmm(d, dt, case, nb, bsz):
    (ja, ta, xa), (jb, tb, xb) = operands(case, nb, bsz, dt, seed=nb + d)
    jm, tm = jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)
    jpa, tpa = jpar.pbsr_from_bsr(ja, jm), tpar.pbsr_from_bsr(ta, tm)
    jpb, tpb = jpar.pbsr_from_bsr(jb, jm), tpar.pbsr_from_bsr(tb, tm)
    same(jpa, tpa, ("indices", "blocks"))
    same(jpb, tpb, ("indices", "blocks"))
    assert tpa.rows_per_shard == jpa.rows_per_shard
    jp = jpar.build_pbsr_smsmm_plan(jpa, jpb, jm)
    tp = tpar.build_pbsr_smsmm_plan(tpa, tpb, tm)
    same(jp, tp, ("send_pos", "a_pos", "b_pos", "seg", "out_indices"))
    assert (tp.exch, tp.cap, tp.nbz_out, tp.comm_entries_per_device) == \
        (jp.exch, jp.cap, jp.nbz_out, jp.comm_entries_per_device)
    jc, tc = jpar.pbsr_smsmm(jpa, jpb, jm, jp), tpar.pbsr_smsmm(tpa, tpb, tm,
                                                                tp)
    same(jc, tc, ("indices",))
    np.testing.assert_allclose(tc.blocks.numpy(), np.asarray(jc.blocks),
                               **tol(dt))
    np.testing.assert_allclose(bsr_todense(tpar.pbsr_to_bsr(tc)).numpy(),
                               xa @ xb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case,nb,bsz,d,dt", [
    ("uneven", 9, 4, 2, np.float64), ("uneven", 16, 8, 8, np.float32),
    ("empty", 16, 4, 8, np.float32), ("uneven", 12, 16, 1, np.float64)])
def test_pbsr_slab_plan_and_apply(case, nb, bsz, d, dt):
    (ja, ta, xa), (jb, tb, xb) = operands(case, nb, bsz, dt, seed=3 * nb)
    jm, tm = jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)
    jpa, tpa = jpar.pbsr_from_bsr(ja, jm), tpar.pbsr_from_bsr(ta, tm)
    jpb, tpb = jpar.pbsr_from_bsr(jb, jm), tpar.pbsr_from_bsr(tb, tm)
    jp = jpar.build_pbsr_smsmm_plan_pallas(jpa, jpb, jm)
    tp = tpar.build_pbsr_smsmm_plan_slab(tpa, tpb, tm)
    same(jp, tp, ("send_pos", "a_idx", "b_idx", "oloc", "first", "slab",
                  "out_indices"))
    assert (tp.exch, tp.chunks, tp.g, tp.p, tp.nbz_out,
            tp.comm_entries_per_device) == \
        (jp.exch, jp.chunks, jp.g, jp.p, jp.nbz_out,
         jp.comm_entries_per_device)
    tc = tpar.pbsr_smsmm_slab(tpa, tpb, tm, tp)
    jc = jpar.pbsr_smsmm_pallas(jpa, jpb, jm, jp)
    same(jc, tc, ("indices",))
    np.testing.assert_allclose(tc.blocks.numpy(), np.asarray(jc.blocks),
                               **tol(dt))
    np.testing.assert_allclose(bsr_todense(tpar.pbsr_to_bsr(tc)).numpy(),
                               xa @ xb, rtol=1e-4, atol=1e-4)
    # a plan carried over from the reference runs in the port
    cp = interop.pbsr_slab_plan_from_arrays(
        jp.send_pos, jp.a_idx, jp.b_idx, jp.oloc, jp.first, jp.slab,
        jp.out_indices, exch=jp.exch, chunks=jp.chunks, g=jp.g, p=jp.p,
        nbz_out=jp.nbz_out, n=jp.n, bsz=jp.bsz,
        rows_per_shard=jp.rows_per_shard, mesh=tm)
    pa = interop.pbsr_from_arrays(jpa.indices, jpa.blocks, n=jpa.n,
                                  bsz=jpa.bsz,
                                  rows_per_shard=jpa.rows_per_shard, mesh=tm)
    np.testing.assert_array_equal(
        tpar.pbsr_smsmm_slab(pa, tpb, tm, cp).blocks.numpy(),
        tc.blocks.numpy())


@pytest.mark.parametrize("bsz", [2, 4, 8])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_flat_block_products_match_reference(dt, bsz):
    rng = np.random.default_rng(bsz)
    fa = rng.standard_normal((13, bsz * bsz)).astype(dt)
    fb = rng.standard_normal((13, bsz * bsz)).astype(dt)
    want = np.asarray(j_flat(jnp.asarray(fa), jnp.asarray(fb), bsz, dt))
    got = t_flat(torch.from_numpy(fa), torch.from_numpy(fb), bsz,
                 torch.float32 if dt == np.float32 else torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_schedule_stacked_matches_reference():
    rng = np.random.default_rng(4)
    outs, s1, s2 = [], [], []
    for t in range(3):
        f = 0 if t == 1 else 40 + 7 * t  # an empty shard in the middle
        outs.append(rng.integers(0, 30, f))
        s1.append(rng.integers(0, 20, f))
        s2.append(rng.integers(0, 25, f))
    for g, p in [(None, None), (4, 3), (24, 1)]:
        want = j_schedule(outs, s1, s2, 20, 25, 30, g, p, 8)
        got = t_schedule(outs, s1, s2, 20, 25, 30, g, p, 8)
        for w, x in zip(want, got):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(w))


def test_banded_comm_volume_and_value_update():
    # tests/test_pbsr.py::test_comm_volume_banded_vs_dense and
    # ::test_value_update_and_jit_reuse, on the port
    nb, bsz, half = 64, 4, 1
    rows = np.concatenate([np.arange(max(0, -o), min(nb, nb - o))
                           for o in range(-half, half + 1)])
    cols = np.concatenate([np.arange(max(0, -o), min(nb, nb - o)) + o
                           for o in range(-half, half + 1)])
    order = np.lexsort((cols, rows))
    rng = np.random.default_rng(1)
    _, ta, x = both_bsr(rows[order], cols[order], nb, bsz, np.float64, rng)
    tm = tpar.make_1d_mesh(8, device=CPU)
    pa = tpar.pbsr_from_bsr(ta, tm)
    plan = tpar.build_pbsr_smsmm_plan(pa, pa, tm)
    assert plan.comm_entries_per_device <= 8 * 2 * half * (2 * half + 1) \
        * bsz * bsz
    assert plan.comm_entries_per_device < rows.size * bsz * bsz / 2
    c1 = tpar.pbsr_smsmm(pa, pa, tm, plan)
    pa2 = dataclasses.replace(pa, blocks=pa.blocks * 2.0)
    c2 = tpar.pbsr_smsmm(pa2, pa2, tm, plan)
    np.testing.assert_allclose(c2.blocks.numpy(), 4.0 * c1.blocks.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(bsr_todense(tpar.pbsr_to_bsr(c1)).numpy(),
                               x @ x, rtol=1e-12, atol=1e-12)
    rngd = np.random.default_rng(2)
    rr, cc = np.nonzero(np.ones((16, 16), bool))
    _, td, _ = both_bsr(rr, cc, 16, 4, np.float64, rngd)
    pd = tpar.pbsr_from_bsr(td, tm)
    assert tpar.build_pbsr_smsmm_plan(pd, pd, tm).exch == pd.nbz_per_shard
