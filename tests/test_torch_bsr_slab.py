"""K7 — the block-SpGEMM slab apply — its planners and its gradient in the
PyTorch port against the reference (``sparse_tpu/ops/pallas_bsr.py`` in
interpret mode, ``sparse_tpu/formats/bsr.py``).

Inputs are numpy-seeded and given to both packages.  The planners must give
the reference's tables exactly; the slab apply (its plain version on CPU
tensors) must agree with the Pallas kernel at rtol/atol 2e-5 in float32
(the two sum each block product in different orders), 1e-12 in float64,
and within 2e-2 of the float32 oracle's largest value for bf16 inputs (one
bf16 rounding, as the reference's own test allows).  The kernel itself is
tested on the card by ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.formats import bsr as jbsr
from sparse_tpu.ops import pallas_bsr as jpb
from sparse_tpu.ops.segmented import INDEX_DTYPE
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.ops import cuda_bsr as tcb

TABLES = ("a_idx", "b_idx", "oloc", "slab", "first")
META = ("chunks", "n", "bsz", "g", "p", "nbz_out", "paired")
F32 = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def random_pair(nb, bsz, density, seed, dtype=np.float32):
    """(reference BSR, port BSR) of random stored blocks, as the
    reference's ``tests/test_pallas_bsr.py::random_bsr`` draws them."""
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((nb, nb)) < density)
    blocks = rng.standard_normal((r.size, bsz, bsz)).astype(dtype)
    idx = (r * nb + c).astype(np.int32)
    ja = jbsr.BSR(indices=jnp.asarray(idx, INDEX_DTYPE),
                  blocks=jnp.asarray(blocks), n=nb * bsz, bsz=bsz)
    return ja, interop.bsr_from_arrays(idx, blocks, nb * bsz, bsz,
                                       device="cpu")


def _plans(ja, jb, ta, tb):
    jp, tp = jbsr.bsr_smsmm_prepare(ja, jb), tbsr.bsr_smsmm_prepare(ta, tb)
    for f in ("a_pos", "b_pos", "seg", "indices"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    return jp, tp


def _assert_same_schedule(tp, jp):
    for f in TABLES:
        t, j = _np(getattr(tp, f)), np.asarray(getattr(jp, f))
        assert t.dtype == j.dtype == np.int32, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    for f in META:
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(_np(tp.indices), np.asarray(jp.indices))
    # the port's slab step ranges are the ones `first` marks
    first = _np(tp.first)
    np.testing.assert_array_equal(
        _np(tp.slab_start), np.append(np.flatnonzero(first), first.size))


CASES = [
    (6, 8, 0.4, 4, 4),    # multi-product runs, several slabs
    (10, 8, 0.15, 2, 8),  # sparse: mostly 1-product outputs
    (4, 16, 0.9, 8, 2),   # dense-ish: long runs, multi-step slabs
    (5, 8, 0.3, 16, 16),  # g and p larger than most runs (heavy pad)
]


@pytest.mark.parametrize("nb,bsz,density,g,p", CASES)
def test_schedules_match_reference(nb, bsz, density, g, p):
    ja, ta = random_pair(nb, bsz, density, seed=nb + bsz)
    jb, tb = random_pair(nb, bsz, density, seed=3 * nb)
    jp, tp = _plans(ja, jb, ta, tb)
    for paired in (False, True):
        _assert_same_schedule(
            tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, g=g, p=p,
                                       paired=paired),
            jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, g=g, p=p,
                                         paired=paired))
    tad = tcb.bsr_smsmm_slab_prepare_ad(tp, ta.nbz, tb.nbz, g=g, p=p)
    jad = jpb.bsr_smsmm_pallas_prepare_ad(jp, ja.nbz, jb.nbz, g=g, p=p)
    for f in ("fwd", "da", "db"):
        _assert_same_schedule(getattr(tad, f), getattr(jad, f))


@pytest.mark.parametrize("nb,bsz,density,g,p", CASES)
def test_apply_matches_reference(nb, bsz, density, g, p):
    ja, ta = random_pair(nb, bsz, density, seed=nb + bsz)
    jb, tb = random_pair(nb, bsz, density, seed=3 * nb)
    jp, tp = _plans(ja, jb, ta, tb)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, g=g, p=p)
    ref = jpb.bsr_smsmm_apply_pallas(jpp, ja, jb, interpret=True)
    got = tcb.bsr_smsmm_apply_slab(
        tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, g=g, p=p), ta, tb)
    np.testing.assert_array_equal(_np(got.indices), np.asarray(ref.indices))
    np.testing.assert_allclose(_np(got.blocks), np.asarray(ref.blocks), **F32)
    # the reference's own plan carried across: the apply apart from its
    # planner
    carried = interop.slab_plan_from_arrays(
        jpp.a_idx, jpp.b_idx, jpp.oloc, jpp.slab, jpp.first, jpp.indices,
        chunks=jpp.chunks, n=jpp.n, bsz=jpp.bsz, g=jpp.g, p=jpp.p,
        nbz_out=jpp.nbz_out, nbz_a=ja.nbz, nbz_b=jb.nbz, paired=jpp.paired,
        device="cpu")
    np.testing.assert_allclose(
        _np(tcb.bsr_smsmm_apply_slab(carried, ta, tb).blocks),
        np.asarray(ref.blocks), **F32)
    da, db = _np(tbsr.bsr_todense(ta)), _np(tbsr.bsr_todense(tb))
    np.testing.assert_allclose(_np(tbsr.bsr_todense(got)), da @ db,
                               rtol=2e-4, atol=2e-4)


def test_chunk_boundaries():
    """A lowered prefetch budget in both modules splits the plan into
    several reference chunks; the tables and the sums stay the same."""
    ja, ta = random_pair(24, 8, 0.3, seed=7)
    jp, tp = _plans(ja, ja, ta, ta)
    whole = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=2, p=2)
    budget = (3 * 2 + 2) * 4 * 256  # -> cap = 256 steps
    old = (jpb._SMEM_BUDGET, tcb._SMEM_BUDGET)
    try:
        jpb._SMEM_BUDGET = tcb._SMEM_BUDGET = budget
        jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, ja.nbz, g=2, p=2)
        tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=2, p=2)
    finally:
        jpb._SMEM_BUDGET, tcb._SMEM_BUDGET = old
    assert len(tpp.chunks) > 2 and len(whole.chunks) == 1
    _assert_same_schedule(tpp, jpp)
    got = tcb.bsr_smsmm_apply_slab(tpp, ta, ta)
    # chunking moves no product: the sums are the one-chunk plan's, bitwise
    torch.testing.assert_close(
        got.blocks, tcb.bsr_smsmm_apply_slab(whole, ta, ta).blocks, rtol=0,
        atol=0)
    np.testing.assert_allclose(
        _np(got.blocks), np.asarray(jbsr.bsr_smsmm_apply(jp, ja, ja).blocks),
        **F32)
    # the raw-array call: slab step ranges derived from `first` on the
    # device give the plan's own
    raw = dict(chunks=tpp.chunks, bsz=8, g=2, p=tpp.p, nbz_out=tpp.nbz_out,
               out_dtype=torch.float32)
    z1 = tcb._append_zero(ta.blocks, torch.float32)
    args = (tpp.a_idx, tpp.b_idx, tpp.oloc, tpp.first, tpp.slab, z1, z1)
    torch.testing.assert_close(tcb.run_slabs_arrays(*args, **raw),
                               got.blocks, rtol=0, atol=0)
    nslabs = -(-tpp.nbz_out // tpp.p)
    torch.testing.assert_close(tcb._slab_starts(tpp.first, nslabs),
                               tpp.slab_start, rtol=0, atol=0)


def test_oversized_slab_shrinks_p_or_raises():
    """One stored block row times one stored block column puts every product
    on one output block; under a tiny budget p shrinks until each slab fits
    a step cap, and one output past the cap at p=1 raises in both
    packages."""
    bsz, nb = 8, 40
    rng = np.random.default_rng(0)
    blocks_a = rng.standard_normal((nb, bsz, bsz)).astype(np.float32)
    blocks_b = rng.standard_normal((nb, bsz, bsz)).astype(np.float32)
    ja = jbsr.BSR(indices=jnp.asarray(np.arange(nb), INDEX_DTYPE),
                  blocks=jnp.asarray(blocks_a), n=nb * bsz, bsz=bsz)
    jb = jbsr.BSR(indices=jnp.asarray(np.arange(nb) * nb, INDEX_DTYPE),
                  blocks=jnp.asarray(blocks_b), n=nb * bsz, bsz=bsz)
    ta = interop.bsr_from_arrays(np.arange(nb), blocks_a, nb * bsz, bsz,
                                 device="cpu")
    tb = interop.bsr_from_arrays(np.arange(nb) * nb, blocks_b, nb * bsz, bsz,
                                 device="cpu")
    jp, tp = _plans(ja, jb, ta, tb)
    assert tp.n_products == nb and tp.nbz_out == 1
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, g=2, p=16)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, g=2, p=16)
    _assert_same_schedule(tpp, jpp)
    np.testing.assert_allclose(
        _np(tcb.bsr_smsmm_apply_slab(tpp, ta, tb).blocks),
        np.asarray(jpb.bsr_smsmm_apply_pallas(jpp, ja, jb,
                                              interpret=True).blocks), **F32)
    old = (jpb._SMEM_BUDGET, tcb._SMEM_BUDGET)
    try:
        jpb._SMEM_BUDGET = tcb._SMEM_BUDGET = 1
        # 4 outputs x 200 products in one p=16 slab = 400 steps at g=2 >
        # the 256-step cap: p halves until each slab fits
        args = (np.repeat(np.arange(4, dtype=np.int64), 200),
                np.zeros(800, np.int64), np.zeros(800, np.int64), 1, 1, 4)
        tsched = tcb._schedule(*args, torch.zeros(4, dtype=torch.int32),
                               2, 16, bsz, bsz)
        jsched = jpb._schedule(*args, jnp.zeros(4, jnp.int32), 2, 16, bsz,
                               bsz)
        assert tsched.p < 16
        assert max(c[1] - c[0] for c in tsched.chunks) <= 256
        _assert_same_schedule(tsched, jsched)
        bad = (np.zeros(600, np.int64),) * 3 + (1, 1, 1)
        for mod, idx in ((tcb, torch.zeros(1, dtype=torch.int32)),
                         (jpb, jnp.zeros(1, jnp.int32))):
            with pytest.raises(ValueError, match="use bsr_smsmm_apply"):
                mod._schedule(*bad, idx, 2, 16, bsz, bsz)
    finally:
        jpb._SMEM_BUDGET, tcb._SMEM_BUDGET = old


def test_value_update():
    """Prepare once, apply with fresh values of the same pattern."""
    ja, ta = random_pair(6, 8, 0.5, seed=1)
    jp, tp = _plans(ja, ja, ta, ta)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, ja.nbz, g=4, p=4)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=4, p=4)
    ja2 = dataclasses.replace(ja, blocks=ja.blocks * 2.0 + 1.0)
    ta2 = dataclasses.replace(ta, blocks=ta.blocks * 2.0 + 1.0)
    for jx, tx in ((ja, ta), (ja2, ta2)):
        ref = jpb.bsr_smsmm_apply_pallas(jpp, jx, jx, interpret=True)
        got = tcb.bsr_smsmm_apply_slab(tpp, tx, tx)
        np.testing.assert_allclose(_np(got.blocks), np.asarray(ref.blocks),
                                   **F32)
        np.testing.assert_allclose(
            _np(got.blocks), _np(tbsr.bsr_smsmm_apply(tp, tx, tx).blocks),
            **F32)


def test_empty_product_set():
    """A single stored block at (0, 1) squared meets no partner: no output
    blocks, in both packages."""
    bsz = 8
    ones = np.ones((1, bsz, bsz), np.float32)
    ja = jbsr.BSR(indices=jnp.asarray([1], INDEX_DTYPE),
                  blocks=jnp.asarray(ones), n=2 * bsz, bsz=bsz)
    ta = interop.bsr_from_arrays([1], ones, 2 * bsz, bsz, device="cpu")
    jp, tp = _plans(ja, ja, ta, ta)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=2, p=2)
    _assert_same_schedule(
        tpp, jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, ja.nbz, g=2, p=2))
    got = tcb.bsr_smsmm_apply_slab(tpp, ta, ta)
    assert got.blocks.shape == (0, bsz, bsz) and got.indices.shape == (0,)


def test_bf16_inputs_sum_in_f32():
    """bf16 inputs sum each block product in float32 and round once: the
    result sits within one bf16 rounding of the float32 oracle."""
    ja, _ = random_pair(5, 8, 0.5, seed=4)
    jab = dataclasses.replace(ja, blocks=ja.blocks.astype(jnp.bfloat16))
    exact = np.asarray(jab.blocks.astype(jnp.float32))  # the bf16 values
    tab = interop.bsr_from_arrays(ja.indices, jab.blocks, ja.n, ja.bsz,
                                  device="cpu")
    assert tab.dtype == torch.bfloat16
    ta32 = interop.bsr_from_arrays(ja.indices, exact, ja.n, ja.bsz,
                                   device="cpu")
    jp, tp = _plans(jab, jab, tab, tab)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, jab.nbz, jab.nbz, g=4, p=4)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, tab.nbz, tab.nbz, g=4, p=4)
    got = tcb.bsr_smsmm_apply_slab(tpp, tab, tab)
    assert got.blocks.dtype == torch.bfloat16
    oracle = _np(tbsr.bsr_smsmm_apply(tp, ta32, ta32).blocks)
    ref = np.asarray(jpb.bsr_smsmm_apply_pallas(jpp, jab, jab,
                                                interpret=True).blocks,
                     np.float32)
    scale = np.abs(oracle).max()
    for path in (got, tbsr.bsr_smsmm_apply(tp, tab, tab)):
        assert np.abs(_np(path.blocks) - oracle).max() / scale < 2e-2
        assert np.abs(_np(path.blocks) - ref).max() / scale < 2e-2


@pytest.mark.parametrize("nb,density,seed,parity",
                         [(12, 0.3, 0, 1), (9, 0.5, 1, 0)])
def test_paired_schedule_matches_reference(nb, density, seed, parity):
    """The paired schedule (A read in two-block windows) for an odd and an
    even stored-block count of A (the zero pair must land even-aligned)."""
    bsz = 8
    rng = np.random.default_rng(seed)
    pair = []
    for _ in range(2):
        r, c = np.nonzero(rng.random((nb, nb)) < density)
        blocks = rng.standard_normal((r.size, bsz, bsz)).astype(np.float32)
        idx = (r * nb + c).astype(np.int32)
        pair.append((jbsr.BSR(indices=jnp.asarray(idx, INDEX_DTYPE),
                              blocks=jnp.asarray(blocks), n=nb * bsz,
                              bsz=bsz),
                     interop.bsr_from_arrays(idx, blocks, nb * bsz, bsz,
                                             device="cpu")))
    (ja, ta), (jb, tb) = pair
    assert ta.nbz % 2 == parity
    jp, tp = _plans(ja, jb, ta, tb)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, paired=True)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, paired=True)
    _assert_same_schedule(tpp, jpp)
    assert tpp.paired and tpp.a_idx.shape[0] * 2 == tpp.b_idx.shape[0]
    ref = jpb.bsr_smsmm_apply_pallas(jpp, ja, jb, interpret=True)
    got = tcb.bsr_smsmm_apply_slab(tpp, ta, tb)
    np.testing.assert_allclose(_np(got.blocks), np.asarray(ref.blocks), **F32)
    np.testing.assert_allclose(
        _np(got.blocks), _np(tbsr.bsr_smsmm_apply(tp, ta, tb).blocks), **F32)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("bsz,nb", [(8, 8), (16, 7), (20, 6), (32, 5),
                                    (33, 5), (64, 4)])
def test_float64_apply(bsz, nb, paired):
    """float64 at the block sizes of K7's FMA tile (8) and its DMMA body
    (16-64; 20 and 33 through element copies on the card), unpaired and
    paired schedules, at 1e-12."""
    ja, ta = random_pair(nb, bsz, 0.35, seed=21, dtype=np.float64)
    jb, tb = random_pair(nb, bsz, 0.35, seed=22, dtype=np.float64)
    jp, tp = _plans(ja, jb, ta, tb)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, g=4, p=8,
                                       paired=paired)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, g=4, p=8,
                                     paired=paired)
    _assert_same_schedule(tpp, jpp)
    got = tcb.bsr_smsmm_apply_slab(tpp, ta, tb)
    assert got.blocks.dtype == torch.float64
    ref = jpb.bsr_smsmm_apply_pallas(jpp, ja, jb, interpret=True)
    np.testing.assert_allclose(_np(got.blocks), np.asarray(ref.blocks),
                               rtol=1e-12, atol=1e-12)


def test_grads_match_reference_and_autograd():
    """The autograd Function (slab apply on permuted schedules) against
    ``jax.grad`` through the reference's custom VJP, and against torch
    autograd through the port's ``bsr_smsmm_apply``."""
    ja, ta = random_pair(6, 8, 0.4, seed=2)
    jb, tb = random_pair(6, 8, 0.4, seed=5)
    jp, tp = _plans(ja, jb, ta, tb)
    jplans = jpb.bsr_smsmm_pallas_prepare_ad(jp, ja.nbz, jb.nbz, g=4, p=8)
    tplans = tcb.bsr_smsmm_slab_prepare_ad(tp, ta.nbz, tb.nbz, g=4, p=8)
    w = np.random.default_rng(0).standard_normal(
        (tp.nbz_out, 8, 8)).astype(np.float32)

    def loss_ref(ab, bb):
        c = jpb.bsr_smsmm_apply_pallas_ad(
            jplans, dataclasses.replace(ja, blocks=ab),
            dataclasses.replace(jb, blocks=bb), interpret=True)
        return jnp.sum(c.blocks * jnp.asarray(w))

    vr, (gar, gbr) = jax.value_and_grad(loss_ref, argnums=(0, 1))(ja.blocks,
                                                                  jb.blocks)
    wt = torch.from_numpy(w)
    grads = []
    for apply in (lambda a, b: tcb.bsr_smsmm_apply_slab_ad(tplans, a, b),
                  lambda a, b: tbsr.bsr_smsmm_apply(tp, a, b)):
        ab = ta.blocks.clone().requires_grad_(True)
        bb = tb.blocks.clone().requires_grad_(True)
        c = apply(dataclasses.replace(ta, blocks=ab),
                  dataclasses.replace(tb, blocks=bb))
        loss = torch.sum(c.blocks * wt)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(vr), rtol=1e-5)
        grads.append((ab.grad.numpy(), bb.grad.numpy()))
    for ga, gb in grads:
        np.testing.assert_allclose(ga, np.asarray(gar), **F32)
        np.testing.assert_allclose(gb, np.asarray(gbr), **F32)
    # the reference's AD plans carried across give the same gradients
    carried = interop.slab_plan_ad_from_arrays(jplans.fwd, jplans.da,
                                               jplans.db, device="cpu")
    ab = ta.blocks.clone().requires_grad_(True)
    c = tcb.bsr_smsmm_apply_slab_ad(carried, dataclasses.replace(
        ta, blocks=ab), tb)
    torch.sum(c.blocks * wt).backward()
    np.testing.assert_allclose(ab.grad.numpy(), np.asarray(gar), **F32)


def test_ad_forward_equals_apply():
    ja, ta = random_pair(5, 8, 0.5, seed=11)
    _, tp = _plans(ja, ja, ta, ta)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=4, p=4)
    tplans = tcb.bsr_smsmm_slab_prepare_ad(tp, ta.nbz, ta.nbz, g=4, p=4)
    torch.testing.assert_close(
        tcb.bsr_smsmm_apply_slab_ad(tplans, ta, ta).blocks,
        tcb.bsr_smsmm_apply_slab(tpp, ta, ta).blocks, rtol=0, atol=0)


def test_slab_apply_rejects_what_it_cannot_take():
    ja, ta = random_pair(5, 8, 0.5, seed=3)
    _, tp = _plans(ja, ja, ta, ta)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=4, p=4)
    ti = dataclasses.replace(ta, blocks=ta.blocks.round().to(torch.int64))
    with pytest.raises(ValueError, match="dtype"):
        tcb.bsr_smsmm_apply_slab(tpp, ti, ti)
    with pytest.raises(ValueError, match="precision"):
        tcb.bsr_smsmm_apply_slab(tpp, ta, ta, precision="bf16x3")
    meta = dict(chunks=tpp.chunks, bsz=8, g=4, p=tpp.p, nbz_out=tpp.nbz_out,
                out_dtype=torch.float32)
    z = tcb._append_zero(ta.blocks, torch.float32)
    with pytest.raises(ValueError, match="device"):
        tcb.run_slabs_arrays(tpp.a_idx, tpp.b_idx, tpp.oloc, tpp.first,
                             tpp.slab, z, z.to("meta"), **meta)
