"""K7's product list in the PyTorch port against the reference's slab
tables (``sparse_tpu/ops/pallas_bsr.py``, its Pallas kernel in interpret
mode), and the K6 / K7 issued-work host models.

K7 walks ``prod_ptr`` / ``prod_ab`` (each output block's first product;
each product's A slot and B slot, in slot order within its output, pads
left out), built once per plan.  Here that list is held against one
derived independently from the reference's ``bsr_smsmm_pallas_prepare``
tables: every slot's global output block (chunk slab + ``slab`` of its
step, times p, plus its row), its A slot (a paired window resolved by the
row bit) and B slot, the pads (slots reading past the stored blocks)
dropped, the slot order kept.  The raw-array route derives the list on the
device with the pads kept.  The list walk's plain version must agree with
the reference's kernel at rtol/atol 2e-5 in float32 (the two sum in
different orders).  Inputs are numpy-seeded and given to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.formats import bsr as jbsr
from sparse_tpu.ops import pallas_bsr as jpb
from sparse_tpu.ops.segmented import INDEX_DTYPE
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.formats.bell import BELL
from sparse_tpu_torch.ops import cuda_bell as tbl
from sparse_tpu_torch.ops import cuda_bsr as tcb

F32 = dict(rtol=2e-5, atol=2e-5)


def _pair(nb, bsz, density, seed, parity=None):
    """(reference BSR, port BSR) of random stored blocks; ``parity`` makes
    the stored-block count odd (1) or even (0)."""
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((nb, nb)) < density)
    if parity is not None and r.size % 2 != parity:
        r, c = r[:-1], c[:-1]
    blocks = rng.standard_normal((r.size, bsz, bsz)).astype(np.float32)
    idx = (r * nb + c).astype(np.int32)
    ja = jbsr.BSR(indices=jnp.asarray(idx, INDEX_DTYPE),
                  blocks=jnp.asarray(blocks), n=nb * bsz, bsz=bsz)
    return ja, interop.bsr_from_arrays(idx, blocks, nb * bsz, bsz,
                                       device="cpu")


def _ref_slots(jp):
    """Per slot of a reference plan: (global output, A slot, B slot)."""
    a_idx, b_idx = np.asarray(jp.a_idx, np.int64), np.asarray(jp.b_idx,
                                                              np.int64)
    oloc, slab = np.asarray(jp.oloc, np.int64), np.asarray(jp.slab, np.int64)
    sl0 = np.repeat([c[2] for c in jp.chunks],
                    [c[1] - c[0] for c in jp.chunks]).astype(np.int64)
    step_slab = np.repeat(sl0 + slab, jp.g)
    if jp.paired:
        out = step_slab * jp.p + (oloc >> 1)
        a = 2 * np.repeat(a_idx, 2) + (oloc & 1)
    else:
        out, a = step_slab * jp.p + oloc, a_idx
    return out, a, b_idx


def _ref_list(jp, caps=None):
    """The reference plan's product list, independently: stable sort of its
    slots by output, pads (slots reading past ``caps``) dropped if given."""
    out, a, b = _ref_slots(jp)
    if caps is not None:
        keep = (a < caps[0]) & (b < caps[1])
        out, a, b = out[keep], a[keep], b[keep]
    order = np.argsort(out, kind="stable")
    ptr = np.zeros(jp.nbz_out + 1, np.int64)
    np.cumsum(np.bincount(out, minlength=jp.nbz_out), out=ptr[1:])
    return ptr, np.stack([a[order], b[order]], 1)


def _assert_list(tp, ref):
    ptr, ab = ref
    assert tp.prod_ptr.dtype == tp.prod_ab.dtype == torch.int32
    np.testing.assert_array_equal(tp.prod_ptr.numpy(), ptr)
    np.testing.assert_array_equal(tp.prod_ab.numpy().reshape(-1, 2), ab)


CASES = [
    (6, 8, 0.4, 4, 4),
    (10, 8, 0.15, 2, 8),
    (4, 16, 0.9, 8, 2),
    (5, 8, 0.3, 16, 16),
]


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("nb,bsz,density,g,p", CASES)
def test_lists_match_reference_tables(nb, bsz, density, g, p, paired):
    """The fwd, da and db lists (and a paired forward plan, with an odd A
    count) against the list read off the reference's tables."""
    ja, ta = _pair(nb, bsz, density, nb + bsz, 1 if paired else None)
    jb, tb = _pair(nb, bsz, density, 3 * nb)
    jp, tp = jbsr.bsr_smsmm_prepare(ja, jb), tbsr.bsr_smsmm_prepare(ta, tb)
    nbz_out = tp.nbz_out
    if paired:
        tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, g=g, p=p,
                                         paired=True)
        jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, g=g, p=p,
                                           paired=True)
        assert ta.nbz % 2 == 1
        _assert_list(tpp, _ref_list(jpp, (ta.nbz, tb.nbz)))
        assert int(tpp.prod_ptr[-1]) == tp.n_products
        return
    tad = tcb.bsr_smsmm_slab_prepare_ad(tp, ta.nbz, tb.nbz, g=g, p=p)
    jad = jpb.bsr_smsmm_pallas_prepare_ad(jp, ja.nbz, jb.nbz, g=g, p=p)
    caps = {"fwd": (ta.nbz, tb.nbz), "da": (nbz_out, tb.nbz),
            "db": (ta.nbz, nbz_out)}
    # the reference's plans carried in derive the same lists, their stored
    # counts read off each other's output counts
    carried = interop.slab_plan_ad_from_arrays(jad.fwd, jad.da, jad.db,
                                               device="cpu")
    for f, cap in caps.items():
        _assert_list(getattr(tad, f), _ref_list(getattr(jad, f), cap))
        _assert_list(getattr(carried, f), _ref_list(getattr(jad, f), cap))
        assert int(getattr(tad, f).prod_ptr[-1]) == tp.n_products


def test_outputs_with_none_and_many_products():
    """One stored block row times one stored block column: every product
    lands on output 0 (40 of them); dA's list then has A blocks with no
    product at all when B's column is cut short."""
    bsz, nb = 8, 40
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((nb, bsz, bsz)).astype(np.float32)
    ta = interop.bsr_from_arrays(np.arange(nb), blocks, nb * bsz, bsz,
                                 device="cpu")
    tb = interop.bsr_from_arrays(np.arange(nb // 2) * nb, blocks[:nb // 2],
                                 nb * bsz, bsz, device="cpu")
    ja = jbsr.BSR(indices=jnp.asarray(np.arange(nb), INDEX_DTYPE),
                  blocks=jnp.asarray(blocks), n=nb * bsz, bsz=bsz)
    jb = jbsr.BSR(indices=jnp.asarray(np.arange(nb // 2) * nb, INDEX_DTYPE),
                  blocks=jnp.asarray(blocks[:nb // 2]), n=nb * bsz, bsz=bsz)
    tp, jp = tbsr.bsr_smsmm_prepare(ta, tb), jbsr.bsr_smsmm_prepare(ja, jb)
    tad = tcb.bsr_smsmm_slab_prepare_ad(tp, ta.nbz, tb.nbz, g=2, p=4)
    jad = jpb.bsr_smsmm_pallas_prepare_ad(jp, ja.nbz, jb.nbz, g=2, p=4)
    assert tp.nbz_out == 1 and tp.n_products == nb // 2
    np.testing.assert_array_equal(tad.fwd.prod_ptr.numpy(), [0, nb // 2])
    counts = np.diff(tad.da.prod_ptr.numpy())
    assert counts.max() == 1 and (counts == 0).sum() == nb - nb // 2
    _assert_list(tad.da, _ref_list(jad.da, (1, tb.nbz)))
    # many products per output in the reference's slot order
    _assert_list(tad.fwd, _ref_list(jad.fwd, (ta.nbz, tb.nbz)))
    # the plain list walk: no product is zero, the rest the reference's
    ct = torch.from_numpy(rng.standard_normal((1, bsz, bsz)).astype(
        np.float32))
    da = tcb.slab_list_plain(tad.da.prod_ptr, tad.da.prod_ab, ct,
                             tb.blocks.transpose(1, 2),
                             out_dtype=torch.float32)
    assert not da[counts == 0].any()
    np.testing.assert_allclose(da[:nb // 2].numpy(), (
        ct.numpy() @ blocks[:nb // 2].transpose(0, 2, 1)), **F32)


def test_empty_product_set_and_chunked_plan():
    ones = np.ones((1, 8, 8), np.float32)
    te = interop.bsr_from_arrays([1], ones, 16, 8, device="cpu")
    pe = tcb.bsr_smsmm_slab_prepare(tbsr.bsr_smsmm_prepare(te, te), 1, 1)
    assert pe.prod_ptr.shape == (1,) and pe.prod_ab.shape == (0, 2)
    assert tcb.bsr_slab_issued_model(pe.prod_ptr) == 0
    # several reference chunks: the list does not see them
    ja, ta = _pair(24, 8, 0.3, 7)
    jp, tp = jbsr.bsr_smsmm_prepare(ja, ja), tbsr.bsr_smsmm_prepare(ta, ta)
    whole = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=2, p=2)
    old = (jpb._SMEM_BUDGET, tcb._SMEM_BUDGET)
    try:
        jpb._SMEM_BUDGET = tcb._SMEM_BUDGET = (3 * 2 + 2) * 4 * 256
        jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, ja.nbz, g=2, p=2)
        tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=2, p=2)
    finally:
        jpb._SMEM_BUDGET, tcb._SMEM_BUDGET = old
    assert len(tpp.chunks) > 2
    _assert_list(tpp, _ref_list(jpp, (ta.nbz, ta.nbz)))
    torch.testing.assert_close(tpp.prod_ab, whole.prod_ab, rtol=0, atol=0)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("nb,bsz,density,g,p", CASES[:2])
def test_slot_list_of_the_raw_route(nb, bsz, density, g, p, paired):
    """``slot_list`` (the raw-array route's list, built on the tensors'
    device) keeps the pads; with the stored capacities it is the plan's."""
    ja, ta = _pair(nb, bsz, density, nb + bsz, 0 if paired else None)
    jb, tb = _pair(nb, bsz, density, 3 * nb)
    jp, tp = jbsr.bsr_smsmm_prepare(ja, jb), tbsr.bsr_smsmm_prepare(ta, tb)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, g=g, p=p,
                                       paired=paired)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, g=g, p=p,
                                     paired=paired)
    kw = dict(g=g, p=p, nbz_out=tpp.nbz_out, paired=paired)
    args = (tpp.a_idx, tpp.b_idx, tpp.oloc, tpp.slab_start)
    ptr, ab = tcb.slot_list(*args, **kw)
    ref_ptr, ref_ab = _ref_list(jpp)
    np.testing.assert_array_equal(ptr.numpy(), ref_ptr)
    np.testing.assert_array_equal(ab.numpy(), ref_ab)
    assert int(ptr[-1]) == tpp.b_idx.shape[0] > tp.n_products  # pads kept
    ptr, ab = tcb.slot_list(*args, **kw, caps=(ta.nbz, tb.nbz))
    torch.testing.assert_close(ptr, tpp.prod_ptr, rtol=0, atol=0)
    torch.testing.assert_close(ab, tpp.prod_ab, rtol=0, atol=0)
    # a plan carried in from the reference's tables derives the same list
    # once, pads dropped
    carried = interop.slab_plan_from_arrays(
        jpp.a_idx, jpp.b_idx, jpp.oloc, jpp.slab, jpp.first, jpp.indices,
        chunks=jpp.chunks, n=jpp.n, bsz=jpp.bsz, g=jpp.g, p=jpp.p,
        nbz_out=jpp.nbz_out, nbz_a=ja.nbz, nbz_b=jb.nbz, paired=jpp.paired,
        device="cpu")
    torch.testing.assert_close(carried.prod_ptr, tpp.prod_ptr, rtol=0,
                               atol=0)
    torch.testing.assert_close(carried.prod_ab, tpp.prod_ab, rtol=0, atol=0)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("nb,bsz,density,g,p", CASES)
def test_plain_list_walk_matches_reference(nb, bsz, density, g, p, paired):
    """The list walk's plain version on the plan's list against the
    reference's Pallas kernel (interpret mode) on its own tables."""
    ja, ta = _pair(nb, bsz, density, nb + bsz, 1 if paired else None)
    jb, tb = _pair(nb, bsz, density, 3 * nb)
    jp, tp = jbsr.bsr_smsmm_prepare(ja, jb), tbsr.bsr_smsmm_prepare(ta, tb)
    jpp = jpb.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, g=g, p=p,
                                       paired=paired)
    tpp = tcb.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, g=g, p=p,
                                     paired=paired)
    ref = jpb.bsr_smsmm_apply_pallas(jpp, ja, jb, interpret=True)
    got = tcb.slab_list_plain(tpp.prod_ptr, tpp.prod_ab, ta.blocks, tb.blocks,
                              out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.blocks), **F32)
    # the slot-table plain version (the CPU apply) agrees with it
    np.testing.assert_allclose(
        tcb.bsr_smsmm_apply_slab(tpp, ta, tb).blocks.numpy(), got.numpy(),
        **F32)


def test_plain_list_walk_float64_and_bf16():
    for dt, tol in ((torch.float64, 1e-12), (torch.bfloat16, 2e-2)):
        ja, ta = _pair(7, 16, 0.35, 21)
        _, tb = _pair(7, 16, 0.35, 22)
        tpp = tcb.bsr_smsmm_slab_prepare(tbsr.bsr_smsmm_prepare(ta, tb),
                                         ta.nbz, tb.nbz, g=4, p=8)
        x, y = ta.blocks.to(dt), tb.blocks.to(dt)
        got = tcb.slab_list_plain(tpp.prod_ptr, tpp.prod_ab, x, y,
                                  out_dtype=dt)
        assert got.dtype == dt
        exact = tcb.slab_list_plain(tpp.prod_ptr, tpp.prod_ab, x.double(),
                                    y.double(), out_dtype=torch.float64)
        scale = float(exact.abs().max())
        assert float((got.double() - exact).abs().max()) <= tol * scale


def test_k7_issued_model_by_hand():
    """Two stored blocks of A on the diagonal, B full 2 x 2: each output
    block (0, j) and (1, j) has one product, 4 in all."""
    bsz = 4
    a = interop.bsr_from_arrays([0, 3], np.ones((2, bsz, bsz), np.float32),
                                2 * bsz, bsz, device="cpu")
    b = interop.bsr_from_arrays([0, 1, 2, 3], np.ones((4, bsz, bsz),
                                                      np.float32),
                                2 * bsz, bsz, device="cpu")
    pp = tcb.bsr_smsmm_slab_prepare(tbsr.bsr_smsmm_prepare(a, b), 2, 4, g=3,
                                    p=2)
    assert tcb.bsr_slab_issued_model(pp.prod_ptr) == 4
    np.testing.assert_array_equal(pp.prod_ptr.numpy(), [0, 1, 2, 3, 4])
    # the slot walk multiplied every slot, pads included
    assert pp.b_idx.shape[0] == 6


def _bell(cols, blocks):
    nb, _, bsz, _ = blocks.shape
    return BELL(cols=torch.tensor(cols, dtype=torch.int32),
                blocks=torch.from_numpy(blocks), n=nb * bsz, bsz=bsz)


@pytest.mark.parametrize("bsz", [3, 32, 40])
def test_k6_issued_model_by_hand(bsz):
    """Three block rows of two slots: four non-zero stored blocks, one
    padding slot (zero), one block holding only -0 and, at bsz 40, one
    whose only non-zero (a NaN) sits in the second 32-row group."""
    blocks = np.zeros((3, 2, bsz, bsz), np.float32)
    blocks[0, 0, 0, 0] = 1.0
    blocks[0, 1] = 2.0
    blocks[1, 0, bsz - 1, 1] = np.nan
    blocks[1, 1] = -0.0
    blocks[2, 0, 1, bsz - 1] = 3.0
    a = _bell([[0, 1], [1, 0], [2, 0]], blocks)
    k = 70
    rows_last = bsz - 32 if bsz > 32 else bsz  # the NaN's row group
    full = 3 * bsz * bsz * k  # blocks (0,0), (0,1), (2,0)
    if bsz > 32:  # (0,1) is non-zero in both groups, (0,0), (2,0) in one
        full = (bsz + 32 + 32) * bsz * k
    want = 2 * (full + rows_last * bsz * k)
    assert tbl.block_issued_model(a, k) == want
    assert tbl.block_issued_model(a, k, stream_dtype=torch.bfloat16) == want


@pytest.mark.parametrize("stream", [torch.float32, torch.float64])
def test_k6_issued_model_past_bsz64_is_the_band_bodys(stream):
    """Past bsz 64 K6's float32 stream at k 70 (280 bytes an operand row,
    not a whole number of 16-byte units, so no TMA map describes it) runs
    K3's band body on the wide row, as it did before float32 took the
    wide-block body at other shapes, so its model is K3's: one 32 x 32 x
    128 product for each 32 x 32 chunk of a block row's wide row [A_r0 |
    A_r1] (rows 32, 32 and 16 at bsz 80; columns 0-31, 32-63, 64-95
    (straddling the two blocks), 96-127, 128-159) that holds a non-zero
    (NaN does, -0 does not).  Its
    float64 stream at k 70 (560 bytes a row, a multiple of 16) runs the
    wide-block body instead: useful rows x useful indices x k for each
    64-row group and 32-index slice of a stored block that holds a
    non-zero (rows 64 and 16, indices 32, 32 and 16 at bsz 80)."""
    bsz, k = 80, 70
    blocks = np.zeros((3, 2, bsz, bsz), np.float32)
    blocks[0, 0, 0, 0] = 1.0    # chunk (0, 0)
    blocks[0, 1] = 2.0          # 3 row chunks x column chunks 2, 3, 4
    blocks[1, 0, bsz - 1, 1] = np.nan  # chunk (2, 0)
    blocks[1, 1] = -0.0
    blocks[2, 0, 1, bsz - 1] = 3.0     # chunk (0, 2)
    a = _bell([[0, 1], [1, 0], [2, 0]], blocks)
    band = 12 * 2 * 32 * 32 * 128
    assert tbl.fused_issued_model(a, k) == band
    if stream == torch.float32:
        assert tbl._k6_body(bsz, k, stream) == "band"
        assert tbl.block_issued_model(a, k) == band
        assert tbl.block_issued_model(a, k, stream_dtype=stream) == band
        return
    assert tbl._k6_body(bsz, k, stream) == "wide"
    # (0, 0): group 0 x slice 0; (0, 1): whole; (1, 0): group 1 x slice 0;
    # (2, 0): group 0 x slice 2
    want = 2 * (64 * 32 + bsz * bsz + 16 * 32 + 64 * 16) * k
    assert tbl.block_issued_model(a, k, stream_dtype=stream) == want


def test_k6_issued_counter_refuses_cpu_and_float64():
    blocks = np.ones((2, 1, 4, 4), np.float32)
    a = _bell([[0], [1]], blocks)
    with pytest.raises(ValueError, match="card"):
        tbl.block_issued_flops(a, torch.ones(8, 3))
    # float64 counts too (on the card), and so does every bsz
    a64 = _bell([[0], [1]], blocks.astype(np.float64))
    with pytest.raises(ValueError, match="card"):
        tbl.block_issued_flops(a64, torch.ones(8, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="card"):
        tcb.bsr_slab_issued(torch.zeros(2, dtype=torch.int32),
                            torch.zeros(0, 2, dtype=torch.int32),
                            torch.ones(1, 4, 4), torch.ones(1, 4, 4),
                            out_dtype=torch.float32)
