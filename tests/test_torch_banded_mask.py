"""K4's kit route in the PyTorch port: the chunk mask a ``BandedKit``
carries (``BandedKit.chunk_nz``), its builders, and ``bell_spmm(plan=kit)``
against the reference's ``bell_spmm(plan=kit)`` (``sparse_tpu``'s banded
kernel in interpret mode, as its own tests run it on the CPU).

Inputs are made with numpy from a seed and handed to both packages.  The
mask is checked against the tiles' bits read in numpy: magnitude bits for
float32, bf16 and float64 (so a NaN counts and -0 does not, as the
kernels' vote reads them), every bit for int32.  The mask body itself runs
on the card (``tests/test_torch_cuda.py``); on CPU tensors the kit route
runs ``bell_spmm_banded_plain``'s product.  Tolerances, times ``|A||B|``
per element: float32 1e-5, float64 1e-12, a bf16 stream float32's on the
bf16-rounded inputs, bf16x3 1e-4 against float64 (it drops lo*lo).
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.formats import bell as jbell
from sparse_tpu.ops import pallas_bell as jpb
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bell as tbell
from sparse_tpu_torch.ops import cuda_bell as tcb

_UINT = {4: np.uint32, 8: np.uint64, 2: np.uint16}
_MAG = {np.float32: 0x7FFFFFFF, np.float64: 0x7FFFFFFFFFFFFFFF,
        "bfloat16": 0x7FFF, np.int32: 0xFFFFFFFF}


def _band(nb, bsz, hb, seed, empty=(), dtype=np.float32):
    """(dense, reference BELL, port BELL, slot_valid) of a block band of
    half-width ``hb``: rows store their band's blocks in column order, edge
    and ``empty`` rows padded with zero blocks at column 0."""
    c = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (c >= 0) & (c < nb)
    ok[list(empty)] = False
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols, ok = np.where(ok, c, 0)[rows, order], ok[rows, order]
    rng = np.random.default_rng(seed)
    blocks = (rng.standard_normal((nb, 2 * hb + 1, bsz, bsz))
              * ok[:, :, None, None]).astype(dtype)
    cols = cols.astype(np.int32)
    dense = np.zeros((nb * bsz, nb * bsz), dtype)
    for r, l in zip(*np.nonzero(ok)):
        c0 = cols[r, l] * bsz
        dense[r * bsz:(r + 1) * bsz, c0:c0 + bsz] = blocks[r, l]
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=nb * bsz, bsz=bsz)
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    return dense, ja, ta, ok


def _mask_from_bits(tiles):
    """The 32 x 32 chunk map of (ntiles, M, K) tiles from their bits in
    numpy: magnitude bits of a float, every bit of an int32."""
    if tiles.dtype == torch.bfloat16:
        bits, mag = tiles.view(torch.int16).numpy().view(np.uint16), 0x7FFF
    else:
        x = tiles.numpy()
        bits = x.view(_UINT[x.itemsize])
        mag = _MAG[np.int32 if x.dtype == np.int32 else x.dtype.type]
    nz = (bits & bits.dtype.type(mag)) != 0
    nt, m, k = nz.shape
    pad = np.zeros((nt, -(-m // 32) * 32, -(-k // 32) * 32), bool)
    pad[:, :m, :k] = nz
    return pad.reshape(nt, pad.shape[1] // 32, 32, pad.shape[2] // 32,
                       32).any(axis=(2, 4)).astype(np.uint8)


def _assert_close(got, ref, x, b, tol):
    bound = tol * (np.abs(x).astype(np.float64) @ np.abs(b).astype(
        np.float64))
    got = got.float().numpy() if got.dtype == torch.bfloat16 else np.asarray(
        got)
    err = np.abs(got.astype(np.float64) - np.asarray(ref, np.float64))
    assert err.shape == bound.shape
    assert np.all(err <= bound), (err - bound).max()


def _bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# -- the mask -----------------------------------------------------------------


@pytest.mark.parametrize("stream", ["float32", "bfloat16", "float64",
                                    "int32"])
@pytest.mark.parametrize("nb,bsz,hb,rt,empty", [
    (75, 32, 2, 5, ()),          # the bench band's rt and width, cut
    (40, 24, 2, 3, (2,)),        # rt*bsz 72: ragged 32-row blocks
    (45, 16, 1, None, (7,)),     # nb % rt != 0 (rt 8)
    (130, 13, 1, 3, (64,)),      # rt*bsz 39: a row block of 7 rows
])
def test_kit_mask_is_the_tiles_nonzero_chunks(stream, nb, bsz, hb, rt,
                                              empty):
    _, _, ta, ok = _band(nb, bsz, hb, nb + bsz, empty)
    if stream == "int32":
        ta = dataclasses.replace(ta, blocks=(ta.blocks * 2 ** 20).round().to(
            torch.int32))
    cd = None if stream == "int32" else getattr(torch, stream)
    kit = tcb.bell_banded_prepare(ta, row_tile=rt, compute_dtype=cd,
                                  max_window=128, slot_valid=ok)
    nt, m, k = kit.tiles.shape
    assert kit.tiles.dtype == getattr(torch, stream)
    assert kit.chunk_nz.dtype == torch.uint8
    assert kit.chunk_nz.shape == (nt, -(-m // 32), -(-k // 32))
    assert kit.chunk_nz.device == kit.tiles.device
    want = _mask_from_bits(kit.tiles)
    np.testing.assert_array_equal(kit.chunk_nz.numpy(), want)
    assert 0 < want.sum() < want.size
    assert torch.equal(kit.chunk_nz, tcb._nonzero_chunks(
        kit.tiles, 32, 32).to(torch.uint8))
    # chunks of an all-zero kit set one by one: a NaN counts, -0 does not,
    # a denormal does; an int32's lowest and sign bits alone count
    t = torch.zeros_like(kit.tiles)
    if stream == "int32":
        t[0, m - 1, k - 1] = 1
        t[nt - 1, 0, 0] = -2 ** 31
        hits = {(0, -1, -1), (nt - 1, 0, 0)}
    else:
        t[0, m - 1, k - 1] = float("nan")
        t[nt - 1, 0, 0] = -0.0
        t[nt - 1, min(m - 1, 33), min(k - 1, 40)] = (
            1e-40 if stream == "float32" else
            1e-300 if stream == "float64" else 1e-39)
        hits = {(0, -1, -1), (nt - 1, min(m - 1, 33) // 32,
                              min(k - 1, 40) // 32)}
    hand = dataclasses.replace(kit, tiles=t)
    np.testing.assert_array_equal(hand.chunk_nz.numpy(),
                                  _mask_from_bits(t))
    assert int(hand.chunk_nz.sum()) == len(hits)
    for i, r, c in hits:
        assert hand.chunk_nz[i, r, c] == 1


def test_every_builder_carries_the_mask():
    """prepare, refresh, the reference's kit through interop, a hand-built
    kit and dataclasses.replace each build the mask from their own tiles;
    it is no field of the constructor, and kit equality ignores it."""
    _, ja, ta, ok = _band(40, 32, 2, seed=3, empty=(11,))
    kit = tcb.bell_banded_prepare(ta, row_tile=4, slot_valid=ok)
    want = _mask_from_bits(kit.tiles)
    np.testing.assert_array_equal(kit.chunk_nz.numpy(), want)
    jk = jpb.bell_banded_prepare(ja, row_tile=4)
    assert not hasattr(jk, "chunk_nz")  # plan data of the port only
    carried = interop.banded_kit_from_arrays(jk.plan, jk.tiles, device="cpu")
    np.testing.assert_array_equal(carried.chunk_nz.numpy(), want)
    np.testing.assert_array_equal(
        carried.chunk_nz.numpy(), _mask_from_bits(torch.from_numpy(
            np.array(jk.tiles))))
    hand = tcb.BandedKit(plan=kit.plan, tiles=kit.tiles.clone())
    assert torch.equal(hand.chunk_nz, kit.chunk_nz)
    with pytest.raises(TypeError):
        tcb.BandedKit(plan=kit.plan, tiles=kit.tiles,
                      chunk_nz=kit.chunk_nz)
    zero = dataclasses.replace(kit, tiles=torch.zeros_like(kit.tiles))
    assert int(zero.chunk_nz.sum()) == 0
    # equality: same plan and tiles, another mask object (or another mask)
    assert kit == tcb.BandedKit(plan=kit.plan, tiles=kit.tiles)
    stale = tcb.BandedKit(plan=kit.plan, tiles=kit.tiles)
    object.__setattr__(stale, "chunk_nz", torch.zeros_like(kit.chunk_nz))
    assert kit == stale
    assert "chunk_nz" not in repr(kit)
    f = {x.name: x for x in dataclasses.fields(tcb.BandedKit)}["chunk_nz"]
    assert not f.init and not f.compare and not f.repr
    # refresh across a chunk that turns non-zero (block row 20's stored
    # blocks, zero before) and one that turns to zero (row 21's)
    blocks = ta.blocks.clone()
    blocks[20] = 0
    old = tcb.bell_banded_prepare(dataclasses.replace(ta, blocks=blocks),
                                  row_tile=4, slot_valid=ok)
    blocks = ta.blocks.clone()
    blocks[21] = 0
    fresh = tcb.bell_banded_refresh(old, dataclasses.replace(ta,
                                                             blocks=blocks))
    np.testing.assert_array_equal(fresh.chunk_nz.numpy(),
                                  _mask_from_bits(fresh.tiles))
    # rt 4 at bsz 32: block row r is row block r % 4 of tile r // 4
    assert not old.chunk_nz[5, 0].any() and fresh.chunk_nz[5, 0].any()
    assert old.chunk_nz[5, 1].any() and not fresh.chunk_nz[5, 1].any()
    assert torch.equal(old.chunk_nz[:5], fresh.chunk_nz[:5])


def test_a_mask_that_does_not_fit_is_refused():
    """A mask of another shape, dtype or device than the kit's tiles, or
    not contiguous, raises ValueError on the kit route and on the count;
    nothing gives way to another route."""
    _, _, ta, ok = _band(24, 32, 1, seed=5)
    kit = tcb.bell_banded_prepare(ta, row_tile=3, slot_valid=ok)
    b = torch.ones(ta.n, 8)
    m = kit.chunk_nz
    for bad in (m[:, :, :-1].contiguous(), m[:-1].contiguous(),
                m.to(torch.int32), m.bool(), m.to("meta"),
                m.transpose(1, 2).contiguous().transpose(1, 2), None):
        hand = tcb.BandedKit(plan=kit.plan, tiles=kit.tiles)
        object.__setattr__(hand, "chunk_nz", bad)
        with pytest.raises(ValueError, match="chunk mask"):
            tbell.bell_spmm(ta, b, prefer_pallas=True, plan=hand)
        if bad is not None:
            with pytest.raises(ValueError, match="chunk mask"):
                tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, 32,
                                        mask=bad)
    with pytest.raises(ValueError, match="card"):  # a good mask: card only
        tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, 32, mask=m)


def _narrow_plan(ta, ok, W):
    """A one-row-tile plan whose window is ``W`` panels, so the tiles' K =
    W*bsz need not be a multiple of 32 (the planner rounds W to 128 lanes):
    each row's first stored column, its window start clamped into [0, nb -
    W]."""
    cols = ta.cols.numpy().astype(np.int64)
    first = np.where(ok.any(1), cols[:, 0], 0)
    start = np.minimum(first, ta.nb - W)
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32))
    return tcb.BandedPlan(offs=i32(first - start), start=i32(start),
                          rel=i32(np.zeros(ta.nb)), sup=i32(start), W=W,
                          rt=1, S=1, SW=W)


@pytest.mark.parametrize("bsz", [24, 13])
def test_kit_mask_when_k_is_not_a_multiple_of_32(bsz):
    """Hand-built kits of a window of 3 panels: K = 72 (chunks of 32, 32
    and 8 indices) and 39 (32 and 7), M = bsz.  The mask's last column of
    chunks covers the short chunk, and the kit route is the plain
    product."""
    x, _, ta, ok = _band(30, bsz, 1, seed=bsz, empty=(7,))
    plan = _narrow_plan(ta, ok, 3)
    kit = tcb.BandedKit(plan=plan, tiles=tcb._densify_band_tiles(
        ta, plan, torch.float32))
    assert kit.tiles.shape == (30, bsz, 3 * bsz)
    assert kit.chunk_nz.shape == (30, 1, -(-3 * bsz // 32))
    np.testing.assert_array_equal(kit.chunk_nz.numpy(),
                                  _mask_from_bits(kit.tiles))
    assert kit.chunk_nz[:, 0, -1].any() and not kit.chunk_nz[7].any()
    b = np.random.default_rng(1).standard_normal((ta.n, 40)).astype(
        np.float32)
    got = tbell.bell_spmm(ta, torch.from_numpy(b), prefer_pallas=True,
                          plan=kit)
    _assert_close(got, x.astype(np.float64) @ b, x, b, 1e-5)


# -- the kit route against the reference --------------------------------------


def _reference_kit_spmm(ja, b, jk, precision):
    """The reference's ``bell_spmm(plan=kit)``, its banded kernel run in
    interpret mode (as its tests run it off the TPU)."""
    orig = jpb.bell_spmm_pallas_banded
    spy = mock.Mock(side_effect=lambda *a, **kw: orig(*a, interpret=True,
                                                      **kw))
    with mock.patch.object(jpb, "bell_spmm_pallas_banded", spy):
        out = jbell.bell_spmm(ja, jnp.asarray(b), prefer_pallas=True,
                              plan=jk, precision=precision)
    assert spy.called
    return np.asarray(out)


@pytest.mark.parametrize("nb,bsz,hb,rt,k,tier", [
    (40, 8, 2, 4, 128, None),        # super-tiles (S 5)
    (27, 8, 2, 4, 33, None),         # nb % rt != 0
    (30, 32, 2, 5, 64, None),        # the bench's rt and bsz
    (40, 8, 2, 4, 128, "bf16x3"),
    (24, 16, 1, 2, 32, "bfloat16"),
    (20, 24, 1, 3, 16, "float64"),   # rt*bsz 72: ragged row blocks
])
def test_kit_route_matches_the_reference(nb, bsz, hb, rt, k, tier):
    dtype = np.float64 if tier == "float64" else np.float32
    x, ja, ta, ok = _band(nb, bsz, hb, nb * 3 + rt, empty=(nb // 2,),
                          dtype=dtype)
    jdt = jnp.bfloat16 if tier == "bfloat16" else None
    jk = jpb.bell_banded_prepare(ja, row_tile=rt, compute_dtype=jdt)
    prec = "bf16x3" if tier == "bf16x3" else None
    b = np.random.default_rng(rt + k).standard_normal(
        (nb * bsz, k)).astype(dtype)
    ref = _reference_kit_spmm(ja, b, jk, prec)
    tk = tcb.bell_banded_prepare(
        ta, row_tile=rt, slot_valid=ok,
        compute_dtype=torch.bfloat16 if tier == "bfloat16" else None)
    got = tbell.bell_spmm(ta, torch.from_numpy(b), prefer_pallas=True,
                          plan=tk, precision=prec)
    assert got.shape == (nb * bsz, k) and got.dtype == torch.from_numpy(
        b).dtype
    # the kit route on the CPU is the plain version's product, bit for bit
    assert torch.equal(got, tcb.bell_spmm_banded_plain(
        ta, torch.from_numpy(b), tk.plan, tiles=tk.tiles,
        compute_dtype=tk.tiles.dtype, precision=prec))
    # the reference's kit carried over gives the same
    carried = interop.banded_kit_from_arrays(jk.plan, jk.tiles, device="cpu")
    assert torch.equal(carried.chunk_nz, tk.chunk_nz)
    assert torch.equal(got, tbell.bell_spmm(
        ta, torch.from_numpy(b), prefer_pallas=True, plan=carried,
        precision=prec))
    if tier == "bfloat16":
        x, b = _bf16(x), _bf16(b)
    tol = 1e-12 if tier == "float64" else 1e-5
    _assert_close(got, ref, x, b, tol)
    _assert_close(got, x.astype(np.float64) @ b, x, b,
                  1e-4 if tier == "bf16x3" else tol)


def test_kit_route_under_vmap_on_the_cpu():
    """``torch.func.vmap`` over the operand through ``bell_spmm(plan=kit)``
    equals one call a slice, bit for bit."""
    _, _, ta, ok = _band(30, 32, 2, seed=8)
    kit = tcb.bell_banded_prepare(ta, row_tile=5, slot_valid=ok)
    bs = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, ta.n, 40)).astype(np.float32))
    ys = torch.func.vmap(lambda x: tbell.bell_spmm(
        ta, x, prefer_pallas=True, plan=kit))(bs)
    for i in range(3):
        assert torch.equal(ys[i], tbell.bell_spmm(ta, bs[i],
                                                  prefer_pallas=True,
                                                  plan=kit))


# -- the vote grain -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("rt,bsz,k", [(2, 32, 128), (3, 32, 40),
                                      (5, 32, 200), (3, 24, 1)])
def test_issued_model_counts_each_32_row_half(rt, bsz, k, dtype):
    """``banded_issued_model`` on tiles where one 32-row half of every 64
    rows is zero (the first half in even tiles, the second in odd ones; a
    few -0 entries in the zero halves of float tiles): one 32 x 32 x (k
    rounded up to 128) product for each 32 x 32 chunk that a numpy count
    finds non-zero, never one for a 64-row pair.  This is the vote grain
    K4's and K8's bodies count at, whatever rows a thread block takes."""
    rng = np.random.default_rng(rt * bsz + k)
    nt, m, kk = 3, rt * bsz, 12 * 32 + 8
    x = rng.standard_normal((nt, m, kk)) * (rng.random((nt, m, kk)) < 0.02)
    x = x.astype(dtype) if dtype == np.float32 else (x * 50).astype(dtype)
    for t in range(nt):
        for r0 in range(32 * (t % 2), m, 64):
            x[t, r0:r0 + 32] = 0
            if dtype == np.float32:
                x[t, r0:min(r0 + 32, m), ::97] = -0.0
    chunks = _mask_from_bits(torch.from_numpy(x))
    assert chunks.any() and not chunks.all()
    # the zeroed 32-row blocks (-0 included) hold no chunk
    assert not chunks[0, 0::2].any() and not chunks[1, 1::2].any()
    want = int(chunks.sum()) * 2 * 32 * 32 * (-(-k // 128) * 128)
    assert tcb.banded_issued_model(torch.from_numpy(x), k) == want
