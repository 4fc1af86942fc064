"""The zero-chunk skip of K3 and K5 in the PyTorch port: K5's chunk mask
(``BandedKitT.chunk_nz``), the host models of the work K3's and K5's
float32 / bf16 bodies issue, and the two kernels' plain versions against
the reference (``sparse_tpu/ops/pallas_bell.py`` in interpret mode).

Inputs are made with numpy from a seed and handed to both packages.  The
mask is checked against the tiles' magnitude bits read in numpy (so a NaN
counts and -0 does not, as the kernels read them); the counters
themselves run on the card (``tests/test_torch_cuda.py``).  Tolerances,
times ``|A||B|`` per element: float32 1e-5, and for a bf16 stream the
float32 bound on the bf16-rounded inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.formats import bell as jbell
from sparse_tpu.ops import pallas_bell as jpb
from sparse_tpu_torch import interop
from sparse_tpu_torch.ops import cuda_bell as tcb


def _band(nb, bsz, hb, seed, empty=()):
    """(reference BELL, port BELL, slot_valid, dense) of a block band of
    half-width ``hb``: each row stores its band's blocks in column order,
    edge and ``empty`` rows padded with zero blocks at column 0."""
    c = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (c >= 0) & (c < nb)
    ok[list(empty)] = False
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols, ok = np.where(ok, c, 0)[rows, order], ok[rows, order]
    rng = np.random.default_rng(seed)
    blocks = (rng.standard_normal((nb, 2 * hb + 1, bsz, bsz))
              * ok[:, :, None, None]).astype(np.float32)
    cols = cols.astype(np.int32)
    dense = np.zeros((nb * bsz, nb * bsz), np.float32)
    for r, l in zip(*np.nonzero(ok)):
        c0 = cols[r, l] * bsz
        dense[r * bsz:(r + 1) * bsz, c0:c0 + bsz] = blocks[r, l]
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=nb * bsz, bsz=bsz)
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    return ja, ta, ok, dense


def _mask_from_bits(tiles_t):
    """The non-zero map of (ntiles, K, M) float32 tiles' 32 x 32 chunks,
    from their magnitude bits."""
    t = np.asarray(tiles_t, np.float32)
    nz = (t.view(np.uint32) & np.uint32(0x7FFFFFFF)) != 0
    nt, K, M = nz.shape
    pad = np.zeros((nt, -(-K // 32) * 32, -(-M // 32) * 32), bool)
    pad[:, :K, :M] = nz
    return pad.reshape(nt, pad.shape[1] // 32, 32, pad.shape[2] // 32,
                       32).any(axis=(2, 4)).astype(np.uint8)


def _hand_kit_t(ta, ok, rt, max_window):
    """A BandedKitT built by hand from K4's plan (any rt): no mask given."""
    plan = tcb.build_banded_plan(ta, row_tile=rt, max_window=max_window,
                                 slot_valid=ok)
    tiles = tcb._densify_band_tiles(ta, plan, torch.float32)
    return tcb.BandedKitT(plan=plan,
                          tiles_t=tiles.transpose(1, 2).contiguous())


def _assert_close(got, ref, x, b, tol=1e-5):
    bound = tol * (np.abs(x).astype(np.float64) @ np.abs(b).astype(
        np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert err.shape == bound.shape
    assert np.all(err <= bound), (err - bound).max()


# -- the chunk mask -----------------------------------------------------------


@pytest.mark.parametrize("nb,bsz,hb,rt,empty", [
    (400, 32, 2, None, ()),          # the bench band, cut to 400 block rows
    (100, 24, 2, None, (3, 50)),     # rt 16: 384 tile columns; empty rows
    (45, 16, 1, None, (7,)),         # nb % rt != 0 (rt 8)
    (130, 33, 1, 3, (64,)),          # hand-built: 99 columns, nb % rt != 0
])
def test_chunk_mask_is_the_tiles_nonzero_chunks(nb, bsz, hb, rt, empty):
    _, ta, ok, _ = _band(nb, bsz, hb, seed=nb + bsz, empty=empty)
    kit = (_hand_kit_t(ta, ok, rt, 128) if rt
           else tcb.bell_banded_prepare_t(ta, slot_valid=ok))
    nt, K, M = kit.tiles_t.shape
    assert kit.chunk_nz.dtype == torch.uint8
    assert kit.chunk_nz.shape == (nt, -(-K // 32), -(-M // 32))
    want = _mask_from_bits(kit.tiles_t.numpy())
    np.testing.assert_array_equal(kit.chunk_nz.numpy(), want)
    assert 0 < want.sum() < want.size
    # a NaN counts, -0 does not: chunks of an all-zero tile set one by one
    t = torch.zeros_like(kit.tiles_t)
    t[0, K - 1, M - 1] = float("nan")
    t[nt - 1, 0, 0] = -0.0
    t[nt - 1, min(K - 1, 33), min(M - 1, 40)] = 1e-40  # a denormal
    hand = dataclasses.replace(kit, tiles_t=t)
    np.testing.assert_array_equal(hand.chunk_nz.numpy(),
                                  _mask_from_bits(t.numpy()))
    assert int(hand.chunk_nz.sum()) == 2
    assert hand.chunk_nz[0, -1, -1] == 1 and hand.chunk_nz[-1, 0, 0] == 0


def test_kit_from_the_reference_has_the_same_mask():
    ja, ta, ok, _ = _band(120, 24, 2, seed=5, empty=(9,))
    jk = jpb.bell_banded_prepare_t(ja)
    tk = interop.banded_kit_t_from_arrays(jk.plan, jk.tiles_t, device="cpu")
    own = tcb.bell_banded_prepare_t(ta)
    np.testing.assert_array_equal(tk.chunk_nz.numpy(), own.chunk_nz.numpy())
    np.testing.assert_array_equal(tk.chunk_nz.numpy(),
                                  _mask_from_bits(np.asarray(jk.tiles_t)))
    assert not hasattr(jk, "chunk_nz")  # plan data of the port only


def test_hand_built_kit_gets_its_mask_in_post_init():
    _, ta, ok, _ = _band(64, 32, 1, seed=2)
    kit = tcb.bell_banded_prepare_t(ta, slot_valid=ok)
    hand = tcb.BandedKitT(plan=kit.plan, tiles_t=kit.tiles_t.clone())
    assert torch.equal(hand.chunk_nz, kit.chunk_nz)
    assert hand.chunk_nz.device == hand.tiles_t.device
    with pytest.raises(TypeError):
        tcb.BandedKitT(plan=kit.plan, tiles_t=kit.tiles_t,
                       chunk_nz=kit.chunk_nz)
    zero = dataclasses.replace(kit, tiles_t=torch.zeros_like(kit.tiles_t))
    assert int(zero.chunk_nz.sum()) == 0  # replaced tiles, a new mask
    bf = tcb.bell_banded_prepare_t(ta, compute_dtype=torch.bfloat16,
                                   slot_valid=ok)
    assert torch.equal(bf.chunk_nz, kit.chunk_nz)


# -- the host models of the issued work ---------------------------------------


@pytest.mark.parametrize("k,col_blocks", [(1, 1), (128, 1), (200, 2)])
def test_k3_issued_model_counts_by_hand(k, col_blocks):
    """bsz 32, Lb 2: each stored block is one 32-index chunk of its row."""
    blocks = np.zeros((3, 2, 32, 32), np.float32)
    blocks[0, 0] = 1.0                  # row 0: slot 1 is padding
    blocks[1] = 2.0                     # row 1: two chunks
    blocks[2, 0, 5, 5] = -0.0           # row 2: -0 is no data ...
    blocks[2, 1, 31, 0] = np.nan        # ... a NaN is
    a = interop.bell_from_arrays(np.array([[0, 0], [0, 1], [1, 2]]), blocks,
                                 96, 32, device="cpu")
    per_chunk = 2 * 32 * 32 * 128
    assert tcb.fused_issued_model(a, k) == 4 * per_chunk * col_blocks
    assert tcb.fused_issued_model(
        a, k, compute_dtype=torch.bfloat16) == 4 * per_chunk * col_blocks
    # bsz 24, Lb 3: the wide row's 72 indices are chunks 0-31, 32-63 and
    # 64-71; block 1 (indices 24-47) spans the first two, block 2 (48-71)
    # the last two; bsz 64: two 32-row blocks per block row
    b24 = np.zeros((1, 3, 24, 24), np.float32)
    b24[0, 1, 0, 0] = 1.0     # index 24: chunk 0
    b24[0, 1, 23, 23] = 1.0   # index 47: chunk 1
    a24 = interop.bell_from_arrays(np.array([[0, 0, 0]]), b24, 24, 24,
                                   device="cpu")
    assert tcb.fused_issued_model(a24, k) == 2 * per_chunk * col_blocks
    b64 = np.zeros((1, 1, 64, 64), np.float32)
    b64[0, 0, 40, 3] = 1.0    # rows 32-63, indices 0-31
    b64[0, 0, 0, 63] = 1.0    # rows 0-31, indices 32-63
    a64 = interop.bell_from_arrays(np.array([[0]]), b64, 64, 64,
                                   device="cpu")
    assert tcb.fused_issued_model(a64, k) == 2 * per_chunk * col_blocks


@pytest.mark.parametrize("k,row_blocks", [(1, 1), (32, 1), (40, 2)])
def test_k5_issued_model_counts_by_hand(k, row_blocks):
    """Tiles (4, 128, 40): chunks of 32 contraction rows x 32 columns, the
    second column of chunks 8 columns wide.  Every kind reads this model:
    bf16x3 a float32 kit's, each chunk once (its three products split the
    same multiply-adds; the card tests read its counter against it)."""
    _, ta, ok, _ = _band(20, 8, 1, seed=1)
    kit = _hand_kit_t(ta, ok, 5, 64)
    assert tuple(kit.tiles_t.shape) == (4, 128, 40)
    t = torch.zeros_like(kit.tiles_t)
    t[0, 0, 0] = 1.0                 # chunk (0, 0): 32 x 32 inside
    t[0, 127, 39] = 2.0              # chunk (3, 1): 32 x 8 inside
    t[1, 40, 5] = float("nan")       # chunk (1, 0): 32 x 32
    t[1, 2, 35] = -0.0               # not data
    hand = dataclasses.replace(kit, tiles_t=t)
    flops, nbytes = tcb.banded_t_issued_model(hand, k)
    assert flops == 3 * 2 * 32 * 32 * 32 * row_blocks
    assert nbytes == (32 * 32 + 32 * 8 + 32 * 32) * 4 * row_blocks
    half = dataclasses.replace(kit, tiles_t=t.to(torch.bfloat16))
    assert tcb.banded_t_issued_model(half, k) == (flops, nbytes // 2)
    # float64 kits: the same chunks at 8 bytes an element
    double = dataclasses.replace(kit, tiles_t=t.double())
    assert tcb.banded_t_issued_model(double, k) == (flops, nbytes * 2)


def test_counters_need_the_card():
    _, ta, ok, _ = _band(20, 32, 1, seed=3)
    kit = tcb.bell_banded_prepare_t(ta, slot_valid=ok)
    b = torch.ones(ta.n, 32)
    with pytest.raises(ValueError, match="card"):
        tcb.fused_issued_flops(ta, b)
    with pytest.raises(ValueError, match="card"):
        tcb.banded_t_issued(ta, b.T.contiguous(), kit)
    with pytest.raises(ValueError, match="card"):  # float64 counts too
        tcb.fused_issued_flops(ta, b.double())
    with pytest.raises(ValueError, match="tiles_t"):
        tcb.bell_spmm_banded_t(ta, b.T.contiguous(), dataclasses.replace(
            kit, tiles_t=kit.tiles_t[:, :-1]))


@pytest.mark.parametrize("precision,match", [("bf16x3", "card"),
                                             (None, "card"),
                                             ("tf32", "precision"),
                                             ("bf16x6", "precision")])
@pytest.mark.parametrize("entry", ["fused", "banded", "banded_t"])
def test_issued_counters_refuse_cpu_and_unknown_precision(entry, precision,
                                                          match):
    """K3's, K4's and K5's counters take ``precision="bf16x3"`` (the split
    kind); on CPU tensors they raise, as for any precision they do not
    know."""
    _, ta, ok, _ = _band(20, 32, 1, seed=4)
    b = torch.ones(ta.n, 32)
    with pytest.raises(ValueError, match=match):
        if entry == "fused":
            tcb.fused_issued_flops(ta, b, precision=precision)
        elif entry == "banded_t":
            kit = tcb.bell_banded_prepare_t(ta, slot_valid=ok)
            tcb.banded_t_issued(ta, b.T.contiguous(), kit,
                                precision=precision)
        else:
            kit = tcb.bell_banded_prepare(ta, slot_valid=ok)
            tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, ta.bsz,
                                    precision=precision)


# -- the plain versions against the reference ---------------------------------


@pytest.mark.parametrize("nb,bsz,k,padded,compute", [
    (40, 32, 32, False, None),
    (130, 24, 7, True, None),
    (40, 32, 32, True, "bfloat16"),
])
def test_k5_plain_matches_reference(nb, bsz, k, padded, compute):
    ja, ta, _, dense = _band(nb, bsz, 2, seed=nb + k, empty=(nb // 3,))
    jdt = getattr(jnp, compute) if compute else None
    jk = jpb.bell_banded_prepare_t(ja, compute_dtype=jdt)
    tk = interop.banded_kit_t_from_arrays(jk.plan, jk.tiles_t, device="cpu")
    n, n_pad = nb * bsz, jk.plan.offs.shape[0] * bsz
    b = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32)
    bt = b.T.copy()
    if padded:
        bt = np.concatenate([bt, np.zeros((k, n_pad - n), np.float32)], 1)
    if compute:
        bt = np.asarray(jnp.asarray(bt).astype(jnp.bfloat16))
    got = tcb.bell_spmm_banded_t_plain(ta, torch.from_numpy(
        np.asarray(bt, np.float32)).to(tk.tiles_t.dtype), tk)
    ref = jpb.bell_spmm_pallas_banded_t(ja, jnp.asarray(bt), jk,
                                        interpret=True)
    assert got.shape == ref.shape == (k, n_pad if padded else n)
    x = dense
    if compute:
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
        b = np.asarray(jnp.asarray(b).astype(jnp.bfloat16).astype(
            jnp.float32))
    _assert_close(got[:, :n].float().T.numpy(),
                  np.asarray(ref, np.float32)[:, :n].T, x, b)
    _assert_close(got[:, :n].float().T.numpy(), x.astype(np.float64) @ b,
                  x, b)


@pytest.mark.parametrize("nb,bsz,k,compute", [
    (20, 32, 128, None),
    (30, 24, 70, None),
    (20, 32, 33, "bfloat16"),
])
def test_k3_plain_matches_reference(nb, bsz, k, compute):
    """Edge rows and an empty row hold padding slots (zero blocks)."""
    ja, ta, _, dense = _band(nb, bsz, 2, seed=nb * k, empty=(nb // 2,))
    b = np.random.default_rng(k).standard_normal((nb * bsz, k)).astype(
        np.float32)
    got = tcb.bell_spmm_fused_plain(
        ta, torch.from_numpy(b),
        compute_dtype=getattr(torch, compute) if compute else None)
    ref = jpb.bell_spmm_pallas_fused(
        ja, jnp.asarray(b), interpret=True,
        compute_dtype=getattr(jnp, compute) if compute else None)
    x = dense
    if compute:
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
        b = np.asarray(jnp.asarray(b).astype(jnp.bfloat16).astype(
            jnp.float32))
    _assert_close(got.numpy(), np.asarray(ref), x, b)
    _assert_close(got.numpy(), x.astype(np.float64) @ b, x, b)
