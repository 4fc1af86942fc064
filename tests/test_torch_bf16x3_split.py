"""The error model of the bf16x3 split on the band body of K3 and K4, on
K5's chunk-mask body and on K6's persistent body.

On the card, ``precision="bf16x3"`` runs ``csrc/band_body.cuh``'s
``split_chunk``: the contraction in 32-index chunks, and in each 16-index
step of a chunk that is multiplied three bf16 ``mma.sync`` products into
one float32 accumulator: hi*hi, then hi*lo, then lo*hi, each operand split
as ``hi = bf16(x)``, ``lo = bf16(x - hi)``.  K3 and K4 (32 output rows a
thread block) skip a chunk that is zero throughout in their rows of A (the
vote); K5 (``csrc/bell_banded.cu``: C^T = B^T window @ tile, the operand
as A and the tile as B) skips a 32-column slice's chunk of the tile that
the kit's mask marks zero; K6 (``csrc/block_body.cuh``) walks the stored
blocks in slot order, each padded to 32 contraction indices (64 past bsz
32), and skips a block that is zero throughout in a 32-row group of its
rows.  Here that order of summation is emulated in
plain PyTorch (each step's 16 products summed exactly, then rounded into
the float32 accumulator) on small banded shapes and held to the
reference's ``_dot_bf16x3`` (``sparse_tpu/ops/pallas_bell.py``, the JAX
function on the CPU; for K5 also the reference kernel
``bell_spmm_pallas_banded_t`` in interpret mode) and to float64 NumPy
within ``2^-15 + 1e-5`` of ``|A||B|`` per element, the gate the card's
smoke run holds the kernels to; and to the port's plain version within
float32's 1e-5, the card tests' tolerance between kernel and plain
version.  An order that would fail those gates fails here before the card
does.

Operands: N(0, 1) draws; draws scaled by 2^u, u uniform in [-20, 20], in
both A and B; and rows that cancel (pairs of A's columns of opposite sign
against equal rows of B, so each sum is ~2^-10 of |A||B|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.formats import bell as jbell
from sparse_tpu.ops import pallas_bell as jpb
from sparse_tpu_torch import interop
from sparse_tpu_torch.ops import cuda_bell as tcb

BF16X3_TOL = 2.0 ** -15 + 1e-5
F32_TOL = 1e-5
CHUNK, STEP, ROWS = 32, 16, 32  # the chunk, mma step and skip's width


def _split(x):
    """bf16 high part and bf16 residual of float32 ``x``, as float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _ceil(n):
    return -(-n // CHUNK) * CHUNK


def _nonzero(x):
    """Magnitude bits set: NaN counts, -0 does not."""
    return (x != 0) | torch.isnan(x)


def split_order(a, b, kept):
    """C = A @ B (a: (n, M, K), b: (n, K, N), float32) in the bf16x3 bodies'
    order: the 32-index chunks in order, chunk c's products left out of
    output (i, j) where ``kept[:, i // 32, c, j // 32]`` is False, and per
    16-index step hi*hi, hi*lo, lo*hi into one float32 accumulator."""
    n, m, kk = a.shape
    cols = b.shape[2]
    mp, kp, np_ = _ceil(m), _ceil(kk), _ceil(cols)
    a = torch.nn.functional.pad(a, (0, kp - kk, 0, mp - m))
    b = torch.nn.functional.pad(b, (0, np_ - cols, 0, kp - kk))
    ah, al = _split(a)
    bh, bl = _split(b)
    acc = torch.zeros(n, mp, np_)
    for c, k0 in enumerate(range(0, kp, CHUNK)):
        keep = kept[:, :, c].repeat_interleave(ROWS, 1).repeat_interleave(
            ROWS, 2)
        for s0 in range(k0, k0 + CHUNK, STEP):
            ks = slice(s0, s0 + STEP)
            for x, y in ((ah, bh), (ah, bl), (al, bh)):
                part = x[:, :, ks].double() @ y[:, ks].double()
                acc = torch.where(keep, (acc.double() + part).float(), acc)
    return acc[:, :m, :cols]


def band_body_bf16x3(a, b):
    """K3's and K4's order: per 32-row block of each output matrix, a chunk
    that is zero in those rows of A skipped."""
    n, m, kk = a.shape
    ap = torch.nn.functional.pad(a, (0, _ceil(kk) - kk, 0, _ceil(m) - m))
    kept = _nonzero(ap.reshape(n, _ceil(m) // ROWS, ROWS, _ceil(kk) // CHUNK,
                               CHUNK)).any(4).any(2)
    return split_order(a, b, kept[..., None].expand(
        -1, -1, -1, _ceil(b.shape[2]) // ROWS))


def k5_body_bf16x3(win, tiles_t):
    """K5's order (win: (n, k, K) operand windows, tiles_t: (n, K, M)):
    chunk c of a 32-column slice of the tile that is zero throughout
    skipped for that slice's outputs."""
    n, kk, m = tiles_t.shape
    tp = torch.nn.functional.pad(tiles_t, (0, _ceil(m) - m, 0,
                                           _ceil(kk) - kk))
    kept = _nonzero(tp.reshape(n, _ceil(kk) // CHUNK, CHUNK, _ceil(m) // ROWS,
                               ROWS)).any(4).any(2)
    return split_order(win, tiles_t, kept[:, None].expand(
        -1, _ceil(win.shape[1]) // ROWS, -1, -1))


def block_body_bf16x3(a, b, bsz):
    """K6's order (a: (n, bsz, Lb*bsz) block rows [A_r0 | ... | A_r,Lb-1],
    b: (n, Lb*bsz, k) their stacked panels): per stored block, in slot
    order, its columns padded to 32 (64 past bsz 32), so that its 32-index
    chunks are the body's, and the block skipped for the outputs of a
    32-row group where it is zero throughout in those rows."""
    n, m, wide = a.shape
    lb, bk = wide // bsz, 32 if bsz <= 32 else 64
    blocks = a.reshape(n, m, lb, bsz)
    ap = torch.nn.functional.pad(blocks, (0, bk - bsz)).reshape(n, m, lb * bk)
    bp = torch.nn.functional.pad(b.reshape(n, lb, bsz, -1),
                                 (0, 0, 0, bk - bsz)).reshape(n, lb * bk, -1)
    rows = torch.nn.functional.pad(blocks, (0, 0, 0, 0, 0, _ceil(m) - m))
    kept = _nonzero(rows.reshape(n, _ceil(m) // ROWS, ROWS, lb, bsz)).any(
        4).any(2).repeat_interleave(bk // CHUNK, 2)  # (n, groups, chunks)
    return split_order(ap, bp, kept[..., None].expand(
        -1, -1, -1, _ceil(b.shape[2]) // ROWS))


def _operands(nb, bsz, hb, k, values, seed):
    """A band BELL's (cols, blocks, slot_valid) and B (n, k), float32."""
    rng = np.random.default_rng(seed)
    c = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (c >= 0) & (c < nb)
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols, ok = np.where(ok, c, 0)[rows, order], ok[rows, order]
    blocks = rng.standard_normal((nb, 2 * hb + 1, bsz, bsz))
    b = rng.standard_normal((nb * bsz, k))
    if values == "wide":
        blocks *= 2.0 ** rng.uniform(-20, 20, blocks.shape)
        b *= 2.0 ** rng.uniform(-20, 20, b.shape)
    elif values == "cancel":
        eps = 2.0 ** -10 * rng.standard_normal(blocks[..., 0::2].shape)
        blocks[..., 1::2] = -blocks[..., 0::2] * (1 + eps)
        b[1::2] = b[0::2]
    blocks *= ok[:, :, None, None]
    return (cols.astype(np.int32), blocks.astype(np.float32), ok,
            b.astype(np.float32))


def _products(kernel, ta, b, rt, cols, blocks):
    """Each output matrix's (A, B) as the body sees it, with the port's
    plain version of the whole product laid out the same way: K3's and
    K6's block rows (as wide rows) against their stacked panels, K4's
    densified tiles against their operand windows, or K5's operand windows
    (k, W*bsz) against its transposed tiles (then also the reference
    kernel's C^T, per tile)."""
    bt = torch.from_numpy(b)
    if kernel == "K5":
        return _k5_products(ta, b, cols, blocks)
    if kernel in ("K3", "K6"):
        nb, lb, bsz = ta.nb, ta.Lb, ta.bsz
        a = ta.blocks.transpose(1, 2).reshape(nb, bsz, lb * bsz)
        panels = bt.reshape(nb, bsz, -1)[ta.cols.long()].reshape(
            nb, lb * bsz, -1)
        plain = (tcb.bell_spmm_fused_plain if kernel == "K3"
                 else tcb.bell_spmm_block_plain)(ta, bt, precision="bf16x3")
        return a, panels, plain.reshape(nb, bsz, -1)
    plan = tcb.build_banded_plan(ta, row_tile=rt)
    tiles = tcb._densify_band_tiles(ta, plan, torch.float32)
    idx, inside = tcb._window_index(plan, ta.bsz, ta.n)
    win = torch.where(inside[:, :, None], bt[idx], bt.new_zeros(()))
    plain = tcb.bell_spmm_banded_plain(ta, bt, plan, tiles=tiles,
                                       precision="bf16x3")
    m = tiles.shape[1]
    plain = torch.nn.functional.pad(plain, (0, 0, 0, tiles.shape[0] * m
                                            - ta.n))
    return tiles, win, plain.reshape(tiles.shape[0], m, -1)


def _k5_products(ta, b, cols, blocks):
    """K5 on the reference's kit (the port's carried over): per tile, the
    operand window of B^T, the tile, the port's plain version and the
    reference kernel in interpret mode, both as (ntiles, k, rt*bsz)."""
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=ta.n, bsz=ta.bsz)
    jk = jpb.bell_banded_prepare_t(ja)
    kit = interop.banded_kit_t_from_arrays(jk.plan, jk.tiles_t, device="cpu")
    bt = np.ascontiguousarray(b.T)
    idx, inside = tcb._window_index(kit.plan, ta.bsz, ta.n)
    tbt = torch.from_numpy(bt)
    win = torch.where(inside[None], tbt[:, idx], tbt.new_zeros(()))
    nt, _, m = kit.tiles_t.shape

    def per_tile(ct):
        ct = torch.from_numpy(np.array(ct, np.float32))
        ct = torch.nn.functional.pad(ct, (0, nt * m - ct.shape[1]))
        return ct.reshape(ct.shape[0], nt, m).permute(1, 0, 2)

    plain = tcb.bell_spmm_banded_t_plain(ta, tbt, kit, precision="bf16x3")
    ref = jpb.bell_spmm_pallas_banded_t(ja, jnp.asarray(bt), jk,
                                        precision="bf16x3", interpret=True)
    return win.permute(1, 0, 2), kit.tiles_t, per_tile(plain), per_tile(ref)


def _within(got, ref, bound, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.isfinite(np.asarray(got, np.float64)).all()
    assert np.all(err <= tol * bound), float((err - tol * bound).max())


@pytest.mark.parametrize("values", ["normal", "wide", "cancel"])
@pytest.mark.parametrize("kernel,nb,bsz,hb,rt,k", [
    ("K4", 40, 8, 2, 4, 48),     # bsz 8: a chunk spans four panels
    ("K4", 24, 32, 1, 3, 40),    # bsz 32: a chunk is one block
    ("K4", 30, 24, 2, 3, 24),    # bsz 24: chunks straddle blocks
    ("K3", 30, 32, 2, None, 40),  # padding slots: zero chunks
    ("K3", 26, 24, 1, None, 16),
    ("K5", 24, 32, 2, None, 32),  # bsz 32: a slice is one block row
    ("K5", 40, 24, 1, None, 7),   # bsz 24: 384-column tiles, k 7
    ("K6", 30, 32, 2, None, 40),  # a stored block is one chunk
    ("K6", 26, 24, 1, None, 16),  # blocks padded to 32 indices
    ("K6", 12, 64, 1, None, 24),  # two chunks and two row groups a block
])
def test_band_body_order_meets_the_bf16x3_gate(kernel, nb, bsz, hb, rt, k,
                                               values):
    cols, blocks, ok, b = _operands(nb, bsz, hb, k, values,
                                    seed=nb * bsz + k)
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    got_ref = _products(kernel, ta, b, rt, cols, blocks)
    a, bw, plain = got_ref[:3]
    if kernel == "K5":
        got = k5_body_bf16x3(a, bw)
        # zero chunks of the tiles were there to skip
        assert not bool(tcb._nonzero_chunks(bw, CHUNK, ROWS).all())
    elif kernel == "K6":
        got = block_body_bf16x3(a, bw, bsz)
        # padding slots' zero blocks were there to skip
        assert not bool(_nonzero(ta.blocks).flatten(2).any(2).all())
    else:
        got = band_body_bf16x3(a, bw)
        # zero chunks were there to skip
        assert not bool(tcb._nonzero_chunks(a, ROWS, CHUNK).all())
    a64, b64 = a.double().numpy(), bw.double().numpy()
    bound = np.abs(a64) @ np.abs(b64)
    ref = np.stack([np.asarray(jpb._dot_bf16x3(
        jnp.asarray(x), jnp.asarray(y), jnp.float32))
        for x, y in zip(a.numpy(), bw.numpy())])
    _within(got.numpy(), ref, bound, BF16X3_TOL)
    _within(got.numpy(), a64 @ b64, bound, BF16X3_TOL)
    _within(got.numpy(), plain.numpy(), bound, F32_TOL)
    if kernel == "K5":  # the reference kernel, in interpret mode
        _within(got.numpy(), got_ref[3].numpy(), bound, BF16X3_TOL)


@pytest.mark.parametrize("nb,bsz,hb,k", [(30, 32, 2, 40), (12, 64, 1, 200),
                                         (26, 24, 1, 7)])
def test_k6_bf16x3_issued_model_is_float32s(nb, bsz, hb, k):
    """K6's bf16x3 kind counts each kept block once, at the float32 model:
    its three products split the same multiply-adds (the card tests read
    its counter against this model)."""
    cols, blocks, _, _ = _operands(nb, bsz, hb, k, "normal", seed=nb + k)
    blocks[nb // 2] = 0.0   # an empty row: only padding
    blocks[1, 0, :, :] = 0.0
    blocks[1, 0, bsz - 1, 0] = np.nan  # a NaN is data
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    model = tcb.block_issued_model(ta, k)
    assert model == tcb.block_issued_model(ta, k, stream_dtype=torch.float32)
    # by hand: rows x bsz x k for every 32-row group of a stored block
    # that holds data
    groups = -(-bsz // ROWS)
    rows = [min(ROWS, bsz - ROWS * g) for g in range(groups)]
    kept = sum(rows[g] for blk in blocks.reshape(-1, bsz, bsz)
               for g in range(groups)
               if _nonzero(torch.from_numpy(blk[ROWS * g:ROWS * (g + 1)])
                           ).any())
    assert model == 2 * kept * bsz * k


@pytest.mark.parametrize("nb,bsz,hb,rt,k", [(40, 8, 2, 4, 48),
                                            (24, 32, 1, 3, 128),
                                            (30, 24, 2, 3, 200)])
def test_k4_float64_issued_model_is_float32s(nb, bsz, hb, rt, k):
    """K4's and K8's float64 kind runs the same vote body on the same
    chunks: the host model of a float64 kit equals the float32 kit's (and a
    bf16x3 call reads the float32 kit's)."""
    cols, blocks, ok, _ = _operands(nb, bsz, hb, k, "normal", seed=nb * rt)
    t32 = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    t64 = interop.bell_from_arrays(cols, blocks.astype(np.float64),
                                   nb * bsz, bsz, device="cpu")
    k32 = tcb.bell_banded_prepare(t32, row_tile=rt, slot_valid=ok)
    k64 = tcb.bell_banded_prepare(t64, row_tile=rt, slot_valid=ok)
    assert k64.tiles.dtype == torch.float64
    model = tcb.banded_issued_model(k32.tiles, k)
    assert tcb.banded_issued_model(k64.tiles, k) == model
    # by hand: one 32 x 32 x (k rounded up to 128) product per 32 x 32
    # chunk of the tiles that holds data, and some chunks hold none
    nt, m, kk = k64.tiles.shape
    t = np.zeros((nt, _ceil(m), _ceil(kk)), bool)
    t[:, :m, :kk] = k64.tiles.numpy() != 0
    chunks = t.reshape(nt, t.shape[1] // 32, 32, t.shape[2] // 32,
                       32).any(axis=(2, 4))
    assert not chunks.all()
    assert model == int(chunks.sum()) * 2 * 32 * 32 * (-(-k // 128) * 128)
