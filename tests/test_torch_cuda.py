"""The port's hand-written CUDA kernels and its main path on a card.

Every test here needs a CUDA device and ``nvcc`` (the kernels have no CPU
mode) and skips without one.  The file imports neither jax nor the
reference package, so it also runs where only PyTorch is installed:

    python -m pytest -c /dev/null --rootdir . --noconftest \
        -p no:cacheprovider tests/test_torch_cuda.py

The oracle is each kernel's plain PyTorch version on the same tensors, and
SciPy in float64.  Tolerances: float32 1e-5 and float64 1e-12, times
``|A||v|`` per row (``|A||B|`` per element for SpMM; the kernel and the plain
version sum in different orders), with a bf16 stream's bound taken on the
bf16-rounded inputs.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu_torch as pt
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.formats.bell import BELL
from sparse_tpu_torch.ops import cuda_bell as tcb
from sparse_tpu_torch.ops import cuda_bsr as tbs
from sparse_tpu_torch.ops import cuda_csr as tpc
from sparse_tpu_torch.ops import cuda_csr_block as tpb

pytestmark = pytest.mark.cuda
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, ref, s, v, dtype):
    bound = TOL[dtype] * (abs(s) @ np.abs(np.asarray(v, np.float64)))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= bound), (err - bound).max()


def _band(n, nnz, seed, half):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = np.clip(r + rng.integers(-half, half + 1, nnz), 0, n - 1)
    s = sp.coo_matrix((rng.standard_normal(nnz), (r, c)), shape=(n, n))
    s = s.tocsr()
    s.sum_duplicates()
    return s


def _blocks(nb, seed, bw):
    rng = np.random.default_rng(seed)
    mask = np.zeros((nb, nb), bool)
    for i in range(nb):
        mask[i, np.clip(i + rng.integers(-bw, bw + 1, 4), 0, nb - 1)] = True
    full = sp.kron(sp.csr_matrix(mask), np.ones((2, 2))).tocsr()
    full.data = rng.standard_normal(full.nnz) + 3.0
    return full


def _csr(s, dtype, device):
    return interop.csr_from_arrays(s.data.astype(dtype), s.indices, s.indptr,
                                   s.shape, device=device)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("wsub", [8, 16, 32])
def test_k1_matches_plain(cuda, wsub, dtype):
    """K1 over the plan's compact stream against its plain version and
    SciPy, bitwise repeatable; the raw-array route (slots compacted per
    call) gives the plan route's result bit for bit."""
    s = _band(3000, 40000, 11, 2500)
    a = _csr(s, dtype, cuda)
    plan = tpc.build_seg_tiles(a, wsub=wsub)
    assert plan.stream.nnz == s.nnz and plan.stream.vals.is_cuda
    v = np.random.default_rng(12).standard_normal(3000).astype(dtype)
    vt = torch.from_numpy(v).to(cuda)
    before = tpc.K1_LAUNCHES
    y1 = tpc.csr_smvm_segtile(a, vt, plan)
    y2 = tpc.csr_smvm_segtile(a, vt, plan)
    torch.cuda.synchronize()
    assert tpc.K1_LAUNCHES == before + 2
    assert torch.equal(y1, y2)  # bitwise repeatable
    plain = tpc.segtile_stream_plain(plan.stream, vt)
    _assert_close(_np(y1), _np(plain), s, v, dtype)
    _assert_close(_np(y1), s @ v.astype(np.float64), s, v, dtype)
    raw = dict(n=3000, wsub=wsub, rows=8, kstep=plan.kstep,
               chunks=plan.chunks)
    arrs = (plan.vals, plan.q, plan.seg_of, plan.rb)
    assert torch.equal(tpc.segtile_apply(*arrs, vt, **raw)[:3000], y1)
    p = torch.randperm(plan.n_tiles, device=cuda)
    y3 = tpc.segtile_apply(*(x[p] for x in arrs), vt, **raw)
    _assert_close(_np(y3)[:3000], _np(plain), s, v, dtype)


def test_k1_rejects_what_it_cannot_take(cuda):
    s = _band(64, 300, 13, 64)
    a = _csr(s, np.float32, cuda)
    plan = tpc.build_seg_tiles(a)
    raw = dict(n=64, wsub=8, rows=8, kstep=plan.kstep, chunks=plan.chunks)
    v = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        tpc.segtile_apply(plan.vals, plan.q.to(torch.int32), plan.seg_of,
                          plan.rb, v, **raw)
    with pytest.raises(TypeError):
        tpc.segtile_apply(plan.vals.half(), plan.q, plan.seg_of, plan.rb,
                          v.half(), **raw)
    with pytest.raises(TypeError):
        tpc.segtile_stream_apply(dataclasses.replace(
            plan.stream, vals=plan.stream.vals.half()), v.half())
    with pytest.raises(ValueError):
        tpc.segtile_apply(plan.vals, plan.q, plan.seg_of, plan.rb, v.cpu(),
                          **raw)
    with pytest.raises(ValueError, match="device"):
        tpc.segtile_stream_apply(plan.stream, v.cpu())
    with pytest.raises(ValueError):
        tpc.segtile_apply(plan.vals[:, :4], plan.q, plan.seg_of, plan.rb, v,
                          **raw)


@pytest.mark.parametrize("reduce", ["vpu", "mxu"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_long_rows_and_empty_matrix(cuda, dtype, reduce):
    """A 20,000-entry row and rows just past the long threshold go through
    the pieces and their ordered sum; an empty matrix and a matrix with no
    stored entry give exact zeros; all bitwise repeatable."""
    rng = np.random.default_rng(31)
    n, m = 600, 30000
    base = sp.random(n, m, density=0.0005, random_state=3, format="coo")
    rows = np.r_[base.row, np.full(20000, 7), np.full(700, 100),
                 np.full(2100, 599)]
    cols = np.r_[base.col, rng.choice(m, 20000, replace=False),
                 rng.choice(m, 700, replace=False),
                 rng.choice(m, 2100, replace=False)]
    s = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, m)).tocsr()
    s.sum_duplicates()
    a = _csr(s, dtype, cuda)
    plan = tpc.build_seg_tiles(a, wsub=32)
    assert plan.stream.n_long >= 3 and plan.stream.n_pieces > 40
    v = rng.standard_normal(m).astype(dtype)
    vt = torch.from_numpy(v).to(cuda)
    y1 = tpc.csr_smvm_segtile(a, vt, plan, reduce=reduce)
    y2 = tpc.csr_smvm_segtile(a, vt, plan, reduce=reduce)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    _assert_close(_np(y1), _np(tpc.segtile_stream_plain(plan.stream, vt)), s,
                  v, dtype)
    _assert_close(_np(y1), s @ v.astype(np.float64), s, v, dtype)
    for shape in ((0, 5), (40, 7)):
        e = _csr(sp.csr_matrix(shape), dtype, cuda)
        ep = tpc.build_seg_tiles(e)
        got = tpc.csr_smvm_segtile(e, torch.ones(shape[1], device=cuda,
                                                 dtype=e.dtype), ep,
                                   reduce=reduce)
        assert got.shape == (shape[0],) and bool((got == 0).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_matches_plain(cuda, dtype):
    """K2 over the block plan's compact stream against its plain version and
    SciPy, bitwise repeatable, a misaligned operand included; a block row
    of 600 blocks goes through the pieces."""
    s = _blocks(2000, 11, 900).tolil()
    s[10:12, :1200] = 1.25  # block row 5: 600 blocks
    s = s.tocsr().astype(dtype)
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device=cuda)
    ab = tbsr.csr_to_bsr(a, 2)
    plan = tpb.build_seg_tiles_block(ab, wsub=16)
    assert plan.stream.n_long >= 1 and plan.stream.vals.shape[1] == 4
    v = np.random.default_rng(12).standard_normal(4000).astype(dtype)
    vt = torch.from_numpy(v).to(cuda)
    before = tpb.K2_LAUNCHES
    y1 = tpb.bsr_smvm_segtile_block(ab, vt, plan)
    y2 = tpb.bsr_smvm_segtile_block(ab, vt, plan)
    torch.cuda.synchronize()
    assert tpb.K2_LAUNCHES == before + 2
    assert torch.equal(y1, y2)
    plain = tpb.block_stream_plain(plan.stream, vt)
    _assert_close(_np(y1), _np(plain), s, v, dtype)
    _assert_close(_np(y1), s.astype(np.float64) @ v.astype(np.float64), s,
                  v, dtype)
    odd = torch.cat([vt.new_zeros(1), vt])[1:]  # one element off alignment
    assert torch.equal(tpb.bsr_smvm_segtile_block(ab, odd, plan), y1)


def test_readme_fixture_on_the_card(cuda):
    a = pt.csr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)],
                            dtype=torch.float64, device=cuda)
    v = torch.tensor([10.0, 20.0, 30.0], dtype=torch.float64, device=cuda)
    want = torch.tensor([20.0, 90.0], dtype=torch.float64, device=cuda)
    assert torch.equal(pt.smvm_prepare(a).apply(v), want)
    assert torch.equal(pt.csr_smvm_segtile(a, v, pt.build_seg_tiles(a)),
                       want)


@pytest.mark.parametrize("kind", [None, "segtile", "blockseg", "hubsplit",
                                  "xla"])
def test_main_path_rungs_on_the_card(cuda, kind):
    """Default ladder on CUDA tensors takes the fast rungs, and every rung
    matches SciPy."""
    s = _blocks(1024, 3, 40) if kind in (None, "blockseg") \
        else _band(4096, 40000, 4, 300)
    c = s.tocoo()
    a = pt.csr_from_coo(pt.coo_make(
        s.shape, torch.from_numpy(c.row).to(cuda),
        torch.from_numpy(c.col).to(cuda), torch.from_numpy(c.data).to(cuda)))
    counts = (tpc.K1_LAUNCHES, tpb.K2_LAUNCHES)
    plan = pt.smvm_prepare(a, prefer=kind)
    assert plan.kind == (kind or "blockseg")
    v = np.random.default_rng(5).standard_normal(s.shape[0])
    y = plan.apply(torch.from_numpy(v).to(cuda))
    torch.cuda.synchronize()
    assert y.is_cuda
    _assert_close(_np(y), s @ v, s, v, np.float64)
    launched = (tpc.K1_LAUNCHES > counts[0], tpb.K2_LAUNCHES > counts[1])
    assert launched == {"segtile": (True, False), "hubsplit": (True, False),
                        "xla": (False, False)}.get(kind, (False, True))


def test_duplicate_sum_is_bitwise_repeatable(cuda):
    rng = np.random.default_rng(1)
    r = rng.integers(0, 50, 200_000)
    c = rng.integers(0, 50, 200_000)
    v = torch.from_numpy(rng.standard_normal(200_000)).to(cuda)
    outs = [pt.csr_from_coo(pt.coo_make((50, 50), torch.from_numpy(r).to(
        cuda), torch.from_numpy(c).to(cuda), v)).data for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    s = sp.coo_matrix((_np(v), (r, c)), shape=(50, 50)).tocsr()
    s.sum_duplicates()
    np.testing.assert_allclose(_np(outs[0])[:s.nnz], s.data, rtol=1e-12,
                               atol=1e-9)


# -- K3-K6: blocked-ELL SpMM --------------------------------------------------


def _band_bell(nb, bsz, hb, seed, dtype, device, empty=()):
    """Block band of half-width ``hb`` on ``device``; edge and ``empty``
    rows padded with zero blocks at column 0.  Returns (BELL, slot_valid)."""
    c = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (c >= 0) & (c < nb)
    ok[list(empty)] = False
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols, ok = np.where(ok, c, 0)[rows, order], ok[rows, order]
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((nb, 2 * hb + 1, bsz, bsz)) * ok[
        :, :, None, None]
    return BELL(cols=torch.from_numpy(cols.astype(np.int32)).to(device),
                blocks=torch.from_numpy(blocks).to(dtype).to(device),
                n=nb * bsz, bsz=bsz), ok


def _spmm_bound(a, b, stream):
    """|A||B| in float64 for A and B rounded to the stream dtype."""
    ab = BELL(cols=a.cols, blocks=a.blocks.to(stream).abs().double(), n=a.n,
              bsz=a.bsz)
    return tcb.bell_spmm_fused_plain(ab, b.to(stream).abs().double())


def _check_spmm(got, ref, bound, dtype):
    # a bf16 result: both sides round a float32 sum to bf16 once
    tol = {torch.float64: 1e-12, torch.bfloat16: 2.0 ** -7 + 1e-5}.get(
        dtype, 1e-5)
    err = (got.double() - ref.double()).abs()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert bool((err <= tol * bound).all()), float((err - tol * bound).max())


def _bits(y):
    return y.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[y.element_size()])


def _twice(fn, counter):
    before = getattr(tcb, counter)
    y1, y2 = fn(), fn()
    torch.cuda.synchronize()
    assert getattr(tcb, counter) == before + 2
    assert torch.equal(_bits(y1), _bits(y2))  # bitwise repeatable, NaN too
    return y1


def _with_values(a, values):
    """``a`` with other values: "band" and "shift" keep them, "zero" makes
    every block zero, "lone" leaves one stored element (1.5, in a stored
    slot of an interior row), "nan" puts a NaN into a stored block."""
    if values in ("band", "shift"):
        return a
    blocks = a.blocks.clone()
    r = a.nb // 3
    if values in ("zero", "lone"):
        blocks.zero_()
    if values == "lone":
        blocks[r, 1, a.bsz - 1, a.bsz // 2] = 1.5
    elif values == "nan":
        blocks[r, 1, 1, 0] = float("nan")
    return BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=a.bsz)


def _shifted(b, values):
    """``b``, or for "shift" a copy of it one element past a 16-byte
    boundary (a contiguous view the wrappers take as it is), so the kernels
    copy and store element by element."""
    if values != "shift":
        return b
    flat = b.new_empty(b.numel() + 1)
    out = flat[1:].view(b.shape)
    out.copy_(b)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


def _check_values(got, ref, bound, dtype, values):
    """_check_spmm, where a NaN in A must give NaN exactly where the plain
    version has it (its row of C), and a lone element a non-zero row (K3)
    or column (K5, ``ref`` being C^T) with exact zeros elsewhere."""
    if values == "nan":
        nan = torch.isnan(ref)
        assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
        got, ref = got.masked_fill(nan, 0), ref.masked_fill(nan, 0)
        bound = bound.masked_fill(torch.isnan(bound), 0)
    if values in ("zero", "lone"):
        nz = (ref != 0).sum().item()
        assert (got != 0).sum().item() == nz and (nz > 0) == (
            values == "lone")
    _check_spmm(got, ref, bound, dtype)


TIERS = {"f32": (torch.float32, None, None),
         "f64": (torch.float64, None, None),
         "bf16": (torch.float32, torch.bfloat16, None),
         "bf16x3": (torch.float32, None, "bf16x3"),
         # bf16 blocks and operand: K3 and K6 stream bf16, bf16 results
         "bf16in": (torch.bfloat16, None, None)}


# Every stream of K3 runs the band body (32 x 128 blocks, the zero-chunk
# vote; bf16x3 as three bf16 mma.sync products, float64 on DMMA), every
# stream of K6 the persistent body (one block row x 128 columns per tile,
# a vote per stored block; bf16x3 on the same split, float64 on the same
# DMMA chunks), both with their issued-work counters.
# Shapes:
# bsz 3 and 33 (element copies, ragged 32-row blocks), 8, 24 (a 32-index
# chunk spans two blocks), 32 (a chunk is a block), 64 (two row blocks per
# block row); k 1, 5, 33, 65, 70 (element copies or a ragged column
# block), 32, 128, 200 (two column blocks).  Edge rows and an empty row
# hold padding slots (zero blocks at column 0).
# The edges of the band body's float32 / int32 register map: bsz 13, 20,
# 45 and 100 (not multiples of 8: part of a thread's rows fall past the
# block row), k 20, 100, 130 and 257 (a warp's columns partly past N),
# "shift" (the operand one element off a 16-byte boundary: element copies
# and stores where bsz and k would allow vectors), and bsz 80 / 100 (K6
# past its persistent body: int32 and the shapes TMA cannot describe run
# the band body).
K3_CASES = [(37, 3, 2, 5, "band"), (29, 33, 1, 65, "band"),
            (50, 8, 3, 1, "band"), (40, 24, 2, 70, "band"),
            (30, 32, 2, 32, "band"), (12, 64, 1, 200, "band"),
            (29, 33, 1, 33, "band"), (37, 3, 2, 200, "band"),
            (30, 32, 2, 128, "zero"), (30, 32, 2, 128, "lone"),
            (30, 32, 2, 128, "nan"), (40, 24, 2, 33, "lone"),
            (21, 13, 2, 20, "band"), (17, 40, 1, 100, "band"),
            (13, 45, 1, 130, "band"), (9, 20, 2, 257, "band"),
            (21, 13, 2, 100, "nan"), (17, 40, 1, 100, "shift"),
            (30, 32, 2, 128, "shift"), (8, 100, 1, 257, "band"),
            (7, 80, 1, 20, "shift"), (21, 13, 2, 1, "lone")]


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("nb,bsz,hb,k,values", K3_CASES)
def test_k3_k6_match_plain_at_odd_shapes(cuda, nb, bsz, hb, k, values, tier):
    dt, cd, prec = TIERS[tier]
    a, _ = _band_bell(nb, bsz, hb, nb + k, dt, cuda, empty=(nb // 2,))
    a = _with_values(a, values)
    b = _shifted(torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda), values)
    bound = _spmm_bound(a, b, cd or dt)
    got = _twice(lambda: tcb.bell_spmm_fused(a, b, compute_dtype=cd,
                                             precision=prec), "K3_LAUNCHES")
    _check_values(got, tcb.bell_spmm_fused_plain(a, b, compute_dtype=cd,
                                                 precision=prec), bound, dt,
                  values)
    # the band body's own count (bf16x3: float32's)
    issued = tcb.fused_issued_flops(a, b, compute_dtype=cd, precision=prec)
    assert issued == tcb.fused_issued_model(a, k, compute_dtype=cd or dt)
    if values == "lone":
        assert issued == 2 * 32 * 32 * 128 * -(-k // 128)
    if cd is None:  # K6 streams at the result dtype
        got = _twice(lambda: tcb.bell_spmm_block(a, b, precision=prec),
                     "K6_LAUNCHES")
        assert got.dtype == dt
        _check_values(got, tcb.bell_spmm_block_plain(a, b, precision=prec),
                      bound, dt, values)
    if cd is None:  # K6's persistent body counts its work (bf16x3:
        before = tcb.K6_LAUNCHES  # float32's)
        issued = tcb.block_issued_flops(a, b, precision=prec)
        assert tcb.K6_LAUNCHES == before
        assert issued == tcb.block_issued_model(a, k)
        if values == "lone":  # in row bsz - 1: its 32-row group's rows
            assert issued == 2 * (bsz - 32 * ((bsz - 1) // 32)) * bsz * k
        if values == "zero":
            assert issued == 0


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("nb,bsz,hb,rt,k", [(41, 24, 2, 3, 70),
                                            (26, 16, 1, 4, 3),
                                            (29, 40, 1, 3, 130),
                                            (26, 16, 1, 3, 257),
                                            (23, 8, 1, 5, 20)])
def test_k4_matches_plain_at_odd_shapes(cuda, nb, bsz, hb, rt, k, tier):
    dt, cd, prec = TIERS[tier]
    a, ok = _band_bell(nb, bsz, hb, nb * k, dt, cuda, empty=(1,))
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    kit = tcb.bell_banded_prepare(a, row_tile=rt, compute_dtype=cd,
                                  slot_valid=ok)
    assert kit is not None and nb % rt
    kw = dict(tiles=kit.tiles, compute_dtype=kit.tiles.dtype,
              precision=prec)
    got = _twice(lambda: tcb.bell_spmm_banded(a, b, kit.plan, **kw),
                 "K4_LAUNCHES")
    _check_spmm(got, tcb.bell_spmm_banded_plain(a, b, kit.plan, **kw),
                _spmm_bound(a, b, kit.tiles.dtype), dt)


# Every stream of K4/K8 runs the 32-row, 128-column body with the
# zero-chunk vote (float64 on DMMA, C in float64).  Shapes:
# bsz 24 (does not divide the 32-row block, nor does rt*bsz = 72), bsz 3
# and 33 (ragged row blocks; the plan's lane rounding makes W*bsz a
# multiple of 128, so W is 128 panels there), bsz 32 (blocks are block
# rows); k 1 and 33 (element copies), 128 (one column block), 200 (two,
# the second ragged), 20, 100, 130 and 257 (a warp's columns partly past
# N); bsz 13 (part of a thread's rows past M).
K4_K = [1, 33, 128, 200, 20, 100, 130, 257]
K4_SHAPES = [(40, 24, 2, 3, 64), (130, 3, 2, 7, 128), (130, 33, 1, 2, 128),
             (50, 32, 2, 5, 64), (130, 13, 1, 3, 128)]


@pytest.mark.parametrize("tier", ["f32", "bf16", "bf16x3", "f64"])
@pytest.mark.parametrize("k", K4_K)
@pytest.mark.parametrize("nb,bsz,hb,rt,mw", K4_SHAPES)
def test_k4_vote_body_matches_plain(cuda, nb, bsz, hb, rt, mw, k, tier):
    dt, cd, prec = TIERS[tier]
    a, ok = _band_bell(nb, bsz, hb, nb * k + bsz, dt, cuda, empty=(2,))
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    kit = tcb.bell_banded_prepare(a, row_tile=rt, max_window=mw,
                                  compute_dtype=cd, slot_valid=ok)
    kw = dict(tiles=kit.tiles, compute_dtype=kit.tiles.dtype,
              precision=prec)
    got = _twice(lambda: tcb.bell_spmm_banded(a, b, kit.plan, **kw),
                 "K4_LAUNCHES")
    _check_spmm(got, tcb.bell_spmm_banded_plain(a, b, kit.plan, **kw),
                _spmm_bound(a, b, kit.tiles.dtype), dt)
    # the vote body's own count; bf16x3 and float64 keep float32's chunks
    assert tcb.banded_issued_flops(
        kit.tiles, kit.plan.start, b, bsz, precision=prec) == _issued_model(
            kit.tiles, k)


# float64 and bf16x3 ran the first body before they moved to the vote
# body; both now run the vote body, and these cases are kept at their
# shapes
@pytest.mark.parametrize("tier", ["f64", "bf16x3"])
@pytest.mark.parametrize("k", [1, 200])
def test_k4_first_body_kinds_match_plain(cuda, k, tier):
    dt, cd, prec = TIERS[tier]
    a, ok = _band_bell(40, 24, 2, k, dt, cuda, empty=(2,))
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    kit = tcb.bell_banded_prepare(a, row_tile=3, slot_valid=ok)
    kw = dict(tiles=kit.tiles, precision=prec)
    got = _twice(lambda: tcb.bell_spmm_banded(a, b, kit.plan, **kw),
                 "K4_LAUNCHES")
    _check_spmm(got, tcb.bell_spmm_banded_plain(a, b, kit.plan, **kw),
                _spmm_bound(a, b, dt), dt)


def _issued_model(tiles, k):
    """Operations the vote body should issue: 2 x 32 x 32 x (k rounded up
    to 128) for every 32 x 32 chunk of the tiles that is not all zero."""
    nt, m, kk = tiles.shape
    t = torch.nn.functional.pad(tiles.float() != 0, (0, -kk % 32, 0, -m % 32))
    kept = t.reshape(nt, t.shape[1] // 32, 32, t.shape[2] // 32, 32).any(
        4).any(2).sum()
    return int(kept) * 2 * 32 * 32 * (-(-k // 128) * 128)


def _sparse_tiles_case(cuda, stream, fill):
    """A 4-tile kit (bsz 32, rt 2) whose tiles are all zero, then ``fill``
    writes into them; returns (BELL, operand, plan, tiles)."""
    a, ok = _band_bell(8, 32, 1, 0, torch.float32, cuda)
    kit = tcb.bell_banded_prepare(a, row_tile=2, compute_dtype=stream,
                                  slot_valid=ok)
    tiles = torch.zeros_like(kit.tiles)
    fill(tiles)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (a.n, 128))).float().to(cuda)
    return a, b, kit.plan, tiles


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["all-zero", "one-element", "chunk-edge"])
def test_k4_vote_keeps_lone_elements(cuda, stream, where):
    def fill(t):
        if where == "one-element":  # one value in an otherwise zero chunk
            t[1, 37, 70] = 1.5
        elif where == "chunk-edge":  # last row and column of a 32x32 chunk
            t[2, 31, 63] = -2.0
            t[3, 63, 95] = 0.75

    a, b, plan, tiles = _sparse_tiles_case(cuda, stream, fill)
    kw = dict(tiles=tiles, compute_dtype=stream)
    got = _twice(lambda: tcb.bell_spmm_banded(a, b, plan, **kw),
                 "K4_LAUNCHES")
    want = tcb.bell_spmm_banded_plain(a, b, plan, **kw)
    nz = tiles.float().reshape(-1, tiles.shape[2]).abs().sum(1) != 0
    assert int(nz.sum()) == {"all-zero": 0, "one-element": 1,
                             "chunk-edge": 2}[where]
    # the kernel's own count: one 32 x 32 x 128 chunk per stored element
    assert tcb.banded_issued_flops(tiles, plan.start, b, 32) == int(
        nz.sum()) * 2 * 32 * 32 * 128 == _issued_model(tiles, 128)
    # a row with a stored element is that element times a row of B, and
    # not skipped; the rest are exact zeros
    assert torch.equal(got[~nz], torch.zeros_like(got[~nz]))
    assert bool((got[nz] != 0).all())
    bound = tcb.bell_spmm_banded_plain(a, b.abs(), plan, tiles=tiles.abs(),
                                       compute_dtype=stream)
    _check_spmm(got, want, bound, torch.float32)


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
def test_k4_nan_in_a_propagates(cuda, stream):
    def fill(t):
        t[0, 5, 40] = float("nan")
        t[0, 5, 41] = 1.0
        t[1, 40, 3] = 2.0

    a, b, plan, tiles = _sparse_tiles_case(cuda, stream, fill)
    kw = dict(tiles=tiles, compute_dtype=stream)
    before = tcb.K4_LAUNCHES
    y1 = tcb.bell_spmm_banded(a, b, plan, **kw)
    y2 = tcb.bell_spmm_banded(a, b, plan, **kw)
    torch.cuda.synchronize()
    assert tcb.K4_LAUNCHES == before + 2
    assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
    want = tcb.bell_spmm_banded_plain(a, b, plan, **kw)
    assert torch.isnan(y1[5]).all()  # the NaN row: NaN in every column
    # the NaN's chunk (with its neighbour) and the 2.0's were multiplied
    assert tcb.banded_issued_flops(tiles, plan.start, b,
                                   32) == 2 * (2 * 32 * 32 * 128)
    assert torch.equal(torch.isnan(y1), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.allclose(y1[ok], want[ok], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel,tier", [
    (kn, t) for kn in ("K3", "K4") for t in ("f32", "bf16", "bf16x3")] + [
    ("K5", t) for t in ("f32", "bf16", "bf16x3", "f64")] + [
    ("K4", "f64"), ("K6", "bf16x3"), ("K3", "f64"), ("K6", "f64"),
    ("K6", "f32"), ("K6", "bf16")] + [
    ("K4-kit", t) for t in ("f32", "bf16", "bf16x3", "f64")] + [
    ("K6-wide", t) for t in ("f32", "bf16", "bf16x3", "f64")] + [
    (kn, t) for kn in ("K4-half", "K4-kit-half") for t in ("f32", "f64")])
def test_inf_opposite_a_zero_chunk_gives_the_sparse_answer(cuda, kernel,
                                                           tier):
    """Inf and NaN in operand panel 0, which block rows 0 and 1 store: K3's
    and K6's padding slots (zero blocks at column 0 in the edge rows and
    the empty row 6), K4's densified zero chunks (block row 2 in tile 0's
    window; ``K4-kit``: the kit route, whose chunk mask skips them) and
    K5's (block rows 2 and 3's slices of tile 0, whose window
    starts at panel 0) sit opposite them, so the vote or the chunk mask
    skips them and those rows are the sparse product, finite; block rows 0
    and 1 carry the Inf and NaN.  Every kernel gives it in every kind,
    float64 too (K6 streams at the result dtype: its bf16 case takes bf16
    blocks and operand).  ``K6-wide`` is K6 at bsz 128 on its wide-block
    body (5 block rows, row 3 empty): its vote skips each 32-index slice of
    a padding block.  ``-half``: K4 with block row 0 empty too, so that the
    zero chunk opposite panel 0 lies in one 32-row block of the tile's
    first 64 rows and block row 1's non-zero chunk in the other: block row
    0 is exact zeros, block row 1 carries the Inf and NaN."""
    dt, cd, prec = TIERS[tier]
    tol_dt = dt
    half = kernel.endswith("-half")
    kernel = kernel.removesuffix("-half")
    wide = kernel == "K6-wide"
    bsz = 128 if wide else 32
    if wide:
        a, ok = _band_bell(5, bsz, 1, 8, dt, cuda, empty=(3,))
    else:
        a, ok = _band_bell(12, bsz, 1, 8, dt, cuda,
                           empty=(0, 6) if half else (6,))
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (a.n, 40))).to(dt).to(cuda)
    b_inf = b.clone()
    b_inf[0, 5] = float("inf")
    b_inf[3, 9] = float("nan")
    if kernel == "K3":
        kw = dict(compute_dtype=cd, precision=prec)
        got = _twice(lambda: tcb.bell_spmm_fused(a, b_inf, **kw),
                     "K3_LAUNCHES")
        want = tcb.bell_spmm_fused_plain(a, b, **kw)
    elif kernel in ("K6", "K6-wide"):
        if cd is not None:  # bf16 blocks and operand, a bf16 result
            a = BELL(cols=a.cols, blocks=a.blocks.to(cd), n=a.n, bsz=a.bsz)
            b, b_inf, tol_dt = b.to(cd), b_inf.to(cd), cd
        assert (tcb._k6_body(bsz, 40, b.dtype) == "wide") == wide
        got = _twice(lambda: tcb.bell_spmm_block(a, b_inf, precision=prec),
                     "K6_LAUNCHES")
        want = tcb.bell_spmm_block_plain(a, b, precision=prec)
        assert got.dtype == want.dtype == b.dtype
    elif kernel == "K5":
        kit = tcb.bell_banded_prepare_t(a, compute_dtype=cd, slot_valid=ok)
        assert int(kit.plan.start[0]) == 0
        got = _twice(lambda: tcb.bell_spmm_banded_t(
            a, b_inf.T.contiguous(), kit, precision=prec), "K5_LAUNCHES").T
        want = tcb.bell_spmm_banded_t_plain(a, b.T.contiguous(), kit,
                                            precision=prec).T
    else:
        kit = tcb.bell_banded_prepare(a, row_tile=3, compute_dtype=cd,
                                      slot_valid=ok)
        assert int(kit.plan.start[0]) == 0
        kw = dict(tiles=kit.tiles, compute_dtype=kit.tiles.dtype,
                  precision=prec)
        if kernel == "K4-kit":
            got = _twice(lambda: pt.bell_spmm(a, b_inf, plan=kit,
                                              precision=prec),
                         "K4_KIT_LAUNCHES")
        else:
            got = _twice(lambda: tcb.bell_spmm_banded(a, b_inf, kit.plan,
                                                      **kw), "K4_LAUNCHES")
        want = tcb.bell_spmm_banded_plain(a, b, kit.plan, **kw)
    hit = torch.zeros_like(got, dtype=torch.bool)
    hit[bsz if half else 0:2 * bsz, [5, 9]] = True  # against Inf and NaN
    assert not bool(torch.isfinite(got[hit]).any())
    if half:
        assert not bool(got[:bsz].any())
    _check_spmm(got[~hit], want[~hit],
                _spmm_bound(a, b, cd or dt)[~hit], tol_dt)


@pytest.mark.parametrize("stream", ["f32", "bf16", "f64"])
def test_k8_windows_past_the_operand_end(cuda, stream):
    """``b3`` shorter than the last windows: rows past its end read 0."""
    from sparse_tpu_torch.ops import cuda_dband as tdb

    sdt = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f64": torch.float64}[stream]
    odt = torch.float64 if sdt == torch.float64 else torch.float32
    nb, bsz, rt, k = 45, 32, 5, 128
    a, ok = _band_bell(nb, bsz, 2, 11, torch.float32, cuda, empty=(7,))
    plan = tcb.build_banded_plan(a, row_tile=rt, max_window=96,
                                 slot_valid=ok)
    tiles = tdb.densify_tiles(a, plan, sdt)
    b = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (a.n, k))).float().to(cuda)
    b3 = b.reshape(nb, bsz, k)[:nb - 3]  # the last windows run past it
    assert int(plan.start.max()) + plan.W > b3.shape[0]
    args = (tiles, plan.start, b3, nb, bsz, k, plan.W, rt, odt)
    before = tdb.K8_LAUNCHES
    y1, y2 = tdb.dband_spmm(*args), tdb.dband_spmm(*args)
    torch.cuda.synchronize()
    assert tdb.K8_LAUNCHES == before + 2
    assert torch.equal(y1, y2) and y1.shape == (nb * bsz, k)
    b_cut = torch.cat([b3.reshape(-1, k), b.new_zeros(3 * bsz, k)])
    _check_spmm(y1, tdb.dband_spmm_plain(*args),
                _spmm_bound(a, b_cut, sdt), odt)


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,W,rt,k,shift", [(3, 5, 7, 33, 0),
                                              (33, 3, 2, 70, 0),
                                              (8, 4, 3, 64, 1),
                                              (8, 4, 3, 100, 1),
                                              (16, 3, 3, 20, 1),
                                              (13, 5, 3, 257, 0),
                                              (20, 4, 2, 130, 1)])
def test_k8_element_copies(cuda, bsz, W, rt, k, shift, stream):
    """Tiles of any W (K8 takes them as given): W*bsz not a multiple of 16
    bytes, or tiles, operand and output at an odd element offset (shift),
    take the element-copy path; half the 32-column chunks are zero."""
    from sparse_tpu_torch.ops import cuda_dband as tdb

    rng = np.random.default_rng(bsz * W + k)
    nb, ntiles = 9, 4
    t = rng.standard_normal((ntiles, rt * bsz, W * bsz))
    for c0 in range(32, W * bsz, 64):
        t[:, :, c0:c0 + 32] = 0.0
    start = torch.from_numpy(rng.integers(0, nb, ntiles).astype(np.int32))
    b3 = rng.standard_normal((nb, bsz, k))  # windows run past its end

    def dev(x):
        flat = torch.from_numpy(x).to(stream).reshape(-1)
        return torch.cat([flat.new_zeros(shift), flat]).to(cuda)[
            shift:].reshape(x.shape)

    tiles, bb = dev(t), dev(b3)
    args = (tiles, start.to(cuda), bb, nb, bsz, k, W, rt, torch.float32)
    before = tdb.K8_LAUNCHES
    y1, y2 = tdb.dband_spmm(*args), tdb.dband_spmm(*args)
    torch.cuda.synchronize()
    assert tdb.K8_LAUNCHES == before + 2
    assert torch.equal(y1, y2)
    assert tcb.banded_issued_flops(tiles, start.to(cuda), bb.reshape(-1, k),
                                   bsz) == _issued_model(tiles, k)
    bound = tdb.dband_spmm_plain(tiles.abs(), start.to(cuda), bb.abs(),
                                 *args[3:])
    _check_spmm(y1, tdb.dband_spmm_plain(*args), bound, torch.float32)


def _hand_kit_t(a, ok, rt, mw, stream):
    """A BandedKitT built by hand from K4's plan (unaligned starts, any rt),
    as a caller may: its chunk mask comes from ``__post_init__``."""
    plan = tcb.build_banded_plan(a, row_tile=rt, max_window=mw,
                                 slot_valid=ok)
    tiles = tcb._densify_band_tiles(a, plan, stream)
    return tcb.BandedKitT(plan=plan, tiles_t=tiles.transpose(1, 2)
                          .contiguous())


# K5's four kinds run the mask body (32 rows of k x 128 tile columns per
# thread block, one 32-column slice per warp; bf16x3 as three bf16 mma.sync
# products, float64 on DMMA), each with its issued-work counter (operations
# and tile bytes, at the kit's element width).  Kits: prepare_t's (rt*bsz a
# multiple of 128; bsz 24 gives 384 columns) or, for bsz 3 and 33 (whose
# aligned plans need windows of 384 and 128 panels), a hand-built one (rt 7
# and 2: 21 and 66 columns, 128-panel windows).  bsz 3 and 33 take element
# copies; k 1, 7, 33, 70, 200 end in a part 32-row block of k.  An unpadded
# operand's last windows run past its end.
K5_CASES = [(45, 16, 7, "band", None), (70, 8, 33, "band", None),
            (100, 24, 70, "band", None), (250, 32, 32, "band", None),
            (70, 64, 200, "band", None), (1000, 3, 1, "band", 7),
            (130, 33, 33, "band", 2), (250, 32, 32, "zero", None),
            (250, 32, 32, "lone", None), (250, 32, 32, "nan", None)]


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("nb,bsz,k,values,hand_rt", K5_CASES)
def test_k5_matches_plain_at_odd_shapes(cuda, nb, bsz, k, values, hand_rt,
                                        padded, tier):
    dt, cd, prec = TIERS[tier]
    a, ok = _band_bell(nb, bsz, 2, nb + k, dt, cuda)
    a = _with_values(a, values)
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    if hand_rt:
        kit = _hand_kit_t(a, ok, hand_rt, 128, cd or dt)
    else:
        kit = tcb.bell_banded_prepare_t(a, max_window=128, compute_dtype=cd,
                                        slot_valid=ok)
    assert torch.equal(kit.chunk_nz, tcb.chunk_mask(kit.tiles_t))
    n_pad = kit.plan.offs.shape[0] * bsz
    bt = b.T.contiguous()
    bound = _spmm_bound(a, b, kit.tiles_t.dtype).T
    if padded:
        bt = torch.cat([bt, bt.new_zeros(k, n_pad - a.n)], 1)
        bound = torch.cat([bound, bound.new_zeros(k, n_pad - a.n)], 1)
    got = _twice(lambda: tcb.bell_spmm_banded_t(a, bt, kit, precision=prec),
                 "K5_LAUNCHES")
    assert got.shape == (k, n_pad if padded else a.n)
    _check_values(got, tcb.bell_spmm_banded_t_plain(a, bt, kit,
                                                    precision=prec),
                  bound, dt, values)
    # the mask body's own counts (bf16x3: each chunk once)
    counted = tcb.banded_t_issued(a, bt, kit, precision=prec)
    assert counted == tcb.banded_t_issued_model(kit, k)
    if values == "lone":
        esz = kit.tiles_t.element_size()
        assert counted == (2 * 32 ** 3 * -(-k // 32),
                           32 * 32 * esz * -(-k // 32))


def test_bell_spmm_on_cuda_launches_the_kernels(cuda):
    import scipy.sparse as sp

    a, ok = _band_bell(64, 32, 2, 3, torch.float32, cuda)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (a.n, 32))).float().to(cuda)
    dense = pt.bell_todense(a).double().cpu().numpy()
    s = sp.csr_matrix(dense)
    bh = b.double().cpu().numpy()
    ref = torch.from_numpy(s @ bh).to(cuda)
    bound = torch.from_numpy(abs(s) @ np.abs(bh)).to(cuda)
    kit = tcb.bell_banded_prepare(a, slot_valid=ok)
    kit_t = tcb.bell_banded_prepare_t(a, slot_valid=ok)
    for plan, counter in ((None, "K3_LAUNCHES"), (kit, "K4_KIT_LAUNCHES"),
                          (kit.plan, "K4_LAUNCHES"),
                          (kit_t, "K5_LAUNCHES")):
        before = getattr(tcb, counter)
        got = pt.bell_spmm(a, b, plan=plan)
        torch.cuda.synchronize()
        assert getattr(tcb, counter) == before + 1
        assert got.is_cuda and got.is_contiguous()
        _check_spmm(got, ref, bound, torch.float32)
    _check_spmm(a @ b, ref, bound, torch.float32)
    names = ("K3", "K4", "K4_KIT", "K5", "K6")
    counts = [getattr(tcb, f"{n}_LAUNCHES") for n in names]
    got = pt.bell_spmm(a, b, prefer_pallas=False)  # the gather-einsum
    assert counts == [getattr(tcb, f"{n}_LAUNCHES") for n in names]
    _check_spmm(got, ref, bound, torch.float32)


def test_bell_kernels_reject_what_they_cannot_take(cuda):
    a, ok = _band_bell(16, 8, 1, 0, torch.float32, cuda)
    b = torch.ones(a.n, 4, device=cuda)
    kit = tcb.bell_banded_prepare(a, slot_valid=ok)
    for call in (lambda: pt.bell_spmm(a, b.cpu()),
                 lambda: pt.bell_spmm(a, b.cpu(), plan=kit),
                 lambda: tcb.bell_spmm_block(a, b.cpu()),
                 lambda: tcb.bell_spmm_banded_t(
                     a, b.T.contiguous().cpu(),
                     tcb.bell_banded_prepare_t(a, slot_valid=ok))):
        with pytest.raises(ValueError, match="device"):
            call()
    a16 = BELL(cols=a.cols, blocks=a.blocks.half(), n=a.n, bsz=a.bsz)
    for call in (lambda: pt.bell_spmm(a16, b.half()),
                 lambda: tcb.bell_spmm_block(a16, b.half()),
                 lambda: pt.bell_spmm(a, b, compute_dtype=torch.float16),
                 lambda: pt.bell_spmm(a, b, plan=kit.plan,
                                      compute_dtype=torch.float16),
                 lambda: pt.bell_spmm(a, b.double(), precision="bf16x3")):
        with pytest.raises(ValueError):
            call()


# -- K7: the block-SpGEMM slab apply ------------------------------------------


def _rand_bsr(nb, bsz, density, seed, dtype, device, parity=None):
    """Random stored blocks on ``device``; with ``parity`` the stored-block
    count is made odd (1) or even (0)."""
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((nb, nb)) < density)
    if parity is not None and r.size % 2 != parity:
        r, c = r[:-1], c[:-1]
    blocks = torch.from_numpy(rng.standard_normal((r.size, bsz, bsz)))
    return pt.BSR(indices=torch.from_numpy((r * nb + c).astype(
        np.int32)).to(device), blocks=blocks.to(dtype).to(device),
                  n=nb * bsz, bsz=bsz)


def _slab_raw(pp, z1, z2, dtype):
    return ((pp.a_idx, pp.b_idx, pp.oloc, pp.first, pp.slab, z1, z2),
            dict(chunks=pp.chunks, bsz=pp.bsz, g=pp.g, p=pp.p,
                 nbz_out=pp.nbz_out, out_dtype=dtype, paired=pp.paired))


def _check_slab(got, z1, z2, pp, dtype):
    """Against the plain version within tol * (|z1||z2|); bf16 results may
    differ from it by one bf16 rounding (2^-7 relative)."""
    args, kw = _slab_raw(pp, z1, z2, dtype)
    ref = tbs.run_slabs_arrays_plain(*args, **kw)
    bound = tbs.run_slabs_arrays_plain(
        *args[:5], z1.abs().double(), z2.abs().double(),
        **{**kw, "out_dtype": torch.float64})
    tol = {torch.float32: 1e-5, torch.float64: 1e-12,
           torch.bfloat16: 2.0 ** -7 + 1e-5}[dtype]
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    err = (got.double() - ref.double()).abs()
    assert bool((err <= tol * bound).all()), float((err - tol * bound).max())


SLAB_DTYPES = {"f32": torch.float32, "f64": torch.float64,
               "bf16": torch.bfloat16}


def _k7_twice(fn, count_before):
    """Two launches of K7 through ``fn``, bitwise equal, two launches
    counted; returns the first result."""
    y1, y2 = fn(), fn()
    torch.cuda.synchronize()
    assert tbs.K7_LAUNCHES == count_before + 2
    assert torch.equal(y1, y2)  # bitwise repeatable
    return y1


def _check_list(got, ptr, ab, z1, z2, dtype):
    """K7's result on a product list against the list walk's plain version,
    within tol * (|z1||z2|), and the kernel's own count of the products it
    multiplied against the list's."""
    ref = tbs.slab_list_plain(ptr, ab, z1, z2, out_dtype=dtype)
    bound = tbs.slab_list_plain(ptr, ab, z1.abs().double(),
                                z2.abs().double(), out_dtype=torch.float64)
    tol = {torch.float32: 1e-5, torch.float64: 1e-12,
           torch.bfloat16: 2.0 ** -7 + 1e-5}[dtype]
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    err = (got.double() - ref.double()).abs()
    assert bool((err <= tol * bound).all()), float((err - tol * bound).max())
    assert not got[torch.diff(ptr) == 0].any()  # no product: zeros
    before = tbs.K7_LAUNCHES
    assert tbs.bsr_slab_issued(ptr, ab, z1, z2, out_dtype=dtype) == \
        tbs.bsr_slab_issued_model(ptr)
    assert tbs.K7_LAUNCHES == before


def _k7_route(route, pp, a, b, dt):
    """K7 through the prepared apply (the plan's list, the blocks as they
    are) or the raw-array route (the slot tables with appended zeros, a
    list with the pads built per call); checked against the plain version
    of the list it walks."""
    if route == "prepared":
        got = _k7_twice(lambda: pt.bsr_smsmm_apply_slab(pp, a, b).blocks,
                        tbs.K7_LAUNCHES)
        _check_list(got, pp.prod_ptr, pp.prod_ab, a.blocks, b.blocks, dt)
        return got
    ka = 2 + (a.nbz & 1) if pp.paired else 1
    z1 = tbs._append_zero(a.blocks, dt, ka)
    z2 = tbs._append_zero(b.blocks, dt)
    args, kw = _slab_raw(pp, z1, z2, dt)
    got = _k7_twice(lambda: tbs.run_slabs_arrays(*args, **kw),
                    tbs.K7_LAUNCHES)
    ptr, ab = tbs.slot_list(pp.a_idx, pp.b_idx, pp.oloc, pp.slab_start,
                            g=pp.g, p=pp.p, nbz_out=pp.nbz_out,
                            paired=pp.paired)
    assert int(ptr[-1]) == pp.b_idx.numel()  # every slot, pads included
    _check_list(got, ptr, ab, z1, z2, dt)
    _check_slab(got, z1, z2, pp, dt)
    return got


@pytest.mark.parametrize("route", ["prepared", "raw"])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("dtype", list(SLAB_DTYPES))
@pytest.mark.parametrize("bsz,nb,density", [(8, 40, 0.12), (16, 25, 0.15),
                                            (32, 16, 0.2), (64, 9, 0.3),
                                            (6, 30, 0.15), (40, 10, 0.3)])
def test_k7_matches_plain(cuda, bsz, nb, density, dtype, paired, route):
    """bsz 8-64 as the route gives them, and 6 and 40 (element copies into
    a padded stage, one warp or four per output); paired schedules with an
    odd A block count; the prepared route on the plan's list and the raw
    route on the slot tables, each twice, bitwise equal, with the kernel's
    product count."""
    dt = SLAB_DTYPES[dtype]
    a = _rand_bsr(nb, bsz, density, nb + bsz, dt, cuda, 1 if paired else None)
    b = _rand_bsr(nb, bsz, density, 3 * nb, dt, cuda)
    plan = pt.bsr_smsmm_prepare(a, b)
    pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, b.nbz, g=4 if paired else 3,
                                   p=8, paired=paired)
    assert int(pp.prod_ptr[-1]) == plan.n_products
    _k7_route(route, pp, a, b, dt)


def _one_output(nb, bsz, seed, device):
    """A stored block row times a stored block column: one output block
    with nb products."""
    rng = np.random.default_rng(seed)
    blocks = torch.from_numpy(rng.standard_normal((2, nb, bsz, bsz))).float()
    a = pt.BSR(indices=torch.arange(nb, dtype=torch.int32, device=device),
               blocks=blocks[0].to(device), n=nb * bsz, bsz=bsz)
    b = pt.BSR(indices=torch.arange(nb, dtype=torch.int32,
                                    device=device) * nb,
               blocks=blocks[1].to(device), n=nb * bsz, bsz=bsz)
    return a, b


@pytest.mark.parametrize("route", ["prepared", "raw"])
@pytest.mark.parametrize("case", ["chunked", "one_output"])
def test_k7_chunked_plan_and_empty_set(cuda, case, route):
    """A plan in several reference chunks, and one output block of 40
    products; then a product set that is empty."""
    if case == "chunked":
        a = b = _rand_bsr(40, 8, 0.12, 1, torch.float32, cuda)
        plan = pt.bsr_smsmm_prepare(a, a)
        old = tbs._SMEM_BUDGET
        try:
            tbs._SMEM_BUDGET = (3 * 2 + 2) * 4 * 256
            pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, a.nbz, g=2, p=2)
        finally:
            tbs._SMEM_BUDGET = old
        assert len(pp.chunks) > 1
    else:
        a, b = _one_output(40, 32, 8, cuda)
        plan = pt.bsr_smsmm_prepare(a, b)
        pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, b.nbz, g=4, p=4)
        assert pp.nbz_out == 1 and int(pp.prod_ptr[-1]) == 40
    got = _k7_route(route, pp, a, b, torch.float32)
    z1 = tbs._append_zero(a.blocks, torch.float32)
    z2 = tbs._append_zero(b.blocks, torch.float32)
    args, kw = _slab_raw(pp, z1, z2, torch.float32)
    _check_slab(got, z1, z2, pp, torch.float32)
    # the raw route without the plan's slab ranges (read off `first`)
    assert torch.equal(tbs.run_slabs_arrays(*args, **kw),
                       tbs.run_slabs_arrays(*args, **kw,
                                            slab_start=pp.slab_start))
    e = pt.BSR(indices=torch.tensor([1], dtype=torch.int32, device=cuda),
               blocks=torch.ones(1, 8, 8, device=cuda), n=16, bsz=8)
    pe = pt.bsr_smsmm_slab_prepare(pt.bsr_smsmm_prepare(e, e), 1, 1)
    assert pt.bsr_smsmm_apply_slab(pe, e, e).blocks.shape == (0, 8, 8)


@pytest.mark.parametrize("density", [0.2, 0.06])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k7_gradients(cuda, dtype, density):
    """dA and dB are K7 on the permuted schedules' lists; they agree with
    torch autograd through the plain ``bsr_smsmm_apply``.  At density 0.06
    some stored blocks meet no product: their gradient is zero."""
    dt = SLAB_DTYPES[dtype]
    a = _rand_bsr(16, 32, density, 4, dt, cuda)
    b = _rand_bsr(16, 32, density, 5, dt, cuda)
    plan = pt.bsr_smsmm_prepare(a, b)
    plans = pt.bsr_smsmm_slab_prepare_ad(plan, a.nbz, b.nbz)
    ct = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (plan.nbz_out, 32, 32))).to(dt).to(cuda)
    grads = []
    for apply in (lambda x, y: pt.bsr_smsmm_apply_slab_ad(plans, x, y),
                  lambda x, y: pt.bsr_smsmm_apply(plan, x, y)):
        ab = a.blocks.clone().requires_grad_(True)
        bb = b.blocks.clone().requires_grad_(True)
        before = tbs.K7_LAUNCHES
        c = apply(pt.BSR(indices=a.indices, blocks=ab, n=a.n, bsz=32),
                  pt.BSR(indices=b.indices, blocks=bb, n=b.n, bsz=32))
        c.blocks.backward(ct)
        torch.cuda.synchronize()
        grads.append((ab.grad, bb.grad, tbs.K7_LAUNCHES - before))
    (ga, gb, launched), (ra, rb, none) = grads
    assert launched == 3 and none == 0
    if density < 0.1:
        assert bool((torch.diff(plans.da.prod_ptr) == 0).any())
    tol = 1e-5 if dt == torch.float32 else 1e-12
    for g, r, z1, z2, pp in (
            (ga, ra, tbs._append_zero(ct, dt),
             tbs._append_zero(b.blocks.transpose(1, 2), dt), plans.da),
            (gb, rb, tbs._append_zero(a.blocks.transpose(1, 2), dt),
             tbs._append_zero(ct, dt), plans.db)):
        _check_slab(g, z1, z2, pp, dt)
        _check_list(g, pp.prod_ptr, pp.prod_ab, z1[:-1], z2[:-1], dt)
        args, kw = _slab_raw(pp, z1.abs().double(), z2.abs().double(),
                             torch.float64)
        bound = tbs.run_slabs_arrays_plain(*args, **kw)
        assert bool(((g - r).abs().double() <= 2 * tol * bound).all())


def test_k7_rejects_what_it_cannot_take(cuda):
    a = _rand_bsr(10, 8, 0.3, 2, torch.float32, cuda)
    pp = pt.bsr_smsmm_slab_prepare(pt.bsr_smsmm_prepare(a, a), a.nbz, a.nbz)
    ai = pt.BSR(indices=a.indices, blocks=a.blocks.round().long(), n=a.n,
                bsz=8)
    before = tbs.K7_LAUNCHES
    for call in (lambda: pt.bsr_smsmm_apply_slab(pp, ai, ai),
                 lambda: pt.bsr_smsmm_apply_slab(pp, a, a,
                                                 precision="bf16x3")):
        with pytest.raises(ValueError):
            call()
    z = tbs._append_zero(a.blocks, torch.float32)
    args, kw = _slab_raw(pp, z, z.cpu(), torch.float32)
    with pytest.raises(ValueError, match="device"):
        tbs.run_slabs_arrays(*args, **kw)
    big = _rand_bsr(3, 72, 1.0, 3, torch.float32, cuda)
    pb = pt.bsr_smsmm_slab_prepare(pt.bsr_smsmm_prepare(big, big), big.nbz,
                                   big.nbz)
    with pytest.raises(ValueError, match="block size"):
        pt.bsr_smsmm_apply_slab(pb, big, big)
    assert tbs.K7_LAUNCHES == before


def _dense_blocks_csr(nb, bsz, seed, dtype, device):
    """Scalar CSR on ``device`` whose stored pattern is fully dense
    bsz x bsz blocks (a band of block columns)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((nb, nb), bool)
    for i in range(nb):
        mask[i, np.clip(i + rng.integers(-3, 4, 3), 0, nb - 1)] = True
    r, c = np.nonzero(mask)
    vals = rng.standard_normal((r.size, bsz, bsz))
    vals[vals == 0] = 1.0
    if dtype == torch.int64:
        vals = np.round(np.abs(vals) * 4) + 1.0  # no zero, no cancel
    s = sp.bsr_matrix((vals, c, np.searchsorted(r, np.arange(nb + 1))),
                      shape=(nb * bsz, nb * bsz)).tocsr()
    s.sort_indices()
    return s, interop.csr_from_arrays(
        torch.from_numpy(s.data).to(dtype), s.indices, s.indptr, s.shape,
        device=device)


@pytest.mark.parametrize("bsz,dtype,launches", [
    (8, torch.float32, 1), (16, torch.float64, 1), (4, torch.float32, 0),
    (8, torch.int64, 0)])
def test_spgemm_block_route_on_the_card(cuda, bsz, dtype, launches):
    """``spgemm(a, a)`` takes the block route; bsz >= 8 in a float type
    launches K7, bsz < 8 and integers take ``bsr_smsmm_apply``."""
    from unittest import mock

    from sparse_tpu_torch.ops import spgemm as tsg

    s, a = _dense_blocks_csr(48, bsz, bsz, dtype, cuda)
    before = tbs.K7_LAUNCHES
    with mock.patch.object(tsg, "_MXU_DENSE_ELEMS", 10), \
         mock.patch.object(tsg, "_BLOCK_ROUTE_MIN_NNZ", 1):
        assert tsg._spgemm_route(a, a) == ("block", bsz)
        c = pt.spgemm(a, a)
    torch.cuda.synchronize()
    assert tbs.K7_LAUNCHES - before == launches
    assert c.data.is_cuda and c.data.dtype == dtype
    ref = (s @ s).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(_np(c.indptr), ref.indptr)
    np.testing.assert_array_equal(_np(c.indices), ref.indices)
    if dtype == torch.int64:
        np.testing.assert_array_equal(_np(c.data), ref.data)
    else:
        bound = (abs(s) @ abs(s)).tocsr()
        bound.sort_indices()
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        err = np.abs(_np(c.data).astype(np.float64) - ref.data)
        assert np.all(err <= tol * bound.data)


# -- slice 4: K1-r32, K1-mxu, K8, the default device, Matrix Market ---------

_K1_COUNTERS = {(8, "vpu"): "K1_LAUNCHES", (32, "vpu"): "K1_R32_LAUNCHES",
                (8, "mxu"): "K1_MXU_LAUNCHES", (32, "mxu"): "K1_MXU_LAUNCHES"}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("wsub", [8, 16, 32])
@pytest.mark.parametrize("layout", ["ff", "rigid"])
@pytest.mark.parametrize("rows,reduce", [(32, "vpu"), (8, "mxu"),
                                         (32, "mxu")])
def test_k1_variants_match_plain(cuda, rows, reduce, layout, wsub, dtype):
    """K1-r32 and K1-mxu over the compact stream against its plain version
    and SciPy, bitwise repeatable, on a band with an empty row block and a
    spill slot; the raw-array route, whose output is padded to whole tiles
    (3000 is not a multiple of 32), gives the plan route's result, in any
    tile order."""
    s = _band(3000, 40000, 21, 1800).tolil()
    s[64:96, :] = 0
    s[5, 7 + 128 * np.arange(12)] = 1.5  # one (row, lane) slot, 12 entries
    s = s.tocsr()
    s.eliminate_zeros()
    a = _csr(s, dtype, cuda)
    plan = tpc.build_seg_tiles(a, wsub=wsub, rows=rows, layout=layout)
    v = np.random.default_rng(22).standard_normal(3000).astype(dtype)
    vt = torch.from_numpy(v).to(cuda)
    counter = _K1_COUNTERS[(rows, reduce)]
    before = getattr(tpc, counter)
    y1 = tpc.csr_smvm_segtile(a, vt, plan, reduce=reduce, batch=4)
    y2 = tpc.csr_smvm_segtile(a, vt, plan, reduce=reduce)
    torch.cuda.synchronize()
    assert getattr(tpc, counter) == before + 2
    assert torch.equal(y1, y2)  # bitwise repeatable
    plain = tpc.segtile_stream_plain(plan.stream, vt)
    _assert_close(_np(y1), _np(plain), s, v, dtype)
    _assert_close(_np(y1), s @ v.astype(np.float64), s, v, dtype)
    assert bool((y1[64:96] == 0).all())
    raw = dict(n=3000, wsub=wsub, rows=rows, kstep=plan.kstep,
               chunks=plan.chunks, reduce=reduce)
    arrs = (plan.vals, plan.q, plan.seg_of, plan.rb)
    y3 = tpc.segtile_apply(*arrs, vt, **raw)
    assert y3.shape == (-(-3000 // rows) * rows,)
    assert torch.equal(y3[:3000], y1) and bool((y3[3000:] == 0).all())
    slot_plain = tpc.segtile_apply_plain(*arrs, vt, **raw)
    _assert_close(_np(y1), _np(slot_plain)[:3000], s, v, dtype)
    p = torch.randperm(plan.n_tiles, device=cuda)
    y4 = tpc.segtile_apply(*(x[p] for x in arrs), vt, **raw)
    _assert_close(_np(y4)[:3000], _np(plain), s, v, dtype)


def test_k1_variants_reject_what_they_cannot_take(cuda):
    s = _band(64, 300, 13, 64)
    a = _csr(s, np.float32, cuda)
    plan = tpc.build_seg_tiles(a, rows=32)
    raw = dict(n=64, wsub=8, kstep=plan.kstep, chunks=plan.chunks)
    v = torch.ones(64, device=cuda)
    arrs = (plan.vals, plan.q, plan.seg_of, plan.rb)
    with pytest.raises(ValueError, match="do not form a plan"):
        tpc.segtile_apply(*arrs, v, rows=8, **raw)  # 32-row tiles as 8
    with pytest.raises(TypeError):
        tpc.segtile_apply(plan.vals.half(), *arrs[1:], v.half(), rows=32,
                          reduce="mxu", **raw)
    with pytest.raises(ValueError, match="reduce"):
        tpc.segtile_apply(*arrs, v, rows=32, reduce="x", **raw)
    with pytest.raises(ValueError, match="reduce"):
        tpc.csr_smvm_segtile(a, v, plan, reduce="x")


@pytest.mark.parametrize("stream", ["f32", "bf16", "f64"])
def test_k8_matches_plain(cuda, stream):
    from sparse_tpu_torch.ops import cuda_dband as tdb

    dt = {"f32": torch.float32, "bf16": torch.float32,
          "f64": torch.float64}[stream]
    sdt = torch.bfloat16 if stream == "bf16" else dt
    nb, bsz, rt, k = 53, 16, 5, 40
    a, ok = _band_bell(nb, bsz, 2, 7, dt, cuda, empty=(9,))
    plan = tcb.build_banded_plan(a, row_tile=rt, max_window=96,
                                 slot_valid=ok)
    tiles = tdb.densify_tiles(a, plan, sdt)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(plan.W, bsz, k)])
    args = (tiles, plan.start, b3, nb, bsz, k, plan.W, rt, dt)
    before = tdb.K8_LAUNCHES
    y1, y2 = tdb.dband_spmm(*args), tdb.dband_spmm(*args)
    torch.cuda.synchronize()
    assert tdb.K8_LAUNCHES == before + 2
    assert torch.equal(y1, y2) and y1.shape == (nb * bsz, k)
    bound = _spmm_bound(a, b, sdt)
    _check_spmm(y1, tdb.dband_spmm_plain(*args), bound, dt)
    _check_spmm(y1, tcb.bell_spmm_banded_plain(a, b, plan, tiles=tiles,
                                               compute_dtype=sdt), bound, dt)


def test_default_device_is_the_card(cuda):
    """No ``device=``: host data builds on the card, and the README fixture
    runs there."""
    a = pt.csr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)])
    assert a.data.device == torch.device("cuda", 0)
    assert a.indptr.device == torch.device("cuda", 0)
    y = pt.smvm_prepare(a).apply([10, 20, 30])
    assert y.device == torch.device("cuda", 0)
    assert y.tolist() == [20, 90]
    for obj in (pt.coo_make((2, 3), np.array([0, 1]), np.array([0, 2]),
                            np.array([2.0, 3.0])),
                pt.csr_empty(3, 3), pt.bsr_zero(4, 2),
                interop.csr_from_arrays([2.0], [0], [0, 1, 1], (2, 3))):
        assert obj.data.is_cuda if hasattr(obj, "data") else \
            obj.blocks.is_cuda


def test_mm_read_lands_on_the_card(cuda):
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "benchmarks" / "matrices"
            / "fem_poisson_8k.mtx")
    a = pt.mm_read(path, dtype=np.float32)
    assert a.data.is_cuda and a.indices.is_cuda and a.indptr.is_cuda
    s = sp.csr_matrix((a.data.cpu().numpy().astype(np.float64),
                       a.indices.cpu().numpy(), a.indptr.cpu().numpy()),
                      shape=a.shape)
    v = np.random.default_rng(3).standard_normal(a.shape[1])
    y = pt.smvm_prepare(a).apply(torch.from_numpy(v).float().to(cuda))
    _assert_close(_np(y), s @ v.astype(np.float32).astype(np.float64), s,
                  v.astype(np.float32), np.float32)


# -- the block LU's steps replayed as one CUDA graph ---------------------------


def _lu_band(nb, bsz, seed, device):
    """A float64 block band (half-width 2, +4 I on the diagonal) as a BSR
    on ``device``."""
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(np.abs(np.subtract.outer(np.arange(nb),
                                                     np.arange(nb))) <= 2)
    blocks = rng.standard_normal((rows.size, bsz, bsz)) * 0.05
    blocks[rows == cols] += 4 * np.eye(bsz)
    return interop.bsr_from_arrays(rows * nb + cols, blocks, nb * bsz, bsz,
                                   device=device)


@pytest.mark.parametrize("pivot", [True, False])
def test_lu_graph_replay_matches_step_loop(cuda, monkeypatch, pivot):
    """The numeric LU and both sweeps, replayed as one CUDA graph, equal
    the step-by-step loop on the card bit for bit, and the CPU's factors
    within 1e-12 (float64)."""
    import importlib

    lu_mod = importlib.import_module("sparse_tpu_torch.solve.bsr_lu")
    a = _lu_band(40, 8, 3, cuda)
    plan = pt.bsr_lu_numeric_prepare(a)
    b = torch.randn(a.n, dtype=torch.float64, device=cuda)

    def run():
        lu, p = pt.bsr_lu_numeric_apply(plan, a, pivot)
        y = pt.bsr_forsolve(lu, b[p.long()])
        return lu.blocks, p, pt.bsr_backsolve(lu, y)

    graph = run()

    def loop(step, count, device):
        for _ in range(count):
            step()

    monkeypatch.setattr(lu_mod, "_repeat", loop)
    steps = run()
    for g, s in zip(graph, steps):
        assert torch.equal(g, s)
    cpu = interop.bsr_from_arrays(a.indices.cpu(), a.blocks.cpu(), a.n,
                                  a.bsz, device="cpu")
    lu_cpu, p_cpu = pt.bsr_lu_numeric_apply(
        pt.bsr_lu_numeric_prepare(cpu), cpu, pivot)
    assert torch.equal(p_cpu, graph[1].cpu())
    np.testing.assert_allclose(_np(graph[0]), _np(lu_cpu.blocks),
                               rtol=1e-12, atol=1e-12)
    x = _np(graph[2])
    dense = _np(a.todense())
    np.testing.assert_allclose(dense @ x, _np(b), rtol=1e-10, atol=1e-10)


# -- the int32 and bf16 kinds --------------------------------------------------
#
# Every int32 kind (K1, K1-r32, K1-mxu, K2, K3-K8) equals NumPy's int64
# product taken modulo 2^32 (values whose products and sums overflow int32)
# and its plain version, bit for bit.  The bf16 kinds of K1 (its variants
# too) and K2 are within 2^-8 (|A||v|)_i of SciPy's float64 product of the
# bf16 inputs (one rounding of a float32 sum) and within two such roundings
# of the plain version.  Each call is launched once (its counter) and two
# calls are bitwise equal.

KIND_DTYPE = {"int32": torch.int32, "bf16": torch.bfloat16}


def _wrap32(x):
    x = np.asarray(x, np.int64)
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def _ints(rng, shape, hi=2 ** 20):
    x = rng.integers(-hi, hi, shape)
    return np.where(x == 0, 1, x).astype(np.int32)


def _kind_pair(s, kind, rng, device):
    """The pattern of SciPy CSR ``s`` with int32 values (overflowing) or
    bf16 values on ``device``, an operand, and the answer: (CSR, v, NumPy's
    int32 answer or SciPy's float64 one, |A||v| or None)."""
    n, m = s.shape
    if kind == "int32":
        x, v = _ints(rng, s.nnz), _ints(rng, m)
        want = _wrap32(sp.csr_matrix((x.astype(np.int64), s.indices,
                                      s.indptr), shape=s.shape)
                       @ v.astype(np.int64))
        a = interop.csr_from_arrays(x, s.indices, s.indptr, s.shape,
                                    device=device)
        return a, torch.from_numpy(v).to(device), want, None
    x = torch.from_numpy(rng.standard_normal(s.nnz)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal(m)).to(torch.bfloat16)
    s64 = sp.csr_matrix((x.double().numpy(), s.indices, s.indptr),
                        shape=s.shape)
    v64 = v.double().numpy()
    a = interop.csr_from_arrays(x.float().numpy(), s.indices, s.indptr,
                                s.shape, device=device)
    a = dataclasses.replace(a, data=a.data.to(torch.bfloat16))
    return a, v.to(device), s64 @ v64, abs(s64) @ np.abs(v64)


def _check_kind(y, plain, want, mag, kind, gate=2.0 ** -8):
    """int32: equal to the plain version and to NumPy; bf16: within
    ``gate`` (|A||v|)_i of SciPy and twice that of the plain version."""
    assert y.dtype == KIND_DTYPE[kind] and y.is_cuda
    if kind == "int32":
        assert torch.equal(y, plain)
        np.testing.assert_array_equal(_np(y), want)
        return
    yd, pd = _np(y.double()), _np(plain.double())
    assert np.all(np.abs(yd - want) <= gate * mag), \
        np.max(np.abs(yd - want) - gate * mag)
    assert np.all(np.abs(yd - pd) <= 2 * gate * mag)


def _long_band(seed):
    """band rows, a 3000-entry row (long: its pieces and their ordered
    sum) and an empty row."""
    s = _band(3000, 40000, seed, 2500).tolil()
    s[5, :] = 1.0
    s[9, :] = 0.0
    s = s.tocsr()
    s.eliminate_zeros()
    return s


@pytest.mark.parametrize("kind", ["int32", "bf16"])
@pytest.mark.parametrize("rows,reduce", [(8, "vpu"), (32, "vpu"), (8, "mxu"),
                                         (32, "mxu")])
def test_k1_int32_bf16_kinds(cuda, rows, reduce, kind):
    """K1, K1-r32 and K1-mxu in int32 and bf16 (K1-mxu's int32 kind is
    K1's kernel, counted as K1-mxu's launch) over the compact stream, long
    rows included; the raw-array route gives the plan route's result bit
    for bit."""
    rng = np.random.default_rng(41 + rows)
    s = _long_band(41)
    a, v, want, mag = _kind_pair(s, kind, rng, cuda)
    plan = tpc.build_seg_tiles(a, wsub=16, rows=rows)
    assert plan.stream.vals.dtype == a.dtype and plan.stream.n_pieces > 0
    counter = _K1_COUNTERS[(rows, reduce)]
    before = getattr(tpc, counter)
    y1 = tpc.csr_smvm_segtile(a, v, plan, reduce=reduce)
    y2 = tpc.csr_smvm_segtile(a, v, plan, reduce=reduce)
    torch.cuda.synchronize()
    assert getattr(tpc, counter) == before + 2
    assert torch.equal(_bits(y1), _bits(y2))
    _check_kind(y1, tpc.segtile_stream_plain(plan.stream, v), want, mag,
                kind)
    raw = dict(n=3000, wsub=16, rows=rows, kstep=plan.kstep,
               chunks=plan.chunks, reduce=reduce)
    y3 = tpc.segtile_apply(plan.vals, plan.q, plan.seg_of, plan.rb, v, **raw)
    assert torch.equal(_bits(y3[:3000]), _bits(y1))


@pytest.mark.parametrize("kind", ["int32", "bf16"])
def test_k2_int32_bf16_kinds(cuda, kind):
    """K2 in int32 and bf16 over the block plan's stream, a 600-block row
    through the pieces, a misaligned operand bitwise the same."""
    rng = np.random.default_rng(43)
    s = _blocks(2000, 11, 900).tolil()
    s[10:12, :1200] = 1.25  # block row 5: 600 blocks
    s = s.tocsr()
    a, v, want, mag = _kind_pair(s, kind, rng, cuda)
    ab = tbsr.csr_to_bsr(a, 2)
    plan = tpb.build_seg_tiles_block(ab, wsub=16)
    assert plan.stream.n_long >= 1 and plan.stream.vals.dtype == a.dtype
    before = tpb.K2_LAUNCHES
    y1 = tpb.bsr_smvm_segtile_block(ab, v, plan)
    y2 = tpb.bsr_smvm_segtile_block(ab, v, plan)
    torch.cuda.synchronize()
    assert tpb.K2_LAUNCHES == before + 2
    assert torch.equal(_bits(y1), _bits(y2))
    _check_kind(y1, tpb.block_stream_plain(plan.stream, v), want, mag, kind)
    odd = torch.cat([v.new_zeros(1), v])[1:]  # one element off alignment
    assert torch.equal(_bits(tpb.bsr_smvm_segtile_block(ab, odd, plan)),
                       _bits(y1))


@pytest.mark.parametrize("kind", ["int32", "bf16"])
@pytest.mark.parametrize("rung", [None, "segtile", "blockseg", "hubsplit"])
def test_main_path_rungs_int32_bf16(cuda, rung, kind):
    """smvm_prepare -> plan.apply on an int32 and a bf16 CSR takes the rung
    a float32 CSR of the pattern takes and launches K1 or K2 on it;
    csr_smvm_auto and hub_split_smvm (a 256-column hub strip, the rest in
    the row-binned tail) too.  hubsplit adds two bf16 results: three
    roundings."""
    rng = np.random.default_rng(45)
    s = _blocks(1024, 3, 40) if rung in (None, "blockseg") \
        else _band(4096, 40000, 4, 300)
    a, v, want, mag = _kind_pair(s, kind, rng, cuda)
    a32 = interop.csr_from_arrays(s.data.astype(np.float32), s.indices,
                                  s.indptr, s.shape, device=cuda)
    plan = pt.smvm_prepare(a, prefer=rung)
    assert plan.kind == pt.smvm_prepare(a32, prefer=rung).kind == (
        rung or "blockseg")
    counts = (tpc.K1_LAUNCHES, tpb.K2_LAUNCHES)
    y = plan.apply(v)
    torch.cuda.synchronize()
    launched = (tpc.K1_LAUNCHES - counts[0], tpb.K2_LAUNCHES - counts[1])
    assert launched == ((0, 1) if plan.kind == "blockseg" else (1, 0))
    gate = 3 * 2.0 ** -8 if rung == "hubsplit" else 2.0 ** -8
    _check_kind(y, y, want, mag, kind, gate)
    if rung == "segtile":
        before = tpc.K1_LAUNCHES
        _check_kind(pt.csr_smvm_auto(a, v), y, want, mag, kind)
        assert tpc.K1_LAUNCHES == before + 1
    if rung == "hubsplit":
        split = pt.hub_split_prepare(a, max_hub_cols=256)
        assert 0 < split.hub_nnz < split.tail_nnz
        before = tpc.K1_LAUNCHES
        _check_kind(pt.hub_split_smvm(split, v), y, want, mag, kind, gate)
        assert tpc.K1_LAUNCHES == before + 1


def _int_bell(nb, bsz, hb, seed, device, values="band", empty=()):
    """An int32 block band (values up to 2^22: products and sums overflow
    int32 against ``_ints`` operands) on ``device``, from
    ``_band_bell``'s float64 one with ``values``; returns (BELL, slot_valid,
    int64 blocks on the host)."""
    a, ok = _band_bell(nb, bsz, hb, seed, torch.float64, device, empty=empty)
    a = _with_values(a, values)
    blocks = (a.blocks * 2 ** 20).round().to(torch.int32)
    return BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=a.bsz), ok, \
        blocks.long().cpu().numpy()


def _int_spmm_want(a, blocks64, b):
    """NumPy's int64 C = A B of an int32 BELL, modulo 2^32."""
    bh = b.long().cpu().numpy()
    panels = bh.reshape(a.nb, a.bsz, -1)[a.cols.long().cpu().numpy()]
    return _wrap32(np.einsum("rlij,rljk->rik", blocks64, panels).reshape(
        a.n, -1))


# K3_CASES without "nan": an int has none
INT_BELL_CASES = [c for c in K3_CASES if c[4] != "nan"]


@pytest.mark.parametrize("nb,bsz,hb,k,values", INT_BELL_CASES)
def test_k3_k6_int32_at_odd_shapes(cuda, nb, bsz, hb, k, values):
    """K3's int32 kind on the band body and K6's on the persistent body
    (bsz <= 64; past 64 on K3's band body) at K3_CASES' shapes: equal to
    their plain versions and to NumPy modulo 2^32, with the multiply-adds
    their votes kept (the float32 kinds' chunk and block models)."""
    a, _, blocks64 = _int_bell(nb, bsz, hb, nb + k, cuda, values,
                               empty=(nb // 2,))
    b = _shifted(torch.from_numpy(_ints(np.random.default_rng(k),
                                        (a.n, k))).to(cuda), values)
    want = _int_spmm_want(a, blocks64, b)
    got = _twice(lambda: tcb.bell_spmm_fused(a, b), "K3_LAUNCHES")
    assert got.dtype == torch.int32
    assert torch.equal(got, tcb.bell_spmm_fused_plain(a, b))
    np.testing.assert_array_equal(_np(got), want)
    assert tcb.fused_issued_flops(a, b) == tcb.fused_issued_model(a, k)
    got = _twice(lambda: tcb.bell_spmm_block(a, b), "K6_LAUNCHES")
    assert got.dtype == torch.int32
    assert torch.equal(got, tcb.bell_spmm_block_plain(a, b))
    np.testing.assert_array_equal(_np(got), want)
    assert tcb.block_issued_flops(a, b) == tcb.block_issued_model(a, k)
    if values == "zero":
        assert tcb.block_issued_flops(a, b) == 0


@pytest.mark.parametrize("kind", ["int32", "f32", "bf16", "bf16x3", "f64"])
@pytest.mark.parametrize("k", [33, 128])
def test_k6_past_bsz64(cuda, k, kind):
    """K6 at bsz 80 (past the persistent body's 64) in every kind, on both
    of its routes there: the wide-block body for float32, bf16, bf16x3 and
    float64 at k 128, K3's band body on the wide row (whose 32-index chunks
    straddle the stored blocks) for the rest, k 33 among them.  Against its
    plain version (int32: equal, and NumPy modulo 2^32; bf16: bf16 blocks
    and operand, both sides rounding a float32 sum to the bf16 result
    once), each in the result dtype, with the multiply-adds its vote kept
    equal to its body's host model (K3's chunk model over the wide row on
    the band body)."""
    nb, bsz = 12, 80
    prec = "bf16x3" if kind == "bf16x3" else None
    if kind == "int32":
        a, _, blocks64 = _int_bell(nb, bsz, 1, k, cuda, empty=(5,))
        b = torch.from_numpy(_ints(np.random.default_rng(k), (a.n, k))).to(
            cuda)
    else:
        dt = {"f64": torch.float64, "bf16": torch.bfloat16}.get(
            kind, torch.float32)
        a, _ = _band_bell(nb, bsz, 1, k, dt, cuda, empty=(5,))
        b = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (a.n, k))).to(dt).to(cuda)
    body = tcb._k6_body(bsz, k, b.dtype)
    assert body == ("wide" if k == 128 and kind != "int32" else "band")
    got = _twice(lambda: tcb.bell_spmm_block(a, b, precision=prec),
                 "K6_LAUNCHES")
    plain = tcb.bell_spmm_block_plain(a, b, precision=prec)
    assert got.dtype == plain.dtype == b.dtype
    if kind == "int32":
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(_np(got), _int_spmm_want(a, blocks64,
                                                               b))
    else:
        _check_spmm(got, plain, _spmm_bound(a, b, b.dtype), b.dtype)
    model = tcb.block_issued_model(a, k, precision=prec)
    assert model > 0
    if body == "band":
        assert model == tcb.fused_issued_model(a, k)
    else:  # every stored block is non-zero throughout
        stored = int((a.blocks != 0).any(3).any(2).sum())
        assert model == 2 * stored * bsz * bsz * k
    before = tcb.K6_LAUNCHES
    assert tcb.block_issued_flops(a, b, precision=prec) == model
    assert tcb.K6_LAUNCHES == before


# K6's wide-block body (float32, bf16, bf16x3, float64 past bsz 64): bsz
# 80 (one ragged 128-row tile: the second warpgroup holds 16 rows), 128
# (one tile), 192 (two, the second ragged), 256 (two); k 8 (one ragged
# column tile), 128 (one), 136 (two, the second 8 wide).  Seven block
# rows, row 3 empty (padding slots only), the edge rows padded.
@pytest.mark.parametrize("k", [8, 128, 136])
@pytest.mark.parametrize("bsz", [80, 128, 192, 256])
@pytest.mark.parametrize("kind", ["f32", "bf16", "bf16x3", "f64"])
def test_k6_wide_body_matches_plain(cuda, kind, bsz, k):
    """Twice, bitwise equal, launched each time; against its plain version
    within 1e-5 |A||B| (float32, bf16x3), 1e-12 (float64) or 2^-7 (bf16
    against bf16: both round a float32 sum to the bf16 result once); its
    count equal to the wide body's host model, which counts no padding
    block."""
    dt = {"f64": torch.float64, "bf16": torch.bfloat16}.get(kind,
                                                           torch.float32)
    prec = "bf16x3" if kind == "bf16x3" else None
    assert tcb._k6_body(bsz, k, dt) == "wide"
    a, ok = _band_bell(7, bsz, 1, bsz + k, dt, cuda, empty=(3,))
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    got = _twice(lambda: tcb.bell_spmm_block(a, b, precision=prec),
                 "K6_LAUNCHES")
    plain = tcb.bell_spmm_block_plain(a, b, precision=prec)
    assert got.dtype == plain.dtype == dt
    _check_spmm(got, plain, _spmm_bound(a, b, dt), dt)
    model = tcb.block_issued_model(a, k, precision=prec)
    assert model == 2 * int(ok.sum()) * bsz * bsz * k
    assert tcb.block_issued_flops(a, b, precision=prec) == model


@pytest.mark.parametrize("values", ["zero", "lone", "nan"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "bf16x3", "f64"])
def test_k6_wide_body_votes(cuda, kind, values):
    """All-zero blocks, a lone element (its 64-row group and 32-index slice
    only are counted) and a NaN stored in A (NaN exactly where the plain
    version has it) on the wide-block body at bsz 192, k 40, beside an
    operand view that does not start 16-byte aligned (the wrapper copies
    it)."""
    dt = {"f64": torch.float64, "bf16": torch.bfloat16}.get(kind,
                                                           torch.float32)
    prec = "bf16x3" if kind == "bf16x3" else None
    bsz, k = 192, 40
    a, _ = _band_bell(6, bsz, 1, 5, dt, cuda)
    a = _with_values(a, values)
    base = torch.from_numpy(np.random.default_rng(1).standard_normal(
        a.n * k + 1)).to(dt).to(cuda)
    b = base[1:].view(a.n, k)
    assert b.data_ptr() % 16 and b.is_contiguous()
    got = _twice(lambda: tcb.bell_spmm_block(a, b, precision=prec),
                 "K6_LAUNCHES")
    _check_values(got, tcb.bell_spmm_block_plain(a, b, precision=prec),
                  _spmm_bound(a, b, dt), dt, values)
    issued = tcb.block_issued_flops(a, b, precision=prec)
    assert issued == tcb.block_issued_model(a, k, precision=prec)
    if values == "zero":
        assert issued == 0
    if values == "lone":  # row bsz - 1: a 64-row group; column 96: slice 3
        assert issued == 2 * 64 * 32 * k


@pytest.mark.parametrize("kind,bsz,k", [("bf16", 65, 128), ("bf16", 80, 33),
                                        ("bf16x3", 128, 33),
                                        ("f64", 128, 33), ("f64", 40, 128),
                                        ("f32", 66, 128), ("f32", 128, 70)])
def test_k6_shapes_tma_cannot_take_run_the_band_body(cuda, kind, bsz, k):
    """Past the persistent body, a shape whose rows are not whole 16-byte
    units (bsz 65 in bf16, bsz 66 in float32, k 33, float32 at k 70) and
    float64 at bsz 33-64 run K3's band body, as before the wide-block body:
    its count is K3's chunk model."""
    dt = {"f64": torch.float64, "bf16": torch.bfloat16}.get(kind,
                                                           torch.float32)
    prec = "bf16x3" if kind == "bf16x3" else None
    assert tcb._k6_body(bsz, k, dt) == "band"
    a, _ = _band_bell(5, bsz, 1, bsz + k, dt, cuda, empty=(2,))
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    got = _twice(lambda: tcb.bell_spmm_block(a, b, precision=prec),
                 "K6_LAUNCHES")
    assert got.dtype == dt
    _check_spmm(got, tcb.bell_spmm_block_plain(a, b, precision=prec),
                _spmm_bound(a, b, dt), dt)
    model = tcb.block_issued_model(a, k, precision=prec)
    assert model == tcb.fused_issued_model(a, k)
    assert tcb.block_issued_flops(a, b, precision=prec) == model


# float64 on the vote bodies: K3 on the band body (a 32-index chunk spans
# two blocks at bsz 24 and 33, a block has ragged 32-row groups at bsz 3
# and 33), K6 on the persistent body at bsz 3 and 24 and on K3's band body
# at bsz 33 and 64 (past the float64 persistent body's 32); element copies
# at bsz 3 and 33 and at k 1 and 33, 16-byte copies (two doubles) at bsz
# 24 and 64 with k 128.
@pytest.mark.parametrize("k", [1, 33, 128])
@pytest.mark.parametrize("bsz", [3, 24, 33, 64])
def test_k3_k6_float64_on_the_vote_bodies(cuda, bsz, k):
    """K3 and K6 in float64 with all-zero stored blocks (every third row's
    second slot, besides the padding slots) and a NaN stored in A: twice,
    bitwise equal, launched each time; NaN exactly where the plain version
    has it, the rest within 1e-12 |A||B|; each body's issued work equal to
    its host model, which counts no all-zero block."""
    nb = 20
    a, _ = _band_bell(nb, bsz, 2, bsz + k, torch.float64, cuda,
                      empty=(nb // 2,))
    blocks = a.blocks.clone()
    blocks[::3, 1] = 0.0
    blocks[4, 2, bsz - 1, bsz // 2] = float("nan")
    a = BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=bsz)
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(cuda)
    bound = _spmm_bound(a, b, torch.float64)
    for kname, kern, plain, issued, model in (
            ("K3", tcb.bell_spmm_fused, tcb.bell_spmm_fused_plain,
             tcb.fused_issued_flops, tcb.fused_issued_model),
            ("K6", tcb.bell_spmm_block, tcb.bell_spmm_block_plain,
             tcb.block_issued_flops, tcb.block_issued_model)):
        got = _twice(lambda: kern(a, b), f"{kname}_LAUNCHES")
        assert got.dtype == torch.float64
        _check_values(got, plain(a, b), bound, torch.float64, "nan")
        assert issued(a, b) == model(a, k)
        dense = a.blocks.clone()
        dense[::3, 1] = 1.0  # the same band with no all-zero stored block
        full = model(BELL(cols=a.cols, blocks=dense, n=a.n, bsz=bsz), k)
        # the band body skips a zero block's chunks only where no chunk
        # straddles it; the persistent body (K6 at bsz <= 32) every block
        if bsz % 32 == 0 or (kname == "K6" and bsz <= 32):
            assert model(a, k) < full
        else:
            assert model(a, k) <= full


@pytest.mark.parametrize("k", K4_K)
@pytest.mark.parametrize("nb,bsz,hb,rt,mw", K4_SHAPES)
def test_k4_int32_vote_body(cuda, nb, bsz, hb, rt, mw, k):
    """K4's int32 kind on the band body (a vote on every bit of a word):
    equal to its plain version and NumPy, with the float32 kind's chunk
    count; bell_spmm with the kit launches its mask body, bitwise the
    vote body's C."""
    a, ok, blocks64 = _int_bell(nb, bsz, hb, nb * k + bsz, cuda, empty=(2,))
    b = torch.from_numpy(_ints(np.random.default_rng(k), (a.n, k))).to(cuda)
    kit = tcb.bell_banded_prepare(a, row_tile=rt, max_window=mw,
                                  slot_valid=ok)
    assert kit.tiles.dtype == torch.int32
    got = _twice(lambda: pt.bell_spmm(a, b, plan=kit), "K4_KIT_LAUNCHES")
    assert torch.equal(got, tcb.bell_spmm_banded_plain(a, b, kit.plan,
                                                       tiles=kit.tiles))
    assert torch.equal(got, tcb.bell_spmm_banded(a, b, kit.plan,
                                                 tiles=kit.tiles))
    np.testing.assert_array_equal(_np(got), _int_spmm_want(a, blocks64, b))
    assert tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, bsz) == \
        _issued_model(kit.tiles, k)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("nb,bsz,k,values,hand_rt",
                         [c for c in K5_CASES if c[3] != "nan"])
def test_k5_int32_mask_body(cuda, nb, bsz, k, values, hand_rt, padded):
    """K5's int32 kind on the mask body, padded and unpadded operands,
    prepared and hand-built kits: equal to its plain version and NumPy,
    with its counts (operations and tile bytes at 4 bytes an element)."""
    a, ok, blocks64 = _int_bell(nb, bsz, 2, nb + k, cuda, values)
    b = torch.from_numpy(_ints(np.random.default_rng(k), (a.n, k))).to(cuda)
    kit = (_hand_kit_t(a, ok, hand_rt, 128, torch.int32) if hand_rt else
           tcb.bell_banded_prepare_t(a, max_window=128, slot_valid=ok))
    assert kit.tiles_t.dtype == torch.int32
    assert torch.equal(kit.chunk_nz, tcb.chunk_mask(kit.tiles_t))
    n_pad = kit.plan.offs.shape[0] * bsz
    bt = b.T.contiguous()
    if padded:
        bt = torch.cat([bt, bt.new_zeros(k, n_pad - a.n)], 1)
    got = _twice(lambda: tcb.bell_spmm_banded_t(a, bt, kit), "K5_LAUNCHES")
    assert got.shape == (k, n_pad if padded else a.n)
    assert torch.equal(got, tcb.bell_spmm_banded_t_plain(a, bt, kit))
    np.testing.assert_array_equal(_np(got[:, :a.n].T),
                                  _int_spmm_want(a, blocks64, b))
    assert tcb.banded_t_issued(a, bt, kit) == tcb.banded_t_issued_model(
        kit, k)


def test_bell_spmm_int32_routes_and_k8(cuda):
    """bell_spmm on an int32 BELL with no plan, a BandedKit and a
    BandedKitT launches K3, K4 (its mask body) and K5 once each, and
    dband_spmm K8, all
    equal to NumPy modulo 2^32; precision="bf16x3" raises for an int32
    stream on every route, launching nothing."""
    from sparse_tpu_torch.ops import cuda_dband as tdb

    nb, bsz, k, rt = 53, 16, 40, 5
    a, ok, blocks64 = _int_bell(nb, bsz, 2, 7, cuda, empty=(9,))
    b = torch.from_numpy(_ints(np.random.default_rng(8), (a.n, k))).to(cuda)
    want = _int_spmm_want(a, blocks64, b)
    kit = tcb.bell_banded_prepare(a, slot_valid=ok)
    kit_t = tcb.bell_banded_prepare_t(a, slot_valid=ok)
    for plan, counter in ((None, "K3_LAUNCHES"), (kit, "K4_KIT_LAUNCHES"),
                          (kit_t, "K5_LAUNCHES")):
        before = getattr(tcb, counter)
        got = pt.bell_spmm(a, b, plan=plan)
        torch.cuda.synchronize()
        assert getattr(tcb, counter) == before + 1
        np.testing.assert_array_equal(_np(got), want)
    plan = tcb.build_banded_plan(a, row_tile=rt, max_window=96,
                                 slot_valid=ok)
    tiles = tdb.densify_tiles(a, plan, torch.int32)
    b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(plan.W, bsz, k)])
    args = (tiles, plan.start, b3, nb, bsz, k, plan.W, rt, torch.int32)
    before = tdb.K8_LAUNCHES
    y1, y2 = tdb.dband_spmm(*args), tdb.dband_spmm(*args)
    torch.cuda.synchronize()
    assert tdb.K8_LAUNCHES == before + 2 and torch.equal(y1, y2)
    assert torch.equal(y1, tdb.dband_spmm_plain(*args))
    np.testing.assert_array_equal(_np(y1), want)
    counts = [getattr(tcb, f"K{i}_LAUNCHES") for i in (3, 4, 5, 6)]
    for call in (lambda: pt.bell_spmm(a, b, precision="bf16x3"),
                 lambda: pt.bell_spmm(a, b, plan=kit, precision="bf16x3"),
                 lambda: pt.bell_spmm(a, b, plan=kit_t, precision="bf16x3"),
                 lambda: tcb.bell_spmm_block(a, b, precision="bf16x3")):
        with pytest.raises(ValueError, match="bf16x3"):
            call()
    assert counts == [getattr(tcb, f"K{i}_LAUNCHES") for i in (3, 4, 5, 6)]


def _int_bsr(nb, bsz, density, seed, device, parity=None):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((nb, nb)) < density)
    if parity is not None and r.size % 2 != parity:
        r, c = r[:-1], c[:-1]
    blocks = torch.from_numpy(_ints(rng, (r.size, bsz, bsz)))
    return pt.BSR(indices=torch.from_numpy((r * nb + c).astype(
        np.int32)).to(device), blocks=blocks.to(device), n=nb * bsz,
                  bsz=bsz)


def _int_bsr_dense(a):
    nb = a.n // a.bsz
    x = np.zeros((a.n, a.n), np.int64)
    for i, blk in zip(_np(a.indices), _np(a.blocks)):
        r, c = divmod(int(i), nb)
        x[r * a.bsz:(r + 1) * a.bsz, c * a.bsz:(c + 1) * a.bsz] = blk
    return x


@pytest.mark.parametrize("route", ["prepared", "raw"])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("bsz,nb,density", [(8, 40, 0.12), (16, 25, 0.15),
                                            (32, 16, 0.2), (64, 9, 0.3),
                                            (6, 30, 0.15), (40, 10, 0.3)])
def test_k7_int32(cuda, bsz, nb, density, paired, route):
    """K7's int32 kind (the float32 team body, unsigned sums) on the
    prepared route (the plan's list, no pads) and the raw one (the slot
    tables, pads kept), bsz 6-64 (element copies at 6 and 40): twice,
    bitwise equal, equal to the list walk's plain version and to NumPy's
    A @ B modulo 2^32, with the kernel's product count."""
    a = _int_bsr(nb, bsz, density, nb + bsz, cuda, 1 if paired else None)
    b = _int_bsr(nb, bsz, density, 3 * nb, cuda)
    plan = pt.bsr_smsmm_prepare(a, b)
    pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, b.nbz, g=4 if paired else 3,
                                   p=8, paired=paired)
    dt = torch.int32
    if route == "prepared":
        ptr, ab, z1, z2 = pp.prod_ptr, pp.prod_ab, a.blocks, b.blocks
        got = _k7_twice(lambda: pt.bsr_smsmm_apply_slab(pp, a, b).blocks,
                        tbs.K7_LAUNCHES)
    else:
        ka = 2 + (a.nbz & 1) if paired else 1
        z1 = tbs._append_zero(a.blocks, dt, ka)
        z2 = tbs._append_zero(b.blocks, dt)
        args, kw = _slab_raw(pp, z1, z2, dt)
        got = _k7_twice(lambda: tbs.run_slabs_arrays(*args, **kw),
                        tbs.K7_LAUNCHES)
        assert torch.equal(got, tbs.run_slabs_arrays_plain(*args, **kw))
        ptr, ab = tbs.slot_list(pp.a_idx, pp.b_idx, pp.oloc, pp.slab_start,
                                g=pp.g, p=pp.p, nbz_out=pp.nbz_out,
                                paired=pp.paired)
    assert got.dtype == dt
    assert torch.equal(got, tbs.slab_list_plain(ptr, ab, z1, z2,
                                                out_dtype=dt))
    c = pt.BSR(indices=pp.indices, blocks=got, n=a.n, bsz=bsz)
    np.testing.assert_array_equal(
        _int_bsr_dense(c), _wrap32(_int_bsr_dense(a) @ _int_bsr_dense(b)))
    before = tbs.K7_LAUNCHES
    assert tbs.bsr_slab_issued(ptr, ab, z1, z2, out_dtype=dt) == \
        tbs.bsr_slab_issued_model(ptr)
    assert tbs.K7_LAUNCHES == before


# -- K2's folded view and K1-mxu's register-fed lane sum -----------------------


def _kind_csr(s, kind, rng, device):
    """``_kind_pair`` with float32 and float64 too: (CSR, v, SciPy's or
    NumPy's answer, |A||v| or None)."""
    if kind in KIND_DTYPE:
        return _kind_pair(s, kind, rng, device)
    dtype = {"float32": np.float32, "float64": np.float64}[kind]
    v = rng.standard_normal(s.shape[1]).astype(dtype)
    a = _csr(s, dtype, device)
    s64 = s.astype(np.float64)
    return a, torch.from_numpy(v).to(device), s64 @ v.astype(np.float64), \
        abs(s64) @ np.abs(v.astype(np.float64))


def _unfolded(plan, v):
    """The parent's blockseg apply: gather v through the block RCM, K2 on
    the plan's stream, gather y back."""
    ab, bp = plan.state
    vp = v.reshape(-1, 2)[plan.perm].reshape(-1)
    y = tpb.bsr_smvm_segtile_block(ab, vp, bp)
    return y.reshape(-1, 2)[plan.inv_perm].reshape(-1)


@pytest.mark.parametrize("kind", ["float32", "float64", "int32", "bf16"])
def test_k2_folded_apply_is_the_unfolded_apply(cuda, kind):
    """The blockseg apply over a block RCM is one K2 launch on the folded
    view, bitwise equal to the unfolded apply (gathers around K2), long
    block rows through their pieces and an empty block row included; so
    after a kernel-level refresh, which keeps both views in step."""
    rng = np.random.default_rng(61)
    s = _blocks(2000, 11, 900).tolil()
    s[10:12, :1200] = 1.25  # block row 5: 600 blocks
    s[20:22, :] = 0  # block row 10: empty
    s = s.tocsr()
    s.eliminate_zeros()
    a, v, want, mag = _kind_csr(s, kind, rng, cuda)
    plan = pt.smvm_prepare(a, prefer="blockseg")
    bp = plan.state[1]
    assert plan.perm is not None and bp.folded is not None
    assert bp.stream.n_long >= 1 and bp.stream.n_pieces >= 2
    before = tpb.K2_LAUNCHES
    y1, y2 = plan.apply(v), plan.apply(v)
    torch.cuda.synchronize()
    assert tpb.K2_LAUNCHES == before + 2
    assert torch.equal(_bits(y1), _bits(y2))
    assert torch.equal(_bits(y1), _bits(_unfolded(plan, v)))
    plain = tpb.block_stream_plain(bp.folded, v)
    if kind in KIND_DTYPE:
        _check_kind(y1, plain, want, mag, kind)
    else:
        dt = np.dtype(kind).type
        _assert_close(_np(y1), _np(plain), s, _np(v), dt)
        _assert_close(_np(y1), want, s, _np(v), dt)
    assert bool((y1[20:22] == 0).all())
    # a kernel-level refresh keeps the folded view in step
    ab = plan.state[0]
    rp = tpb.block_seg_tiles_fold(
        tpb.build_seg_tiles_block(ab, wsub=16, refreshable=True), plan.perm)
    new = (ab.blocks * 3 + 1) if kind == "int32" else ab.blocks * -1.5
    rp = tpb.block_seg_tiles_refresh(rp, new)
    ab2 = pt.BSR(indices=ab.indices, blocks=new, n=ab.n, bsz=2)
    p2 = dataclasses.replace(plan, state=(ab2, rp))
    assert torch.equal(_bits(p2.apply(v)), _bits(_unfolded(p2, v)))
    assert torch.equal(_bits(tpb.bsr_smvm_segtile_block(ab2, v, rp)),
                       _bits(tpb.bsr_smvm_segtile_block(
                           ab2, v, tpb.build_seg_tiles_block(ab2, wsub=16))))


def test_k2_folded_apply_under_vmap(cuda):
    """``torch.func.vmap`` over the blockseg apply launches K2 once a
    slice, each slice bitwise the single apply."""
    s = _blocks(1024, 3, 40)
    a = _csr(s, np.float32, cuda)
    plan = pt.smvm_prepare(a, prefer="blockseg")
    assert plan.state[1].folded is not None
    vs = torch.from_numpy(np.random.default_rng(62).standard_normal(
        (3, s.shape[0])).astype(np.float32)).to(cuda)
    before = tpb.K2_LAUNCHES
    ys = torch.func.vmap(plan.apply)(vs)
    torch.cuda.synchronize()
    assert tpb.K2_LAUNCHES == before + 3
    for i in range(3):
        assert torch.equal(_bits(ys[i]), _bits(plan.apply(vs[i])))
        assert torch.equal(_bits(ys[i]), _bits(_unfolded(plan, vs[i])))


def _mxu_rows(rng):
    """Rows of 0, 1, 7, 8, 9 and 20 entries in turn over 3000 rows of 5000
    columns and rows of 129, 700 and 3000 entries (past long_min:
    pieces)."""
    n, m = 3000, 5000
    lens = np.array([0, 1, 7, 8, 9, 20])[np.arange(n) % 6]
    lens[[40, 1500, 2998]] = (129, 700, 3000)
    rows = np.repeat(np.arange(n), lens)
    cols = np.concatenate([np.sort(rng.choice(m, k, replace=False))
                           for k in lens])
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(n, m))


@pytest.mark.parametrize("kind", ["float32", "bf16", "float64"])
@pytest.mark.parametrize("rows", [8, 32])
def test_k1_mxu_register_fed_sum(cuda, rows, kind):
    """K1-mxu's tensor-core lane sum against its plain version on 8- and
    32-row plans: every row length of a step (0, 1, 7, 8, 9, 20 entries),
    long rows, a NaN in A that reaches its row's sum and no other; two
    runs bitwise equal, one launch a call."""
    rng = np.random.default_rng(63 + rows)
    s = _mxu_rows(rng)
    a, v, want, mag = _kind_csr(s, kind, rng, cuda)
    data = a.data.clone()
    data[s.indptr[101] + 3] = float("nan")  # a NaN stored in row 101
    a = dataclasses.replace(a, data=data)
    plan = tpc.build_seg_tiles(a, wsub=32, rows=rows)
    assert plan.stream.n_long >= 3
    before = tpc.K1_MXU_LAUNCHES
    y1 = tpc.csr_smvm_segtile(a, v, plan, reduce="mxu")
    y2 = tpc.csr_smvm_segtile(a, v, plan, reduce="mxu")
    torch.cuda.synchronize()
    assert tpc.K1_MXU_LAUNCHES == before + 2
    assert torch.equal(_bits(y1), _bits(y2))
    plain = tpc.segtile_stream_plain(plan.stream, v)
    nan = np.zeros(s.shape[0], bool)
    nan[101] = True
    assert bool(torch.isnan(y1[101])) and bool(torch.isnan(plain[101]))
    assert not bool(torch.isnan(y1[torch.from_numpy(~nan).to(cuda)]).any())
    ok = ~nan
    if kind == "bf16":
        _check_kind(y1[torch.from_numpy(ok).to(cuda)],
                    plain[torch.from_numpy(ok).to(cuda)], want[ok], mag[ok],
                    kind)
    else:
        dt = np.dtype(kind).type
        _assert_close(_np(y1)[ok], _np(plain)[ok], s[ok], _np(v), dt)
        _assert_close(_np(y1)[ok], want[ok], s[ok], _np(v), dt)
    empty = np.flatnonzero(np.diff(s.indptr) == 0)
    assert bool((y1[torch.from_numpy(empty).to(cuda)] == 0).all())


def _k1_f64_rows(rng):
    """3000 rows of 5000 columns in float64: ~20 band entries a row, with
    empty rows (some in a run), one-entry rows, rows of exactly 256 and 257
    entries (the stream's long_min at lane group 8, and one past it: the
    pieces), rows of odd lengths so the next segment starts mid-unit, and
    a last row of 7 entries."""
    n, m = 3000, 5000
    lens = rng.integers(14, 27, n)
    lens[[5, 6, 7, 900, 2997]] = 0
    lens[[100, 101, 1234]] = 1
    lens[[300, 301]] = (256, 257)
    lens[[102, 103, 104]] = (3, 5, 9)
    lens[-1] = 7
    rows = np.repeat(np.arange(n), lens)
    cols = np.concatenate([
        np.sort(rng.choice(m, k, replace=False)) if k > 200 else
        np.sort(np.clip(i + rng.choice(np.arange(-600, 600), k,
                                       replace=False), 0, m - 1))
        for i, k in enumerate(lens)])
    s = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, m))
    s.sum_duplicates()
    return s


@pytest.mark.parametrize("rows", [8, 32])
def test_k1_float64_row_kernel_edges(cuda, rows):
    """K1 / K1-r32 in float64 (the row kernel at two rows a lane group)
    against the plain version and SciPy at 1e-12 (|A||v|): empty rows,
    one-entry rows, rows of long_min and long_min + 1 entries, segments
    starting mid-unit, the last row; two runs bitwise equal, one launch a
    call; the kernel's geometry read from the runtime."""
    rng = np.random.default_rng(230 + rows)
    s = _k1_f64_rows(rng)
    a = _csr(s, np.float64, cuda)
    plan = tpc.build_seg_tiles(a, wsub=32, rows=rows)
    st = plan.stream
    assert st.group == 8 and st.long_min == 256
    lens = np.diff(s.indptr)
    assert (lens == 256).any() and (lens == 257).any() and st.n_long >= 1
    assert int(st.long_rows.max()) == 301  # 257 entries: long; 256: short
    v = rng.standard_normal(5000)
    vt = torch.from_numpy(v).to(cuda)
    name = "K1_R32_LAUNCHES" if rows == 32 else "K1_LAUNCHES"
    before = getattr(tpc, name)
    y1 = tpc.csr_smvm_segtile(a, vt, plan)
    y2 = tpc.csr_smvm_segtile(a, vt, plan)
    torch.cuda.synchronize()
    assert getattr(tpc, name) == before + 2
    assert torch.equal(y1, y2)
    _assert_close(_np(y1), _np(tpc.segtile_stream_plain(st, vt)), s, v,
                  np.float64)
    _assert_close(_np(y1), s @ v, s, v, np.float64)
    empty = torch.from_numpy(np.flatnonzero(lens == 0)).to(cuda)
    assert bool((y1[empty] == 0).all())
    geo = tpc.k1_geometry(torch.float64, st.group)
    assert geo["rows_per_group"] == 2 and geo["blocks_per_sm"] >= 1
    assert tpc.k1_geometry(torch.float32, st.group)["rows_per_group"] == 4


def _k1_bf16_rows(rng):
    """3000 rows of 40,000 columns in bf16: ~20 band entries a row within
    +-600 of column 12 i, rows 700-1099 scattered over all the columns,
    empty rows (a run of them), one-entry rows, rows of 256 entries
    (long_min at lane group 8) and 257 (long: the pieces), odd lengths that
    start the next row mid-unit, a last row of 7."""
    n, m = 3000, 40_000
    lens = rng.integers(14, 27, n)
    lens[[5, 6, 7, 2100, 2996]] = 0
    lens[[100, 101, 1500]] = 1
    lens[[300, 301]] = (256, 257)
    lens[[102, 103, 104]] = (3, 5, 9)
    lens[-1] = 7
    cols = [np.sort(rng.choice(m, k, replace=False)) if k == 257
            or 700 <= i < 1100 else
            np.sort(np.clip(12 * i + rng.choice(np.arange(-600, 600), k,
                                                replace=False), 0, m - 1))
            for i, k in enumerate(lens)]
    return sp.csr_matrix((np.ones(lens.sum()), (np.repeat(np.arange(n), lens),
                                                np.concatenate(cols))),
                         shape=(n, m))


def _pow2_ints(rng, size):
    """Small integers times powers of two, exact in bf16, with exact
    float32 products and sums over a few hundred of them."""
    k = rng.integers(1, 9, size) * rng.choice([-1, 1], size)
    return (k * 2.0 ** rng.integers(-2, 1, size)).astype(np.float32)


@pytest.mark.parametrize("values", ["exact", "random"])
@pytest.mark.parametrize("rows", [8, 32])
def test_k1_bf16_row_kernel_edges(cuda, rows, values):
    """K1 / K1-r32 in bf16 (the row kernel on 32-bit entry offsets, one
    wave of resident blocks) at the row lengths it treats apart: exact sums
    (values and operand small integers times powers of two) bitwise the
    plain version's, random values within 2^-8 (|A||v|) of SciPy; an
    operand view off 16-byte alignment gives the same bits; two runs
    bitwise equal, one launch a call; the kernel's geometry and its split
    of the launch from the runtime."""
    rng = np.random.default_rng(240 + rows)
    s = _k1_bf16_rows(rng)
    n, m = s.shape
    lens = np.diff(s.indptr)
    if values == "exact":
        x, vh = _pow2_ints(rng, s.nnz), _pow2_ints(rng, m)
    else:
        x = rng.standard_normal(s.nnz).astype(np.float32)
        vh = rng.standard_normal(m).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    vb = torch.from_numpy(vh).to(torch.bfloat16)
    s64 = sp.csr_matrix((xb.double().numpy(), s.indices, s.indptr),
                        shape=s.shape)
    v64 = vb.double().numpy()
    a = interop.csr_from_arrays(xb.float().numpy(), s.indices, s.indptr,
                                s.shape, device=cuda)
    a = dataclasses.replace(a, data=a.data.to(torch.bfloat16))
    plan = tpc.build_seg_tiles(a, wsub=32, rows=rows)
    st = plan.stream
    assert st.vals.dtype == torch.bfloat16
    assert st.group == 8 and st.long_min == 256
    assert (lens == 256).any() and int(st.long_rows.max()) == 301
    v = vb.to(cuda)
    buf = torch.zeros(m + 8, dtype=torch.bfloat16, device=cuda)
    odd = buf[3:3 + m]  # six bytes off 16-byte alignment
    odd.copy_(vb)
    assert odd.data_ptr() % 16 == 6
    name = "K1_R32_LAUNCHES" if rows == 32 else "K1_LAUNCHES"
    ys = []
    for op in (v, odd):
        before = getattr(tpc, name)
        y1 = tpc.csr_smvm_segtile(a, op, plan)
        y2 = tpc.csr_smvm_segtile(a, op, plan)
        torch.cuda.synchronize()
        assert getattr(tpc, name) == before + 2
        assert torch.equal(_bits(y1), _bits(y2))
        plain = tpc.segtile_stream_plain(st, op)
        if values == "exact":
            assert torch.equal(_bits(y1), _bits(plain))
        _check_kind(y1, plain, s64 @ v64, abs(s64) @ np.abs(v64), "bf16")
        empty = torch.from_numpy(np.flatnonzero(lens == 0)).to(cuda)
        assert not bool(y1[empty].any())
        ys.append(y1)
    assert torch.equal(_bits(ys[0]), _bits(ys[1]))
    geo = tpc.k1_geometry(torch.bfloat16, st.group, n)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert geo["rows_per_group"] == 2 and geo["local_bytes"] == 0
    assert geo["registers"] <= 40 and geo["blocks_per_sm"] >= 6
    chunks = -(-n // 64)  # 256 threads, 8 lanes a row, 2 rows a group
    assert geo["row_blocks"] == chunks <= geo["blocks_per_sm"] * sms
    assert geo["chunks_per_block"] == 1
    big = tpc.k1_geometry(torch.bfloat16, st.group, 500_000)
    assert big["row_blocks"] <= big["blocks_per_sm"] * sms
    assert big["row_blocks"] * big["chunks_per_block"] >= -(-500_000 // 64)


def _k7_list(nb_out, n_blocks, rng, device):
    """A product list over ``n_blocks`` stored blocks with outputs of no,
    one and many (40) products: (prod_ptr, prod_ab) int32 on ``device``."""
    counts = np.array([0, 1, 3, 0, 40, 1, 0, 2])[np.arange(nb_out) % 8]
    ptr = np.r_[0, np.cumsum(counts)].astype(np.int32)
    ab = rng.integers(0, n_blocks, (int(ptr[-1]), 2)).astype(np.int32)
    return (torch.from_numpy(ptr).to(device),
            torch.from_numpy(ab).contiguous().to(device))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bsz", [1, 8, 16, 20, 32, 33, 64])
def test_k7_float64_dmma_body(cuda, bsz, aligned):
    """K7 in float64 (bsz 16-64 on the m16n8k8 DMMA body with a three-stage
    ring of k-slices, bsz 1-8 on the FMA tile) on a hand-built list:
    outputs of no product (+0, every bit), one and 40 products, against
    the list walk's plain version at 1e-12 (|z1||z2|), two runs bitwise
    equal, the kernel's product count equal to the model; misaligned
    factors take the element copies; the geometry the runtime reports."""
    rng = np.random.default_rng(bsz + 7 * aligned)
    n_blocks, nb_out = 30, 24
    ptr, ab = _k7_list(nb_out, n_blocks, rng, cuda)
    buf = torch.from_numpy(rng.standard_normal(
        (2, n_blocks * bsz * bsz + 1))).to(cuda)
    off = 0 if aligned else 1  # one float64 off 16-byte alignment
    z1 = buf[0, off:off + n_blocks * bsz * bsz].view(n_blocks, bsz, bsz)
    z2 = buf[1, off:off + n_blocks * bsz * bsz].view(n_blocks, bsz, bsz)
    assert (z1.data_ptr() % 16 == 0) == aligned
    before = tbs.K7_LAUNCHES
    y1 = tbs._launch_list("K7", ptr, ab, z1, z2, bsz, torch.float64)
    y2 = tbs._launch_list("K7", ptr, ab, z1, z2, bsz, torch.float64)
    torch.cuda.synchronize()
    assert tbs.K7_LAUNCHES == before + 2
    assert torch.equal(y1, y2)
    _check_list(y1, ptr, ab, z1, z2, torch.float64)
    empty = torch.diff(ptr) == 0
    assert not bool(torch.signbit(y1[empty]).any())
    geo = tbs.slab_geometry(torch.float64, bsz)
    dmma = bsz > 8
    assert (geo["body"] == "float64 m16n8k8 dmma") == dmma
    assert geo["stages"] == 3
    assert geo["k_slice"] == (16 if dmma else 8)  # bsz <= 8: a whole product
    if 16 < bsz <= 32:
        assert geo["blocks_per_sm"] >= 2  # 24 KB a one-warp team


# K7's float32, bf16 and int32 kinds: (dtype, blocks an SM at least at
# bsz 17-32).  Their ring is three stages of whole products, each refilled
# before the multiply of the stage after it (a ring of 16-wide k-slices ran
# slower in all three)
K7_KINDS = {"f32": (torch.float32, 2), "bf16": (torch.bfloat16, 3),
            "i32": (torch.int32, 2)}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bsz", [16, 32, 40, 64])
@pytest.mark.parametrize("kind", list(K7_KINDS))
def test_k7_team_ring(cuda, kind, bsz, aligned):
    """K7's float32, bf16 and int32 kinds on a hand-built list: outputs of
    no product (+0, every bit), one and 40 products; two runs bitwise
    equal; against the list walk's plain version at the kind's tolerance
    (int32 exactly, sums modulo 2^32); the kernel's product count equal to
    ``prod_ptr[-1]``; misaligned factors (and bsz 40) take the element
    copies; the geometry the runtime reports (three stages of whole
    products; no local (spilled) bytes)."""
    dt, per_sm = K7_KINDS[kind]
    rng = np.random.default_rng(bsz + 11 * aligned)
    n_blocks, nb_out = 30, 24
    ptr, ab = _k7_list(nb_out, n_blocks, rng, cuda)
    size = n_blocks * bsz * bsz
    vals = rng.integers(-8, 9, (2, size + 8)) if dt == torch.int32 else \
        rng.standard_normal((2, size + 8))
    buf = torch.from_numpy(vals).to(dt).to(cuda)
    off = 0 if aligned else 1  # one element off 16-byte alignment
    z1 = buf[0, off:off + size].view(n_blocks, bsz, bsz)
    z2 = buf[1, off:off + size].view(n_blocks, bsz, bsz)
    assert (z1.data_ptr() % 16 == 0) == aligned
    before = tbs.K7_LAUNCHES
    y1 = tbs._launch_list("K7", ptr, ab, z1, z2, bsz, dt)
    y2 = tbs._launch_list("K7", ptr, ab, z1, z2, bsz, dt)
    torch.cuda.synchronize()
    assert tbs.K7_LAUNCHES == before + 2
    assert torch.equal(y1, y2)
    empty = torch.diff(ptr) == 0
    if dt == torch.int32:
        assert torch.equal(y1, tbs.slab_list_plain(ptr, ab, z1, z2,
                                                   out_dtype=dt))
        assert not y1[empty].any()
        assert tbs.bsr_slab_issued(ptr, ab, z1, z2, out_dtype=dt) == \
            tbs.bsr_slab_issued_model(ptr) == int(ptr[-1])
        assert tbs.K7_LAUNCHES == before + 2
    else:
        _check_list(y1, ptr, ab, z1, z2, dt)
        assert not bool(torch.signbit(y1[empty]).any())
    geo = tbs.slab_geometry(dt, bsz)
    assert geo["body"] == ("bf16 mma.sync" if kind == "bf16" else "fma tile")
    assert geo["k_slice"] == (16 if bsz <= 16 else 32 if bsz <= 32 else 64)
    assert geo["stages"] == 3
    assert geo["local_bytes"] == 0 and geo["pieces"] == 8
    if 16 < bsz <= 32:
        assert geo["blocks_per_sm"] >= per_sm and geo["teams"] == 4


# -- K4 on a kit: the mask body -----------------------------------------------
#
# bell_spmm(plan=kit) runs K4's mask body on the kit's chunk mask
# (BandedKit.chunk_nz): it copies and multiplies the chunks the mask marks
# only, which are the chunks the vote body keeps, in the same order.  So
# its C is bitwise the vote body's on the same tiles (the tiles route,
# bell_spmm_banded(..., tiles=kit.tiles)) and its issued count the vote
# body's model, in every kind, at the vote body's shapes (K4_SHAPES, K4_K:
# ragged row blocks, element copies, K not a multiple of 32 where W*bsz is
# not).

KIT_TIERS = ["f32", "bf16", "bf16x3", "f64", "i32"]


def _kit_operands(cuda, nb, bsz, hb, seed, k, tier, empty=(2,)):
    """(BELL, operand, slot_valid, compute dtype, precision) of a block
    band in ``tier`` (``"i32"``: an int32 band and operand)."""
    if tier == "i32":
        a, ok, _ = _int_bell(nb, bsz, hb, seed, cuda, empty=empty)
        b = torch.from_numpy(_ints(np.random.default_rng(k), (a.n, k)))
        return a, b.to(cuda), ok, None, None
    dt, cd, prec = TIERS[tier]
    a, ok = _band_bell(nb, bsz, hb, seed, dt, cuda, empty=empty)
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    return a, b, ok, cd, prec


def _kit_is_the_vote(a, b, kit, prec):
    """The kit route twice (bitwise, K4_KIT_LAUNCHES), equal bit for bit to
    the vote body on the kit's tiles, its count the vote body's model;
    returns C."""
    before = tcb.K4_LAUNCHES
    got = _twice(lambda: pt.bell_spmm(a, b, plan=kit, precision=prec),
                 "K4_KIT_LAUNCHES")
    assert tcb.K4_LAUNCHES == before  # the vote body did not run
    vote = tcb.bell_spmm_banded(a, b, kit.plan, tiles=kit.tiles,
                                compute_dtype=kit.tiles.dtype,
                                precision=prec)
    assert torch.equal(_bits(got), _bits(vote))
    k = b.shape[1]
    counted = tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, a.bsz,
                                      precision=prec, mask=kit.chunk_nz)
    assert counted == tcb.banded_issued_model(kit.tiles, k) == \
        tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, a.bsz,
                                precision=prec)
    return got


@pytest.mark.parametrize("tier", KIT_TIERS)
@pytest.mark.parametrize("k", K4_K)
@pytest.mark.parametrize("nb,bsz,hb,rt,mw", K4_SHAPES)
def test_k4_kit_route_is_the_vote_route(cuda, nb, bsz, hb, rt, mw, k, tier):
    a, b, ok, cd, prec = _kit_operands(cuda, nb, bsz, hb, nb * k + bsz, k,
                                       tier)
    kit = tcb.bell_banded_prepare(a, row_tile=rt, max_window=mw,
                                  compute_dtype=cd, slot_valid=ok)
    assert torch.equal(kit.chunk_nz, tcb._nonzero_chunks(
        kit.tiles, 32, 32).to(torch.uint8))
    assert 0 < int(kit.chunk_nz.sum()) < kit.chunk_nz.numel()
    got = _kit_is_the_vote(a, b, kit, prec)
    if tier != "i32":
        dt = TIERS[tier][0]
        _check_spmm(got, tcb.bell_spmm_banded_plain(
            a, b, kit.plan, tiles=kit.tiles, compute_dtype=kit.tiles.dtype,
            precision=prec), _spmm_bound(a, b, kit.tiles.dtype), dt)
    else:
        assert torch.equal(got, tcb.bell_spmm_banded_plain(
            a, b, kit.plan, tiles=kit.tiles))


def _fill_chunks(t, where):
    """Write into the all-zero tiles ``t`` (4, 64, 128 at bsz 32, rt 2):
    no chunk, one element in one chunk, the last row and column of a chunk
    in two tiles, every chunk, or a NaN beside a value."""
    if where == "one":
        t[1, 37, 70] = 1.5
    elif where == "edges":
        t[2, 31, 63] = -2.0
        t[3, 63, 95] = 0.75
    elif where == "all":
        t.copy_(torch.from_numpy(np.random.default_rng(3).standard_normal(
            tuple(t.shape))).to(t.dtype))
    elif where == "nan":
        t[0, 5, 40] = float("nan")
        t[0, 5, 41] = 1.0
        t[1, 40, 3] = 2.0
    elif where == "half":  # chunk 1 of tile 0's first 32 rows, not its next
        t[0, 3, 40] = 1.5
        t[0, 40, 100] = 2.0


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16,
                                    torch.float64])
@pytest.mark.parametrize("where", ["none", "one", "edges", "all", "nan",
                                   "half"])
def test_k4_kit_mask_edges(cuda, where, stream, shift):
    """Hand-built kits whose masks mark no chunk (every row a zero), one,
    two at a chunk's last row and column, all of them, a NaN's chunk, and
    a chunk marked in one 32-row block of a tile's 64 rows but not in the
    other, with an Inf in B opposite it (``half``: the marked block's rows
    are not finite in that column, the other block's are); ``shift`` puts
    the operand one element off 16 bytes, so the mask body copies element
    by element.  Each is bitwise the vote body and counts one 32 x 32 x 128
    chunk for each marked one."""
    a, b, plan, tiles = _sparse_tiles_case(cuda, stream,
                                           lambda t: _fill_chunks(t, where))
    b = _shifted(b.to(stream), "shift" if shift else "band")
    b_ref = b
    if where == "half":  # Inf opposite chunk 1 of tile 0, column 7
        b = _shifted(b.clone(), "shift" if shift else "band")
        b[int(plan.start[0]) * 32 + 32 + 5, 7] = float("inf")
    kit = tcb.BandedKit(plan=plan, tiles=tiles)
    marked = int(kit.chunk_nz.sum())
    assert marked == {"none": 0, "one": 1, "edges": 2, "all": 4 * 2 * 4,
                      "nan": 2, "half": 2}[where]
    got = _kit_is_the_vote(a, b, kit, None)
    if where == "half":
        assert not bool(torch.isfinite(got[:32, 7]).any())
        assert bool(torch.isfinite(got[32:, 7]).all())
        got = torch.cat([got[:, :7], got[:, 8:]], 1)
        b = torch.cat([b_ref[:, :7], b_ref[:, 8:]], 1)
    assert tcb.banded_issued_flops(tiles, plan.start, b, 32,
                                   mask=kit.chunk_nz) == \
        marked * 2 * 32 * 32 * 128
    if where == "none":
        assert not bool(got.any())
    if where == "nan":
        assert torch.isnan(got[5]).all()
    want = tcb.bell_spmm_banded_plain(a, b, plan, tiles=tiles,
                                      compute_dtype=stream)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    bound = tcb.bell_spmm_banded_plain(a, b.abs(), plan, tiles=tiles.abs(),
                                       compute_dtype=stream)
    _check_spmm(got[ok], want[ok], bound[ok],
                torch.float64 if stream == torch.float64 else torch.float32)


@pytest.mark.parametrize("tier", KIT_TIERS)
def test_k4_kit_refresh_and_vmap(cuda, tier):
    """A refreshed kit carries its new tiles' mask: a chunk that turns to
    zero (block row 4's blocks) and one that turns non-zero (the empty row
    2's stored slots) move in the mask, and the kit route stays bitwise the
    vote body on the new tiles.  Under ``torch.func.vmap`` over three
    operands the kit route launches once a slice, each bitwise one call."""
    a, b, ok, cd, prec = _kit_operands(cuda, 20, 32, 1, 11, 40, tier,
                                       empty=())
    blocks = a.blocks.clone()
    blocks[2] = 0
    a0 = BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=a.bsz)
    kit = tcb.bell_banded_prepare(a0, row_tile=2, compute_dtype=cd,
                                  slot_valid=ok)
    _kit_is_the_vote(a0, b, kit, prec)
    blocks = a.blocks.clone()
    blocks[4] = 0
    a1 = BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=a.bsz)
    fresh = tcb.bell_banded_refresh(kit, a1)
    assert torch.equal(fresh.chunk_nz, tcb._nonzero_chunks(
        fresh.tiles, 32, 32).to(torch.uint8))
    # rt 2 at bsz 32: block row r is row block r % 2 of tile r // 2
    assert not bool(kit.chunk_nz[1, 0].any()) and bool(
        fresh.chunk_nz[1, 0].any())
    assert bool(kit.chunk_nz[2, 0].any()) and not bool(
        fresh.chunk_nz[2, 0].any())
    got = _kit_is_the_vote(a1, b, fresh, prec)
    bs = torch.stack([b, 2 * b, -b])
    before = tcb.K4_KIT_LAUNCHES
    ys = torch.func.vmap(lambda x: pt.bell_spmm(a1, x, plan=fresh,
                                                precision=prec))(bs)
    torch.cuda.synchronize()
    assert tcb.K4_KIT_LAUNCHES == before + 3
    assert torch.equal(_bits(ys[0]), _bits(got))
    for i in (1, 2):
        assert torch.equal(_bits(ys[i]), _bits(pt.bell_spmm(
            a1, bs[i], plan=fresh, precision=prec)))


def _narrow_plan(a, ok, W):
    """A one-row-tile plan whose window is ``W`` panels, so the tiles' K =
    W*bsz need not be a multiple of 32 (the planner rounds W to 128
    lanes): each row's first stored column, its window start clamped into
    [0, nb - W]."""
    cols = a.cols.cpu().numpy().astype(np.int64)
    first = np.where(ok.any(1), cols[:, 0], 0)
    start = np.minimum(first, a.nb - W)

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(a.cols.device)

    return tcb.BandedPlan(offs=i32(first - start), start=i32(start),
                          rel=i32(np.zeros(a.nb)), sup=i32(start), W=W,
                          rt=1, S=1, SW=W)


@pytest.mark.parametrize("tier", KIT_TIERS)
@pytest.mark.parametrize("bsz,k", [(24, 40), (13, 40), (24, 1)])
def test_k4_kit_k_not_a_multiple_of_32(cuda, bsz, k, tier):
    """Hand-built kits on a window of 3 panels: K = 72 (chunks of 32, 32
    and 8 indices; 16-byte copies) or 39 (32 and 7; element copies), one
    32-row block of bsz rows; an empty row (no marked chunk).  Bitwise the
    vote body, its count the model, within the plain version's bound."""
    a, b, ok, cd, prec = _kit_operands(cuda, 30, bsz, 1, bsz + k, k, tier,
                                       empty=(7,))
    plan = _narrow_plan(a, ok, 3)
    tiles = tcb._densify_band_tiles(a, plan, cd or a.dtype)
    kit = tcb.BandedKit(plan=plan, tiles=tiles)
    assert kit.chunk_nz.shape == (30, 1, -(-3 * bsz // 32))
    assert not bool(kit.chunk_nz[7].any()) and bool(
        kit.chunk_nz[:, 0, -1].any())
    got = _kit_is_the_vote(a, b, kit, prec)
    want = tcb.bell_spmm_banded_plain(a, b, plan, tiles=tiles,
                                      compute_dtype=tiles.dtype,
                                      precision=prec)
    if tier == "i32":
        assert torch.equal(got, want)
    else:
        _check_spmm(got, want, _spmm_bound(a, b, tiles.dtype),
                    TIERS[tier][0])
    assert not bool(got[7 * bsz:8 * bsz].any())


def test_k4_kit_refuses_a_mask_that_does_not_fit(cuda):
    """A mask of another shape, dtype or device than the tiles' raises
    before any launch: no route gives way to the vote body or the plain
    version."""
    a, ok = _band_bell(16, 32, 1, 0, torch.float32, cuda)
    b = torch.ones(a.n, 8, device=cuda)
    kit = tcb.bell_banded_prepare(a, row_tile=2, slot_valid=ok)
    m = kit.chunk_nz
    counts = (tcb.K4_LAUNCHES, tcb.K4_KIT_LAUNCHES)
    for bad in (m[:, :, :-1].contiguous(), m.to(torch.int32), m.cpu(),
                m.bool()):
        hand = tcb.BandedKit(plan=kit.plan, tiles=kit.tiles)
        object.__setattr__(hand, "chunk_nz", bad)
        with pytest.raises(ValueError, match="chunk mask"):
            pt.bell_spmm(a, b, plan=hand)
        with pytest.raises(ValueError, match="chunk mask"):
            tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, 32,
                                    mask=bad)
    assert (tcb.K4_LAUNCHES, tcb.K4_KIT_LAUNCHES) == counts


# K3's grid: the kinds that walk their tiles (bf16, bf16x3, float64:
# band::run_tiles) take at most the thread blocks resident at once
# (fused_geometry's grid), each walking its tiles with one ring that runs
# across them; float32 and int32 take a thread block a tile.  Every kind at
# bsz 3 and 20 (ragged 32-row blocks; a 32-index chunk spans blocks), 32 (a
# chunk is a block), 33, 64 (two row blocks), 100 (four, the last ragged)
# and k 1, 31 (element copies), 128, 129 and 200 (a ragged column block):
# one block row of one slot (Lb 1, one tile), then a band of Lb 5 holding
# more than twice as many tiles as resident blocks, with two block rows of
# zero blocks only and, in the float kinds, a NaN stored in A, then that
# band against an operand one element off a 16-byte boundary (element
# copies).
WALK_KINDS = ["f32", "f64", "bf16", "bf16x3", "i32"]


def _walk_case(cuda, nb, hb, bsz, k, kind):
    """(BELL, operand, its empty block rows) for ``_walk``'s cases."""
    empty = (nb // 4, 3 * nb // 4) if nb > 4 else ()
    if kind == "i32":
        a, _, _ = _int_bell(nb, bsz, hb, nb + k, cuda, empty=empty)
        b = torch.from_numpy(_ints(np.random.default_rng(k), (a.n, k)))
        return a, b.to(cuda), empty
    dt = TIERS[kind][0]
    a, _ = _band_bell(nb, bsz, hb, nb + k, dt, cuda, empty=empty)
    if nb > 4:  # a NaN in block row nb // 2, which holds data
        a.blocks[nb // 2, 1, bsz // 2, 0] = float("nan")
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).to(dt).to(cuda)
    return a, b, empty


@pytest.mark.parametrize("k", [1, 31, 128, 129, 200])
@pytest.mark.parametrize("bsz", [3, 20, 32, 33, 64, 100])
@pytest.mark.parametrize("kind", WALK_KINDS)
def test_k3_tiles_on_its_grid(cuda, kind, bsz, k):
    """K3 twice, bitwise equal and launched each time, on its grid (the
    walking kinds on at most the resident blocks); within its kind's gate
    of the plain version (int32: equal), NaN exactly where the plain
    version has it, zero rows of zero blocks exactly zero; the issued count
    equal to its host model."""
    cd, prec = (None, None) if kind == "i32" else TIERS[kind][1:]
    dt = torch.int32 if kind == "i32" else TIERS[kind][0]
    stream = cd or dt
    per_row = -(-bsz // 32) * -(-k // 128)
    geo = tcb.fused_geometry(1, 5, bsz, k, stream, prec)
    assert geo["walks"] == (kind in ("bf16", "bf16x3", "f64"))
    resident = geo["blocks_per_sm"] * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    nb_big = (2 * resident + 3) // per_row + 1
    for nb, hb, shift in ((1, 0, False), (nb_big, 2, False),
                          (nb_big, 2, True)):
        a, b, empty = _walk_case(cuda, nb, hb, bsz, k, kind)
        b = _shifted(b, "shift" if shift else "band")
        geo = tcb.fused_geometry(nb, a.Lb, bsz, k, stream, prec)
        assert geo["tiles"] == nb * per_row
        if geo["walks"]:
            assert geo["grid"] == min(geo["tiles"], resident)
            assert nb == 1 or geo["tiles"] > 2 * geo["grid"]
        else:
            assert geo["grid"] == geo["tiles"]
        kw = dict(compute_dtype=cd, precision=prec)
        got = _twice(lambda: tcb.bell_spmm_fused(a, b, **kw), "K3_LAUNCHES")
        want = tcb.bell_spmm_fused_plain(a, b, **kw)
        if kind == "i32":
            assert torch.equal(got, want)
        else:
            _check_values(got, want, _spmm_bound(a, b, stream), dt,
                          "nan" if nb > 4 else "band")
        for r in empty:
            assert not bool(got[r * bsz:(r + 1) * bsz].any())
        assert tcb.fused_issued_flops(a, b, **kw) == \
            tcb.fused_issued_model(a, k, compute_dtype=stream)


# The band body's float64 kind on Hopper's m16n8k8 DMMA, K8 and both K4
# routes (the vote on raw tiles, the chunk mask on a kit) at K4_SHAPES'
# ragged rows (bsz 3, 13, 24, 33: part of a 16-row tile past M) and k 31 /
# 129 (a ragged 32-column piece and column block, element copies).
@pytest.mark.parametrize("k", [31, 129])
@pytest.mark.parametrize("nb,bsz,hb,rt,mw", K4_SHAPES)
def test_band_body_float64_on_m16n8k8(cuda, nb, bsz, hb, rt, mw, k):
    """K4's vote route against its plain version within 1e-12 |A||B|, its
    kit route bitwise the vote's with the vote's count, and K8 on the same
    plan and tiles bitwise the vote's and within the gate of its plain
    version, each twice, bitwise equal."""
    from sparse_tpu_torch.ops import cuda_dband as tdb

    f64 = torch.float64
    a, b, ok, _, _ = _kit_operands(cuda, nb, bsz, hb, nb * k + bsz, k, "f64")
    kit = tcb.bell_banded_prepare(a, row_tile=rt, max_window=mw,
                                  slot_valid=ok)
    plan, bound = kit.plan, _spmm_bound(a, b, f64)
    kw = dict(tiles=kit.tiles, compute_dtype=f64)
    vote = _twice(lambda: tcb.bell_spmm_banded(a, b, plan, **kw),
                  "K4_LAUNCHES")
    _check_spmm(vote, tcb.bell_spmm_banded_plain(a, b, plan, **kw), bound,
                f64)
    assert tcb.banded_issued_flops(kit.tiles, plan.start, b, bsz) == \
        _issued_model(kit.tiles, k)
    assert torch.equal(_bits(_kit_is_the_vote(a, b, kit, None)), _bits(vote))
    b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(plan.W, bsz, k)])
    args = (kit.tiles, plan.start, b3, nb, bsz, k, plan.W, plan.rt, f64)
    before = tdb.K8_LAUNCHES
    y1, y2 = tdb.dband_spmm(*args), tdb.dband_spmm(*args)
    torch.cuda.synchronize()
    assert tdb.K8_LAUNCHES == before + 2
    # K8 is the vote body on the same tiles: zero panels past the operand
    # where K4 reads zeros
    assert torch.equal(_bits(y1), _bits(y2)) and torch.equal(_bits(y1),
                                                             _bits(vote))
    _check_spmm(y1, tdb.dband_spmm_plain(*args), bound, f64)


# K4's and K8's float32 kernels at each number of 32-row blocks a tile can
# hold: M = rt * bsz of 32, 64, 96 and 160 (one to five blocks; 160 is
# bench.py's rt 5 at bsz 32) and 72 (bsz 24, rt 3: the last block
# ragged); k 40 (16-byte copies, a column block partly past N) and 200 (two
# column blocks, the second ragged); the operand aligned or one element
# off 16 bytes (element copies).
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("k", [40, 200])
@pytest.mark.parametrize("bsz,rt", [(32, 1), (32, 2), (32, 3), (32, 5),
                                    (24, 3)])
def test_k4_k8_float32_row_blocks(cuda, bsz, rt, k, shift):
    """The vote route within 1e-5 |A||B| of its plain version, its count
    the model; the kit route bitwise the vote's, with the same count; K8 on
    the kit's plan and tiles bitwise the vote's; each twice, bitwise
    equal."""
    from sparse_tpu_torch.ops import cuda_dband as tdb

    f32, how = torch.float32, "shift" if shift else "band"
    nb = 6 * rt + 7  # not a multiple of rt > 1; at least the window
    a, ok = _band_bell(nb, bsz, 2, nb + k, f32, cuda, empty=(2,))
    b = _shifted(torch.from_numpy(np.random.default_rng(k).standard_normal(
        (a.n, k))).float().to(cuda), how)
    kit = tcb.bell_banded_prepare(a, row_tile=rt, slot_valid=ok)
    assert kit is not None and kit.tiles.shape[1] == rt * bsz
    plan = kit.plan
    kw = dict(tiles=kit.tiles, compute_dtype=f32)
    vote = _twice(lambda: tcb.bell_spmm_banded(a, b, plan, **kw),
                  "K4_LAUNCHES")
    _check_spmm(vote, tcb.bell_spmm_banded_plain(a, b, plan, **kw),
                _spmm_bound(a, b, f32), f32)
    assert tcb.banded_issued_flops(kit.tiles, plan.start, b, bsz) == \
        tcb.banded_issued_model(kit.tiles, k) == _issued_model(kit.tiles, k)
    assert torch.equal(_bits(_kit_is_the_vote(a, b, kit, None)), _bits(vote))
    b3 = _shifted(torch.cat([b.reshape(nb, bsz, k),
                             b.new_zeros(plan.W, bsz, k)]), how)
    args = (kit.tiles, plan.start, b3, nb, bsz, k, plan.W, plan.rt, f32)
    before = tdb.K8_LAUNCHES
    y1, y2 = tdb.dband_spmm(*args), tdb.dband_spmm(*args)
    torch.cuda.synchronize()
    assert tdb.K8_LAUNCHES == before + 2
    assert torch.equal(_bits(y1), _bits(y2)) and torch.equal(_bits(y1),
                                                             _bits(vote))


@pytest.mark.parametrize("bsz", [24, 13])
def test_k8_float32_k_not_a_multiple_of_32(cuda, bsz):
    """K8 on a hand-built plan whose window is 3 panels (K = 72: chunks of
    32, 32 and 8; or 39: 32 and 7, element copies), a 32-row block of bsz
    rows a tile, an empty row: bitwise K4's vote route on the same tiles,
    within the gate of its plain version, its count the model."""
    from sparse_tpu_torch.ops import cuda_dband as tdb

    f32, nb, k = torch.float32, 30, 40
    a, ok = _band_bell(nb, bsz, 1, bsz + k, f32, cuda, empty=(7,))
    b = torch.from_numpy(np.random.default_rng(bsz).standard_normal(
        (a.n, k))).float().to(cuda)
    plan = _narrow_plan(a, ok, 3)
    tiles = tcb._densify_band_tiles(a, plan, f32)
    assert tiles.shape[2] % 32
    vote = _twice(lambda: tcb.bell_spmm_banded(a, b, plan, tiles=tiles),
                  "K4_LAUNCHES")
    b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(plan.W, bsz, k)])
    args = (tiles, plan.start, b3, nb, bsz, k, plan.W, plan.rt, f32)
    before = tdb.K8_LAUNCHES
    y1, y2 = tdb.dband_spmm(*args), tdb.dband_spmm(*args)
    torch.cuda.synchronize()
    assert tdb.K8_LAUNCHES == before + 2
    assert torch.equal(_bits(y1), _bits(y2)) and torch.equal(_bits(y1),
                                                             _bits(vote))
    _check_spmm(y1, tdb.dband_spmm_plain(*args), _spmm_bound(a, b, f32), f32)
    assert tcb.banded_issued_flops(tiles, plan.start, b3.reshape(-1, k),
                                   bsz) == tcb.banded_issued_model(tiles, k)
    assert not bool(y1[7 * bsz:8 * bsz].any())


def test_k4_k8_float32_a_sum_of_negative_zeros(cuda):
    """A row whose products all round to -0 (1e-30 against -1e-30 in one
    kept chunk) sums to -0 on the vote route, the kit route and K8: each
    output's sum starts at +0 and adds its products one at a time, so
    fmaf's first rounding gives -0 and the rest keep it.  The plain
    version gives 0; every other output is within its gate."""
    from sparse_tpu_torch.ops import cuda_dband as tdb

    def fill(t):  # tile 1, row 40 (its second 32-row block), chunk 1
        t[1, 40, 32:64] = 1e-30

    f32 = torch.float32
    a, b, plan, tiles = _sparse_tiles_case(cuda, f32, fill)
    w1 = int(plan.start[1]) * 32  # tile 1's window in the operand
    b[w1 + 32:w1 + 64, 3] = -1e-30
    kit = tcb.BandedKit(plan=plan, tiles=tiles)
    got = _kit_is_the_vote(a, b, kit, None)
    r = 64 + 40
    assert float(got[r, 3]) == 0.0 and bool(torch.signbit(got[r, 3]))
    want = tcb.bell_spmm_banded_plain(a, b, plan, tiles=tiles)
    assert float(want[r, 3]) == 0.0
    bound = tcb.bell_spmm_banded_plain(a, b.abs(), plan, tiles=tiles.abs())
    _check_spmm(got, want, bound, f32)
    nb, k = a.nb, b.shape[1]
    b3 = torch.cat([b.reshape(nb, 32, k), b.new_zeros(plan.W, 32, k)])
    y = tdb.dband_spmm(tiles, plan.start, b3, nb, 32, k, plan.W, plan.rt, f32)
    assert torch.equal(_bits(y), _bits(got))
