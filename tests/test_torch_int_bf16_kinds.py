"""The int32 and bf16 kinds of the port's kernel routes against the
reference's kernels (Pallas in interpret mode) on the CPU.

The reference's kernels take int32 values (K1-K7) and bf16 values (K1,
K2); the port's routes compute them too: on CPU tensors through each
kernel's plain version, on the card through the hand-written kinds
(``tests/test_torch_cuda.py``).  Inputs are numpy-seeded and handed to
both packages.  Gates:

- int32: exact.  Both packages equal NumPy's int64 product taken modulo
  2^32, with cases whose sums (and products) overflow int32.
- bf16 SpMV (K1, K2): the port sums bf16 products in float32 and rounds
  once, so it is within ``2^-8 (|A||v|)_i`` of SciPy's float64 product of
  the bf16 inputs; the reference rounds products and partial sums to bf16,
  so it is within ``(L_i + 1) 2^-8 (|A||v|)_i``, ``L_i`` the stored entries
  of row i; the two packages agree within the sum of the two gates.
- Where the reference refuses an int32 case (``precision="bf16x3"`` on
  K3, K6 and its XLA route), the port refuses it too; where the reference
  computes it through bf16 (K4 and K5 with ``precision="bf16x3"``), the
  port still refuses, and the test pins that difference.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

import sparse_tpu as st
from sparse_tpu.formats import bell as jbell
from sparse_tpu.formats import bsr as jbsr
from sparse_tpu.ops import pallas_bell as jpb
from sparse_tpu.ops import pallas_bsr as jps
from sparse_tpu.ops import pallas_csr as jpc
from sparse_tpu.ops.dispatch import smvm_prepare as j_prepare
from sparse_tpu.ops.segmented import INDEX_DTYPE
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bell as tbell
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.formats.csr import CSR
from sparse_tpu_torch.ops import cuda_bell as tcb
from sparse_tpu_torch.ops import cuda_bsr as tbs
from sparse_tpu_torch.ops import cuda_csr as tpc
from sparse_tpu_torch.ops import cuda_dband as tdb
from sparse_tpu_torch.ops.dispatch import smvm_prepare

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "benchmarks"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import measure_dband as jdb  # noqa: E402  (imports bench from the root)

U = 2.0 ** -8  # bf16's unit roundoff


def _wrap(x):
    """int64 -> the int32 it wraps to (two's complement, modulo 2^32)."""
    x = np.asarray(x, np.int64)
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _ints(rng, shape, big):
    """int32 values: small ones, or (big) ones whose products and sums
    overflow int32."""
    hi = 2 ** 20 if big else 50
    x = rng.integers(-hi, hi, shape)
    return np.where(x == 0, 1, x).astype(np.int32)


# -- SpMV: K1 (segtile, hubsplit) and K2 (blockseg) -------------------------


def _band_pattern(n, seed, per_row=6, half=40):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), per_row)
    c = np.clip(r + rng.integers(-half, half + 1, r.size), 0, n - 1)
    s = sp.csr_matrix((np.ones(r.size), (r, c)), shape=(n, n))
    s.sum_duplicates()
    s.sort_indices()
    return s


def _block_pattern(nb, seed, per_row=4, bw=6):
    """A pattern of fully dense 2x2 blocks (the blockseg rung's)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((nb, nb), bool)
    for i in range(nb):
        mask[i, np.clip(i + rng.integers(-bw, bw + 1, per_row), 0,
                        nb - 1)] = True
    s = sp.csr_matrix(np.kron(mask, np.ones((2, 2))))
    s.sort_indices()
    return s


def _pattern(rung, seed):
    return _block_pattern(512, seed) if rung == "blockseg" \
        else _band_pattern(1536, seed)


def _csr_pair(s, data):
    """The CSR ``s`` with values ``data`` (int32, or a bf16 array) in both
    packages."""
    ja = st.CSR(data=jnp.asarray(data), indices=jnp.asarray(
        s.indices.astype(np.int32)), indptr=jnp.asarray(
        s.indptr.astype(np.int32)), shape=s.shape)
    ta = interop.csr_from_arrays(data, s.indices, s.indptr, s.shape,
                                 device="cpu")
    return ja, ta


def _bf16(x):
    """A float array rounded to bf16 (the reference's array, carrying the
    bits to the port), and its values in float64."""
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return xb, xb.astype(np.float64)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("rung", ["segtile", "blockseg", "hubsplit"])
def test_spmv_rungs_int32_exact(rung, big):
    """smvm_prepare(prefer=rung).apply on int32: the port, the reference and
    NumPy's int64 product modulo 2^32 agree exactly, overflow included."""
    s = _pattern(rung, 3)
    rng = np.random.default_rng(4)
    data = _ints(rng, s.nnz, big)
    v = _ints(rng, s.shape[1], big)
    ja, ta = _csr_pair(s, data)
    want = _wrap(sp.csr_matrix((data.astype(np.int64), s.indices, s.indptr),
                               shape=s.shape) @ v.astype(np.int64))
    if big:
        assert np.any(want != sp.csr_matrix(
            (data.astype(np.float64), s.indices, s.indptr),
            shape=s.shape) @ v.astype(np.float64))  # it did overflow
    plan = smvm_prepare(ta, prefer=rung)
    assert plan.kind == rung
    got = plan.apply(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jplan = j_prepare(ja, prefer=rung)
    assert jplan.kind == rung
    ref = np.asarray(jplan.apply(jnp.asarray(v)))
    assert ref.dtype == np.int32
    np.testing.assert_array_equal(ref, want)


def _bf16_gates(s, xv, vv, got, ref):
    """The bf16 gates of the module docstring, per row."""
    sa = sp.csr_matrix((np.abs(xv), s.indices, s.indptr), shape=s.shape)
    mag = sa @ np.abs(vv)
    exact = sp.csr_matrix((xv, s.indices, s.indptr), shape=s.shape) @ vv
    lens = np.diff(s.indptr)
    port_gate = U * mag
    ref_gate = (lens + 1) * U * mag
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert np.all(np.abs(got - exact) <= port_gate), \
        np.max(np.abs(got - exact) - port_gate)
    assert np.all(np.abs(ref - exact) <= ref_gate), \
        np.max(np.abs(ref - exact) - ref_gate)
    assert np.all(np.abs(got - ref) <= port_gate + ref_gate)


@pytest.mark.parametrize("rung", ["segtile", "blockseg", "hubsplit"])
def test_spmv_rungs_bf16_gates(rung):
    """smvm_prepare(prefer=rung).apply on bf16 values and operand: both
    packages return bf16, each within its gate of SciPy, and of each
    other."""
    s = _pattern(rung, 5)
    rng = np.random.default_rng(6)
    xb, xv = _bf16(rng.standard_normal(s.nnz) + 0.25)
    vb, vv = _bf16(rng.standard_normal(s.shape[1]))
    ja, ta = _csr_pair(s, xb)
    assert ta.dtype == torch.bfloat16
    plan = smvm_prepare(ta, prefer=rung)
    assert plan.kind == rung
    got = plan.apply(interop._t(vb, "cpu"))
    assert got.dtype == torch.bfloat16
    jplan = j_prepare(ja, prefer=rung)
    ref = jplan.apply(jnp.asarray(vb))
    assert ref.dtype == jnp.bfloat16
    _bf16_gates(s, xv, vv, got, ref)


@pytest.mark.parametrize("dtype", ["int32", "bfloat16"])
@pytest.mark.parametrize("rows,reduce", [(8, "vpu"), (32, "vpu"), (8, "mxu"),
                                         (32, "mxu")])
def test_k1_variants_int32_bf16(rows, reduce, dtype):
    """K1, K1-r32 and K1-mxu (``csr_smvm_segtile``) at both tile heights and
    reductions: int32 exact (overflowing), bf16 within the gates, against
    the reference's segtile kernel in interpret mode."""
    s = _band_pattern(1024, 7, per_row=9, half=300)
    rng = np.random.default_rng(8)
    if dtype == "int32":
        data, v = _ints(rng, s.nnz, True), _ints(rng, s.shape[1], True)
    else:
        data, xv = _bf16(rng.standard_normal(s.nnz))
        v, vv = _bf16(rng.standard_normal(s.shape[1]))
    ja, ta = _csr_pair(s, data)
    plan = tpc.build_seg_tiles(ta, wsub=16, rows=rows)
    jplan = jpc.build_seg_tiles(ja, wsub=16, rows=rows)
    got = tpc.csr_smvm_segtile(ta, interop._t(v, "cpu"), plan,
                               reduce=reduce)
    ref = jpc.csr_smvm_segtile(ja, jnp.asarray(v), jplan, reduce=reduce,
                               interpret=True)
    if dtype == "int32":
        want = _wrap(sp.csr_matrix((data.astype(np.int64), s.indices,
                                    s.indptr), shape=s.shape)
                     @ v.astype(np.int64))
        assert got.dtype == torch.int32 and np.asarray(ref).dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(ref), want)
    else:
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        _bf16_gates(s, xv, vv, got, ref)


def test_hub_split_int32_with_a_tail():
    """hub_split_smvm with a narrow hub strip (most entries in the
    row-binned tail), int32 overflowing: both packages exact."""
    from sparse_tpu.ops.hub_split import hub_split_prepare as j_hub
    from sparse_tpu.ops.hub_split import hub_split_smvm as j_hub_smvm
    from sparse_tpu_torch.ops.hub_split import (hub_split_prepare,
                                                hub_split_smvm)

    s = _band_pattern(1024, 9)
    rng = np.random.default_rng(10)
    data, v = _ints(rng, s.nnz, True), _ints(rng, s.shape[1], True)
    ja, ta = _csr_pair(s, data)
    want = _wrap(sp.csr_matrix((data.astype(np.int64), s.indices, s.indptr),
                               shape=s.shape) @ v.astype(np.int64))
    split = hub_split_prepare(ta, max_hub_cols=256)
    assert 0 < split.hub_nnz < split.tail_nnz
    got = hub_split_smvm(split, torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = j_hub_smvm(j_hub(ja, max_hub_cols=256), jnp.asarray(v),
                     interpret=True)
    np.testing.assert_array_equal(np.asarray(ref), want)


def test_plain_bf16_sums_in_float32():
    """The SpMV plain versions (the kernels' function) sum bf16 in float32
    and round once: a row whose bf16 running sum would lose its small
    entries (256 + 1 rounds back to 256) keeps them."""
    n = 260
    indptr = np.r_[0, np.full(n, 257)]
    data = np.r_[256.0, np.ones(256)].astype(np.float32)
    a = CSR(data=torch.from_numpy(data).to(torch.bfloat16),
            indices=torch.arange(257, dtype=torch.int32),
            indptr=torch.from_numpy(indptr), shape=(n, n))
    v = torch.ones(n, dtype=torch.bfloat16)
    y = tpc.segtile_stream_plain(tpc.build_seg_tiles(a).stream, v)
    assert y.dtype == torch.bfloat16 and float(y[0]) == 512.0
    blocks = tbsr.csr_to_bsr(a, 2)
    from sparse_tpu_torch.ops import cuda_csr_block as tpb

    y2 = tpb.block_stream_plain(tpb.build_seg_tiles_block(blocks).stream, v)
    assert y2.dtype == torch.bfloat16 and float(y2[0]) == 512.0


# -- BELL SpMM: K3, K4, K5, K6, K8 --------------------------------------------


def _bell_pair(nb, bsz, hb, seed, big):
    """A block band (edge rows padded with zero blocks at column 0) in both
    packages, int32; returns (dense int64, reference BELL, port BELL)."""
    rng = np.random.default_rng(seed)
    c = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (c >= 0) & (c < nb)
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols = np.where(ok, c, 0)[rows, order].astype(np.int32)
    ok = ok[rows, order]
    blocks = _ints(rng, (nb, 2 * hb + 1, bsz, bsz), big) * ok[
        :, :, None, None]
    x = np.zeros((nb * bsz, nb * bsz), np.int64)
    for r in range(nb):
        for j in np.flatnonzero(ok[r]):
            x[r * bsz:(r + 1) * bsz,
              cols[r, j] * bsz:(cols[r, j] + 1) * bsz] = blocks[r, j]
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=nb * bsz, bsz=bsz)
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    return x, ja, ta


def _bell_ref(route, ja, b):
    """The reference's kernel of ``route`` in interpret mode."""
    jb = jnp.asarray(b)
    if route == "fused":
        return jpb.bell_spmm_pallas_fused(ja, jb, interpret=True)
    if route == "block":
        return jpb.bell_spmm_pallas(ja, jb, interpret=True)
    if route == "kit":
        kit = jpb.bell_banded_prepare(ja)
        with pltpu.force_tpu_interpret_mode():
            return jbell.bell_spmm(ja, jb, plan=kit, prefer_pallas=True)
    kit_t = jpb.bell_banded_prepare_t(ja)
    return jpb.bell_spmm_pallas_banded_t(ja, jb.T, kit_t,
                                         interpret=True).T[:ja.n]


def _bell_port(route, ta, b):
    """The port's entry point of ``route`` (its plain version on CPU)."""
    tb = torch.from_numpy(b)
    if route == "fused":
        return tbell.bell_spmm(ta, tb, prefer_pallas=True)
    if route == "block":
        return tcb.bell_spmm_block(ta, tb)
    if route == "kit":
        plan = tcb.bell_banded_prepare(ta)
        assert plan.tiles.dtype == torch.int32
    else:
        plan = tcb.bell_banded_prepare_t(ta)
        assert plan.tiles_t.dtype == torch.int32
    return tbell.bell_spmm(ta, tb, plan=plan, prefer_pallas=True)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("bsz,nb,k", [(8, 40, 24), (32, 12, 64)])
@pytest.mark.parametrize("route", ["fused", "block", "kit", "kit_t"])
def test_bell_spmm_int32_exact(route, bsz, nb, k, big):
    """bell_spmm with no plan (K3), a BandedKit (K4) and a BandedKitT (K5),
    and bell_spmm_block (K6), on int32: the port, the reference's kernel in
    interpret mode and NumPy modulo 2^32 agree exactly, overflow
    included."""
    x, ja, ta = _bell_pair(nb, bsz, 2, nb + k, big)
    b = _ints(np.random.default_rng(k), (nb * bsz, k), big)
    want = _wrap(x @ b.astype(np.int64))
    got = _bell_port(route, ta, b)
    assert got.dtype == torch.int32 and got.shape == (nb * bsz, k)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(_bell_ref(route, ja, b))
    assert ref.dtype == np.int32
    np.testing.assert_array_equal(ref, want)


def test_bell_int32_default_route_and_gather_einsum():
    """On CPU tensors bell_spmm's default (the gather-einsum, as the
    reference's XLA route off-TPU) computes int32 exactly too."""
    x, ja, ta = _bell_pair(20, 8, 1, 1, True)
    b = _ints(np.random.default_rng(2), (160, 16), True)
    want = _wrap(x @ b.astype(np.int64))
    np.testing.assert_array_equal(
        tbell.bell_spmm(ta, torch.from_numpy(b)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jbell.bell_spmm(ja, jnp.asarray(b), prefer_pallas=False)),
        want)


def test_bell_int32_refuses_bf16x3_as_the_reference_does():
    """precision="bf16x3" on an int32 stream: the reference's K3, K6 and XLA
    route raise; the port raises on every route.  The reference's K4 and K5
    compute it through bf16 and return an inexact int32 result: the port
    differs from them there, and raises."""
    x, ja, ta = _bell_pair(24, 8, 2, 3, False)
    b = _ints(np.random.default_rng(4), (192, 16), False)
    want = _wrap(x @ b.astype(np.int64))
    jb = jnp.asarray(b)
    for call in (lambda: jpb.bell_spmm_pallas_fused(
                     ja, jb, precision="bf16x3", interpret=True),
                 lambda: jpb.bell_spmm_pallas(ja, jb, precision="bf16x3",
                                              interpret=True),
                 lambda: jbell.bell_spmm(ja, jb, prefer_pallas=False,
                                         precision="bf16x3")):
        with pytest.raises(ValueError, match="[Pp]recision"):
            call()
    jkit = jpb.bell_banded_prepare(ja)
    ref4 = np.asarray(jpb.bell_spmm_pallas_banded(
        ja, jb, jkit.plan, tiles=jkit.tiles, precision="bf16x3",
        interpret=True))
    jkit_t = jpb.bell_banded_prepare_t(ja)
    ref5 = np.asarray(jpb.bell_spmm_pallas_banded_t(
        ja, jb.T, jkit_t, precision="bf16x3", interpret=True)).T[:ja.n]
    for ref in (ref4, ref5):
        assert ref.dtype == np.int32 and not np.array_equal(ref, want)
    tb = torch.from_numpy(b)
    kit = tcb.bell_banded_prepare(ta)
    kit_t = tcb.bell_banded_prepare_t(ta)
    for call in (lambda: tbell.bell_spmm(ta, tb, precision="bf16x3"),
                 lambda: tcb.bell_spmm_fused(ta, tb, precision="bf16x3"),
                 lambda: tcb.bell_spmm_block(ta, tb, precision="bf16x3"),
                 lambda: tcb.bell_spmm_banded(ta, tb, kit.plan,
                                              tiles=kit.tiles,
                                              precision="bf16x3"),
                 lambda: tcb.bell_spmm_banded_t(ta, tb.T.contiguous(),
                                                kit_t, precision="bf16x3")):
        with pytest.raises(ValueError, match="bf16x3"):
            call()
    # "highest" is the int32 stream's own precision in both
    np.testing.assert_array_equal(
        tcb.bell_spmm_fused(ta, tb, precision="highest").numpy(), want)
    np.testing.assert_array_equal(np.asarray(jpb.bell_spmm_pallas_fused(
        ja, jb, precision="highest", interpret=True)), want)


@pytest.mark.parametrize("route", ["fused", "kit"])
def test_bell_int32_with_bf16_compute(route):
    """compute_dtype=bf16 on an int32 BELL: both packages compute it and
    return int32 (the reference rounds each partial product to bf16, the
    port sums bf16 products in float32), each within the bf16 gate of the
    exact product, (Lb + 1) 2^-8 |A||B| (integer parts of a float: +1)."""
    x, ja, ta = _bell_pair(24, 8, 2, 5, False)
    b = _ints(np.random.default_rng(6), (192, 16), False)
    want = x @ b.astype(np.int64)
    gate = (ta.Lb + 1) * U * (np.abs(x) @ np.abs(b).astype(np.int64)) + 1
    tb = torch.from_numpy(b)
    jb = jnp.asarray(b)
    if route == "fused":
        got = tcb.bell_spmm_fused(ta, tb, compute_dtype=torch.bfloat16)
        ref = jpb.bell_spmm_pallas_fused(ja, jb, compute_dtype=jnp.bfloat16,
                                         interpret=True)
    else:
        kit = tcb.bell_banded_prepare(ta, compute_dtype=torch.bfloat16)
        assert kit.tiles.dtype == torch.bfloat16
        got = tbell.bell_spmm(ta, tb, plan=kit, prefer_pallas=True)
        jkit = jpb.bell_banded_prepare(ja, compute_dtype=jnp.bfloat16)
        with pltpu.force_tpu_interpret_mode():
            ref = jbell.bell_spmm(ja, jb, plan=jkit, prefer_pallas=True)
    ref = np.asarray(ref)
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    for y in (got.numpy(), ref):
        assert np.all(np.abs(y.astype(np.int64) - want) <= gate)


@pytest.mark.parametrize("big", [False, True])
def test_k8_int32_exact(big):
    """The reference's dband_spmm computes int32 (interpret mode), so K8
    takes int32: the port's dband_spmm equals it and NumPy modulo 2^32."""
    nb, bsz, k, rt = 40, 8, 16, 5
    x, ja, ta = _bell_pair(nb, bsz, 2, 7, big)
    jplan = jpb.build_banded_plan(ja, row_tile=rt, max_window=96)
    tplan = tcb.build_banded_plan(ta, row_tile=rt, max_window=96)
    jt = jdb.densify_tiles(ja, jplan, jnp.int32)
    tt = tdb.densify_tiles(ta, tplan, torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    W = tplan.W
    b = _ints(np.random.default_rng(8), (nb * bsz, k), big)
    b3 = np.concatenate([b.reshape(nb, bsz, k), np.zeros((W, bsz, k),
                                                           np.int32)])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdb.dband_spmm(jt, jplan.start, jnp.asarray(b3), nb,
                                        bsz, k, W, rt, np.int32))
    got = tdb.dband_spmm(tt, tplan.start, torch.from_numpy(b3), nb, bsz, k,
                         W, rt, torch.int32)
    want = _wrap(x @ b.astype(np.int64))
    np.testing.assert_array_equal(ref, want)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int32_chunk_mask_counts_any_bit():
    """K5's chunk mask marks an int32 chunk that holds any non-zero
    value (every bit counts: an int has no -0)."""
    t = torch.zeros(1, 64, 64, dtype=torch.int32)
    t[0, 40, 3] = -2 ** 31
    t[0, 5, 60] = 1
    np.testing.assert_array_equal(tcb.chunk_mask(t)[0].numpy(),
                                  [[0, 1], [1, 0]])


# -- K7: the block-SpGEMM slab apply ------------------------------------------


def _bsr_pair(nb, bsz, density, seed, big):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((nb, nb)) < density)
    blocks = _ints(rng, (r.size, bsz, bsz), big)
    idx = (r * nb + c).astype(np.int32)
    ja = jbsr.BSR(indices=jnp.asarray(idx, INDEX_DTYPE),
                  blocks=jnp.asarray(blocks), n=nb * bsz, bsz=bsz)
    return ja, interop.bsr_from_arrays(idx, blocks, nb * bsz, bsz,
                                       device="cpu")


def _dense(a):
    x = np.zeros((a.n, a.n), np.int64)
    nb, bsz = a.n // a.bsz, a.bsz
    for i, blk in zip(np.asarray(a.indices), np.asarray(a.blocks)):
        r, c = divmod(int(i), nb)
        x[r * bsz:(r + 1) * bsz, c * bsz:(c + 1) * bsz] = blk
    return x


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("route", ["prepared", "raw"])
def test_k7_int32_exact(route, paired, big):
    """bsr_smsmm_apply_slab (the prepared route) and run_slabs_arrays (the
    raw one) on int32: equal to the reference's slab kernel in interpret
    mode and to NumPy's product modulo 2^32."""
    ja, ta = _bsr_pair(6, 8, 0.5, 11, big)
    jb, tb = _bsr_pair(6, 8, 0.5, 12, big)
    jp, tp = jbsr.bsr_smsmm_prepare(ja, jb), tbsr.bsr_smsmm_prepare(ta, tb)
    kw = dict(g=4, p=4, paired=paired)
    jpp = jps.bsr_smsmm_pallas_prepare(jp, ja.nbz, jb.nbz, **kw)
    tpp = tbs.bsr_smsmm_slab_prepare(tp, ta.nbz, tb.nbz, **kw)
    ref = jps.bsr_smsmm_apply_pallas(jpp, ja, jb, interpret=True)
    assert np.asarray(ref.blocks).dtype == np.int32
    if route == "prepared":
        got = tbs.bsr_smsmm_apply_slab(tpp, ta, tb).blocks
    else:
        ka = 2 + (ta.nbz & 1) if paired else 1
        got = tbs.run_slabs_arrays(
            tpp.a_idx, tpp.b_idx, tpp.oloc, tpp.first, tpp.slab,
            tbs._append_zero(ta.blocks, torch.int32, ka),
            tbs._append_zero(tb.blocks, torch.int32), chunks=tpp.chunks,
            bsz=8, g=tpp.g, p=tpp.p, nbz_out=tpp.nbz_out,
            out_dtype=torch.int32, paired=paired)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.blocks))
    c = tbsr.BSR(indices=tpp.indices, blocks=got, n=ta.n, bsz=8)
    np.testing.assert_array_equal(_dense(c), _wrap(_dense(ta) @ _dense(tb)))


def test_k7_int32_list_walk_plain():
    """The list walk's plain version (K7's function on the card) equals the
    slot-table one on int32, overflow included."""
    ja, ta = _bsr_pair(5, 16, 0.6, 13, True)
    tp = tbsr.bsr_smsmm_prepare(ta, ta)
    tpp = tbs.bsr_smsmm_slab_prepare(tp, ta.nbz, ta.nbz, g=3, p=4)
    got = tbs.slab_list_plain(tpp.prod_ptr, tpp.prod_ab, ta.blocks,
                              ta.blocks, out_dtype=torch.int32)
    np.testing.assert_array_equal(
        got.numpy(), tbs.bsr_smsmm_apply_slab(tpp, ta, ta).blocks.numpy())
