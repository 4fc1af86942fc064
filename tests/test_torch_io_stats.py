"""Matrix Market I/O, the roofline model, timing and the default device of
the PyTorch port against the reference (``sparse_tpu/io``,
``sparse_tpu/utils/stats.py``).

Files are read by both packages and compared entry for entry; the stats
functions are compared at the same ceiling argument (the two packages' own
ceilings differ: the port's is the H100's data sheet).  Everything here
builds on the CPU with ``device="cpu"``; without it the port builds on the
card, which this file checks raises on a machine without one.
"""

import dataclasses
from dataclasses import asdict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.formats import bell as jbell
from sparse_tpu.io import fastmm as j_fastmm
from sparse_tpu.io import mm_read as j_mm_read
from sparse_tpu.io import mm_read_coo as j_mm_read_coo
from sparse_tpu.utils import stats as jstats
from sparse_tpu_torch import interop
from sparse_tpu_torch._device import resolve_device
from sparse_tpu_torch.formats import bell as tbell
from sparse_tpu_torch.io import fastmm, mm_read, mm_read_coo, mm_write
from sparse_tpu_torch.utils import profiling
from sparse_tpu_torch.utils import stats as tstats

MATRICES = sorted((Path(__file__).resolve().parents[1] / "benchmarks"
                   / "matrices").glob("*.mtx"))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_csr(t, j):
    assert t.shape == j.shape
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_three_fixture_files_are_there():
    assert [p.name for p in MATRICES] == [
        "fem_elasticity_6k.mtx", "fem_poisson_8k.mtx",
        "graph_powerlaw_10k.mtx"]


@pytest.mark.parametrize("path", MATRICES, ids=lambda p: p.stem)
def test_mm_read_matches_reference(path):
    tc, jc = mm_read_coo(path, device="cpu"), j_mm_read_coo(path)
    assert tc.shape == jc.shape and tc.dtype == torch.float64
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    _same_csr(mm_read(path, device="cpu"), j_mm_read(path))
    f32 = mm_read(path, dtype=np.float32, device="cpu")
    assert f32.dtype == torch.float32
    _same_csr(f32, j_mm_read(path, dtype=np.float32))
    assert mm_read(path, dtype=torch.float32, device="cpu").dtype == \
        torch.float32


def test_mm_write_round_trip_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5)) * (rng.random((7, 5)) < 0.4)
    a = pt.csr_from_dense(torch.from_numpy(x), device="cpu")
    p = tmp_path / "a.mtx"
    mm_write(p, a, comment="round trip\nsecond line")
    np.testing.assert_allclose(_np(mm_read(p, device="cpu").todense()), x,
                               rtol=1e-15)
    np.testing.assert_allclose(np.asarray(st.csr_todense(j_mm_read(p))), x,
                               rtol=1e-15)
    np.testing.assert_allclose(scipy.io.mmread(p).toarray(), x, rtol=1e-15)
    # the reference writes the same file from the same matrix
    q = tmp_path / "b.mtx"
    from sparse_tpu.io import mm_write as j_mm_write

    j_mm_write(q, st.csr_from_dense(jnp.asarray(x)),
               comment="round trip\nsecond line")
    assert p.read_text() == q.read_text()
    # integer values and COO input
    coo = pt.coo_make((2, 2), [0, 1], [1, 0], np.array([5, -3]),
                      device="cpu")
    mm_write(tmp_path / "i.mtx", coo)
    assert "integer" in (tmp_path / "i.mtx").read_text().splitlines()[0]
    _same_csr(mm_read(tmp_path / "i.mtx", device="cpu"),
              j_mm_read(tmp_path / "i.mtx"))
    with pytest.raises(TypeError):
        mm_write(tmp_path / "x.mtx", x)


@pytest.mark.parametrize("kind", ["symmetric", "skew-symmetric", "array",
                                  "pattern", "bad"])
def test_other_formats_match_reference(tmp_path, kind):
    rng = np.random.default_rng(1)
    p = tmp_path / "m.mtx"
    if kind in ("symmetric", "skew-symmetric"):
        x = rng.standard_normal((6, 6)) * (rng.random((6, 6)) < 0.5)
        x = (np.tril(x) + np.tril(x, -1).T if kind == "symmetric"
             else np.tril(x, -1) - np.tril(x, -1).T)
        scipy.io.mmwrite(p, sp.coo_matrix(x), symmetry=kind)
    elif kind == "array":
        scipy.io.mmwrite(p, rng.standard_normal((4, 3)))
    elif kind == "pattern":
        p.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                     "3 3 2\n1 2\n3 1\n")
    else:
        p.write_text("not a matrix\n1 1 0\n")
        with pytest.raises(ValueError):
            mm_read_coo(p, device="cpu")
        return
    tc, jc = mm_read_coo(p, device="cpu"), j_mm_read_coo(p)
    np.testing.assert_array_equal(_np(pt.coo_todense(tc)),
                                  np.asarray(st.coo_todense(jc)))


def test_native_parser_agrees_with_numpy():
    body = b"% comment inside body\n1 2 -3.5\n3 1 2e-3\n2 2 7\n"
    out = fastmm.parse_coordinate(body, 3, False)
    if out is None:
        pytest.skip("no native toolchain (g++) on this host")
    rows, cols, vals = out
    np.testing.assert_array_equal(rows, [0, 2, 1])
    np.testing.assert_array_equal(cols, [1, 0, 1])
    np.testing.assert_allclose(vals, [-3.5, 2e-3, 7.0])
    with pytest.raises(ValueError):
        fastmm.parse_coordinate(b"1 junk\n", 1, False)


@pytest.mark.parametrize("path", MATRICES, ids=lambda p: p.stem)
def test_stats_match_reference(path):
    ta, ja = mm_read(path, dtype=np.float32, device="cpu"), j_mm_read(
        path, dtype=np.float32)
    assert str(tstats.matrix_stats(ta)) == str(jstats.matrix_stats(ja))
    assert asdict(tstats.matrix_stats(ta)) == asdict(
        jstats.matrix_stats(ja))
    for k in (1, 8):
        assert tstats.spmv_bytes(ta, k) == jstats.spmv_bytes(ja, k)
        assert tstats.csr_min_bytes(ta, k) == jstats.csr_min_bytes(ja, k)
    assert tstats.roofline_report(ta, 1e-4, hbm_gbps=3350.0) == \
        jstats.roofline_report(ja, 1e-4, hbm_gbps=3350.0)
    assert tstats.roofline_report(ta, 2e-3, k=4) == \
        jstats.roofline_report(ja, 2e-3, k=4)
    assert tstats.detect_block_size(ta, (8, 4, 2), 0.5) == \
        jstats.detect_block_size(ja, (8, 4, 2), 0.5)


def test_roofline_model_matches_reference():
    mb = 5 * 4 + 3 * 4 + 4 * 4
    assert tstats.blocked_min_bytes(7, 2, 10, k=3) == \
        jstats.blocked_min_bytes(7, 2, 10, k=3)
    assert tstats.blocked_min_bytes(7, 2, 10, operand_entries=4) == \
        jstats.blocked_min_bytes(7, 2, 10, operand_entries=4)
    for kw in (dict(), dict(plan_bytes=4 * mb, seconds=1e-6),
               dict(plan_bytes=4 * mb, issue_s=1e-5, seconds=2e-5),
               dict(k=8, seconds=3e-6)):
        for gbps in (207.0, 3350.0):
            assert tstats.nnz_roofline(5, min_bytes=mb, hbm_gbps=gbps,
                                       **kw) == \
                jstats.nnz_roofline(5, min_bytes=mb, hbm_gbps=gbps, **kw)
    # the port's defaults are the H100's data sheet at 700 W
    assert tstats.HBM_CEILING_GBPS == 3350.0
    assert tstats.F32_PEAK_TFLOPS == 67.0
    assert tstats.nnz_roofline(5, min_bytes=mb) == jstats.nnz_roofline(
        5, min_bytes=mb, hbm_gbps=3350.0)


@pytest.mark.parametrize("path", MATRICES, ids=lambda p: p.stem)
def test_csr_bound_bytes_counts_the_pattern(path):
    # values and column indices of every entry, the row pointers, each
    # distinct operand entry once, the output once: counted from SciPy
    s = scipy.io.mmread(path).tocsr()
    ta = mm_read(path, dtype=np.float32, device="cpu")
    n, nse = s.shape[0], s.nnz
    for k in (1, 8):
        want = (nse * (4 + 4) + (n + 1) * 4
                + np.unique(s.indices).size * k * 4 + n * k * 4)
        assert tstats.csr_bound_bytes(ta, k) == want
        assert tstats.csr_bound_bytes(ta, k) == tstats.csr_min_bytes(
            ta, k) + nse * 4 + (n + 1) * 4


def test_blocked_bound_bytes_and_kernel_bound():
    # 7 stored 2x2 blocks of a 10-row BSR, k = 3
    vals, ops_in, out = 7 * 2 * 2 * 4, 10 * 3 * 4, 10 * 3 * 4
    assert tstats.blocked_bound_bytes(7, 2, 10, k=3) == \
        vals + ops_in + out + 7 * 4
    assert tstats.blocked_bound_bytes(7, 2, 10, k=3, row_pointers=True) == \
        vals + ops_in + out + 7 * 4 + 6 * 4
    # a bf16 stream with a float32 output
    assert tstats.blocked_bound_bytes(7, 2, 10, k=3, value_bytes=2) == \
        vals // 2 + ops_in // 2 + out + 7 * 4
    # the larger of bytes / 3.35 TB/s and ops / the type's peak binds
    t, by = tstats.kernel_bound_s(3.35e9, 1e9)
    assert (by, t) == ("bytes", pytest.approx(1e-3))
    t, by = tstats.kernel_bound_s(1.0, 67e9)
    assert (by, t) == ("operations", pytest.approx(1e-3))
    t, by = tstats.kernel_bound_s(1.0, 989e9, torch.bfloat16)
    assert (by, t) == ("operations", pytest.approx(1e-3))
    assert tstats.kernel_bound_s(1.0, 67e9, hbm_gbps=1e-9)[1] == "bytes"


def test_bell_stats_matches_reference():
    rng = np.random.default_rng(13)
    nb, bsz, Lb = 4, 4, 3
    cols = np.sort(rng.integers(0, nb, (nb, Lb)), axis=1).astype(np.int32)
    blocks = rng.standard_normal((nb, Lb, bsz, bsz)).astype(np.float32)
    blocks[np.abs(blocks) < 0.3] = 0.0
    blocks[1, 2] = 0.0  # an ELL padding slot
    tb = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    jb = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=nb * bsz, bsz=bsz)
    assert asdict(tstats.bell_stats(tb)) == asdict(jstats.bell_stats(jb))
    assert str(tstats.bell_stats(tb)) == str(jstats.bell_stats(jb))


@pytest.mark.parametrize("body,count", [
    (b"1.5\n2.5 3.5\n", 3),  # the reference's case, tests/test_io_stats.py
    (b"% a comment line\n-1e-3\t4\r\n% another\n7.25 8\n", 4),
    (b"1 2 3 4 5\n", 3),
])
def test_parse_array_matches_reference(body, count):
    got, want = fastmm.parse_array(body, count), j_fastmm.parse_array(body,
                                                                      count)
    if got is None or want is None:
        pytest.skip("no native toolchain (g++) on this host")
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_parse_array_refuses_a_short_body_as_the_reference():
    if fastmm.parse_array(b"1\n", 1) is None:
        pytest.skip("no native toolchain (g++) on this host")
    for parse in (fastmm.parse_array, j_fastmm.parse_array):
        with pytest.raises(ValueError, match="parsed 1 of 3"):
            parse(b"1.5 junk 2\n2.5\n", 3)


@pytest.mark.parametrize("nb,bsz,Lb", [(4, 4, 3), (7, 32, 5), (1, 2, 1)])
def test_bell_smvm_hbm_bytes_matches_reference(nb, bsz, Lb):
    """float32 BELLs move the reference's bytes; other value widths scale
    the value terms (blocks, operand chunks, output), not the int32 ids."""
    rng = np.random.default_rng(nb * bsz)
    cols = np.sort(rng.integers(0, nb, (nb, Lb)), axis=1).astype(np.int32)
    blocks = rng.standard_normal((nb, Lb, bsz, bsz)).astype(np.float32)
    jb = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=nb * bsz, bsz=bsz)
    want = jbell.bell_smvm_hbm_bytes(jb)
    for dt, w in ((np.float32, 4), (np.float64, 8), ("bf16", 2)):
        tb = interop.bell_from_arrays(
            cols, blocks.astype(np.float32 if dt == "bf16" else dt),
            nb * bsz, bsz, device="cpu")
        if dt == "bf16":
            tb = dataclasses.replace(tb, blocks=tb.blocks.to(torch.bfloat16))
        slots = nb * Lb
        assert tbell.bell_smvm_hbm_bytes(tb) == want + (w - 4) * (
            slots * (bsz * bsz + bsz) + nb * bsz)


def test_timed_op_times_the_card_only():
    with pytest.raises(ValueError, match="CUDA"):
        profiling.timed_op(lambda v: v * 2, torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        profiling.timed_op(lambda v: v * 2, np.ones(4))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr") as prof:
        torch.ones(64).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert prof.key_averages() is not None


def test_resolve_device_order():
    cpu = torch.zeros(1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(None, [1], cpu) == torch.device("cpu")
    assert resolve_device("cuda:1", cpu) == torch.device("cuda:1")
    assert resolve_device(None, np.zeros(2)) == torch.device("cuda")


_DEFAULT_BUILDS = {
    "csr_from_triples": lambda p: pt.csr_from_triples(
        2, 3, [(0, 0, 2), (1, 2, 3)]),
    "coo_make": lambda p: pt.coo_make((2, 3), np.array([0, 1]),
                                      np.array([0, 2]), np.array([2., 3.])),
    "coo_from_dense": lambda p: pt.coo_from_dense(np.eye(3)),
    "csr_empty": lambda p: pt.csr_empty(3, 3),
    "bsr_zero": lambda p: pt.bsr_zero(4, 2),
    "csr_from_arrays": lambda p: interop.csr_from_arrays(
        [2.0, 3.0], [0, 2], [0, 1, 2], (2, 3)),
    "mm_read": lambda p: mm_read(p),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_BUILDS))
def test_default_device_is_the_card(name):
    """With no ``device=`` a constructor fed host data builds on CUDA: on a
    machine without a card that raises (no quiet fall back to the CPU); on
    one with a card the result lies there."""
    build = _DEFAULT_BUILDS[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py checks the "
                    "result lies on it")
    with pytest.raises((AssertionError, RuntimeError),
                       match="CUDA|NVIDIA|cuda"):
        build(MATRICES[0])
