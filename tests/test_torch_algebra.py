"""The element-wise algebra of COO, CSR, CSC and BSR in the PyTorch port,
held against the reference.

The goldens of ``tests/test_csr.py`` and ``tests/test_bsr.py`` (the
reference's own compressed_test.fut / blocked_square_regular_test.fut
vectors) run through the port; the capacity contracts (``csr_add``
nse(a) + nse(b), ``bsr_add`` nbz(a) + nbz(b), ``bsr_mul`` nbz(a)), the
stored structure and the stored-zero nnz rule are compared with the
reference on the same numpy-seeded inputs, exactly; bf16 values bit for
bit.  Float64 values agree within 1e-12 (``rtol``) unless stated.  Every
port call runs on the CPU (``device="cpu"`` or CPU tensors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as jst
import sparse_tpu_torch as tst
from sparse_tpu_torch import interop

CPU = "cpu"
BSZ = 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _dense(a):
    return _np(a.todense())


def _bits_t(x):
    return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def _bits_j(x):
    return np.asarray(x).view(np.uint16)


def _rand_dense(n, m, density, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m)) * (rng.random((n, m)) < density)


def _pair_csr(x):
    """The reference's CSR of ``x`` and the same arrays in the port."""
    ja = jst.csr_from_dense(jnp.asarray(x))
    ta = interop.csr_from_arrays(ja.data, ja.indices, ja.indptr, ja.shape,
                                 device=CPU)
    return ja, ta


def _same_csr(t, j, rtol=1e-12):
    """Stored structure exactly, values to ``rtol``."""
    assert t.shape == j.shape and t.nse == j.nse
    np.testing.assert_array_equal(_np(t.indptr), np.asarray(j.indptr))
    np.testing.assert_array_equal(_np(t.indices), np.asarray(j.indices))
    np.testing.assert_allclose(_np(t.data), np.asarray(j.data), rtol=rtol,
                               atol=0)


# -- CSR / CSC goldens (tests/test_csr.py, compressed_test.fut) ---------------

_SHAPES = [(2, 2), (2, 3), (3, 2), (1, 3), (0, 0), (0, 1), (1, 0)]


@pytest.mark.parametrize("n,m", _SHAPES)
@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_eye(fmt, n, m):
    eye = tst.csr_eye if fmt == "csr" else tst.csc_eye
    out = _dense(eye(n, m, dtype=torch.int32, device=CPU))
    np.testing.assert_array_equal(out, np.eye(n, m, dtype=np.int32))


def test_nnz_stored_zero_rule():
    """compressed_test.fut:62-69: A - A keeps its entries stored, nnz 0."""
    a = tst.csr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=torch.int32,
                             device=CPU)
    assert int(tst.csr_nnz(a)) == 2 and int(a.nnz()) == 2
    d = tst.csr_sub(a, a)
    assert d.nse == 2 * a.nse and int(d.indptr[-1]) == 2
    assert int(tst.csr_nnz(d)) == 0
    np.testing.assert_array_equal(_dense(d), np.zeros((2, 3), np.int32))
    c = tst.csc_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=torch.int32,
                             device=CPU)
    assert int(tst.csc_nnz(c)) == 2 and int(tst.csc_nnz(c - c)) == 0


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_coo_compact_round_trip(fmt):
    """compressed_test.fut:72-78, 132-138."""
    build = tst.csr_from_triples if fmt == "csr" else tst.csc_from_triples
    a = build(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=torch.int32, device=CPU)
    c = tst.coo_compact(a.tocoo())
    np.testing.assert_array_equal(_np(c.row), [0, 1])
    np.testing.assert_array_equal(_np(c.col), [0, 2])
    np.testing.assert_array_equal(_np(c.data), [2, 3])


def test_diag_scale_vsmm():
    v = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    np.testing.assert_array_equal(_dense(tst.csr_diag(v)), np.diag([1, 2, 3]))
    np.testing.assert_array_equal(_dense(tst.csc_diag(v)), np.diag([1, 2, 3]))
    a = tst.csc_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)],
                             dtype=torch.float64, device=CPU)
    np.testing.assert_array_equal(_np(tst.csc_vsmm(
        torch.tensor([10.0, 100.0], dtype=torch.float64), a)),
        [20.0, 0.0, 300.0])
    np.testing.assert_array_equal(_dense(2.5 * a), 2.5 * _dense(a))
    np.testing.assert_array_equal(_dense(tst.csc_scale(-1, a)), -_dense(a))


# -- CSR / CSC / COO against the reference ------------------------------------


@pytest.mark.parametrize("n,m,seed", [(9, 7, 0), (16, 16, 1)])
def test_csr_add_sub_vs_reference(n, m, seed):
    """Structure exactly, capacity nse(a) + nse(b), values to 1e-12; the
    operators agree with the functions."""
    xa, xb = _rand_dense(n, m, 0.35, seed), _rand_dense(n, m, 0.35, seed + 50)
    xb[xa != 0] *= (np.arange((xa != 0).sum()) % 3 == 0)  # some overlaps
    ja, ta = _pair_csr(xa)
    jb, tb = _pair_csr(xb)
    for tf, jf in ((tst.csr_add, jst.csr_add), (tst.csr_sub, jst.csr_sub)):
        t, j = tf(ta, tb), jf(ja, jb)
        assert t.nse == ta.nse + tb.nse
        _same_csr(t, j)
        assert int(tst.csr_nnz(t)) == int(jst.csr_nnz(j))
    _same_csr(ta + tb, jst.csr_add(ja, jb))
    _same_csr(ta - tb, jst.csr_sub(ja, jb))
    _same_csr(tst.csr_scale(-2.5, ta), jst.csr_scale(-2.5, ja))
    np.testing.assert_array_equal(_np(tst.csr_diagonal(ta)),
                                  np.asarray(jst.csr_diagonal(ja)))
    # CSC through the transpose duality
    tc = tst.csc_add(ta.T.T.T, tb.T)
    jc = jst.csc_add(jst.csr_transpose(ja), jst.csr_transpose(jb))
    _same_csr(tst.csc_transpose(tc), jst.csc_transpose(jc))
    np.testing.assert_allclose(_dense(tst.csc_sub(ta.T, tb.T)),
                               (xa - xb).T, rtol=1e-12)


def test_csr_add_stored_zero_and_empty():
    """Cancellations stay stored; an empty operand adds its capacity."""
    a = tst.csr_from_triples(3, 3, [(0, 1, 2.0), (2, 2, -1.0)],
                             dtype=torch.float64, device=CPU)
    b = tst.csr_from_triples(3, 3, [(0, 1, -2.0)], dtype=torch.float64,
                             device=CPU)
    c = a + b
    assert c.nse == 3 and int(c.indptr[-1]) == 2 and int(c.nnz()) == 1
    np.testing.assert_array_equal(_np(c.data)[:2], [0.0, -1.0])
    e = tst.csr_empty(3, 3, nse=4, dtype=torch.float64, device=CPU)
    s = tst.csr_add(a, e)
    assert s.nse == a.nse + 4
    np.testing.assert_array_equal(_dense(s), _dense(a))
    with pytest.raises(ValueError, match="shape mismatch"):
        tst.csr_add(a, tst.csr_eye(3, 4, device=CPU))


def test_coo_pad_concatenate_compact_scale():
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 5, 8), rng.integers(0, 6, 8)
    r[3], c[3] = r[0], c[0]  # a duplicate
    d = rng.standard_normal(8)
    j = jst.coo_make((5, 6), r, c, jnp.asarray(d))
    t = tst.coo_make((5, 6), r, c, torch.from_numpy(d), device=CPU)
    jp, tp = jst.coo_pad_to(j, 12), tst.coo_pad_to(t, 12)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)))
    with pytest.raises(ValueError, match="cannot shrink"):
        tst.coo_pad_to(t, 7)
    jc = jst.coo_compact(jst.coo_concatenate(jp, j))
    tc = tst.coo_compact(tst.coo_concatenate(tp, t))
    assert tc.nse == jc.nse == 7
    np.testing.assert_array_equal(_np(tc.row), np.asarray(jc.row))
    np.testing.assert_array_equal(_np(tc.col), np.asarray(jc.col))
    np.testing.assert_allclose(_np(tc.data), np.asarray(jc.data), rtol=1e-12)
    np.testing.assert_array_equal(_np(tst.coo_scale(3.0, t).data), 3.0 * d)
    with pytest.raises(ValueError, match="shape mismatch"):
        tst.coo_concatenate(t, tst.coo_make((5, 5), r, c % 5,
                                            torch.from_numpy(d), device=CPU))


def test_bf16_csr_add_bits():
    """bf16 sums of two stored values round once, as the reference's."""
    x = _rand_dense(12, 10, 0.4, 7)
    y = _rand_dense(12, 10, 0.4, 8)
    ja = jst.csr_from_dense(jnp.asarray(x, jnp.bfloat16))
    jb = jst.csr_from_dense(jnp.asarray(y, jnp.bfloat16))
    ta = interop.csr_from_arrays(ja.data, ja.indices, ja.indptr, ja.shape,
                                 device=CPU)
    tb = interop.csr_from_arrays(jb.data, jb.indices, jb.indptr, jb.shape,
                                 device=CPU)
    j, t = jst.csr_add(ja, jb), tst.csr_add(ta, tb)
    assert t.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(t.indices), np.asarray(j.indices))
    np.testing.assert_array_equal(_bits_t(t.data), _bits_j(j.data))


# -- BSR goldens (tests/test_bsr.py, blocked_square_regular_test.fut) ---------


def _blkdiag_2(n):
    blk = [[1.0, 2.0], [3.0, 4.0]]
    return tst.bsr_make(n, BSZ, [(i, i, blk) for i in range(n // BSZ)],
                        device=CPU)


def _corner_block(n):
    nb = n // BSZ
    blk = np.arange(1.0, BSZ * BSZ + 1).reshape(BSZ, BSZ)
    return tst.bsr_make(n, BSZ, [(nb - 1, 0, blk)], device=CPU)


def _ref_diag_pattern(n):
    """mk_diag_blk (blocked_square_regular_test.fut:98-104)."""
    blocks = []
    for i in range(n // BSZ):
        blk = np.array([[c + 1 + 2 * i + r * (c * (r % 2)) - r
                         for c in range(BSZ)] for r in range(BSZ)],
                       np.float64)
        blocks.append((i, i, blk))
    return tst.bsr_make(n, BSZ, blocks, device=CPU)


@pytest.mark.parametrize("n", [0, 4, 8])
def test_bsr_eye_diag(n):
    """blocked_square_regular_test.fut:55-73."""
    a = tst.bsr_eye(n, BSZ, torch.float64, device=CPU)
    np.testing.assert_array_equal(_dense(a), np.eye(n))
    v = np.arange(1.0, n + 1)
    np.testing.assert_array_equal(
        _dense(tst.bsr_diag(torch.from_numpy(v), BSZ)), np.diag(v))


def test_bsr_transp_make():
    """blocked_square_regular_test.fut:75-93; duplicates summed; bounds."""
    b = _blkdiag_2(4)
    expect = np.array([[1.0, 2, 0, 0], [3, 4, 0, 0], [0, 0, 1, 2],
                       [0, 0, 3, 4]])
    np.testing.assert_array_equal(_dense(b), expect)
    np.testing.assert_array_equal(_dense(b.T), expect.T)
    a = tst.bsr_make(2, 2, [(0, 0, [[1.0, 0], [0, 1]]),
                            (0, 0, [[1.0, 2], [0, 0]])], device=CPU)
    np.testing.assert_array_equal(_dense(a), [[2.0, 2], [0, 1]])
    with pytest.raises(ValueError, match="out of bounds"):
        tst.bsr_make(4, 2, [(2, 0, np.zeros((2, 2)))], device=CPU)
    with pytest.raises(ValueError, match="must divide"):
        tst.bsr_make(5, 2, [], device=CPU)
    assert tst.bsr_make(4, 2, [], device=CPU).nbz == 0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["add", "sub_identity", "mul"])
def test_bsr_op_identities(n, op):
    """blocked_square_regular_test.fut:106-142."""
    c, d = _corner_block(n), _ref_diag_pattern(n)
    if op == "add":
        f = tst.bsr_add
    elif op == "mul":
        f = tst.bsr_mul
    else:
        def f(x, y):
            return tst.bsr_add(y, tst.bsr_add(y, tst.bsr_sub(x, y)))
    np.testing.assert_allclose(_dense(f(c, d)), _dense(f(d, c)), rtol=1e-12)
    np.testing.assert_allclose(_dense(f(c.T, d.T)), _dense(f(c, d).T),
                               rtol=1e-12)


@pytest.mark.parametrize("n,bsz", [(8, 2), (16, 4)])
def test_bsr_elementwise_vs_reference(n, bsz):
    """tests/test_bsr.py's dense oracle, and the reference's stored
    indices and capacities exactly: add nbz(a) + nbz(b), mul nbz(a)."""
    xa, xb = _rand_dense(n, n, 0.4, n + bsz), _rand_dense(n, n, 0.4, n * bsz)
    ja, jb = (jst.bsr_from_dense(jnp.asarray(x), bsz) for x in (xa, xb))
    ta, tb = (tst.bsr_from_dense(torch.from_numpy(x), bsz) for x in (xa, xb))
    np.testing.assert_array_equal(_np(ta.indices), np.asarray(ja.indices))
    np.testing.assert_array_equal(_np(ta.blocks), np.asarray(ja.blocks))
    blocks = (n // bsz, bsz, n // bsz, bsz)
    amask = np.any(xa.reshape(blocks) != 0, axis=(1, 3), keepdims=True)
    bmask = np.any(xb.reshape(blocks) != 0, axis=(1, 3), keepdims=True)
    want = {"add": xa + xb, "sub": xa - xb, "mul": (
        xa.reshape(blocks) * xb.reshape(blocks) * amask * bmask).reshape(n, n)}
    for op in ("add", "sub", "mul"):
        t = getattr(tst, f"bsr_{op}")(ta, tb)
        j = getattr(jst, f"bsr_{op}")(ja, jb)
        assert t.nbz == j.nbz == (ta.nbz if op == "mul" else ta.nbz + tb.nbz)
        np.testing.assert_array_equal(_np(t.indices), np.asarray(j.indices))
        np.testing.assert_allclose(_np(t.blocks), np.asarray(j.blocks),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(_dense(t), want[op], rtol=1e-12, atol=0)
        assert int(tst.bsr_nnz(t)) == int(jst.bsr_nnz(j))
    np.testing.assert_allclose(_dense(2.0 * ta), 2 * xa, rtol=1e-12)
    np.testing.assert_array_equal(_dense(ta * tb), want["mul"])
    jt, tt = jst.bsr_transpose(ja), tst.bsr_transpose(ta)
    np.testing.assert_array_equal(_np(tt.indices), np.asarray(jt.indices))
    np.testing.assert_array_equal(_np(tt.blocks), np.asarray(jt.blocks))


def test_bsr_mul_and_from_dense_capacities():
    """Padded capacities and empty operands, against the reference."""
    x = _rand_dense(8, 8, 0.5, 11)
    ja, ta = (jst.bsr_from_dense(jnp.asarray(x), 2, nbz=20),
              tst.bsr_from_dense(torch.from_numpy(x), 2, nbz=20))
    np.testing.assert_array_equal(_np(ta.indices), np.asarray(ja.indices))
    np.testing.assert_array_equal(_np(ta.blocks), np.asarray(ja.blocks))
    jz, tz = jst.bsr_zero(8, 2, 3), tst.bsr_zero(8, 2, 3, device=CPU)
    for tm, jm in ((tst.bsr_mul(ta, tz), jst.bsr_mul(ja, jz)),
                   (tst.bsr_mul(tz, ta), jst.bsr_mul(jz, ja))):
        assert tm.nbz == jm.nbz
        np.testing.assert_array_equal(_np(tm.indices), np.asarray(jm.indices))
        assert not _np(tm.blocks).any()
    with pytest.raises(ValueError, match="incompatible"):
        tst.bsr_add(ta, tst.bsr_eye(8, 4, device=CPU))


def test_bsr_nnz_stored_zeros():
    """Zeros inside stored blocks do not count (blocked:614)."""
    a = tst.bsr_make(4, 2, [(0, 1, [[1.0, 0], [0, -2]]),
                            (1, 1, [[0.0, 0], [0, 0]])], device=CPU)
    assert a.nbz == 2 and int(a.nnz()) == 2
    assert int(tst.bsr_nnz(tst.bsr_sub(a, a))) == 0


def test_bsr_make_bf16_round_trip():
    """bf16 blocks keep their bits; a float32 block list given
    ``dtype=bfloat16`` rounds once, as the reference's ``astype``."""
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((3, 2, 2)).astype(np.float32)
    entries = [(0, 0), (1, 0), (0, 1)]
    t = tst.bsr_make(4, 2, [(r, c, torch.from_numpy(v).to(torch.bfloat16))
                            for (r, c), v in zip(entries, vals)])
    j = jst.bsr_make(4, 2, [(r, c, v) for (r, c), v in zip(entries, vals)],
                     dtype=jnp.bfloat16)
    assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
    np.testing.assert_array_equal(_np(t.indices), np.asarray(j.indices))
    np.testing.assert_array_equal(_bits_t(t.blocks), _bits_j(j.blocks))
    t2 = tst.bsr_make(4, 2, [(r, c, v) for (r, c), v in zip(entries, vals)],
                      dtype=torch.bfloat16, device=CPU)
    np.testing.assert_array_equal(_bits_t(t2.blocks), _bits_j(j.blocks))


# -- the card is the default device --------------------------------------------

_DEFAULT_BUILDS = {
    "csr_eye": lambda: tst.csr_eye(3, 3),
    "csr_diag": lambda: tst.csr_diag([1.0, 2.0]),
    "csc_empty": lambda: tst.csc_empty(3, 2),
    "csc_eye": lambda: tst.csc_eye(2, 3),
    "csc_diag": lambda: tst.csc_diag([1.0]),
    "bsr_make": lambda: tst.bsr_make(4, 2, [(0, 0, np.eye(2))]),
    "bsr_make_empty": lambda: tst.bsr_make(4, 2, []),
    "bsr_eye": lambda: tst.bsr_eye(4, 2),
    "bsr_diag": lambda: tst.bsr_diag([1.0, 2.0], 2),
    "bsr_from_dense": lambda: tst.bsr_from_dense(np.eye(4), 2),
    "msr_empty": lambda: tst.msr_empty(2, 2),
    "msr_eye": lambda: tst.msr_eye(2, 2),
    "msr_diag": lambda: tst.msr_diag([1.0]),
    "msr_from_triples": lambda: tst.msr_from_triples(2, 2, [(0, 1, 1.0)]),
    "msc_eye": lambda: tst.msc_eye(2, 3),
    "tri_zero": lambda: tst.tri_zero(3),
    "tri_eye": lambda: tst.tri_eye(3),
    "tri_diag": lambda: tst.tri_diag([1.0, 2.0]),
    "tri_from_dense": lambda: tst.tri_from_dense(np.eye(3)),
    "trap_zero": lambda: tst.trap_zero(3, 2),
    "trap_eye": lambda: tst.trap_eye(2, 3),
    "trap_diag": lambda: tst.trap_diag([1.0]),
    "trap_from_dense": lambda: tst.trap_from_dense(np.eye(3, 2)),
    "perm_id": lambda: tst.perm_id(3),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_BUILDS))
def test_default_device_is_the_card(name):
    """With no ``device=`` a constructor fed sizes or host data builds on
    CUDA: without a card that raises (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the result would lie on it")
    with pytest.raises((AssertionError, RuntimeError),
                       match="CUDA|NVIDIA|cuda"):
        _DEFAULT_BUILDS[name]()
