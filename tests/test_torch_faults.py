"""Three faults of the PyTorch port against the reference, pinned.

- ``torch.func.vmap`` over the values of ``csr_smvm`` (the reference vmaps
  it with ``jax.vmap``, ``tests/test_autodiff.py``): ``segment_sum`` builds
  its output out of place, and stays bitwise repeatable.
- bfloat16 values through the host conversions (``csr_from_triples``,
  ``csr_to_bsr``, ``bell_from_csr``, ``bell_from_bsr``,
  ``hub_split_prepare``): structure and nnz exactly, values bit for bit
  against the reference's bf16 (the reference accepts bf16 in each,
  ``tests/test_dtypes.py``).
- The reference's top-level names that the port's modules define are
  exported by ``sparse_tpu_torch`` too.

Both packages get the same numpy-seeded inputs; everything runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as jst
import sparse_tpu_torch as tst
from sparse_tpu.formats.csr import CSR as JCSR
from sparse_tpu.ops import hub_split as jhub
from sparse_tpu_torch.formats.csr import CSR as TCSR
from sparse_tpu_torch.ops import reorder as treorder
from sparse_tpu_torch.ops import spmv as tspmv
from sparse_tpu_torch.ops.segmented import segment_sum


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bits_t(x: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its uint16 bit patterns."""
    return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def _bits_j(x) -> np.ndarray:
    """reference bf16 array -> its uint16 bit patterns."""
    return np.asarray(x).view(np.uint16)


def _random_triples(n, m, k, seed, dup=0, zeros=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, k)
    cols = rng.integers(0, m, k)
    vals = rng.standard_normal(k)
    vals[:zeros] = 0.0  # stored zeros: stored, but not counted in nnz
    if dup:
        rows = np.concatenate([rows, rows[:dup]])
        cols = np.concatenate([cols, cols[:dup]])
        vals = np.concatenate([vals, rng.standard_normal(dup)])
    return [(int(r), int(c), float(v)) for r, c, v in zip(rows, cols, vals)]


# -- vmap over values ----------------------------------------------------------


@pytest.mark.parametrize("n,density,seed", [(6, 0.6, 7), (40, 0.15, 3)])
def test_vmap_csr_smvm_over_values(n, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    x[0] = 0.0  # an empty row
    ja = jst.csr_from_dense(jnp.asarray(x, jnp.float32))
    indices, indptr = np.asarray(ja.indices), np.asarray(ja.indptr)
    mask = np.asarray(ja.data) != 0
    batch = (rng.standard_normal((4, ja.nse)) * mask).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)

    def jone(d):
        return jst.csr_smvm(JCSR(d, ja.indices, ja.indptr, ja.shape),
                            jnp.asarray(v))

    ref = np.asarray(jax.vmap(jone)(jnp.asarray(batch)))

    ti = torch.from_numpy(indices.copy())
    tp = torch.from_numpy(indptr.copy())
    tv = torch.from_numpy(v)

    def tone(d):
        return tst.csr_smvm(TCSR(data=d, indices=ti, indptr=tp,
                                 shape=(n, n)), tv)

    tb = torch.from_numpy(batch)
    got = torch.func.vmap(tone)(tb)
    assert got.shape == (4, n) and got.dtype == torch.float32
    # |A||v| per element, float32 summation-order tolerance
    dense = np.zeros((4, n, n), np.float64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    for b in range(4):
        np.add.at(dense[b], (rows, indices[:rows.size]),
                  batch[b, :rows.size])
    scale = np.abs(dense) @ np.abs(v.astype(np.float64))
    np.testing.assert_array_less(np.abs(_np(got) - ref), 1e-5 * scale + 1e-30)
    # bitwise repeatable, and the same bits as one call per matrix
    again = torch.func.vmap(tone)(tb)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    loop = torch.stack([tone(d) for d in tb])
    assert torch.equal(got.view(torch.int32), loop.view(torch.int32))


def test_segment_sum_vmap_and_repeatable():
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(-1, 9, 200))  # -1 and 8: dropped
    data = torch.from_numpy(rng.standard_normal((3, 200)).astype(np.float32))
    got = torch.func.vmap(lambda d: segment_sum(d, ids, 8))(data)
    ref = np.asarray(jax.vmap(
        lambda d: jax.ops.segment_sum(d, jnp.asarray(_np(ids)), 8))(
            jnp.asarray(_np(data))))
    scale = np.zeros((3, 8))
    keep = (_np(ids) >= 0) & (_np(ids) < 8)
    for b in range(3):
        np.add.at(scale[b], _np(ids)[keep], np.abs(_np(data)[b][keep]))
    np.testing.assert_array_less(np.abs(_np(got) - ref), 1e-5 * scale + 1e-30)
    for b in range(3):
        one = segment_sum(data[b], ids, 8)
        assert torch.equal(one.view(torch.int32), got[b].view(torch.int32))
        assert torch.equal(one.view(torch.int32),
                           segment_sum(data[b], ids, 8).view(torch.int32))


# -- bfloat16 through the host conversions -------------------------------------


def _bf16_pair(n, seed, dup=0, zeros=3):
    tr = _random_triples(n, n, 3 * n, seed, dup=dup, zeros=zeros)
    ja = jst.csr_from_triples(n, n, tr, dtype=jnp.bfloat16)
    ta = tst.csr_from_triples(n, n, tr, dtype=torch.bfloat16, device="cpu")
    return ja, ta


@pytest.mark.parametrize("dup", [0, 5])
def test_bf16_csr_from_triples(dup):
    ja, ta = _bf16_pair(24, 5, dup=dup)
    assert ta.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ta.indptr), np.asarray(ja.indptr))
    np.testing.assert_array_equal(_np(ta.indices), np.asarray(ja.indices))
    np.testing.assert_array_equal(_bits_t(ta.data), _bits_j(ja.data))
    assert int(tst.csr_nnz(ta)) == int(jst.csr_nnz(ja))
    tc = tst.coo_from_triples(3, 3, [(0, 1, 1.5), (2, 2, 0.0)],
                              dtype=torch.bfloat16, device="cpu")
    assert tc.data.dtype == torch.bfloat16 and int(tst.coo_nnz(tc)) == 1


@pytest.mark.parametrize("bsz", [2, 4])
def test_bf16_csr_to_bsr(bsz):
    ja, ta = _bf16_pair(24, 6)
    jb = jst.csr_to_bsr(ja, bsz)
    tb = tst.csr_to_bsr(ta, bsz)
    assert tb.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tb.indices).astype(np.int64),
                                  np.asarray(jb.indices).astype(np.int64))
    np.testing.assert_array_equal(_bits_t(tb.blocks), _bits_j(jb.blocks))


@pytest.mark.parametrize("bsz", [2, 4])
def test_bf16_bell_from_csr_and_bsr(bsz):
    ja, ta = _bf16_pair(24, 7)
    je, te = jst.bell_from_csr(ja, bsz), tst.bell_from_csr(ta, bsz)
    assert te.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(te.cols), np.asarray(je.cols))
    np.testing.assert_array_equal(_bits_t(te.blocks), _bits_j(je.blocks))
    jf = jst.bell_from_bsr(jst.csr_to_bsr(ja, bsz))
    tf = tst.bell_from_bsr(tst.csr_to_bsr(ta, bsz))
    assert tf.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tf.cols), np.asarray(jf.cols))
    np.testing.assert_array_equal(_bits_t(tf.blocks), _bits_j(jf.blocks))


def test_bf16_hub_split_prepare():
    ja, ta = _bf16_pair(32, 8)
    js = jhub.hub_split_prepare(ja, max_hub_cols=6)
    ts = tst.hub_split_prepare(ta, max_hub_cols=6)
    np.testing.assert_array_equal(_np(ts.hub_cols), np.asarray(js.hub_cols))
    assert (ts.hub_nnz, ts.tail_nnz) == (js.hub_nnz, js.tail_nnz)
    for tc, jc in ((ts.hub_csr, js.hub_csr), (ts.tail_csr, js.tail_csr)):
        assert tc.data.dtype == torch.bfloat16 and tc.shape == jc.shape
        k = int(jc.indptr[-1])
        np.testing.assert_array_equal(_np(tc.indptr), np.asarray(jc.indptr))
        np.testing.assert_array_equal(_np(tc.indices)[:k],
                                      np.asarray(jc.indices)[:k])
        np.testing.assert_array_equal(_bits_t(tc.data)[:k],
                                      _bits_j(jc.data)[:k])


# -- top-level names -----------------------------------------------------------

_EXPORTS = [
    ("SpmvPlan", tspmv), ("csr_smvm_ell", tspmv),
    ("PermutePlan", treorder), ("csr_bandwidth", treorder),
    ("csr_permute", treorder), ("permute_apply", treorder),
    ("permute_prepare", treorder), ("permute_vector", treorder),
    ("unpermute_vector", treorder),
]


@pytest.mark.parametrize("name,module", _EXPORTS,
                         ids=[n for n, _ in _EXPORTS])
def test_reference_names_exported(name, module):
    assert hasattr(jst, name)  # the reference exports it
    assert name in tst.__all__
    assert getattr(tst, name) is getattr(module, name)
