"""The port's hand-written CUDA kernels and its main path on a card.

Every test here needs a CUDA device and ``nvcc`` (the kernels have no CPU
mode) and skips without one.  The file imports neither jax nor the
reference package, so it also runs where only PyTorch is installed:

    python -m pytest -c /dev/null --rootdir . --noconftest \
        -p no:cacheprovider tests/test_torch_cuda.py

The oracle is each kernel's plain PyTorch version on the same tensors, and
SciPy in float64.  Tolerances: float32 1e-5 and float64 1e-12, times
``|A||v|`` per row (the kernel and the plain version sum in different
orders).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu_torch as pt
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("wsub", [8, 16, 32])
def test_k1_matches_plain(cuda, wsub, dtype):
    s = _band(3000, 40000, 11, 2500)
    a = interop.csr_from_arrays(s.data.astype(dtype), s.indices, s.indptr,
                                s.shape, device=cuda)
    plan = tpc.build_seg_tiles(a, wsub=wsub)
    v = np.random.default_rng(12).standard_normal(3000).astype(dtype)
    vt = torch.from_numpy(v).to(cuda)
    raw = dict(n=3000, wsub=wsub, rows=8, kstep=plan.kstep,
               chunks=plan.chunks)
    arrs = (plan.vals, plan.q, plan.seg_of, plan.rb)
    before = tpc.K1_LAUNCHES
    y1 = tpc.segtile_apply(*arrs, vt, **raw)
    y2 = tpc.segtile_apply(*arrs, vt, **raw)
    torch.cuda.synchronize()
    assert tpc.K1_LAUNCHES == before + 2
    assert torch.equal(y1, y2)  # bitwise repeatable
    plain = tpc.segtile_apply_plain(*arrs, vt, **raw)
    _assert_close(_np(y1)[:3000], _np(plain)[:3000], s, v, dtype)
    _assert_close(_np(y1)[:3000], s @ v.astype(np.float64), s, v, dtype)
    p = torch.randperm(plan.n_tiles, device=cuda)
    y3 = tpc.segtile_apply(*(x[p] for x in arrs), vt, **raw)
    _assert_close(_np(y3)[:3000], _np(plain)[:3000], s, v, dtype)


def test_k1_rejects_what_it_cannot_take(cuda):
    s = _band(64, 300, 13, 64)
    a = interop.csr_from_arrays(s.data.astype(np.float32), s.indices,
                                s.indptr, s.shape, device=cuda)
    plan = tpc.build_seg_tiles(a)
    raw = dict(n=64, wsub=8, rows=8, kstep=plan.kstep, chunks=plan.chunks)
    v = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        tpc.segtile_apply(plan.vals, plan.q.to(torch.int32), plan.seg_of,
                          plan.rb, v, **raw)
    with pytest.raises(TypeError):
        tpc.segtile_apply(plan.vals.half(), plan.q, plan.seg_of, plan.rb,
                          v.half(), **raw)
    with pytest.raises(ValueError):
        tpc.segtile_apply(plan.vals, plan.q, plan.seg_of, plan.rb, v.cpu(),
                          **raw)
    with pytest.raises(ValueError):
        tpc.segtile_apply(plan.vals[:, :4], plan.q, plan.seg_of, plan.rb, v,
                          **raw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_matches_plain(cuda, dtype):
    s = _blocks(2000, 11, 900).astype(dtype)
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device=cuda)
    ab = tbsr.csr_to_bsr(a, 2)
    plan = tpb.build_seg_tiles_block(ab, wsub=16)
    v = np.random.default_rng(12).standard_normal(4000).astype(dtype)
    vt = torch.from_numpy(v).to(cuda)
    before = tpb.K2_LAUNCHES
    y1 = tpb.bsr_smvm_segtile_block(ab, vt, plan)
    y2 = tpb.bsr_smvm_segtile_block(ab, vt, plan)
    torch.cuda.synchronize()
    assert tpb.K2_LAUNCHES == before + 2
    assert torch.equal(y1, y2)
    plain = tpb.bsr_smvm_segtile_block_plain(ab, vt, plan)
    _assert_close(_np(y1), _np(plain), s, v, dtype)
    _assert_close(_np(y1), s.astype(np.float64) @ v.astype(np.float64), s,
                  v, dtype)


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
