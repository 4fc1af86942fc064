"""The card's kernel routes under ``torch.func`` and autograd, held to the
reference's ``pallas_call``: ``vmap`` works, every derivative raises.

Every test needs a CUDA device and ``nvcc`` and skips without one; the
file imports neither jax nor the reference package:

    python -m pytest -c /dev/null --rootdir . --noconftest \\
        -p no:cacheprovider tests/test_torch_cuda_transforms.py

For each launch point (K1, K1-r32, K1-mxu, K2, K3, K4, K5, K6, K7 raw and
prepared, K8): ``torch.func.vmap`` over 3 operands (or values) launches
the kernel once per slice, each slice bitwise equal to a single call;
``.backward()``, ``torch.autograd.grad``, ``torch.func.grad``,
``torch.func.jvp`` and a forward-AD dual each raise
``NotImplementedError``, so ``loss = kernel(v).sum() + v.sum()`` gives no
silent gradient of ones; a forward pass on inputs that require grad still
computes.  ``bsr_smsmm_apply_slab_ad`` keeps its gradients (K7 twice,
within the plain version's tolerance) and vmaps.  The reference's
``tests/test_dtypes.py`` and ``tests/test_fuzz.py`` default cases run
through the kernel routes against float64 oracles at the reference's
tolerances (float32 1e-5, float64 1e-10 / 1e-12, bf16 5e-2).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.autograd.forward_ad as fwad

import sparse_tpu_torch as pt
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats.bell import BELL
from sparse_tpu_torch.ops import cuda_bell as tcb
from sparse_tpu_torch.ops import cuda_bsr as tbs
from sparse_tpu_torch.ops import cuda_csr as tpc
from sparse_tpu_torch.ops import cuda_csr_block as tpb
from sparse_tpu_torch.ops import cuda_dband as tdb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@dataclasses.dataclass
class Case:
    """``fn(x)`` launches one kernel, counted as ``module.counter``; ``xs``
    holds 3 inputs along dimension 0."""
    fn: object
    xs: torch.Tensor
    module: object
    counter: str


def _band(n, nnz, seed, half, dtype=np.float32):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = np.clip(r + rng.integers(-half, half + 1, nnz), 0, n - 1)
    s = sp.coo_matrix((rng.standard_normal(nnz), (r, c)),
                      shape=(n, n)).tocsr()
    s.sum_duplicates()
    return s.astype(dtype)


def _rows3(rng, *shape):
    return torch.from_numpy(rng.standard_normal((3, *shape)).astype(
        np.float32))


def _band_bell(nb, bsz, hb, seed, device):
    c = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (c >= 0) & (c < nb)
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols, ok = np.where(ok, c, 0)[rows, order], ok[rows, order]
    blocks = np.random.default_rng(seed).standard_normal(
        (nb, 2 * hb + 1, bsz, bsz)) * ok[:, :, None, None]
    return BELL(cols=torch.from_numpy(cols.astype(np.int32)).to(device),
                blocks=torch.from_numpy(blocks).float().to(device),
                n=nb * bsz, bsz=bsz), ok


def _rand_bsr(nb, bsz, density, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((nb, nb)) < density)
    blocks = torch.from_numpy(rng.standard_normal((r.size, bsz, bsz)))
    return pt.BSR(indices=torch.from_numpy((r * nb + c).astype(
        np.int32)).to(device), blocks=blocks.to(dtype).to(device),
                  n=nb * bsz, bsz=bsz)


def _k1_case(dev, which):
    s = _band(3000, 40000, 11, 600)
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device=dev)
    rng = np.random.default_rng(12)
    vs = _rows3(rng, 3000).to(dev)
    if which == "K1-r32":
        plan = tpc.build_seg_tiles(a, rows=32)
        return Case(lambda v: tpc.csr_smvm_segtile(a, v, plan), vs, tpc,
                    "K1_R32_LAUNCHES")
    plan = tpc.build_seg_tiles(a)
    if which == "K1-mxu":
        return Case(lambda v: tpc.csr_smvm_segtile(a, v, plan,
                                                   reduce="mxu"),
                    vs, tpc, "K1_MXU_LAUNCHES")
    if which == "K1-apply":  # the main path's entry point
        auto = pt.smvm_prepare(a, prefer="segtile")
        assert auto.kind == "segtile"
        return Case(auto.apply, vs, tpc, "K1_LAUNCHES")
    if which == "K1-values":  # the stream's values batched, one operand
        stream, v = plan.stream, vs[0]
        scale = torch.tensor([1.0, -0.5, 2.0], device=dev)[:, None]
        return Case(lambda vals: tpc.segtile_stream_apply(
            dataclasses.replace(stream, vals=vals), v),
            stream.vals * scale, tpc, "K1_LAUNCHES")
    if which == "K1-raw":  # the raw-array route: slot values batched
        raw = dict(n=3000, wsub=plan.wsub, rows=8, kstep=plan.kstep,
                   chunks=plan.chunks)
        v = vs[0]
        scale = torch.tensor([1.0, -0.5, 2.0], device=dev)[:, None, None,
                                                           None]
        return Case(lambda vals: tpc.segtile_apply(
            vals, plan.q, plan.seg_of, plan.rb, v, **raw),
            plan.vals * scale, tpc, "K1_LAUNCHES")
    return Case(lambda v: tpc.csr_smvm_segtile(a, v, plan), vs, tpc,
                "K1_LAUNCHES")


def _k2_case(dev):
    rng = np.random.default_rng(11)
    nb = 2000
    mask = np.zeros((nb, nb), bool)
    for i in range(nb):
        mask[i, np.clip(i + rng.integers(-40, 41, 4), 0, nb - 1)] = True
    s = sp.kron(sp.csr_matrix(mask), np.ones((2, 2))).tocsr()
    s.data = (rng.standard_normal(s.nnz) + 3.0).astype(np.float32)
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device=dev)
    ab = pt.csr_to_bsr(a, 2)
    plan = tpb.build_seg_tiles_block(ab, wsub=16)
    return Case(lambda v: tpb.bsr_smvm_segtile_block(ab, v, plan),
                _rows3(rng, 2 * nb).to(dev), tpb, "K2_LAUNCHES")


def _bell_case(dev, which):
    a, ok = _band_bell(64, 32, 2, 3, dev)
    rng = np.random.default_rng(1)
    bs = _rows3(rng, a.n, 32).to(dev)
    if which == "K3":
        return Case(lambda b: tcb.bell_spmm_fused(a, b), bs, tcb,
                    "K3_LAUNCHES")
    if which == "K3-values":
        scale = torch.tensor([1.0, -0.5, 2.0], device=dev)[
            :, None, None, None, None]
        return Case(lambda blocks: tcb.bell_spmm_fused(
            dataclasses.replace(a, blocks=blocks), bs[0]),
            a.blocks * scale, tcb, "K3_LAUNCHES")
    if which == "K6":
        return Case(lambda b: tcb.bell_spmm_block(a, b), bs, tcb,
                    "K6_LAUNCHES")
    if which == "K4":
        kit = tcb.bell_banded_prepare(a, slot_valid=ok)
        return Case(lambda b: pt.bell_spmm(a, b, plan=kit), bs, tcb,
                    "K4_KIT_LAUNCHES")
    kit_t = tcb.bell_banded_prepare_t(a, slot_valid=ok)
    bts = _rows3(rng, 32, a.n).to(dev)
    return Case(lambda bt: tcb.bell_spmm_banded_t(a, bt, kit_t), bts, tcb,
                "K5_LAUNCHES")


def _k7_case(dev, which):
    a = _rand_bsr(40, 8, 0.12, 48, dev)
    b = _rand_bsr(40, 8, 0.12, 120, dev)
    plan = pt.bsr_smsmm_prepare(a, b)
    pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, b.nbz, g=3, p=8)
    scale = torch.tensor([1.0, -0.5, 2.0], device=dev)[:, None, None, None]
    if which == "K7-prepared":
        return Case(lambda x: pt.bsr_smsmm_apply_slab(
            pp, dataclasses.replace(a, blocks=x), b).blocks,
            a.blocks * scale, tbs, "K7_LAUNCHES")
    z1 = tbs._append_zero(a.blocks, torch.float32)
    z2 = tbs._append_zero(b.blocks, torch.float32)
    kw = dict(chunks=pp.chunks, bsz=pp.bsz, g=pp.g, p=pp.p,
              nbz_out=pp.nbz_out, out_dtype=torch.float32)
    return Case(lambda z: tbs.run_slabs_arrays(
        pp.a_idx, pp.b_idx, pp.oloc, pp.first, pp.slab, z, z2, **kw),
        z1 * scale, tbs, "K7_LAUNCHES")


def _k8_case(dev):
    a, ok = _band_bell(40, 24, 2, 5, dev)
    plan = tcb.build_banded_plan(a, row_tile=3, max_window=64,
                                 slot_valid=ok)
    tiles = tdb.densify_tiles(a, plan, torch.float32)
    W, k = plan.W, 33
    b3s = _rows3(np.random.default_rng(2), 40 + W, 24, k).to(dev)
    return Case(lambda b3: tdb.dband_spmm(tiles, plan.start, b3, 40, 24, k,
                                          W, 3, torch.float32),
                b3s, tdb, "K8_LAUNCHES")


CASES = {
    "K1": lambda d: _k1_case(d, "K1"),
    "K1-apply": lambda d: _k1_case(d, "K1-apply"),
    "K1-values": lambda d: _k1_case(d, "K1-values"),
    "K1-raw": lambda d: _k1_case(d, "K1-raw"),
    "K1-r32": lambda d: _k1_case(d, "K1-r32"),
    "K1-mxu": lambda d: _k1_case(d, "K1-mxu"),
    "K2": _k2_case,
    "K3": lambda d: _bell_case(d, "K3"),
    "K3-values": lambda d: _bell_case(d, "K3-values"),
    "K4": lambda d: _bell_case(d, "K4"),
    "K5": lambda d: _bell_case(d, "K5"),
    "K6": lambda d: _bell_case(d, "K6"),
    "K7-prepared": lambda d: _k7_case(d, "K7-prepared"),
    "K7-raw": lambda d: _k7_case(d, "K7-raw"),
    "K8": _k8_case,
}


def _launched(case, fn):
    before = getattr(case.module, case.counter)
    out = fn()
    torch.cuda.synchronize()
    return out, getattr(case.module, case.counter) - before


@pytest.mark.parametrize("name", list(CASES))
def test_vmap_launches_once_per_slice(cuda, name):
    case = CASES[name](cuda)
    got, launched = _launched(case, lambda: torch.func.vmap(case.fn)(
        case.xs))
    assert launched == 3 and got.is_cuda and got.shape[0] == 3
    for i in range(3):
        one, n = _launched(case, lambda: case.fn(case.xs[i].clone()))
        assert n == 1
        assert torch.equal(got[i], one), i  # bitwise


MODES = ["backward", "autograd.grad", "func.grad", "func.jvp", "dual"]


def _derive(fn, x, mode):
    if mode == "backward":
        xr = x.clone().requires_grad_(True)
        (fn(xr).sum() + xr.sum()).backward()  # not a gradient of ones
        return xr.grad
    if mode == "autograd.grad":
        xr = x.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xr).sum(), xr)
    if mode == "func.grad":
        return torch.func.grad(lambda x: fn(x).sum())(x)
    if mode == "func.jvp":
        return torch.func.jvp(fn, (x,), (torch.ones_like(x),))
    with fwad.dual_level():
        y = fn(fwad.make_dual(x, torch.ones_like(x)))
        return fwad.unpack_dual(y).tangent


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_derivatives_raise(cuda, name, mode):
    case = CASES[name](cuda)
    x = case.xs[0].clone()
    with pytest.raises(NotImplementedError) as info:
        _derive(case.fn, x, mode)
    assert "CPU tensors" in str(info.value)
    assert "bsr_smsmm_apply_slab_ad" in str(info.value)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_with_grad_inputs_still_computes(cuda, name):
    case = CASES[name](cuda)
    x = case.xs[0].clone()
    want, n = _launched(case, lambda: case.fn(x))
    got, m = _launched(case, lambda: case.fn(x.clone().requires_grad_(True)))
    assert n == m == 1 and got.requires_grad
    assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_ad_gradients_and_vmap(cuda, dtype):
    """The AD route's gradients (K7 on the permuted schedules) match
    autograd through the plain ``bsr_smsmm_apply`` within tol * |dC||B|;
    vmap over A's blocks equals single applies bitwise, one K7 a slice;
    forward mode raises."""
    a = _rand_bsr(16, 32, 0.2, 4, cuda, dtype)
    b = _rand_bsr(16, 32, 0.2, 5, cuda, dtype)
    plan = pt.bsr_smsmm_prepare(a, b)
    plans = pt.bsr_smsmm_slab_prepare_ad(plan, a.nbz, b.nbz)
    ct = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (plan.nbz_out, 32, 32))).to(dtype).to(cuda)
    grads = []
    for apply in (lambda x, y: pt.bsr_smsmm_apply_slab_ad(plans, x, y),
                  lambda x, y: pt.bsr_smsmm_apply(plan, x, y)):
        ab = a.blocks.clone().requires_grad_(True)
        bb = b.blocks.clone().requires_grad_(True)
        before = tbs.K7_LAUNCHES
        c = apply(dataclasses.replace(a, blocks=ab),
                  dataclasses.replace(b, blocks=bb))
        c.blocks.backward(ct)
        torch.cuda.synchronize()
        grads.append((ab.grad, bb.grad, tbs.K7_LAUNCHES - before))
    (ga, gb, launched), (ra, rb, none) = grads
    assert launched == 3 and none == 0
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    bound_a = pt.bsr_smsmm_apply(plan, dataclasses.replace(
        a, blocks=a.blocks.abs()), dataclasses.replace(
            b, blocks=b.blocks.abs())).blocks  # |A||B|: a scale for dC
    scale = float(bound_a.abs().max()) * float(ct.abs().max()) + 1.0
    assert float((ga - ra).abs().max()) <= 2 * tol * scale
    assert float((gb - rb).abs().max()) <= 2 * tol * scale

    def fwd(x):
        return pt.bsr_smsmm_apply_slab_ad(
            plans, dataclasses.replace(a, blocks=x), b).blocks

    xs = torch.stack([a.blocks, -a.blocks, 2 * a.blocks])
    before = tbs.K7_LAUNCHES
    got = torch.func.vmap(fwd)(xs)
    torch.cuda.synchronize()
    assert tbs.K7_LAUNCHES - before == 3
    for i in range(3):
        assert torch.equal(got[i], fwd(xs[i].clone()))
    with pytest.raises(NotImplementedError, match="forward"):
        torch.func.jvp(fwd, (a.blocks,), (a.blocks,))


# -- the reference's dtype and fuzz default cases through the kernels ---------


def _pattern(n, m, density, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m)) * (rng.random((n, m)) < density)


def _segtile(x, dtype, dev):
    s = sp.csr_matrix(x)
    a = interop.csr_from_arrays(s.data.astype(dtype), s.indices, s.indptr,
                                s.shape, device=dev)
    return a, tpc.build_seg_tiles(a)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_dtypes_csr_through_k1(cuda, dtype, tol):
    """``test_dtypes.py::test_csr_float_dtypes`` through K1 (float32 and
    float64 are K1's types)."""
    x = _pattern(24, 24, 0.3, 0).astype(dtype)
    a, plan = _segtile(x, dtype, cuda)
    before = tpc.K1_LAUNCHES
    got = tpc.csr_smvm_segtile(a, torch.ones(24, dtype=a.dtype,
                                             device=cuda), plan)
    assert tpc.K1_LAUNCHES == before + 1 and got.dtype == a.dtype
    np.testing.assert_allclose(got.cpu().numpy(),
                               x.astype(np.float64) @ np.ones(24),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("stream,tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 5e-2)])
def test_dtypes_block_formats_through_k3_k6(cuda, stream, tol):
    """``test_dtypes.py::test_block_formats_dtypes`` through K3 and K6: a
    BELL of the 16 x 16 pattern at bsz 4, float32 and bf16 blocks."""
    x = _pattern(16, 16, 0.5, 2)
    a = pt.bell_from_bsr(pt.bsr_from_dense(torch.from_numpy(x).to(stream),
                                           4, device=cuda))
    v = torch.ones(16, 1, dtype=stream, device=cuda)
    ref = torch.from_numpy(x).to(stream).double().numpy() @ np.ones(16)
    for fn, counter in ((tcb.bell_spmm_fused, "K3_LAUNCHES"),
                        (tcb.bell_spmm_block, "K6_LAUNCHES")):
        before = getattr(tcb, counter)
        got = fn(a, v)
        assert getattr(tcb, counter) == before + 1
        np.testing.assert_allclose(got.double().cpu().numpy()[:, 0], ref,
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("n,m,density", [(1, 1, 1.0), (13, 13, 0.08)])
def test_fuzz_csr_through_k1(cuda, n, m, density):
    """``test_fuzz.py::test_csr_consistency``'s default cases: the SpMV
    through K1 (the plan route and ``smvm_prepare``) in float64 within the
    reference's rtol 1e-10 / atol 1e-12."""
    rng = np.random.default_rng(hash((n, m, int(density * 100))) % 2**32)
    x = rng.standard_normal((n, m)) * (rng.random((n, m)) < density)
    v = rng.standard_normal(m)
    a, plan = _segtile(x, np.float64, cuda)
    vt = torch.from_numpy(v).to(cuda)
    before = tpc.K1_LAUNCHES
    got = tpc.csr_smvm_segtile(a, vt, plan)
    # below the tile-fill floor prefer= falls through to xla, as in the
    # reference
    auto = pt.smvm_prepare(a, prefer="segtile")
    got2 = auto.apply(vt)
    assert tpc.K1_LAUNCHES == before + 1 + (auto.kind == "segtile")
    for y in (got, got2):
        np.testing.assert_allclose(y.cpu().numpy(), x @ v, rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("nb,bsz,density", [(1, 2, 1.0), (5, 8, 0.1)])
def test_fuzz_bsr_bell_through_k3_k7(cuda, nb, bsz, density):
    """``test_fuzz.py::test_bsr_bell_consistency``'s default cases: the
    BELL SpMV through K3 and K6 (k = 1), ``bsr_smsmm`` through K7's
    prepared apply, float64, within the reference's tolerances."""
    n = nb * bsz
    rng = np.random.default_rng(hash((nb, bsz)) % 2**32)
    mask = np.kron(rng.random((nb, nb)) < density, np.ones((bsz, bsz)))
    x = rng.standard_normal((n, n)) * mask
    a = pt.bsr_from_dense(torch.from_numpy(x), bsz, device=cuda)
    e = pt.bell_from_bsr(a)
    v = rng.standard_normal(n)
    vt = torch.from_numpy(v).to(cuda)[:, None]
    counts = [tcb.K3_LAUNCHES, tcb.K6_LAUNCHES, tbs.K7_LAUNCHES]
    for fn in (tcb.bell_spmm_fused, tcb.bell_spmm_block):
        np.testing.assert_allclose(fn(e, vt).cpu().numpy()[:, 0], x @ v,
                                   rtol=1e-10, atol=1e-12)
    plan = pt.bsr_smsmm_prepare(a, a)
    pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, a.nbz)
    c = pt.bsr_smsmm_apply_slab(pp, a, a)
    np.testing.assert_allclose(pt.bsr_todense(c).cpu().numpy(), x @ x,
                               rtol=1e-9, atol=1e-9)
    assert [tcb.K3_LAUNCHES, tcb.K6_LAUNCHES, tbs.K7_LAUNCHES] == \
        [k + 1 for k in counts]
