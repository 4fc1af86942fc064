"""Differentiability and vmap-ability in the PyTorch port, against the
reference's ``tests/test_autodiff.py``.

Both packages get the same numpy-seeded inputs on the CPU: the reference
under ``jax.grad`` / ``jax.vmap`` / ``jax.jvp``, the port under
``torch.autograd`` / ``torch.func.grad`` / ``torch.func.vmap`` /
``torch.func.jvp``.  The plain routes (every op on CPU tensors) must give
the reference's derivatives: rtol 1e-10 in float64 against the reference
and the analytic forms, rtol 1e-4 against central differences.

A kernel launch behaves as the reference's ``pallas_call``: ``vmap`` works
and a derivative raises ``NotImplementedError``.  The port gets that from
``ops/_transforms.KernelCall``; here it wraps the kernels' plain versions as
launchers, so its rules run on the CPU (the card runs them on the kernels,
``tests/test_torch_cuda_transforms.py``): ``vmap`` of it equals a loop of
single calls bit for bit, with one launch per slice, and every derivative
through it raises — as the reference's Pallas kernels do in interpret mode
on the same inputs.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.autograd.forward_ad as fwad
from jax.experimental.pallas import tpu as pltpu

import sparse_tpu as st
import sparse_tpu_torch as pt
from sparse_tpu.formats import bell as jbell
from sparse_tpu.formats import bsr as jbsr
from sparse_tpu.ops import pallas_bell as jpbell
from sparse_tpu.ops import pallas_bsr as jpb
from sparse_tpu.ops import pallas_csr as jpc
from sparse_tpu.ops.segmented import INDEX_DTYPE
from sparse_tpu.ops.spmv import build_spmv_plan as j_build_spmv_plan
from sparse_tpu.ops.spmv import csr_smvm_fast as j_csr_smvm_fast
from sparse_tpu_torch import interop
from sparse_tpu_torch.formats import bsr as tbsr
from sparse_tpu_torch.formats.csr import CSR as TCSR
from sparse_tpu_torch.ops import _transforms
from sparse_tpu_torch.ops import cuda_bell as tcbell
from sparse_tpu_torch.ops import cuda_bsr as tcb
from sparse_tpu_torch.ops import cuda_csr as tpc
from sparse_tpu_torch.ops import cuda_dband as tdb
from sparse_tpu_torch.ops.spmv import build_spmv_plan, csr_smvm_fast

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "benchmarks"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import measure_dband as jdb  # noqa: E402  (imports bench from the root)

RTOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def random_dense(n, m, density, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m)) * (rng.random((n, m)) < density)


def pair(x):
    """The same float64 CSR in both packages."""
    return (st.csr_from_dense(jnp.asarray(x)),
            pt.csr_from_dense(torch.from_numpy(x), device="cpu"))


def _fd(loss, d0, i, eps=1e-6):
    dp, dm = d0.copy(), d0.copy()
    dp[i] += eps
    dm[i] -= eps
    return (loss(dp) - loss(dm)) / (2 * eps)


# -- the reference's cases ----------------------------------------------------


def test_grad_wrt_vector():
    x = random_dense(10, 12, 0.4, 0)
    ja, ta = pair(x)
    v = np.random.default_rng(1).standard_normal(12)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(st.csr_smvm(ja, v)))(
        jnp.asarray(v)))
    got = torch.func.grad(lambda v: pt.csr_smvm(ta, v).sum())(
        torch.from_numpy(v))
    tv = torch.from_numpy(v).requires_grad_(True)
    pt.csr_smvm(ta, tv).sum().backward()
    for g in (ref, _np(got), _np(tv.grad)):
        np.testing.assert_allclose(g, x.T @ np.ones(10), rtol=RTOL)
    np.testing.assert_allclose(_np(got), ref, rtol=RTOL)


def test_grad_wrt_sparse_values():
    x = random_dense(8, 8, 0.5, 2)
    ja, ta = pair(x)
    v = np.random.default_rng(2).standard_normal(8)

    def jloss(data):
        return jnp.sum(st.csr_smvm(st.CSR(data, ja.indices, ja.indptr,
                                          ja.shape), jnp.asarray(v)) ** 2)

    def tloss(data):
        return (pt.csr_smvm(TCSR(data, ta.indices, ta.indptr, ta.shape),
                            torch.from_numpy(v)) ** 2).sum()

    ref = np.asarray(jax.grad(jloss)(ja.data))
    got = _np(torch.func.grad(tloss)(ta.data))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-14)
    d0 = _np(ta.data).copy()
    for i in (0, len(d0) // 2, len(d0) - 1):
        fd = float(_fd(lambda d: tloss(torch.from_numpy(d)), d0, i))
        np.testing.assert_allclose(got[i], fd, rtol=1e-4, atol=1e-6)


def test_grad_through_spmm_and_fast_path():
    x = random_dense(9, 7, 0.5, 3)
    ja, ta = pair(x)
    b = np.random.default_rng(3).standard_normal((7, 4))
    ref = np.asarray(jax.grad(lambda b: jnp.sum(st.spmm(ja, b)))(
        jnp.asarray(b)))
    got = _np(torch.func.grad(lambda b: pt.spmm(ta, b).sum())(
        torch.from_numpy(b)))
    np.testing.assert_allclose(got, x.T @ np.ones((9, 4)), rtol=RTOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    jplan, tplan = j_build_spmv_plan(ja), build_spmv_plan(ta)
    v = np.random.default_rng(4).standard_normal(7)
    ref2 = np.asarray(jax.grad(
        lambda v: jnp.sum(j_csr_smvm_fast(ja, v, jplan)))(jnp.asarray(v)))
    got2 = _np(torch.func.grad(
        lambda v: csr_smvm_fast(ta, v, tplan).sum())(torch.from_numpy(v)))
    np.testing.assert_allclose(got2, x.T @ np.ones(9), rtol=RTOL)
    np.testing.assert_allclose(got2, ref2, rtol=RTOL)


def test_grad_through_triangular_smm():
    n = 6
    rng = np.random.default_rng(5)
    xa = np.tril(rng.standard_normal((n, n)))
    xb = np.tril(rng.standard_normal((n, n)))
    ja0 = st.tri_from_dense(jnp.asarray(xa))
    jb = st.tri_from_dense(jnp.asarray(xb))
    ta0 = pt.tri_from_dense(torch.from_numpy(xa), device="cpu")
    tb = pt.tri_from_dense(torch.from_numpy(xb), device="cpu")

    def jloss(data):
        a = dataclasses.replace(ja0, data=data)
        return jnp.sum(st.tri_todense(st.tri_smm(a, jb)) ** 2)

    def tloss(data):
        a = dataclasses.replace(ta0, data=data)
        return (pt.tri_todense(pt.tri_smm(a, tb)) ** 2).sum()

    ref = np.asarray(jax.grad(jloss)(ja0.data))
    got = _np(torch.func.grad(tloss)(ta0.data))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-14)
    d0 = _np(ta0.data).copy()
    for i in (0, len(d0) - 1):
        fd = float(_fd(lambda d: tloss(torch.from_numpy(d)), d0, i))
        np.testing.assert_allclose(got[i], fd, rtol=1e-4, atol=1e-6)


def test_vmap_over_batched_values():
    x = random_dense(6, 6, 0.6, 7)
    ja, ta = pair(x)
    rng = np.random.default_rng(8)
    batch = rng.standard_normal((4, ja.nse)) * (np.asarray(ja.data) != 0)
    v = rng.standard_normal(6)
    ref = np.asarray(jax.vmap(lambda d: st.csr_smvm(
        st.CSR(d, ja.indices, ja.indptr, ja.shape), jnp.asarray(v)))(
            jnp.asarray(batch)))
    got = _np(torch.func.vmap(lambda d: pt.csr_smvm(
        TCSR(d, ta.indices, ta.indptr, ta.shape), torch.from_numpy(v)))(
            torch.from_numpy(batch)))
    assert got.shape == ref.shape == (4, 6)
    dense = _np(torch.func.vmap(lambda d: TCSR(
        d, ta.indices, ta.indptr, ta.shape).todense())(
            torch.from_numpy(batch)))
    np.testing.assert_allclose(got, np.einsum("bnm,m->bn", dense, v),
                               rtol=RTOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_jvp_linearity():
    x = random_dense(5, 5, 0.6, 9)
    ja, ta = pair(x)
    t = np.arange(5.0)
    _, ref = jax.jvp(lambda v: st.csr_smvm(ja, v), (jnp.ones(5),),
                     (jnp.asarray(t),))
    _, got = torch.func.jvp(lambda v: pt.csr_smvm(ta, v),
                            (torch.ones(5, dtype=torch.float64),),
                            (torch.from_numpy(t),))
    with fwad.dual_level():
        dual = fwad.make_dual(torch.ones(5, dtype=torch.float64),
                              torch.from_numpy(t))
        got2 = fwad.unpack_dual(pt.csr_smvm(ta, dual)).tangent
    for g in (np.asarray(ref), _np(got), _np(got2)):
        np.testing.assert_allclose(g, x @ t, rtol=RTOL)


def test_grad_through_spgemm_apply():
    xa = random_dense(6, 5, 0.5, 31)
    xb = random_dense(5, 7, 0.5, 32)
    ja, ta = pair(xa)
    jb, tb = pair(xb)
    jplan, tplan = st.spgemm_prepare(ja, jb), pt.spgemm_prepare(ta, tb)

    def jloss(da, db):
        c = st.spgemm_apply(jplan, dataclasses.replace(ja, data=da),
                            dataclasses.replace(jb, data=db))
        return jnp.sum(c.data ** 2)

    def tloss(da, db):
        c = pt.spgemm_apply(tplan, dataclasses.replace(ta, data=da),
                            dataclasses.replace(tb, data=db))
        return (c.data ** 2).sum()

    jga, jgb = jax.grad(jloss, argnums=(0, 1))(ja.data, jb.data)
    tga, tgb = torch.func.grad(tloss, argnums=(0, 1))(ta.data, tb.data)
    c = xa @ xb
    for got, ref, dense, s in ((tga, jga, 2.0 * c @ xb.T, xa),
                               (tgb, jgb, 2.0 * xa.T @ c, xb)):
        rows, cols = np.nonzero(s)
        k = rows.size
        np.testing.assert_allclose(_np(got)[:k], dense[rows, cols],
                                   rtol=RTOL)
        np.testing.assert_allclose(_np(got)[:k], np.asarray(ref)[:k],
                                   rtol=RTOL)


# -- a kernel launch: KernelCall around the plain versions --------------------


def _band_stream(seed=0, n=64, nnz=500):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = np.clip(r + rng.integers(-9, 10, nnz), 0, n - 1)
    s = sp.coo_matrix((rng.standard_normal(nnz), (r, c)),
                      shape=(n, n)).tocsr()
    s.sum_duplicates()
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device="cpu")
    return s, tpc.build_seg_tiles(a).stream


class _Counted:
    """The plain K1 as a launcher, counting its calls."""

    def __init__(self, stream):
        self.stream, self.calls = stream, 0

    def __call__(self, vals, v):
        self.calls += 1
        return tpc.segtile_stream_plain(
            dataclasses.replace(self.stream, vals=vals), v)


def _k1(launch, vals, v):
    return _transforms.KernelCall.apply("K1", launch, vals, v)


@pytest.mark.parametrize("batched", ["operand", "values", "both"])
def test_kernel_call_vmap_is_a_loop_of_single_calls(batched):
    """Each slice bitwise equal to one call on it, one launch a slice."""
    s, stream = _band_stream()
    rng = np.random.default_rng(1)
    vs = torch.from_numpy(rng.standard_normal((3, s.shape[1])))
    k = stream.vals.shape[0]
    vals = stream.vals * torch.from_numpy(rng.random((3, 1)) + 0.5)
    launch = _Counted(stream)
    dims = {"operand": (None, 0), "values": (0, None), "both": (0, 0)}
    args = {"operand": (stream.vals, vs), "values": (vals, vs[0]),
            "both": (vals, vs)}[batched]
    got = torch.func.vmap(lambda a, b: _k1(launch, a, b),
                          in_dims=dims[batched])(*args)
    assert launch.calls == 3 and got.shape == (3, s.shape[0])
    for i in range(3):
        one = [x if d is None else x[i].clone()
               for x, d in zip(args, dims[batched])]
        assert torch.equal(got[i], launch(*one))
        assert one[0].shape == (k,)
    # and against SciPy
    for i in range(3):
        a = args[0] if dims[batched][0] is None else args[0][i]
        b = args[1] if dims[batched][1] is None else args[1][i]
        want = sp.csr_matrix((_np(a)[:stream.nnz], s.indices, s.indptr),
                             shape=s.shape) @ _np(b)
        np.testing.assert_allclose(_np(got[i]), want, rtol=1e-12,
                                   atol=1e-12)


def _raises_not_implemented(fn):
    with pytest.raises(NotImplementedError) as info:
        fn()
    msg = str(info.value)
    assert "CPU tensors" in msg and "bsr_smsmm_apply_slab_ad" in msg
    return msg


def test_kernel_call_derivatives_raise():
    """Reverse and forward mode, by every door, raise; a forward pass with
    inputs that require grad still computes."""
    s, stream = _band_stream(2)
    launch = _Counted(stream)
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(64))
    f = lambda v: _k1(launch, stream.vals, v)  # noqa: E731
    ref = launch(stream.vals, v)

    def backward():
        vr = v.clone().requires_grad_(True)
        (f(vr).sum() + vr.sum()).backward()  # no silent gradient of ones
        return vr.grad

    def autograd_grad():
        vr = v.clone().requires_grad_(True)
        return torch.autograd.grad(f(vr).sum(), vr)

    def values_grad():
        vals = stream.vals.clone().requires_grad_(True)
        _k1(launch, vals, v).sum().backward()

    def dual():
        with fwad.dual_level():
            return fwad.unpack_dual(f(fwad.make_dual(v, v))).tangent

    assert "reverse" in _raises_not_implemented(backward)
    _raises_not_implemented(autograd_grad)
    _raises_not_implemented(values_grad)
    _raises_not_implemented(lambda: torch.func.grad(
        lambda v: f(v).sum())(v))
    _raises_not_implemented(lambda: torch.func.vjp(f, v)[1](ref))
    assert "forward" in _raises_not_implemented(
        lambda: torch.func.jvp(f, (v,), (v,)))
    _raises_not_implemented(dual)
    vr = v.clone().requires_grad_(True)
    y = f(vr)
    assert y.requires_grad and torch.equal(y.detach(), ref)
    # nested: the rule launches per slice at the inner level, and the
    # outer derivative still raises
    _raises_not_implemented(lambda: torch.func.grad(
        lambda vs: torch.func.vmap(f)(vs).sum())(torch.stack([v, v])))
    _raises_not_implemented(lambda: torch.func.vmap(torch.func.grad(
        lambda v: f(v).sum()))(torch.stack([v, v])))


def test_kernel_call_runs_the_launcher_directly_without_a_transform():
    """No transform in play: the launcher's own result, not a graph node;
    with one in play, the opaque Function."""
    _, stream = _band_stream(4)
    launch = _Counted(stream)
    v = torch.ones(64, dtype=torch.float64)
    y = _transforms.kernel_call("K1", launch, stream.vals, v)
    assert y.grad_fn is None and launch.calls == 1
    with torch.no_grad():
        _transforms.kernel_call("K1", launch, stream.vals,
                                v.clone().requires_grad_(True))
    y = _transforms.kernel_call("K1", launch, stream.vals,
                                v.clone().requires_grad_(True))
    assert type(y.grad_fn).__name__ == "KernelCallBackward"
    with fwad.dual_level():
        y = _transforms.kernel_call("K1", launch, stream.vals, v)
    assert torch.equal(y, launch(stream.vals, v))


# -- the reference's kernels under the same transforms ------------------------


def _ref_and_port_k1(seed):
    """K1 of both packages on one segment-tile plan: the reference's
    ``segtile_apply`` in interpret mode, the port's plain stream version
    through KernelCall."""
    s, _ = _band_stream(seed)
    ja = st.CSR(data=jnp.asarray(s.data),
                indices=jnp.asarray(s.indices.astype(np.int32)),
                indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=s.shape)
    jp = jpc.build_seg_tiles(ja, wsub=8)
    raw = dict(n=jp.n, wsub=jp.wsub, rows=jp.rows, kstep=jp.kstep,
               chunks=jp.chunks)

    def ref(v):
        return jpc.segtile_apply(jp.vals, jp.q, jp.seg_of, jp.rb, v,
                                 interpret=True, **raw)[:s.shape[0]]

    _, stream = _band_stream(seed)
    launch = _Counted(stream)
    return ref, lambda v: _k1(launch, stream.vals, v), s.shape[1]


def _ref_and_port_k7(seed):
    """K7's raw slab apply of both packages on one schedule, over the left
    factor (with its zero pad block)."""
    rng = np.random.default_rng(seed)
    nb, bsz = 5, 8
    r, c = np.nonzero(rng.random((nb, nb)) < 0.5)
    blocks = rng.standard_normal((r.size, bsz, bsz))
    idx = (r * nb + c).astype(np.int32)
    ja = jbsr.BSR(indices=jnp.asarray(idx, INDEX_DTYPE),
                  blocks=jnp.asarray(blocks), n=nb * bsz, bsz=bsz)
    ta = interop.bsr_from_arrays(idx, blocks, nb * bsz, bsz, device="cpu")
    jpp = jpb.bsr_smsmm_pallas_prepare(jbsr.bsr_smsmm_prepare(ja, ja),
                                       ja.nbz, ja.nbz, g=4, p=4)
    tpp = tcb.bsr_smsmm_slab_prepare(tbsr.bsr_smsmm_prepare(ta, ta),
                                     ta.nbz, ta.nbz, g=4, p=4)
    zb = np.concatenate([blocks, np.zeros((1, bsz, bsz))])
    meta = dict(chunks=jpp.chunks, bsz=bsz, g=jpp.g, p=jpp.p,
                nbz_out=jpp.nbz_out, out_dtype=jnp.float64, precision=None)

    def ref(z1):
        return jpb.run_slabs_arrays(
            jpp.a_idx, jpp.b_idx, jpp.oloc, jpp.first, jpp.slab, z1,
            jnp.asarray(zb), interpret=True, **meta)

    tz2 = torch.from_numpy(zb)

    def launch(z1, z2):
        return tcb.run_slabs_arrays_plain(
            tpp.a_idx, tpp.b_idx, tpp.oloc, tpp.first, tpp.slab, z1, z2,
            **{**meta, "out_dtype": torch.float64})

    def port(z1):
        return _transforms.KernelCall.apply("K7", launch, z1, tz2)

    return ref, port, zb.shape


def _ref_and_port_k8(seed):
    """K8 of both packages on one banded BELL's tiles, over the operand."""
    nb, bsz, hb, rt, k = 40, 8, 2, 5, 16
    rng = np.random.default_rng(seed)
    cc = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (cc >= 0) & (cc < nb)
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols = np.where(ok, cc, 0)[rows, order].astype(np.int32)
    ok = ok[rows, order]
    blocks = (rng.standard_normal((nb, 2 * hb + 1, bsz, bsz))
              * ok[:, :, None, None]).astype(np.float32)
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=nb * bsz, bsz=bsz)
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    jplan = jpbell.build_banded_plan(ja, row_tile=rt, max_window=96)
    tplan = tcbell.build_banded_plan(ta, row_tile=rt, max_window=96)
    jt = jdb.densify_tiles(ja, jplan, jnp.float32)
    tt = tdb.densify_tiles(ta, tplan, torch.float32)
    W = tplan.W

    def ref(b3):
        with pltpu.force_tpu_interpret_mode():
            return jdb.dband_spmm(jt, jplan.start, b3, nb, bsz, k, W, rt,
                                  np.float32)

    def launch(tiles, b3):
        return tdb.dband_spmm_plain(tiles, tplan.start, b3, nb, bsz, k, W,
                                    rt, torch.float32)

    def port(b3):
        return _transforms.KernelCall.apply("K8", launch, tt, b3)

    return ref, port, (nb + W, bsz, k)


@pytest.mark.parametrize("kernel", ["K1", "K7", "K8"])
def test_kernels_under_transforms_as_the_reference(kernel):
    """The reference's Pallas kernel (interpret mode) and the port's
    KernelCall around the plain version, on the same inputs: ``vmap``
    works in both and equals single calls (within 1e-5 of each other);
    ``jvp`` and ``grad`` raise ``NotImplementedError`` in both."""
    ref, port, shape = {"K1": _ref_and_port_k1, "K7": _ref_and_port_k7,
                        "K8": _ref_and_port_k8}[kernel](seed=5)
    dtype = np.float32 if kernel == "K8" else np.float64
    x = np.random.default_rng(6).standard_normal(
        (2, *np.atleast_1d(shape))).astype(dtype)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jv = np.asarray(jax.vmap(ref)(jx))
    tv = _np(torch.func.vmap(port)(tx))
    for i in range(2):
        assert np.array_equal(jv[i], np.asarray(ref(jx[i])))
        assert np.array_equal(tv[i], _np(port(tx[i].clone())))
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        jax.jvp(ref, (jx[0],), (jx[1],))
    with pytest.raises(NotImplementedError):
        jax.grad(lambda x: ref(x).sum())(jx[0])
    _raises_not_implemented(lambda: torch.func.jvp(port, (tx[0],),
                                                   (tx[1],)))
    _raises_not_implemented(lambda: torch.func.grad(
        lambda x: port(x).sum())(tx[0]))


def test_slab_ad_vmaps_and_refuses_forward_mode():
    """``bsr_smsmm_apply_slab_ad``: gradients flow (``tests/
    test_torch_bsr_slab.py`` holds them to the reference), ``vmap`` over
    A's blocks equals single applies bitwise, and forward mode raises, as
    JAX refuses ``jvp`` through the reference's ``custom_vjp``."""
    rng = np.random.default_rng(9)
    nb, bsz = 5, 8
    r, c = np.nonzero(rng.random((nb, nb)) < 0.5)
    blocks = rng.standard_normal((r.size, bsz, bsz)).astype(np.float32)
    idx = (r * nb + c).astype(np.int32)
    ja = jbsr.BSR(indices=jnp.asarray(idx, INDEX_DTYPE),
                  blocks=jnp.asarray(blocks), n=nb * bsz, bsz=bsz)
    ta = interop.bsr_from_arrays(idx, blocks, nb * bsz, bsz, device="cpu")
    jplans = jpb.bsr_smsmm_pallas_prepare_ad(jbsr.bsr_smsmm_prepare(ja, ja),
                                             ja.nbz, ja.nbz, g=4, p=4)
    tplans = tcb.bsr_smsmm_slab_prepare_ad(tbsr.bsr_smsmm_prepare(ta, ta),
                                           ta.nbz, ta.nbz, g=4, p=4)

    def japply(x):
        return jpb.bsr_smsmm_apply_pallas_ad(
            jplans, dataclasses.replace(ja, blocks=x), ja,
            interpret=True).blocks

    def tapply(x):
        return tcb.bsr_smsmm_apply_slab_ad(
            tplans, dataclasses.replace(ta, blocks=x), ta).blocks

    xs = np.stack([blocks, 2 * blocks, -blocks])
    jv = np.asarray(jax.vmap(japply)(jnp.asarray(xs)))
    tv = _np(torch.func.vmap(tapply)(torch.from_numpy(xs)))
    for i in range(3):
        assert torch.equal(torch.from_numpy(tv[i]),
                           tapply(torch.from_numpy(xs[i]).clone()))
    np.testing.assert_allclose(tv, jv, rtol=2e-5, atol=2e-5)
    # vmap of grad: per-slice gradients through the custom backward
    w = torch.from_numpy(rng.standard_normal(tv.shape[1:]).astype(
        np.float32))
    g = torch.func.vmap(torch.func.grad(
        lambda x: (tapply(x) * w).sum()))(torch.from_numpy(xs))
    assert torch.equal(g[0], g[1]) and torch.equal(g[0], g[2])
    with pytest.raises(TypeError):
        jax.jvp(japply, (jnp.asarray(blocks),), (jnp.asarray(blocks),))
    with pytest.raises(NotImplementedError, match="forward"):
        torch.func.jvp(tapply, (torch.from_numpy(blocks),),
                       (torch.from_numpy(blocks),))


@pytest.mark.parametrize("prefer", [None, "segtile", "blockseg", "xla",
                                    "hubsplit"])
def test_vmap_through_every_rung_on_the_cpu(prefer):
    """``torch.func.vmap`` over the operand of ``plan.apply`` on every
    rung's plain version (the reference's ``jax.vmap`` runs on its own):
    each slice bitwise equal to a single apply, and within float32's
    1e-5 |A||v| of SciPy."""
    rng = np.random.default_rng(12)
    s = sp.random(300, 300, density=0.04, random_state=rng, format="csr",
                  dtype=np.float32)
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device="cpu")
    plan = pt.smvm_prepare(a, prefer=prefer)
    vs = rng.standard_normal((3, 300)).astype(np.float32)
    got = torch.func.vmap(plan.apply)(torch.from_numpy(vs))
    for i in range(3):
        assert torch.equal(got[i], plan.apply(torch.from_numpy(vs[i])))
        bound = 1e-5 * (abs(s) @ np.abs(vs[i].astype(np.float64)))
        err = np.abs(_np(got[i]) - s.astype(np.float64) @ vs[i])
        assert np.all(err <= bound)


@pytest.mark.parametrize("rows", [8, 32])
def test_vmap_over_raw_segtile_values_on_the_cpu(rows):
    """``torch.func.vmap`` over the values of the raw-array
    ``segtile_apply`` on CPU tensors: bitwise the per-slice calls, and the
    reference's ``jax.vmap`` of its Pallas kernel (interpret mode) within
    float32's 1e-5 |A||v|.  The compaction reads no value, so a padding
    slot adds 0·v as the reference's kernel does: an Inf opposite one gives
    the reference's NaN."""
    rng = np.random.default_rng(rows)
    n, m, nnz = 96, 300, 900
    r = rng.integers(0, n, nnz)
    c = np.clip(r * 3 + rng.integers(-40, 41, nnz), 0, m - 1)
    s = sp.coo_matrix((rng.standard_normal(nnz).astype(np.float32),
                       (r, c)), shape=(n, m)).tocsr()
    s.sum_duplicates()
    ja = st.CSR(data=jnp.asarray(s.data),
                indices=jnp.asarray(s.indices.astype(np.int32)),
                indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=s.shape)
    jp = jpc.build_seg_tiles(ja, wsub=8, rows=rows)
    tq, tseg, trb = (torch.from_numpy(np.array(x))
                     for x in (jp.q, jp.seg_of, jp.rb))
    raw = dict(n=n, wsub=jp.wsub, rows=rows, kstep=jp.kstep,
               chunks=jp.chunks)
    scale = rng.standard_normal(3).astype(np.float32)
    vals = np.asarray(jp.vals)[None] * scale[:, None, None, None]
    v = rng.standard_normal(m).astype(np.float32)

    def port(vals, v):
        return tpc.segtile_apply(vals, tq, tseg, trb, v, **raw)

    got = torch.func.vmap(port, in_dims=(0, None))(torch.from_numpy(vals),
                                                   torch.from_numpy(v))
    for i in range(3):
        assert torch.equal(got[i], port(torch.from_numpy(vals[i]),
                                        torch.from_numpy(v)))
    ref = jax.vmap(lambda x: jpc.segtile_apply(
        x, jp.q, jp.seg_of, jp.rb, jnp.asarray(v), interpret=True,
        **raw))(jnp.asarray(vals))
    bound = 1e-5 * np.abs(scale)[:, None] * (abs(s) @ np.abs(v))
    err = np.abs(got.numpy()[:, :n].astype(np.float64)
                 - np.asarray(ref)[:, :n])
    assert (err <= bound + 1e-30).all()
    # a padding slot reads a column no stored entry of its row block holds
    q, seg_of, rb = (np.asarray(x) for x in (jp.q, jp.seg_of, jp.rb))
    col = (seg_of[:, None, None] + q.astype(np.int64)) * 128 + np.arange(128)
    pad = (np.asarray(jp.vals) == 0) & (col < m) & (rb[:, None, None] >= 0)
    assert pad.any()
    vi = v.copy()
    vi[col[pad][0]] = np.inf
    y = port(torch.from_numpy(vals[0]), torch.from_numpy(vi)).numpy()
    y_ref = np.asarray(jpc.segtile_apply(
        jnp.asarray(vals[0]), jp.q, jp.seg_of, jp.rb, jnp.asarray(vi),
        interpret=True, **raw))
    assert np.isnan(y).any()
    np.testing.assert_array_equal(np.isnan(y), np.isnan(y_ref))
