"""Integer contractions of the PyTorch port, exact on a device without
integer matmul.

CUDA has no integer ``einsum`` / ``matmul`` / ``bmm`` / ``mm``: each
raises "not implemented" on int32 CUDA tensors, where the reference's
contractions take integers on every backend.  Every plain contraction of
the port goes through ``utils.precision.contract``, which sums integer
products exactly on the operands' own device.  Here the CPU is made such a
device (those four calls raise for integer operands, as on the card) and
every site that contracts is run on int32 operands: each gives NumPy's
exact int64 answer, on the CPU, in int32.  Floating operands still take
the one ``einsum`` in full precision, bitwise.  Everything runs on the CPU.
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as pt
import sparse_tpu_torch.parallel as tpar
from sparse_tpu_torch.formats import triangular as ttri
from sparse_tpu_torch.utils.precision import contract

SPECS = {
    "rlij,rlj->ri": [(5, 3, 4, 4), (5, 3, 4)],
    "rlij,rljk->rik": [(5, 3, 4, 4), (5, 3, 4, 6)],
    "nl,nlk->nk": [(7, 5), (7, 5, 3)],
    "ij,jk->ik": [(9, 11), (11, 4)],
    "fij,fjk->fik": [(6, 4, 4), (6, 4, 2)],
    "ij,jk->ik ": [(3, 0), (0, 5)],
}


@pytest.fixture
def no_integer_matmul(monkeypatch):
    """Make the CPU refuse integer matmuls, as CUDA does."""
    for name in ("einsum", "matmul", "bmm", "mm"):
        real = getattr(torch, name)

        def refuse(*args, _real=real, _name=name):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if any(not (t.dtype.is_floating_point or t.dtype.is_complex)
                   for t in ts):
                raise RuntimeError(f"{_name}: not implemented for 'Int'")
            return _real(*args)

        monkeypatch.setattr(torch, name, refuse)


def _ints(rng, shape, lo=-9, hi=10):
    return rng.integers(lo, hi, shape).astype(np.int32)


@pytest.mark.parametrize("spec", list(SPECS))
def test_contract_is_exact_for_integers_and_einsum_for_floats(
        spec, no_integer_matmul):
    rng = np.random.default_rng(len(spec))
    xs = [_ints(rng, s, -1000, 1000) for s in SPECS[spec]]
    got = contract(spec, *(torch.from_numpy(x) for x in xs))
    want = np.einsum(spec, *(x.astype(np.int64) for x in xs))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    fs = [torch.from_numpy(x.astype(np.float32) / 7) for x in xs]
    assert torch.equal(contract(spec, *fs), torch.einsum(spec, *fs))


def test_contract_refuses_mixed_dtypes_and_bad_specs():
    x = torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        contract("ij,jk->ik", x, torch.ones(3, 2))
    with pytest.raises(ValueError):
        contract("ij,jk->ik", x, torch.ones(2, 2, dtype=torch.int32))


def _sparse(rng, n, density):
    d = _ints(rng, (n, n))
    d[rng.random((n, n)) >= density] = 0
    return d


def _blocky(rng, nb, bsz, density):
    mask = np.kron(rng.random((nb, nb)) < density,
                   np.ones((bsz, bsz), bool))
    return np.where(mask, _ints(rng, mask.shape), 0).astype(np.int32)


def _csr(d):
    return pt.csr_from_dense(torch.from_numpy(d), device="cpu")


def _bsr(d, bsz):
    return pt.bsr_from_dense(torch.from_numpy(d), bsz, device="cpu")


def _site(name, rng):
    """(port result, NumPy int64 answer) of one contracting entry point on
    int32 operands."""
    d = _blocky(rng, 6, 4, 0.4)
    v = _ints(rng, d.shape[0])
    b = _ints(rng, (d.shape[0], 5))
    d64 = d.astype(np.int64)
    tv, tb = torch.from_numpy(v), torch.from_numpy(b)
    if name == "bell_smvm":
        return pt.bell_smvm(pt.bell_from_bsr(_bsr(d, 4)), tv), d64 @ v
    if name == "bsr_smvm":
        return pt.bsr_smvm(_bsr(d, 4), tv), d64 @ v
    if name == "bsr_smvm_ell":
        a = _bsr(d, 4)
        return pt.bsr_smvm_ell(a, tv, pt.bsr_row_capacity(a)), d64 @ v
    if name == "bsr_spmm_ell":
        a = _bsr(d, 4)
        return pt.bsr_spmm_ell(a, tb, pt.bsr_row_capacity(a)), d64 @ b
    if name == "csr_spmm_ell":
        a = _csr(d)
        return pt.csr_spmm_ell(a, tb, pt.row_capacity(a)), d64 @ b
    if name == "csr_spmm_fast":
        return pt.csr_spmm_fast(_csr(d), tb), d64 @ b
    if name == "spmm":
        return pt.spmm(_csr(d), tb), d64 @ b
    if name in ("pbell_smvm", "pbell_spmm"):
        mesh = tpar.make_1d_mesh(4, device="cpu")
        pa = tpar.pbell_from_bell(pt.bell_from_bsr(_bsr(d, 4)), mesh)
        x, want = (tv, d64 @ v) if name == "pbell_smvm" else (tb, d64 @ b)
        xs = tpar.pbell_shard_vector(x, pa, mesh)
        fn = tpar.pbell_smvm if name == "pbell_smvm" else tpar.pbell_spmm
        return fn(pa, xs, mesh)[:d.shape[0]], want
    if name == "spgemm_mxu_csr_csr":
        s1, s2 = _sparse(rng, 30, 0.2), _sparse(rng, 30, 0.2)
        a, c = _csr(s1), _csr(s2)
        nse = int(pt.spgemm_mxu_nse(a, c))
        got = pt.spgemm_mxu_csr_csr(a, c, nse)
        return pt.csr_todense(got), s1.astype(np.int64) @ s2
    if name == "bsr_smsmm":
        c = pt.bsr_smsmm(_bsr(d, 4), _bsr(d, 4))
        return pt.bsr_todense(c), d64 @ d64
    if name == "bsr_smsmm_bsz16":
        g = _blocky(rng, 5, 16, 0.5)
        return (pt.bsr_todense(pt.bsr_smsmm(_bsr(g, 16), _bsr(g, 16))),
                g.astype(np.int64) @ g)
    if name == "pbsr_smsmm":
        g = _blocky(rng, 8, 16, 0.4)
        mesh = tpar.make_1d_mesh(4, device="cpu")
        pa = tpar.pbsr_from_bsr(_bsr(g, 16), mesh)
        plan = tpar.build_pbsr_smsmm_plan(pa, pa, mesh)
        c = tpar.pbsr_to_bsr(tpar.pbsr_smsmm(pa, pa, mesh, plan))
        return pt.bsr_todense(c), g.astype(np.int64) @ g
    if name == "tri_smm":
        t = np.tril(_ints(rng, (40, 40)))
        a = pt.tri_from_dense(torch.from_numpy(t), device="cpu")
        return pt.tri_todense(pt.tri_smm(a, a)), t.astype(np.int64) @ t
    if name == "trap_smm":
        t = np.tril(_ints(rng, (30, 20)))
        u = np.tril(_ints(rng, (20, 12)))
        a = pt.trap_from_dense(torch.from_numpy(t), device="cpu")
        c = pt.trap_from_dense(torch.from_numpy(u), device="cpu")
        return pt.trap_todense(pt.trap_smm(a, c)), t.astype(np.int64) @ u
    raise KeyError(name)


SITES = ["bell_smvm", "bsr_smvm", "bsr_smvm_ell", "bsr_spmm_ell",
         "csr_spmm_ell", "csr_spmm_fast", "spmm", "pbell_smvm",
         "pbell_spmm", "spgemm_mxu_csr_csr", "bsr_smsmm", "bsr_smsmm_bsz16",
         "pbsr_smsmm", "tri_smm", "trap_smm"]


@pytest.mark.parametrize("site", SITES)
def test_integer_sites_exact_without_integer_matmul(site, no_integer_matmul):
    got, want = _site(site, np.random.default_rng(SITES.index(site)))
    assert got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_blocked_packed_product_exact_without_integer_matmul(
        no_integer_matmul, monkeypatch):
    """``tri_smm``'s blocked packed route (n above the dense cutoff)."""
    monkeypatch.setattr(ttri, "_TRI_DENSE_MAX", 16)
    monkeypatch.setattr(ttri, "_TRI_BLOCK", 8)
    t = np.tril(_ints(np.random.default_rng(5), (37, 37)))
    a = pt.tri_from_dense(torch.from_numpy(t), device="cpu")
    got = pt.tri_todense(pt.tri_smm(a, a))
    np.testing.assert_array_equal(got.numpy(), t.astype(np.int64) @ t)
