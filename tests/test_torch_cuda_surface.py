"""The public surface of ``sparse_tpu_torch`` on the card, name by name.

``SURFACE`` maps every public callable of ``sparse_tpu_torch`` and
``sparse_tpu_torch.parallel`` that no other card test or ``chip_smoke.py``
phase runs by name (``tests/test_torch_surface.py`` holds that list
complete on the CPU), and a few more whose plain code changed, to one
case: a builder of small numpy-seeded inputs and the call.  Each case runs
once on ``device="cpu"`` inputs (held against the JAX reference by the
CPU suite) and twice on ``device="cuda"`` inputs, for each dtype the CPU
suite gives the function: float32, float64, bfloat16 where the CPU tests
use it, int32 wherever the reference takes integers.  The distributed
functions run on an in-process ``Mesh`` of 1 and of 4 shards.

Every tensor of the card's result lies on the card, with the CPU's dtype
and shape.  Integer and boolean values, stored structure, nnz counts,
permutations and plan fields equal the CPU's exactly; floats agree within
1e-5 (float32), 1e-12 (float64) or 2^-7 (bfloat16) of the same function
on the inputs' absolute values in float64 — ``|A||x|`` for a product —
and, for factorizations and solves, whose pivots follow the values, of
the largest entry.  The second card call equals the first bit for bit.

Needs a CUDA card: skips without one.  Imports no JAX.
"""

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np
import pytest
import torch

import sparse_tpu_torch as pt
import sparse_tpu_torch.parallel as tpar
from sparse_tpu_torch import interop

pytestmark = pytest.mark.cuda

F32, F64, BF16, I32 = torch.float32, torch.float64, torch.bfloat16, torch.int32
F = (F32, F64)
FI = F + (I32,)
FB = F + (BF16,)
FIB = FI + (BF16,)
RTOL = {F32: 1e-5, F64: 1e-12, BF16: 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's surface")
    return torch.device("cuda")


class In:
    """One case's inputs on one device: the draws of
    ``default_rng(seed)``, the same for every device and dtype.  Integer
    dtypes take the draws times 4, rounded; ``absval`` takes absolute
    values (the bound's run, in float64 on the CPU)."""

    def __init__(self, seed, dt, dev, absval=False, d=None):
        self.rng = np.random.default_rng(seed)
        self.dt, self.dev, self.absval = dt, dev, absval
        self.mesh = None if d is None else tpar.make_1d_mesh(d, device=dev)

    def t(self, x):
        x = np.abs(x) if self.absval else np.asarray(x, np.float64)
        if not self.dt.is_floating_point:
            x = np.rint(x * 4)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.dt).to(
            self.dev)

    def scalar(self):
        return 3 if not self.dt.is_floating_point else 1.5

    def dense(self, n, m, density=0.3):
        return (self.rng.standard_normal((n, m))
                * (self.rng.random((n, m)) < density))

    def vec(self, n):
        return self.t(self.rng.standard_normal(n))

    def mat(self, n, m, density=0.3):
        return self.t(self.dense(n, m, density))

    def csr(self, n=24, m=20, density=0.3):
        return pt.csr_from_dense(self.mat(n, m, density))

    def csc(self, n=24, m=20, density=0.3):
        return pt.csc_from_dense(self.mat(n, m, density))

    def coo_dup(self, n=12, m=10, nse=40):
        """An unsorted COO with duplicate coordinates."""
        r = self.rng.integers(0, n, nse)
        c = self.rng.integers(0, m, nse)
        return pt.coo_make((n, m), torch.from_numpy(r).to(I32),
                           torch.from_numpy(c).to(I32),
                           self.t(self.rng.standard_normal(nse)),
                           device=self.dev)

    def triples(self, n=12, m=10, nse=40):
        r = self.rng.integers(0, n, nse)
        c = self.rng.integers(0, m, nse)
        v = self.t(self.rng.standard_normal(nse)).cpu()
        return [(int(i), int(j), x) for i, j, x in zip(r, c, v.tolist())]

    def bsr(self, nb=6, bsz=4, density=0.4, diag=False, band=None):
        mask = self.rng.random((nb, nb)) < density
        if band is not None:
            mask = np.abs(np.subtract.outer(np.arange(nb),
                                            np.arange(nb))) <= band
        if diag:
            mask |= np.eye(nb, dtype=bool)
        x = self.rng.standard_normal((nb * bsz, nb * bsz)) * np.kron(
            mask, np.ones((bsz, bsz)))
        if diag:
            x += np.eye(nb * bsz) * 4 * bsz * nb
        return pt.bsr_from_dense(self.t(x), bsz)

    def mono(self, n=12, m=10, rows=True):
        """Triples of a mono matrix: one column per row (``rows``) or one
        row per column."""
        k = n if rows else m
        other = self.rng.integers(0, m if rows else n, k)
        v = self.t(self.rng.standard_normal(k)).cpu().tolist()
        return [(i, int(j), x) if rows else (int(j), i, x)
                for i, j, x in zip(range(k), other, v)]

    def msr(self, n=12, m=10):
        return pt.msr_from_triples(n, m, self.mono(n, m), device=self.dev,
                                   dtype=self.dt)

    def msc(self, n=12, m=10):
        return pt.msc_from_triples(n, m, self.mono(n, m, rows=False),
                                   device=self.dev, dtype=self.dt)

    def lower(self, n=16):
        return self.t(np.tril(self.rng.standard_normal((n, n))))

    def trap(self, n=14, m=9):
        return pt.trap_from_dense(self.t(np.tril(
            self.rng.standard_normal((n, m)))))

    def tri(self, n=16):
        return pt.tri_from_dense(self.lower(n))

    def solvable(self, n=16):
        """A matrix whose LU needs no pivot and whose triangles solve."""
        x = self.rng.standard_normal((n, n)) + np.eye(n) * 2 * n
        return self.t(x)

    def perm(self, n):
        return torch.from_numpy(self.rng.permutation(n)).to(I32).to(self.dev)

    def pcsr(self, n=40, m=40, density=0.15):
        return tpar.pcsr_from_csr(self.csr(n, m, density), self.mesh)


@dataclasses.dataclass(frozen=True)
class Case:
    """``run(inputs)``: the call, on :class:`In`'s inputs.  ``dtypes``:
    the dtypes the CPU suite gives it; ``scale``: ``"abs"`` (the same
    function on absolute inputs bounds each entry) or ``"max"`` (the
    largest entry of each result); ``meshes``: shard counts of the
    distributed functions."""

    run: Callable
    dtypes: tuple = FI
    scale: str = "abs"
    meshes: tuple = (None,)


def _mm_round_trip(i):
    a = i.coo_dup()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "a.mtx")
        pt.mm_write(path, a)
        with open(path) as f:
            text = f.read()
        back = pt.mm_read_coo(path, dtype=i.dt, device=i.dev)
    return text, back


def _debug_checks(i):
    """With the checks on, mono add/sub of mismatched structure raises on
    every device; off again afterwards."""
    a = i.msr()
    pt.debug_checks(True)
    try:
        with pytest.raises(ValueError):
            pt.msr_add(a, pt.msr_from_triples(
                12, 10, [(k, (k + 1) % 10, 1.0) for k in range(12)],
                dtype=i.dt, device=i.dev))
    finally:
        pt.debug_checks(False)
    return a


def _banded(i):
    a = pt.bell_from_bsr(i.bsr(16, 32, band=1))
    kit = pt.bell_banded_prepare(a, row_tile=4)
    return pt.bell_banded_refresh(kit, pt.bell_from_bsr(i.bsr(16, 32,
                                                              band=1)))


def _band_csr(i, n=60):
    x = i.rng.standard_normal((n, n)) * (
        np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3)
    return pt.csr_from_dense(i.t(x))


def _spd_pcsr(i, n=40):
    x = i.rng.standard_normal((n, n)) * (i.rng.random((n, n)) < 0.1)
    x = x + x.T + np.eye(n) * 2 * n
    return tpar.pcsr_from_csr(pt.csr_from_dense(i.t(x)), i.mesh), n


def _dup_pcsr(i, n=30, per_row=6):
    """A PCSR whose rows hold duplicate columns."""
    cols = np.sort(i.rng.integers(0, n, (n, per_row)), axis=1)
    data = i.t(i.rng.standard_normal(n * per_row)).cpu().numpy()
    a = interop.csr_from_arrays(
        data, cols.reshape(-1).astype(np.int32),
        np.arange(0, n * per_row + 1, per_row, dtype=np.int32), (n, n),
        device=i.dev)
    return tpar.pcsr_from_csr(a, i.mesh)


def _cg_step(i):
    a, n = _spd_pcsr(i)
    b = tpar.shard_vector(i.vec(n), a, i.mesh)
    state = (torch.zeros_like(b), b, b, (b * b).sum())
    for _ in range(3):
        state = tpar.cg_step(a, i.mesh, state)
    return state


def _power(i):
    a, n = _spd_pcsr(i)
    v = tpar.shard_vector(i.vec(n), a, i.mesh)
    for _ in range(3):
        v, lam = tpar.power_iteration_step(a, v, i.mesh)
    return v, lam


def _halo_spmm(i):
    a = _band_csr(i, 64)
    ho = tpar.halo_partition_overlapped(a, i.mesh)
    b = tpar.shard_vector(i.mat(64, 5, 1.0), ho, i.mesh)
    return tpar.halo_spmm_overlapped(ho, b, i.mesh)


def _pcsr_spmm(i):
    a = i.pcsr(40, 36)
    return tpar.pcsr_spmm(a, tpar.shard_vector(i.mat(36, 5, 1.0), a, i.mesh),
                          i.mesh)


def _spgemm_esc(i):
    a, b = i.csr(20, 16), i.csr(16, 18)
    return pt.spgemm_csr_csr(a, b, int(pt.spgemm_flops(a, b)))


def _spgemm_dense(i):
    a, b = i.csr(20, 16), i.csr(16, 18)
    return pt.spgemm_mxu_csr_csr(a, b, int(pt.spgemm_mxu_nse(a, b)))


def _permute_plan(i):
    a = i.csr(20, 18)
    return pt.permute_prepare(a, i.perm(20), i.perm(18)), a


def _hub(i):
    x = i.dense(64, 64, 0.05)
    x[:, :3] = i.rng.standard_normal((64, 3))  # three hub columns
    return pt.hub_split_prepare(pt.csr_from_dense(i.t(x)), max_hub_cols=3)


def _smvm_rungs(i):
    """``smvm_prepare(a, prefer=rung).apply(v)`` on the segtile rung (K1 on
    the card) and the blockseg rung (K2, on natural 2x2 blocks)."""
    a = i.csr(64, 64, 0.1)
    y = pt.smvm_prepare(a, prefer="segtile").apply(i.vec(64))
    blk = pt.bsr_to_csr(i.bsr(16, 2, 0.3))
    return y, pt.smvm_prepare(blk, prefer="blockseg").apply(i.vec(32))


def _bsr_pair(i):
    a, b = i.bsr(6, 4, 0.4), i.bsr(6, 4, 0.4)
    return a, b


SURFACE = {
    # formats.coo
    "coo_compact": Case(lambda i: pt.coo_compact(pt.coo_pad_to(
        i.coo_dup(), 48))),
    "coo_concatenate": Case(lambda i: pt.coo_concatenate(i.coo_dup(),
                                                         i.coo_dup())),
    "coo_from_dense": Case(lambda i: pt.coo_from_dense(i.mat(12, 9))),
    "coo_from_triples": Case(lambda i: pt.coo_from_triples(
        12, 10, i.triples(), dtype=i.dt, device=i.dev), FIB),
    "coo_nnz": Case(lambda i: pt.coo_nnz(i.coo_dup())),
    "coo_normalize": Case(lambda i: pt.coo_normalize(i.coo_dup())),
    "coo_pad_to": Case(lambda i: pt.coo_pad_to(i.coo_dup(), 64)),
    "coo_scale": Case(lambda i: pt.coo_scale(i.scalar(), i.coo_dup())),
    "coo_sort": Case(lambda i: pt.coo_sort(i.coo_dup())),
    "coo_todense": Case(lambda i: pt.coo_todense(i.coo_dup())),
    "coo_transpose": Case(lambda i: pt.coo_transpose(i.coo_dup())),
    # formats.csr: CSC
    "csc_add": Case(lambda i: pt.csc_add(i.csc(), i.csc())),
    "csc_diag": Case(lambda i: pt.csc_diag(i.vec(11))),
    "csc_empty": Case(lambda i: pt.csc_empty(7, 5, 4, i.dt, device=i.dev)),
    "csc_eye": Case(lambda i: pt.csc_eye(7, 5, i.dt, device=i.dev)),
    "csc_from_coo": Case(lambda i: pt.csc_from_coo(i.coo_dup())),
    "csc_from_dense": Case(lambda i: pt.csc_from_dense(i.mat(12, 9))),
    "csc_from_triples": Case(lambda i: pt.csc_from_triples(
        12, 10, i.triples(), dtype=i.dt, device=i.dev)),
    "csc_nnz": Case(lambda i: pt.csc_nnz(i.csc())),
    "csc_scale": Case(lambda i: pt.csc_scale(i.scalar(), i.csc())),
    "csc_sub": Case(lambda i: pt.csc_sub(i.csc(), i.csc())),
    "csc_to_coo": Case(lambda i: pt.csc_to_coo(i.csc())),
    "csc_todense": Case(lambda i: pt.csc_todense(i.csc())),
    "csc_transpose": Case(lambda i: pt.csc_transpose(i.csc())),
    "csc_vsmm": Case(lambda i: pt.csc_vsmm(i.vec(24), i.csc())),
    # formats.csr: CSR
    "csr_compact": Case(lambda i: pt.csr_compact(pt.csr_from_coo(
        pt.coo_pad_to(i.coo_dup(), 60)))),
    "csr_diag": Case(lambda i: pt.csr_diag(i.vec(11))),
    "csr_smvm": Case(lambda i: pt.csr_smvm(i.csr(), i.vec(20)), FIB),
    "csr_to_coo": Case(lambda i: pt.csr_to_coo(i.csr())),
    "csr_todense": Case(lambda i: pt.csr_todense(i.csr())),
    "csr_transpose": Case(lambda i: pt.csr_transpose(i.csr())),
    # formats.bsr
    "bsr_compact": Case(lambda i: pt.bsr_compact(pt.bsr_from_coo(
        pt.coo_pad_to(i.coo_dup(12, 12), 60), 2))),
    "bsr_diag": Case(lambda i: pt.bsr_diag(i.vec(12), 4)),
    "bsr_eye": Case(lambda i: pt.bsr_eye(12, 4, i.dt, device=i.dev)),
    "bsr_from_coo": Case(lambda i: pt.bsr_from_coo(i.coo_dup(12, 12), 4)),
    "bsr_make": Case(lambda i: pt.bsr_make(
        8, 4, [(r, c, i.t(i.rng.standard_normal((4, 4))))
               for r, c in ((0, 1), (1, 1), (0, 1))], dtype=i.dt,
        device=i.dev)),
    "bsr_scale": Case(lambda i: pt.bsr_scale(i.scalar(), i.bsr())),
    "bsr_smsmm_core": Case(lambda i: (lambda a: pt.bsr_smsmm_core(
        a, a, int(a.nbz) * a.nb))(i.bsr())),
    "bsr_smvm": Case(lambda i: pt.bsr_smvm(i.bsr(), i.vec(24))),
    "bsr_sub": Case(lambda i: pt.bsr_sub(*_bsr_pair(i))),
    "bsr_transpose": Case(lambda i: pt.bsr_transpose(i.bsr())),
    # formats.bell
    "bell_from_csr": Case(lambda i: pt.bell_from_csr(i.csr(24, 24), 4),
                          FIB),
    "bell_smvm": Case(lambda i: pt.bell_smvm(pt.bell_from_bsr(i.bsr()),
                                             i.vec(24)), FIB),
    "bell_todense": Case(lambda i: pt.bell_todense(pt.bell_from_bsr(
        i.bsr(), Lb=6))),
    # formats.mono
    "debug_checks": Case(_debug_checks),
    "msc_add": Case(lambda i: (lambda a: pt.msc_add(a, pt.msc_scale(
        2, a)))(i.msc())),
    "msc_diag": Case(lambda i: pt.msc_diag(i.vec(9))),
    "msc_empty": Case(lambda i: pt.msc_empty(7, 5, i.dt, device=i.dev)),
    "msc_eye": Case(lambda i: pt.msc_eye(7, 5, i.dt, device=i.dev)),
    "msc_from_coo": Case(lambda i: pt.msc_from_coo(pt.coo_from_triples(
        12, 10, i.mono(rows=False), dtype=i.dt, device=i.dev))),
    "msc_from_triples": Case(lambda i: i.msc()),
    "msc_nnz": Case(lambda i: pt.msc_nnz(i.msc())),
    "msc_scale": Case(lambda i: pt.msc_scale(i.scalar(), i.msc())),
    "msc_sub": Case(lambda i: (lambda a: pt.msc_sub(a, pt.msc_scale(
        2, a)))(i.msc())),
    "msc_to_coo": Case(lambda i: pt.msc_to_coo(i.msc())),
    "msc_todense": Case(lambda i: pt.msc_todense(i.msc())),
    "msc_transpose": Case(lambda i: pt.msc_transpose(i.msc())),
    "msc_vsmm": Case(lambda i: pt.msc_vsmm(i.vec(12), i.msc())),
    "msr_add": Case(lambda i: (lambda a: pt.msr_add(a, pt.msr_scale(
        2, a)))(i.msr())),
    "msr_diag": Case(lambda i: pt.msr_diag(i.vec(9))),
    "msr_dmsmm": Case(lambda i: pt.msr_dmsmm(i.mat(5, 12, 1.0), i.msr())),
    "msr_empty": Case(lambda i: pt.msr_empty(7, 5, i.dt, device=i.dev)),
    "msr_eye": Case(lambda i: pt.msr_eye(7, 5, i.dt, device=i.dev)),
    "msr_from_coo": Case(lambda i: pt.msr_from_coo(pt.coo_from_triples(
        12, 10, i.mono(), dtype=i.dt, device=i.dev))),
    "msr_nnz": Case(lambda i: pt.msr_nnz(i.msr())),
    "msr_scale": Case(lambda i: pt.msr_scale(i.scalar(), i.msr())),
    "msr_sub": Case(lambda i: (lambda a: pt.msr_sub(a, pt.msr_scale(
        2, a)))(i.msr())),
    "msr_to_coo": Case(lambda i: pt.msr_to_coo(i.msr())),
    "msr_todense": Case(lambda i: pt.msr_todense(i.msr())),
    "msr_transpose": Case(lambda i: pt.msr_transpose(i.msr())),
    "msr_vsmm": Case(lambda i: pt.msr_vsmm(i.vec(12), i.msr())),
    # formats.triangular
    "tri_add": Case(lambda i: pt.tri_add(i.tri(), i.tri())),
    "tri_diag": Case(lambda i: pt.tri_diag(i.vec(9))),
    "tri_eye": Case(lambda i: pt.tri_eye(9, dtype=i.dt, device=i.dev)),
    "tri_from_dense": Case(lambda i: pt.tri_from_dense(i.mat(9, 9, 1.0))),
    "tri_idx": Case(lambda i: torch.stack([pt.tri_idx(i.tri(), r, c)
                                           for r, c in ((5, 2), (2, 5))])),
    "tri_map": Case(lambda i: pt.tri_map(lambda x: x * 2, i.tri())),
    "tri_nnz": Case(lambda i: pt.tri_nnz(i.tri())),
    "tri_scale": Case(lambda i: pt.tri_scale(i.scalar(), i.tri())),
    "tri_smm": Case(lambda i: (lambda a: pt.tri_smm(a, a))(i.tri())),
    "tri_sub": Case(lambda i: pt.tri_sub(i.tri(), i.tri())),
    "tri_transpose": Case(lambda i: pt.tri_transpose(i.tri())),
    "tri_zero": Case(lambda i: pt.tri_zero(9, dtype=i.dt, device=i.dev)),
    # formats.trapezoidal
    "trap_add": Case(lambda i: pt.trap_add(i.trap(), i.trap())),
    "trap_diag": Case(lambda i: pt.trap_diag(i.vec(9))),
    "trap_eye": Case(lambda i: pt.trap_eye(9, 6, dtype=i.dt, device=i.dev)),
    "trap_from_dense": Case(lambda i: pt.trap_from_dense(i.mat(9, 6,
                                                               1.0))),
    "trap_idx": Case(lambda i: torch.stack([pt.trap_idx(i.trap(), r, c)
                                            for r, c in ((5, 2), (2, 5))])),
    "trap_map": Case(lambda i: pt.trap_map(lambda x: x * 2, i.trap())),
    "trap_nnz": Case(lambda i: pt.trap_nnz(i.trap())),
    "trap_scale": Case(lambda i: pt.trap_scale(i.scalar(), i.trap())),
    "trap_smm": Case(lambda i: pt.trap_smm(i.trap(14, 9), i.trap(9, 6))),
    "trap_sub": Case(lambda i: pt.trap_sub(i.trap(), i.trap())),
    "trap_transpose": Case(lambda i: pt.trap_transpose(i.trap())),
    "trap_zero": Case(lambda i: pt.trap_zero(9, 6, dtype=i.dt,
                                             device=i.dev)),
    # linalg.dense
    "backsolve_dense": Case(lambda i: pt.backsolve_dense(
        i.solvable().triu(), i.vec(16)), F, "max"),
    "forsolve_dense": Case(lambda i: pt.forsolve_dense(
        i.solvable().tril(), i.vec(16)), F, "max"),
    "lu_dense": Case(lambda i: pt.lu_dense(i.solvable()), F, "max"),
    "lup_dense": Case(lambda i: pt.lup_dense(i.mat(16, 16, 1.0)), F, "max"),
    "perm_compose": Case(lambda i: pt.perm_compose(i.perm(5), i.perm(7)),
                         (I32,)),
    "perm_id": Case(lambda i: pt.perm_id(9, device=i.dev), (I32,)),
    "perm_inverse": Case(lambda i: pt.perm_inverse(i.perm(9)), (I32,)),
    "perm_to_matrix": Case(lambda i: pt.perm_to_matrix(i.perm(9), i.dt)),
    "permute": Case(lambda i: pt.permute(i.perm(9), i.mat(9, 3, 1.0))),
    "rowsolve_upper": Case(lambda i: pt.rowsolve_upper(
        i.solvable().triu(), i.mat(3, 16, 1.0)), F, "max"),
    # solve.bsr_lu
    "bsr_lu_nofill": Case(lambda i: pt.bsr_lu_nofill(i.bsr(diag=True)), F,
                          "max"),
    "bsr_lup_nofill": Case(lambda i: pt.bsr_lup_nofill(
        i.bsr(diag=True)), F, "max"),
    "bsr_tri_plan": Case(lambda i: pt.bsr_tri_plan(pt.bsr_lower(
        pt.bsr_lu_nofill(i.bsr(diag=True))), True), F, "max"),
    # ops.spgemm
    "spgemm_csr_csr": Case(_spgemm_esc),
    "spgemm_flops": Case(lambda i: pt.spgemm_flops(i.csr(20, 16),
                                                   i.csr(16, 18))),
    "spgemm_mxu_csr_csr": Case(_spgemm_dense),
    "spgemm_mxu_nse": Case(lambda i: pt.spgemm_mxu_nse(i.csr(20, 16),
                                                       i.csr(16, 18))),
    # ops.cuda_csr, ops.hub_split, ops.dispatch, formats.bell: the K1, K2
    # and K3 routes in every kind their kernels take (int32 and bf16 too)
    "csr_smvm_auto": Case(lambda i: pt.csr_smvm_auto(i.csr(64, 64, 0.1),
                                                     i.vec(64)), FIB),
    "hub_split_prepare": Case(_hub, FB),
    "hub_split_smvm": Case(lambda i: pt.hub_split_smvm(_hub(i),
                                                       i.vec(64)), FIB),
    "smvm_prepare": Case(_smvm_rungs, FIB),
    "bell_spmm": Case(lambda i: pt.bell_spmm(pt.bell_from_bsr(
        i.bsr(8, 8, 0.4)), i.mat(64, 16, 1.0)), FIB),
    # ops.reorder: patterns, permutations and permuted values
    "rcm_order": Case(lambda i: pt.rcm_order(_band_csr(i)), (F32,)),
    "rcm_order_blocked": Case(lambda i: pt.rcm_order_blocked(
        pt.bsr_to_csr(i.bsr(8, 2, 0.3)), 2), (F32,)),
    "reorder_for_locality": Case(lambda i: pt.reorder_for_locality(
        _band_csr(i))),
    "csr_bandwidth": Case(lambda i: pt.csr_bandwidth(_band_csr(i)), (F32,)),
    "csr_permute": Case(lambda i: pt.csr_permute(i.csr(20, 18), i.perm(20),
                                                 i.perm(18))),
    "permute_apply": Case(lambda i: pt.permute_apply(*_permute_plan(i))),
    "permute_prepare": Case(lambda i: _permute_plan(i)[0]),
    "permute_vector": Case(lambda i: pt.permute_vector(i.vec(9),
                                                       i.perm(9))),
    "unpermute_vector": Case(lambda i: pt.unpermute_vector(i.vec(9),
                                                           i.perm(9))),
    # ops.spmv, ops.spmm, ops.bsr_ell
    "csr_smvm_ell": Case(lambda i: (lambda a: pt.csr_smvm_ell(
        a, i.vec(20), pt.row_capacity(a)))(i.csr())),
    "csr_spmm_ell": Case(lambda i: (lambda a: pt.csr_spmm_ell(
        a, i.mat(20, 5, 1.0), pt.row_capacity(a)))(i.csr())),
    "csr_spmm_fast": Case(lambda i: pt.csr_spmm_fast(i.csr(),
                                                     i.mat(20, 5, 1.0))),
    "row_capacity": Case(lambda i: pt.row_capacity(i.csr()), (F32,)),
    "spmm": Case(lambda i: pt.spmm(i.csr(), i.mat(20, 5, 1.0))),
    "dsmm": Case(lambda i: pt.dsmm(i.mat(5, 24, 1.0), i.csc())),
    "bsr_row_capacity": Case(lambda i: pt.bsr_row_capacity(i.bsr()),
                             (F32,)),
    "bsr_smvm_ell": Case(lambda i: (lambda a: pt.bsr_smvm_ell(
        a, i.vec(24), pt.bsr_row_capacity(a)))(i.bsr())),
    "bsr_spmm_ell": Case(lambda i: (lambda a: pt.bsr_spmm_ell(
        a, i.mat(24, 5, 1.0), pt.bsr_row_capacity(a)))(i.bsr())),
    # ops.cuda_bell: the kit's densified tiles take float32 / float64
    "bell_banded_refresh": Case(_banded, F),
    # io
    "mm_read_coo": Case(lambda i: _mm_round_trip(i)[1], F),
    "mm_write": Case(lambda i: _mm_round_trip(i)[0], F),
    # parallel, on 1 and 4 shards
    "cg_step": Case(_cg_step, F, "max", (1, 4)),
    "halo_spmm_overlapped": Case(_halo_spmm, FI, meshes=(1, 4)),
    "pbell_smvm": Case(lambda i: (lambda a: tpar.pbell_smvm(
        a, tpar.pbell_shard_vector(i.vec(24), a, i.mesh), i.mesh))(
        tpar.pbell_from_bell(pt.bell_from_bsr(i.bsr()), i.mesh)),
        meshes=(1, 4)),
    "pbell_spmm": Case(lambda i: (lambda a: tpar.pbell_spmm(
        a, tpar.pbell_shard_vector(i.mat(24, 5, 1.0), a, i.mesh),
        i.mesh))(tpar.pbell_from_bell(pt.bell_from_bsr(i.bsr()), i.mesh)),
        meshes=(1, 4)),
    "pbsr_smsmm": Case(lambda i: (lambda a: tpar.pbsr_smsmm(
        a, a, i.mesh, tpar.build_pbsr_smsmm_plan(a, a, i.mesh)))(
        tpar.pbsr_from_bsr(i.bsr(8, 16, 0.4), i.mesh)), meshes=(1, 4)),
    "pcsr_spgemm": Case(lambda i: tpar.pcsr_spgemm(i.pcsr(), i.pcsr(),
                                                   i.mesh), meshes=(1, 4)),
    "pcsr_spmm": Case(_pcsr_spmm, meshes=(1, 4)),
    "pcsr_todense": Case(lambda i: tpar.pcsr_todense(_dup_pcsr(i)),
                         meshes=(1, 4)),
    "pcsr_transpose": Case(lambda i: tpar.pcsr_transpose(i.pcsr(40, 30),
                                                         i.mesh),
                           meshes=(1, 4)),
    "power_iteration_step": Case(_power, F, "max", (1, 4)),
}

PARAMS = [pytest.param(name, dt, d, id=f"{name}-{str(dt)[6:]}"
                       + ("" if d is None else f"-d{d}"))
          for name, case in SURFACE.items() for dt in case.dtypes
          for d in case.meshes]


def _seed(name):
    return sum(name.encode()) * 7919 % 2**31


def _leaves(x, path="r"):
    """(path, leaf) pairs of a result: tensors, arrays and Python values,
    through dataclasses, tuples, lists and dicts."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, (tuple, list)):
        for k, y in enumerate(x):
            yield from _leaves(y, f"{path}[{k}]")
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}[{k!r}]")
    else:
        yield path, x


def _bits(t):
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _agree(cpu, card, scale, dt, how):
    """Hold the card's result against the CPU's, leaf by leaf."""
    cl, gl = list(_leaves(cpu)), list(_leaves(card))
    assert [p for p, _ in cl] == [p for p, _ in gl]
    sl = dict(_leaves(scale)) if scale is not None else {}
    for (path, c), (_, g) in zip(cl, gl):
        if not isinstance(c, torch.Tensor):
            assert type(g) is type(c), path
            if isinstance(c, np.ndarray):
                np.testing.assert_array_equal(g, c, err_msg=path)
            else:
                assert g == c, path
            continue
        assert isinstance(g, torch.Tensor) and g.device.type == "cuda", path
        assert g.dtype == c.dtype and g.shape == c.shape, path
        if not c.dtype.is_floating_point:
            assert torch.equal(g.cpu(), c), path
            continue
        c64, g64 = c.double(), g.double().cpu()
        assert torch.equal(c64.isnan(), g64.isnan()), path
        ok = ~c64.isnan()
        if not ok.any():
            continue
        s = sl.get(path)
        if how == "abs" and isinstance(s, torch.Tensor) \
                and s.shape == c.shape:
            bound = RTOL[dt] * s.double().abs()[ok]
        else:
            bound = RTOL[dt] * max(float(c64[ok].abs().max()), 1.0)
        err = (g64 - c64).abs()[ok]
        assert bool((err <= bound + 1e-30).all()), \
            f"{path}: max err {float(err.max())}"


@pytest.mark.parametrize("name,dt,d", PARAMS)
def test_surface_on_the_card(cuda, name, dt, d):
    case = SURFACE[name]
    seed = _seed(name)
    cpu = case.run(In(seed, dt, "cpu", d=d))
    card = case.run(In(seed, dt, cuda, d=d))
    again = case.run(In(seed, dt, cuda, d=d))
    torch.cuda.synchronize()
    scale = None
    if dt.is_floating_point and case.scale == "abs":
        scale = case.run(In(seed, F64, "cpu", absval=True, d=d))
    _agree(cpu, card, scale, dt, case.scale)
    for (path, x), (_, y) in zip(_leaves(card), _leaves(again)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(_bits(x), _bits(y)), f"{path}: not repeatable"
