"""The distributed layer's kernels on the card: K1 and K7 once per shard.

On an in-process mesh on the CUDA device, ``halo_spmv_segtile`` launches K1
once per shard per apply and ``pbsr_smsmm_slab`` launches K7 once per shard
per apply (the modules' launch counters); both equal the same mesh on the
CPU (the kernels' plain versions) within float32 1e-5 / float64 1e-12 of
``|A||v|``, and repeat bitwise.  CG through the K1 path agrees with the CPU
run, and the dry run's 13 sections pass on the card.  Needs a CUDA card:
skips without one (the kernels have no CPU mode).  The file imports no
jax.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu_torch.parallel as tpar
from sparse_tpu_torch import interop
from sparse_tpu_torch.ops import cuda_bsr, cuda_csr

pytestmark = pytest.mark.cuda
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _band(n, seed, dt):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 12)
    cols = np.clip(rows + rng.integers(-300, 300, rows.size), 0, n - 1)
    s = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n)).tocsr()
    s.data = s.data.astype(dt)
    return s


def _csr(s, device):
    return interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                   device=device)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_halo_segtile_launches_k1_per_shard(cuda, d, dt):
    s = _band(30_011, seed=d, dt=dt)
    v = np.random.default_rng(1).standard_normal(s.shape[0]).astype(dt)
    ys = {}
    for dev in ("cpu", cuda):
        mesh = tpar.make_1d_mesh(d, device=dev)
        hs = tpar.halo_partition_segtile(_csr(s, dev), mesh)
        vs = tpar.shard_vector(torch.from_numpy(v), hs, mesh)
        before = cuda_csr.K1_LAUNCHES
        ys[str(dev)] = y = tpar.halo_spmv_segtile(hs, vs, mesh)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert cuda_csr.K1_LAUNCHES - before == d
            assert torch.equal(y, tpar.halo_spmv_segtile(hs, vs, mesh))
    n = s.shape[0]
    bound = TOL[dt] * (abs(s).astype(np.float64) @ np.abs(v))
    err = np.abs(ys["cuda"][:n].double().cpu().numpy()
                 - ys["cpu"][:n].double().numpy())
    assert (err <= bound + 1e-30).all()


@pytest.mark.parametrize("d", [1, 4])
def test_cg_through_k1_matches_cpu(cuda, d):
    rng = np.random.default_rng(3)
    n = 4000
    s = _band(n, seed=7, dt=np.float64)
    spd = (s @ s.T + sp.identity(n) * 50).tocsr()
    b = rng.standard_normal(n)
    xs = {}
    for dev in ("cpu", cuda):
        mesh = tpar.make_1d_mesh(d, device=dev)
        hs = tpar.halo_partition_segtile(_csr(spd, dev), mesh)
        bv = tpar.shard_vector(torch.from_numpy(b), hs, mesh)
        xs[str(dev)] = tpar.cg_solve(hs, bv, mesh, iters=20).cpu().numpy()
    np.testing.assert_allclose(xs["cuda"], xs["cpu"], rtol=1e-10,
                               atol=1e-12 * np.abs(xs["cpu"]).max())


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 4, 8])
def test_pbsr_slab_launches_k7_per_shard(cuda, d, dt):
    rng = np.random.default_rng(d)
    nb, bsz = 40, 16
    rr, cc = np.nonzero(rng.random((nb, nb)) < 0.2)
    blocks = rng.standard_normal((rr.size, bsz, bsz)).astype(dt)
    out = {}
    for dev in ("cpu", cuda):
        a = interop.bsr_from_arrays(rr * nb + cc, blocks, nb * bsz, bsz,
                                    device=dev)
        mesh = tpar.make_1d_mesh(d, device=dev)
        pa = tpar.pbsr_from_bsr(a, mesh)
        plan = tpar.build_pbsr_smsmm_plan_slab(pa, pa, mesh)
        before = cuda_bsr.K7_LAUNCHES
        out[str(dev)] = c = tpar.pbsr_smsmm_slab(pa, pa, mesh, plan).blocks
        if dev != "cpu":
            torch.cuda.synchronize()
            assert cuda_bsr.K7_LAUNCHES - before == d
            assert torch.equal(c, tpar.pbsr_smsmm_slab(pa, pa, mesh,
                                                       plan).blocks)
    got, want = out["cuda"].double().cpu().numpy(), out["cpu"].double().numpy()
    scale = np.abs(blocks).max() ** 2 * bsz * 8
    assert np.abs(got - want).max() <= TOL[dt] * scale


def test_dryrun_on_the_card(cuda, capsys):
    from sparse_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun[4dev]")]
    assert len(lines) == 13 and all(ln.endswith(" ok") for ln in lines)
