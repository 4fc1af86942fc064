"""The port's distributed solvers (``sparse_tpu_torch.parallel.cg``) held
against the reference's ``sparse_tpu.parallel.cg``.

Same numpy-seeded systems and the same iteration counts for both packages:
CG through ``PCSR`` and through ``HaloSegtile`` (K1 per shard; its plain
version on the CPU) for D = 1, 2 and 8 in float32 and float64; PCG with
Jacobi, block-Jacobi and Chebyshev preconditioners, BiCGSTAB and GMRES
(with and without Jacobi) at D = 8 and 2.  Iterates agree at rtol 1e-4
(float32) / 1e-10 (float64), and so do the residuals ``||b - A x||``.
The reference's own ``tests/test_parallel.py`` solver checks (dense
solves, preconditioning wins) run on the port alone, and
``estimate_lmax`` fails on a ``PHubSplit`` in both packages (the
reference's dtype probe reads fields that type lacks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu.parallel as jpar
import sparse_tpu_torch.parallel as tpar
from sparse_tpu.formats.csr import CSR as JCSR
from sparse_tpu_torch import csr_diagonal, interop

CPU = "cpu"
RTOL = {np.float32: 1e-4, np.float64: 1e-10}


def both_csr(x):
    s = sp.csr_matrix(x)
    ref = JCSR(data=jnp.asarray(s.data),
               indices=jnp.asarray(s.indices.astype(np.int32)),
               indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=x.shape)
    port = interop.csr_from_arrays(s.data, s.indices, s.indptr, x.shape,
                                   device=CPU)
    return ref, port


def spd(n, seed, dens=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < dens)
    return x @ x.T + n * np.eye(n), rng


def nonsym(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    return x + n * np.eye(n), rng


def setup(A, b, d, kind="pcsr", dt=np.float64):
    A, b = A.astype(dt), b.astype(dt)
    ja, ta = both_csr(A)
    jm, tm = jpar.make_1d_mesh(d), tpar.make_1d_mesh(d, device=CPU)
    part = {"pcsr": (jpar.pcsr_from_csr, tpar.pcsr_from_csr),
            "segtile": (jpar.halo_partition_segtile,
                        tpar.halo_partition_segtile)}[kind]
    jp, tp = part[0](ja, jm), part[1](ta, tm)
    total = tp.rows_per_shard * d
    bp = np.concatenate([b, np.zeros(total - b.size, dt)])
    return (ja, jm, jp, jnp.asarray(bp)), (ta, tm, tp, tpar.put_sharded(bp,
                                                                        tm))


def agree(got, want, A, b, dt):
    """Iterates and residuals agree at the dtype's rtol."""
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    n = A.shape[0]
    rtol = RTOL[dt]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
    r_got = np.linalg.norm(b - A @ got[:n])
    r_want = np.linalg.norm(b - A @ want[:n])
    np.testing.assert_allclose(r_got, r_want, rtol=rtol * 10,
                               atol=rtol * np.linalg.norm(b))


@pytest.mark.parametrize("kind", ["pcsr", "segtile"])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_cg_matches_reference(d, dt, kind):
    A, rng = spd(37, seed=11 + d)
    b = rng.standard_normal(37)
    (ja, jm, jp, jb), (ta, tm, tp, tb) = setup(A, b, d, kind, dt)
    got = tpar.cg_solve(tp, tb, tm, iters=12)
    agree(got, jpar.cg_solve(jp, jb, jm, iters=12), A, b, dt)


def _precond(name, ja, ta, jp, tp, jm, tm, jb, tb):
    if name == "jacobi":
        n = ja.shape[0]
        inv = 1.0 / csr_diagonal(ta).numpy()
        total = tp.rows_per_shard * tp.n_shards
        invp = np.concatenate([inv, np.zeros(total - n)])
        return jnp.asarray(invp), tpar.put_sharded(invp, tm)
    if name == "block_jacobi":
        import sparse_tpu as jst
        import sparse_tpu_torch as tst

        return (jst.block_jacobi_prepare(ja, 4, padded_n=jb.shape[0]),
                tst.block_jacobi_prepare(ta, 4, padded_n=tb.shape[0]))
    lmax_j = float(jpar.estimate_lmax(jp, jm, iters=20))
    lmax_t = float(tpar.estimate_lmax(tp, tm, iters=20))
    np.testing.assert_allclose(lmax_t, lmax_j, rtol=1e-10)
    return (jpar.chebyshev_preconditioner(jp, jm, lmax=lmax_j, degree=4),
            tpar.chebyshev_preconditioner(tp, tm, lmax=lmax_t, degree=4))


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("name", ["jacobi", "block_jacobi", "chebyshev"])
def test_pcg_matches_reference(name, d):
    rng = np.random.default_rng(21)
    n = 48
    dg = 10.0 ** rng.uniform(0, 2, n)
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    A = x @ x.T + np.diag(dg) + n * np.eye(n)
    b = rng.standard_normal(n)
    (ja, jm, jp, jb), (ta, tm, tp, tb) = setup(A, b, d)
    mj, mt = _precond(name, ja, ta, jp, tp, jm, tm, jb, tb)
    got = tpar.pcg_solve(tp, tb, mt, tm, iters=10)
    agree(got, jpar.pcg_solve(jp, jb, mj, jm, iters=10), A, b, np.float64)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [2, 8])
def test_bicgstab_matches_reference(d, dt):
    A, rng = nonsym(40, seed=51)
    b = rng.standard_normal(40)
    (ja, jm, jp, jb), (ta, tm, tp, tb) = setup(A, b, d, dt=dt)
    agree(tpar.bicgstab_solve(tp, tb, tm, iters=8),
          jpar.bicgstab_solve(jp, jb, jm, iters=8), A, b, dt)


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_gmres_matches_reference(dt, jacobi):
    A, rng = nonsym(40, seed=53)
    b = rng.standard_normal(40)
    (ja, jm, jp, jb), (ta, tm, tp, tb) = setup(A, b, 8, dt=dt)
    mj = mt = None
    if jacobi:
        inv = np.zeros(tb.shape[0], dt)
        inv[:40] = 1.0 / np.diag(A)
        mj, mt = jnp.asarray(inv), torch.from_numpy(inv)
    got = tpar.gmres_solve(tp, tb, tm, inv_diag=mt, restart=6, iters=2)
    want = jpar.gmres_solve(jp, jb, jm, inv_diag=mj, restart=6, iters=2)
    agree(got, want, A, b, dt)


def test_gmres_converged_restart_is_masked():
    # a restart after the residual reached zero changes nothing (the
    # reference's while_loop stops there)
    A = np.diag(np.arange(1.0, 9.0))
    b = np.ones(8)
    _, (ta, tm, tp, tb) = setup(A, b, 2)
    got = tpar.gmres_solve(tp, tb, tm, restart=8, iters=3)
    np.testing.assert_allclose(got.numpy(), b / np.arange(1.0, 9.0),
                               rtol=1e-12)


def test_port_solvers_dense_oracles():
    # the reference's test_parallel.py solver checks, on the port
    A, rng = spd(64, seed=11)
    x_true = rng.standard_normal(64)
    _, (ta, tm, tp, tb) = setup(A, A @ x_true, 8)
    np.testing.assert_allclose(tpar.cg_solve(tp, tb, tm, iters=128)[:64],
                               x_true, rtol=1e-6, atol=1e-6)
    N, rng = nonsym(48, seed=51)
    x_true = rng.standard_normal(48)
    _, (ta, tm, tp, tb) = setup(N, N @ x_true, 8)
    np.testing.assert_allclose(tpar.bicgstab_solve(tp, tb, tm, iters=96)[:48],
                               x_true, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tpar.gmres_solve(tp, tb, tm, restart=24, iters=4)[:48], x_true,
        rtol=1e-6, atol=1e-6)


def test_chebyshev_and_jacobi_win():
    rng = np.random.default_rng(59)
    n = 64
    dg = 10.0 ** rng.uniform(0, 3, n)
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    A = x @ x.T + np.diag(dg) + np.eye(n)
    x_true = rng.standard_normal(n)
    _, (ta, tm, tp, tb) = setup(A, A @ x_true, 8)
    lmax = float(tpar.estimate_lmax(tp, tm))
    assert lmax >= np.linalg.eigvalsh(A).max() * 0.98
    M = tpar.chebyshev_preconditioner(tp, tm, lmax=lmax, degree=8)
    err_c = np.linalg.norm(tpar.cg_solve(tp, tb, tm, iters=25)[:n].numpy()
                           - x_true)
    err_p = np.linalg.norm(tpar.pcg_solve(tp, tb, M, tm, iters=25)[:n]
                           .numpy() - x_true)
    assert err_p < err_c * 1e-3
    inv = tpar.shard_vector(1.0 / csr_diagonal(ta), tp, tm)
    err_j = np.linalg.norm(tpar.pcg_solve(tp, tb, inv, tm, iters=25)[:n]
                           .numpy() - x_true)
    assert err_j < err_c


def test_estimate_lmax_fails_on_phub_in_both():
    A, _ = spd(16, seed=3)
    ja, ta = both_csr(A)
    jm, tm = jpar.make_1d_mesh(2), tpar.make_1d_mesh(2, device=CPU)
    with pytest.raises(AttributeError):
        jpar.estimate_lmax(jpar.phub_partition(ja, jm, max_hub_cols=4), jm)
    with pytest.raises(AttributeError):
        tpar.estimate_lmax(tpar.phub_partition(ta, tm, max_hub_cols=4), tm)
