"""Solve a 2-D Poisson problem (5-point stencil) with distributed
preconditioned CG on a mesh of shards, on the PyTorch port: the port of
``examples/poisson_cg.py``.

Run: python examples/torch_poisson_cg.py [--device cpu] [--shards 8]

By default it runs on the card, all shards in one process.  ``poisson``
takes the device, the grid side and the shard count (the reference's
32 x 32 grid by default).
"""

import argparse
import pathlib
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build_poisson(k: int):
    """5-point stencil on a k x k grid as COO triples, in the order of the
    reference's loop: each point's diagonal, then its neighbours above,
    below, left and right where they exist."""
    n = k * k
    p = np.arange(n)
    i, j = p // k, p % k
    cols = np.stack([p, p - k, p + k, p - 1, p + 1], 1)
    ok = np.stack([np.ones(n, bool), i > 0, i < k - 1, j > 0, j < k - 1], 1)
    rows = np.broadcast_to(p[:, None], cols.shape)
    vals = np.broadcast_to(np.array([4.0, -1.0, -1.0, -1.0, -1.0]),
                           cols.shape)
    return n, rows[ok], cols[ok], vals[ok]


def poisson(k=32, device="cuda", shards=1, iters=60, final_iters=120):
    """The reference's flow: the stencil as a float32 CSR, row-partitioned
    over ``shards``; PCG with Jacobi, 4 x 4 block-Jacobi and degree-6
    Chebyshev preconditioners at ``iters`` iterations, then Chebyshev at
    ``final_iters``.  Returns a dict with each solution (``x``, float64
    NumPy), its relative error against the true solution, ``x_true``,
    ``b``, the matrix in SciPy (float32 values), ``lmax`` and the host
    seconds of each solve (``seconds``, around the card)."""
    import time

    import torch

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.parallel import (chebyshev_preconditioner,
                                           estimate_lmax, make_1d_mesh,
                                           pcg_solve, pcsr_from_csr)
    from sparse_tpu_torch.parallel.pcsr import shard_vector

    n, rows, cols, vals = build_poisson(k)
    a = pt.csr_from_coo(pt.coo_make((n, n), rows, cols, torch.from_numpy(
        vals.astype(np.float32)), device=device))
    mesh = make_1d_mesh(shards, device=device)
    pa = pcsr_from_csr(a, mesh)

    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n).astype(np.float32)
    s = sp.csr_matrix((vals.astype(np.float32), (rows, cols)), shape=(n, n))
    b = s @ x_true

    bv = shard_vector(torch.from_numpy(b), pa, mesh)

    # the ladder at a fixed budget: elementwise Jacobi, 4x4 block-Jacobi
    # (batched inverses) and a degree-6 Chebyshev polynomial (matvecs only)
    inv_d = shard_vector(1.0 / pt.csr_diagonal(a), pa, mesh)
    inv_blocks = pt.block_jacobi_prepare(a, 4, padded_n=bv.shape[0])
    lmax = float(estimate_lmax(pa, mesh))
    cheb = chebyshev_preconditioner(pa, mesh, lmax=lmax, degree=6)
    sync = torch.cuda.synchronize if bv.is_cuda else (lambda: None)
    out = dict(x={}, err={}, seconds={}, x_true=x_true, b=b, s=s, lmax=lmax,
               n=n, shards=shards, iters=iters, final_iters=final_iters)
    runs = [("jacobi", inv_d, iters), ("block-jacobi(4)", inv_blocks, iters),
            ("chebyshev(6)", cheb, iters),
            (f"chebyshev(6) x{final_iters}", cheb, final_iters)]
    for name, M, it in runs:
        sync()
        t0 = time.perf_counter()
        x = pcg_solve(pa, bv, M, mesh, iters=it)
        sync()
        out["seconds"][name] = time.perf_counter() - t0
        xh = x[:n].double().cpu().numpy()
        out["x"][name] = xh
        out["err"][name] = np.linalg.norm(xh - x_true) / np.linalg.norm(
            x_true)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)
    k = 32
    out = poisson(k, device=args.device, shards=args.shards)
    for name in ("jacobi", "block-jacobi(4)", "chebyshev(6)"):
        print(f"grid {k}x{k} ({out['n']} unknowns) on {out['shards']} "
              f"shards, {out['iters']} iters, {name}: relative error "
              f"{out['err'][name]:.2e}")
    assert out["err"][f"chebyshev(6) x{out['final_iters']}"] < 1e-4
    return out


if __name__ == "__main__":
    main()
