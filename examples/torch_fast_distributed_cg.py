"""Distributed CG with the fast per-shard kernel, on the PyTorch port: the
port of ``examples/fast_distributed_cg.py``.

``halo_partition_segtile`` builds one segment-tile plan per shard over the
halo column space; every solver in ``parallel/cg.py`` dispatches its
matvec through ``dist_spmv``, so the same ``cg_solve`` call runs K1 once
per shard per matvec on a ``HaloSegtile`` partition (on the card) and the
plain gather-and-sum formulation on a ``PCSR`` baseline.  Iterates stay in
the distributed layout throughout.

Run: python examples/torch_fast_distributed_cg.py [--device cpu] [--shards 8]

By default it runs on the card, all shards in one process.
``fast_cg`` takes the device, the size and the shard count (the
reference's n = 400 by default).
"""

import argparse
import pathlib
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

#: up to this size the operator is built dense, as the reference builds it
DENSE_MAX = 4096


def spd_operator(n, rng):
    """The reference's banded SPD operator X X^T + 4 I in float32: row i of
    X holds 5 draws within +-10 columns of i (a repeated column keeps its
    last draw), in the reference's order of draws.  Dense (NumPy) up to
    ``DENSE_MAX`` rows, else a SciPy CSR built from the same draws."""
    rows, cols, vals = [], [], []
    for i in range(n):
        js = np.clip(i + rng.integers(-10, 11, size=5), 0, n - 1)
        rows.append(np.full(js.size, i))
        cols.append(js)
        vals.append(rng.standard_normal(js.size) * 0.3)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.concatenate(vals).astype(np.float32)
    if n <= DENSE_MAX:
        x = np.zeros((n, n), np.float32)
        x[rows, cols] = vals  # a repeated index keeps its last value
        return x @ x.T + np.eye(n, dtype=np.float32) * 4.0
    # each (row, column)'s last draw: its first in reversed order
    _, first = np.unique((rows * n + cols)[::-1], return_index=True)
    keep = rows.size - 1 - first
    x = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, n))
    spd = (x @ x.T + sp.identity(n, dtype=np.float32, format="csr") * 4.0)
    return spd.astype(np.float32).tocsr()


def fast_cg(n=400, device="cuda", shards=1, iters=60):
    """The reference's flow: the operator partitioned once as a
    ``HaloSegtile`` and solved by ``cg_solve``, then the same call on the
    ``PCSR`` baseline.  Returns a dict with both solutions (float64 NumPy),
    the segment-tile partition's halo and fill, the relative residual of
    the first, the operator (NumPy or SciPy), ``b`` and host seconds of
    the build (``build_s``) and of each solve (``seconds``)."""
    import torch

    import sparse_tpu_torch as pt
    from sparse_tpu_torch import interop
    from sparse_tpu_torch.parallel import (cg_solve, halo_partition_segtile,
                                           make_1d_mesh, pcsr_from_csr)
    from sparse_tpu_torch.parallel.pcsr import shard_vector

    mesh = make_1d_mesh(shards, device=device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    spd = spd_operator(n, rng)
    if sp.issparse(spd):
        a = interop.csr_from_arrays(spd.data, spd.indices, spd.indptr,
                                    spd.shape, device=device)
    else:
        a = pt.csr_from_dense(torch.from_numpy(spd), device=device)
    b_np = rng.standard_normal(n).astype(np.float32)

    # partition once with the richest structure the pattern supports: the
    # segment-tile halo partition (per-shard plans + strictly remote halo)
    hs = halo_partition_segtile(a, mesh)
    pa = pcsr_from_csr(a, mesh)  # only for the vector-padding convention
    b = shard_vector(torch.from_numpy(b_np), pa, mesh)
    sync = torch.cuda.synchronize if b.is_cuda else (lambda: None)
    sync()
    out = dict(n=n, shards=shards, iters=iters, halo=hs.halo, fill=hs.fill,
               spd=spd, b=b_np, build_s=time.perf_counter() - t0,
               seconds={})
    for name, part in (("segtile", hs), ("pcsr", pa)):
        sync()
        t0 = time.perf_counter()
        xs = cg_solve(part, b, mesh, iters=iters)
        sync()
        out["seconds"][name] = time.perf_counter() - t0
        out[name] = xs[:n].double().cpu().numpy()
    resid = spd @ out["segtile"] - b_np
    out["rel"] = float(np.linalg.norm(resid) / np.linalg.norm(b_np))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)
    print(f"mesh: {args.shards} shards")
    out = fast_cg(device=args.device, shards=args.shards)
    print(f"halo/shard: {out['halo']} entries (vs {out['n']} for an "
          f"all-gather); worst shard tile fill {out['fill']:.3f}")
    print(f"CG({out['iters']}) through the segment-tile shard bodies: "
          f"rel residual {out['rel']:.2e}")
    assert out["rel"] < 1e-5
    # the same call on the all-gather scalar baseline: the same result,
    # the matvec is the slow formulation (dist_spmv dispatches on type)
    np.testing.assert_allclose(out["pcsr"], out["segtile"], rtol=2e-4,
                               atol=2e-4)
    print("matches the PCSR baseline solver to tolerance")
    return out


if __name__ == "__main__":
    main()
