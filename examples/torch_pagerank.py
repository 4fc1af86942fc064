"""PageRank by power iteration on a sparse link matrix (CSR fast path), on
the PyTorch port: the port of ``examples/pagerank.py``.

Run: python examples/torch_pagerank.py [--device cpu]

By default it runs on the card.  ``pagerank`` takes the device and the
graph (the reference's 2,000-page random graph by default, or any SciPy
adjacency), so the same 60 steps run at a million pages on the card.
"""

import argparse
import pathlib
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

DAMPING = 0.85


def random_links(n=2000, avg_out=12, seed=0):
    """The reference's dense 0/1 link matrix, no self links."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < avg_out / n).astype(np.float64)
    np.fill_diagonal(adj, 0)
    return adj


def transition(adj):
    """The column-stochastic transition matrix (adj / out-degree)^T of a
    dense array (as the reference builds it) or of a SciPy matrix's
    pattern (rows scaled by out-degree, transposed)."""
    if sp.issparse(adj):
        adj = sp.csr_matrix(adj, dtype=np.float64, copy=True)
        adj.data[:] = 1.0
        out_deg = np.maximum(np.asarray(adj.sum(axis=1)).ravel(), 1)
        return (sp.diags(1.0 / out_deg) @ adj).T.tocsr()
    out_deg = np.maximum(adj.sum(axis=1, keepdims=True), 1)
    return (adj / out_deg).T


def pagerank(p_mat, device="cuda", steps=60, route="fast"):
    """``steps`` power-iteration steps ``r <- d P r + (1 - d) / n`` in
    float32 on ``device``, and the float64 NumPy oracle of the same steps.

    ``route="fast"`` is the reference's ``build_spmv_plan`` +
    ``csr_smvm_fast``; ``route="auto"`` the main path, ``smvm_prepare`` ->
    ``plan.apply`` (its rung in the result).  Returns a dict: ``ranks``,
    ``oracle``, ``rung``, ``build_s`` (host seconds of the CSR and plan
    build) and ``ms_per_step`` (host clock around the card)."""
    import torch

    import sparse_tpu_torch as pt
    from sparse_tpu_torch import interop
    from sparse_tpu_torch.ops.spmv import build_spmv_plan, csr_smvm_fast

    n = p_mat.shape[0]
    t0 = time.perf_counter()
    if sp.issparse(p_mat):
        a = interop.csr_from_arrays(p_mat.data.astype(np.float32),
                                    p_mat.indices, p_mat.indptr,
                                    p_mat.shape, device=device)
    else:
        a = pt.csr_from_dense(torch.from_numpy(p_mat.astype(np.float32)),
                              device=device)
    if route == "fast":
        plan = build_spmv_plan(a)
        rung = "fast"

        def step(r):
            return DAMPING * csr_smvm_fast(a, r, plan) + (1 - DAMPING) / n
    else:
        auto = pt.smvm_prepare(a)
        rung = auto.kind

        def step(r):
            return DAMPING * auto.apply(r) + (1 - DAMPING) / n
    sync = torch.cuda.synchronize if a.device.type == "cuda" else \
        (lambda: None)
    sync()
    build_s = time.perf_counter() - t0
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=a.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        r = step(r)
    sync()
    ms = (time.perf_counter() - t0) / steps * 1e3
    ranks = r.cpu().numpy()
    oracle = np.full(n, 1.0 / n)
    for _ in range(steps):
        oracle = DAMPING * (p_mat @ oracle) + (1 - DAMPING) / n
    return dict(ranks=ranks, oracle=oracle, rung=rung, build_s=build_s,
                ms_per_step=ms)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = pagerank(transition(random_links()), device=args.device)
    ranks = out["ranks"]
    # f32 iteration vs f64 oracle
    np.testing.assert_allclose(ranks, out["oracle"], rtol=1e-5)
    top = np.argsort(ranks)[::-1][:5]
    print("top-5 pages:", top.tolist(), "ranks:",
          np.round(ranks[top], 5).tolist())
    return out


if __name__ == "__main__":
    main()
