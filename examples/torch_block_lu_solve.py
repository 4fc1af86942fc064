"""Direct solve of a block-sparse FEM-style system with the BSR LU stack, on
the PyTorch port: the port of ``examples/block_lu_solve.py``.

Run: python examples/torch_block_lu_solve.py [--device cpu]

By default it runs on the card.  ``block_lu`` takes the device, the block
size and the block count (the reference's bsz 4, nb 12 by default); past
``DENSE_MAX`` rows the matrix is built from its blocks instead of a dense
array, and P.A - L.U is checked block by block in SciPy.
"""

import argparse
import pathlib
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

#: up to this many rows the matrix is drawn dense, as the reference draws it
DENSE_MAX = 4096


def block_tridiagonal(nb, bsz, rng):
    """A block-tridiagonal stiffness-like matrix plus 6 I, float64.  Up to
    ``DENSE_MAX`` rows: the reference's dense draw (one normal per entry of
    the n x n array, masked).  Beyond: one normal per entry of the stored
    blocks, as a SciPy BSR."""
    n = bsz * nb
    if n <= DENSE_MAX:
        mask = np.zeros((nb, nb), bool)
        for off in (-1, 0, 1):
            mask |= np.eye(nb, k=off, dtype=bool)
        dense = rng.standard_normal((n, n)) * np.kron(mask,
                                                      np.ones((bsz, bsz)))
        return dense + 6 * np.eye(n)
    br = np.concatenate([np.arange(nb), np.arange(1, nb),
                         np.arange(nb - 1)])
    bc = np.concatenate([np.arange(nb), np.arange(nb - 1),
                         np.arange(1, nb)])
    order = np.lexsort((bc, br))
    br, bc = br[order], bc[order]
    blocks = rng.standard_normal((br.size, bsz, bsz))
    blocks[br == bc] += 6 * np.eye(bsz)
    indptr = np.searchsorted(br, np.arange(nb + 1))
    return sp.bsr_matrix((blocks, bc, indptr), shape=(n, n))


def _scipy_of(a):
    """A port BSR as a SciPy CSR in float64 (stored blocks only)."""
    import sparse_tpu_torch as pt

    coo = pt.bsr_to_coo(a)
    row, col = coo.row.cpu().numpy(), coo.col.cpu().numpy()
    keep = row < a.n
    return sp.csr_matrix((coo.data.double().cpu().numpy()[keep],
                          (row[keep], col[keep])), shape=(a.n, a.n))


def block_lu(bsz=4, nb=12, device="cuda"):
    """The reference's flow in float64: ``bsr_lu_find_fills``, ``bsr_lup``
    with P.A - L.U through ``bsr_smsmm`` of its factors, then ``bsr_ols``
    and its residual through ``bsr_smvm``.  Returns a dict: ``fills``,
    ``lu_err`` (max |P.A - L.U|), ``resid`` (max |A x - b|) and host
    seconds (``seconds``: the LU and the solve, around the card)."""
    import torch

    import sparse_tpu_torch as pt
    from sparse_tpu_torch import interop

    rng = np.random.default_rng(7)
    n = bsz * nb
    m = block_tridiagonal(nb, bsz, rng)
    if sp.issparse(m):
        bc = m.indices
        br = np.repeat(np.arange(nb), np.diff(m.indptr))
        a = interop.bsr_from_arrays(br * nb + bc, m.data, n, bsz,
                                    device=device)
    else:
        a = pt.bsr_from_dense(torch.from_numpy(m), bsz, device=device)
    sync = torch.cuda.synchronize if a.blocks.is_cuda else (lambda: None)
    out = dict(n=n, nb=nb, bsz=bsz, seconds={})

    fills = pt.bsr_lu_find_fills(a)
    out["fills"] = len(fills)

    sync()
    t0 = time.perf_counter()
    lu, p = pt.bsr_lup(a)
    sync()
    out["seconds"]["bsr_lup"] = time.perf_counter() - t0
    recon = pt.bsr_smsmm(pt.bsr_lower(lu), pt.bsr_upper(lu))
    p = p.cpu().numpy()
    if sp.issparse(m):
        out["lu_err"] = float(abs(m.tocsr()[p] - _scipy_of(recon)).max())
    else:
        out["lu_err"] = float(np.abs(m[p] - pt.bsr_todense(
            recon).cpu().numpy()).max())

    x_true = rng.standard_normal(n)
    b = m @ x_true
    sync()
    t0 = time.perf_counter()
    x = pt.bsr_ols(a, torch.from_numpy(b).to(a.blocks.device))
    sync()
    out["seconds"]["bsr_ols"] = time.perf_counter() - t0
    out["resid"] = float(np.abs(pt.bsr_smvm(a, x).cpu().numpy() - b).max())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = block_lu(device=args.device)
    print(f"{out['nb']}x{out['nb']} blocks (bsz={out['bsz']}), fill-in "
          f"blocks: {out['fills']}")
    print("max |P.A - L.U| =", out["lu_err"])
    print("ols residual:", out["resid"])
    assert out["resid"] < 1e-8
    return out


if __name__ == "__main__":
    main()
