"""AMG-style Galerkin triple product R A P with pattern reuse, on the
PyTorch port: the port of ``examples/galerkin_reuse.py``.

Multigrid set-up recomputes the coarse operator A_c = R A P every time the
fine operator's values change while all three patterns stay fixed: the
contract of ``spgemm_prepare`` / ``spgemm_apply``.  The symbolic pass runs
once per pattern pair; each update is two numeric passes with no sort.

Run: python examples/torch_galerkin_reuse.py [--device cpu]

By default it runs on the card.  ``galerkin`` takes the device, the fine
size and the number of updates (the reference's n = 256 by default).
"""

import argparse
import pathlib
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def fine_operator(n, coeff):
    """1-D variable-coefficient Laplacian: pattern fixed, values = coeff."""
    main = coeff[:-1] + coeff[1:]
    return sp.diags([-coeff[1:-1], main, -coeff[1:-1]], [-1, 0, 1],
                    shape=(n, n), format="csr")


def interpolation(n):
    """Linear interpolation P (n x n/2) and restriction R = P^T."""
    nc = n // 2
    rows = np.repeat(np.arange(nc), 3)
    cols = np.stack([2 * np.arange(nc) - 1, 2 * np.arange(nc),
                     2 * np.arange(nc) + 1], 1).reshape(-1)
    vals = np.tile([0.5, 1.0, 0.5], nc)
    keep = (cols >= 0) & (cols < n)
    P = sp.coo_matrix((vals[keep], (cols[keep], rows[keep])),
                      shape=(n, nc)).tocsr()
    return P, P.T.tocsr()


def galerkin(n=256, device="cuda", steps=20):
    """Plans once, then ``steps`` value updates of A_c = R (A P); the first
    update's A_c is checked against SciPy's R A P (``np.allclose``, as the
    reference checks it).  Returns a dict: ``ms_per_step`` (host clock
    around the card), the last coarse operator's stored count, the first
    update's largest error beside its allowance, and the host seconds of
    the plans (``plan_s``)."""
    import torch

    from sparse_tpu_torch import interop, spgemm_apply, spgemm_prepare

    nc = n // 2
    rng = np.random.default_rng(0)
    P, R = interpolation(n)

    def to_csr(s):
        s = s.tocsr()
        return interop.csr_from_arrays(s.data.astype(np.float32), s.indices,
                                       s.indptr, s.shape, device=device)

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    coeff0 = 1.0 + rng.random(n + 1)
    t0 = time.perf_counter()
    a = to_csr(fine_operator(n, coeff0))
    r = to_csr(R)
    p = to_csr(P)

    # symbolic passes, once per pattern pair
    plan_ap = spgemm_prepare(a, p)
    ap0 = spgemm_apply(plan_ap, a, p)
    plan_rap = spgemm_prepare(r, ap0)
    sync()
    out = dict(n=n, nc=nc, steps=steps, plan_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for s in range(steps):
        coeff = 1.0 + rng.random(n + 1)  # fresh values, same pattern
        a_s = to_csr(fine_operator(n, coeff))
        ap = spgemm_apply(plan_ap, a_s, p)
        ac = spgemm_apply(plan_rap, r, ap)
        sync()
        if s == 0:
            ref = (R @ fine_operator(n, coeff) @ P).tocsr()
            k = int(ac.indptr[-1])
            got = sp.csr_matrix((ac.data[:k].double().cpu().numpy(),
                                 ac.indices[:k].cpu().numpy(),
                                 ac.indptr.cpu().numpy()), shape=(nc, nc))
            d = (got - ref).tocoo()
            ref_at = np.asarray(ref[d.row, d.col]).ravel()
            err = np.abs(d.data)
            out["first_max_err"] = float(err.max(initial=0.0))
            # np.allclose's rule, entry by entry
            out["first_ok"] = bool(np.all(err <= 1e-8 + 1e-5 * np.abs(
                ref_at)))
    out["ms_per_step"] = (time.perf_counter() - t0) / steps * 1e3
    out["stored"] = int(ac.indptr[-1])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = galerkin(device=args.device)
    assert out["first_ok"], "Galerkin product mismatch"
    print(f"coarse operator update via plans: {out['ms_per_step']:.2f} "
          f"ms/step (A_c is {out['nc']}x{out['nc']}, {out['stored']} "
          "stored)")
    return out


if __name__ == "__main__":
    main()
