"""The whole distributed layer once, over an in-process mesh of n shards.

Port of ``__graft_entry__.dryrun_multichip``: the same 13 sections, each
printing ``dryrun[<n>dev] <section> ok`` once it ran and its result held.
The reference's two Pallas-in-``shard_map`` sections are the kernel-per-
shard sections here: ``halo_spmv_segtile`` runs K1 once per shard and
``pbsr_smsmm_slab`` runs K7 once per shard (their plain versions on the
CPU).  Every section is checked against a float64 NumPy product or against
another path of the layer.

    python -m sparse_tpu_torch.parallel.dryrun 8 [cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def _close(got, want, tol=1e-4):
    got = got.detach().double().cpu().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the 13 sections on ``make_1d_mesh(n_devices, device=device)``
    (the card by default)."""
    from .. import bsr_from_dense, csr_from_dense
    from ..formats.bell import bell_from_bsr
    from ..formats.bsr import BSR, bsr_todense
    from . import (build_pbsr_smsmm_plan, build_pbsr_smsmm_plan_slab,
                   build_pspgemm_plan, build_transpose_plan, cg_solve,
                   gmres_solve, halo_partition, halo_partition_overlapped,
                   halo_partition_segtile, halo_spmm, halo_spmv,
                   halo_spmv_overlapped, halo_spmv_segtile, make_1d_mesh,
                   pbell_from_bell, pbell_shard_vector, pbell_smvm,
                   pbell_spmm, pbsr_from_bsr, pbsr_smsmm, pbsr_smsmm_slab,
                   pbsr_to_bsr, pcsr_from_csr, pcsr_spgemm_aa, pcsr_todense,
                   pcsr_transpose_device, phub_partition, phub_spmv,
                   shard_vector)

    mesh = make_1d_mesh(n_devices, device=device)
    dev = mesh.device
    tag = f"dryrun[{n_devices}dev]"
    rng = np.random.default_rng(1)
    n = 8 * n_devices
    x = rng.standard_normal((n, n)).astype(np.float32) \
        * (rng.random((n, n)) < 0.3)
    spd = (x @ x.T + n * np.eye(n)).astype(np.float32)
    a_csr = csr_from_dense(torch.from_numpy(spd), device=dev)
    a = pcsr_from_csr(a_csr, mesh)
    b_np = rng.standard_normal(n).astype(np.float32)
    b = shard_vector(torch.from_numpy(b_np), a, mesh)
    spd64 = spd.astype(np.float64)

    out = cg_solve(a, b, mesh, iters=2)
    assert out.shape == b.shape and bool(torch.isfinite(out).all())
    print(f"{tag} cg_solve (all_gather+all_reduce) ok", flush=True)

    ha = halo_partition(a_csr, mesh)
    hout = halo_spmv(ha, b, mesh)
    _close(hout[:n], spd64 @ b_np)
    print(f"{tag} halo_spmv (all_to_all) ok", flush=True)

    ho = halo_partition_overlapped(a_csr, mesh)
    _close(halo_spmv_overlapped(ho, b, mesh), hout.double().cpu().numpy(),
           1e-5)
    print(f"{tag} halo_spmv_overlapped ok", flush=True)

    hs = halo_partition_segtile(a_csr, mesh)
    _close(halo_spmv_segtile(hs, b, mesh)[:n],
           hout[:n].double().cpu().numpy(), 1e-5)
    print(f"{tag} halo_spmv_segtile (K1 per shard) ok", flush=True)

    bm_np = rng.standard_normal((n, 8)).astype(np.float32)
    bmat = shard_vector(torch.from_numpy(bm_np), a, mesh)
    _close(halo_spmm(ha, bmat, mesh)[:n], spd64 @ bm_np)
    print(f"{tag} halo_spmm (all_to_all) ok", flush=True)

    e = pbell_from_bell(bell_from_bsr(bsr_from_dense(
        torch.from_numpy(spd), 4, device=dev)), mesh)
    ev = pbell_shard_vector(torch.ones(n), e, mesh)
    _close(pbell_smvm(e, ev, mesh)[:n], spd64.sum(1))
    print(f"{tag} pbell_smvm ok", flush=True)

    em = pbell_shard_vector(torch.ones(n, 8), e, mesh)
    _close(pbell_spmm(e, em, mesh)[:n], np.repeat(spd64.sum(1)[:, None], 8,
                                                  1))
    print(f"{tag} pbell_spmm ok", flush=True)

    ph = phub_partition(a_csr, mesh, max_hub_cols=8)
    _close(phub_spmv(ph, b, mesh)[:n], hout[:n].double().cpu().numpy(),
           1e-5)
    print(f"{tag} phub_spmv (hub all_gather) ok", flush=True)

    plan = build_pspgemm_plan(a, a, mesh)
    c = pcsr_spgemm_aa(a, a, mesh, plan)
    _close(pcsr_todense(c), spd64 @ spd64, 1e-3)
    print(f"{tag} pcsr_spgemm_aa (all_to_all) ok", flush=True)

    at = pcsr_transpose_device(a, mesh, build_transpose_plan(a, mesh))
    _close(pcsr_todense(at), spd64.T)
    print(f"{tag} pcsr_transpose_device (all_to_all) ok", flush=True)

    g = gmres_solve(a, b, mesh, restart=4, iters=1)
    assert g.shape == b.shape and bool(torch.isfinite(g).all())
    print(f"{tag} gmres_solve ok", flush=True)

    rng = np.random.default_rng(11)
    nbb, bszb = 4 * n_devices, 4
    rr, cc = np.nonzero(rng.random((nbb, nbb)) < 0.3)
    ab = BSR(indices=torch.from_numpy(rr * nbb + cc).to(torch.int32).to(dev),
             blocks=torch.from_numpy(rng.standard_normal(
                 (rr.size, bszb, bszb)).astype(np.float32)).to(dev),
             n=nbb * bszb, bsz=bszb)
    dense_b = bsr_todense(ab).double().cpu().numpy()
    pab = pbsr_from_bsr(ab, mesh)
    pc = pbsr_smsmm(pab, pab, mesh, build_pbsr_smsmm_plan(pab, pab, mesh))
    _close(bsr_todense(pbsr_to_bsr(pc)), dense_b @ dense_b)
    print(f"{tag} pbsr_smsmm (all_to_all) ok", flush=True)

    pcp = pbsr_smsmm_slab(pab, pab, mesh,
                          build_pbsr_smsmm_plan_slab(pab, pab, mesh))
    _close(pcp.blocks, pc.blocks.double().cpu().numpy())
    print(f"{tag} pbsr_smsmm_slab (K7 per shard) ok", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
