"""The distributed layer across two ``torch.distributed`` processes (gloo),
held against the same 8-shard mesh in one process.

The analogue of ``tests/test_multiprocess.py`` / ``_mp_worker.py``: two CPU
processes of 4 shards each form one 8-shard mesh (``make_1d_mesh(8,
group=WORLD)``).  ``put_sharded`` keeps only each rank's rows of every
stacked field, and ``pcsr_spmv``, ``halo_spmv_overlapped`` (its
``all_to_all`` issued asynchronously), ``halo_spmv_segtile`` and
``pbsr_smsmm_slab`` give each rank exactly its rows of the in-process
8-shard results; ``cg_solve`` (through ``PCSR`` and ``HaloSegtile``)
agrees within float64 rtol 1e-12, its dot products being each rank's
partial sum reduced across ranks.  This file is also the worker:

    python tests/test_torch_multiprocess.py <rank> <world> <port> <out.npz>
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
D = 8


def _fixture():
    rng = np.random.default_rng(0)
    n = 45
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    spd = x @ x.T + n * np.eye(n)
    v = rng.standard_normal(n)
    nb, bsz = 12, 4
    rr, cc = np.nonzero(rng.random((nb, nb)) < 0.4)
    blocks = rng.standard_normal((rr.size, bsz, bsz))
    return spd, v, (rr * nb + cc, blocks, nb * bsz, bsz)


def _run(mesh):
    """Every checked output on ``mesh``: this process's rows of each."""
    import scipy.sparse as sp

    import sparse_tpu_torch.parallel as tpar
    from sparse_tpu_torch import interop

    spd, v, (bidx, blocks, n_b, bsz) = _fixture()
    s = sp.csr_matrix(spd)
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device="cpu")
    pa = tpar.pcsr_from_csr(a, mesh)
    vs = tpar.shard_vector(torch.from_numpy(v), pa, mesh)
    hs = tpar.halo_partition_segtile(a, mesh)
    ab = interop.bsr_from_arrays(bidx, blocks, n_b, bsz, device="cpu")
    pb = tpar.pbsr_from_bsr(ab, mesh)
    return {
        "pcsr_data": pa.data, "pcsr_indptr": pa.indptr,
        "send_idx": hs.send_idx,
        "pcsr_spmv": tpar.pcsr_spmv(pa, vs, mesh),
        "halo_overlapped": tpar.halo_spmv_overlapped(
            tpar.halo_partition_overlapped(a, mesh), vs, mesh),
        "halo_segtile": tpar.halo_spmv_segtile(hs, vs, mesh),
        "cg": tpar.cg_solve(pa, vs, mesh, iters=30),
        "cg_segtile": tpar.cg_solve(hs, vs, mesh, iters=30),
        "pbsr_slab": tpar.pbsr_smsmm_slab(
            pb, pb, mesh, tpar.build_pbsr_smsmm_plan_slab(pb, pb, mesh)
        ).blocks,
    }


def _worker(rank, world, port, out):
    import torch.distributed as dist

    import sparse_tpu_torch.parallel as tpar

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = tpar.make_1d_mesh(D, group=dist.group.WORLD)
        assert (mesh.local, mesh.lo) == (D // world, rank * D // world)
        res = _run(mesh)
        np.savez(out, **{k: t.numpy() for k, t in res.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_one_process_mesh(tmp_path):
    import sparse_tpu_torch.parallel as tpar

    world, port = 2, _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port),
         str(outs[r])], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    whole = {k: t.numpy() for k, t in
             _run(tpar.make_1d_mesh(D, device="cpu")).items()}
    for r in range(world):
        got = np.load(outs[r])
        for k, full in whole.items():
            per = full.shape[0] // world
            want = full[r * per:(r + 1) * per]
            if k.startswith("cg"):  # a dot is two partial sums, reduced
                np.testing.assert_allclose(got[k], want, rtol=1e-12,
                                           atol=1e-15, err_msg=f"rank {r}")
            else:
                np.testing.assert_array_equal(got[k], want,
                                              err_msg=f"rank {r} {k}")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
