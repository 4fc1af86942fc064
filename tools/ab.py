"""Time one suite of kernels of one copy of ``sparse_tpu_torch``, to compare
two versions of the package on one card.

    python3 tools/ab.py --suite {bell,slab,segtile,apply} [--root DIR]
        [--tag NAME]

Imports ``sparse_tpu_torch`` from ``DIR`` (default: this checkout), and
the inputs and the timing helper from this checkout's ``chip_smoke.py``.
Times each case of the suite back to back (``chip_smoke.pipelined_ms``:
the median of 5 windows of 20 calls, and the fastest) and prints one JSON
line tagged NAME with the card's name and power limit.  Compare two
versions in one call, each in its own process, in turns (A, B, B, A):
back-to-back times move between processes more than within one.

Suites:

- ``bell``: the blocked-ELL SpMM kernels on ``bench.py``'s 80M-entry block
  band (nb 15,625, bsz 32, 5-block band, float32), k = 128 (k = 32 for
  K5): K3, K4, K5, K6 and K8 in float32 and the bf16 streams of K3, K4,
  K5, K6 (bf16 blocks) and K8 with bf16 operands.
- ``slab``: the block-SpGEMM slab apply (K7) on the SpGEMM fixture
  (``benchmarks/measure_auto_block.py``'s ``C = A A``: nb 2,000, bsz 32,
  19,025 stored blocks, 181,214 block products, float32): the prepared
  ``bsr_smsmm_apply_slab`` in float32, bf16 and float64, the raw-array
  ``run_slabs_arrays`` on the plan's slot tables, a 5-step chain of
  prepared applies and the differentiable apply's forward + backward.
- ``segtile``: the segment-tile SpMV kernels: K1, K1-mxu and K1-r32
  through ``csr_smvm_segtile`` on band-10M (500k rows, ~10M entries,
  ``smvm_prepare``'s segtile plan), K2 through ``bsr_smvm_segtile_block``
  on elasticity-400k (the blockseg plan), and both plans' ``apply``.
- ``apply``: the host-bound K1 entry points on band-10M: ``plan.apply``
  and ``halo_spmv_segtile`` on a 1-shard in-process mesh.

Beside each back-to-back time it prints the host microseconds per call
(``chip_smoke._host_us``: 200 calls issued back to back, the card
synchronised only before and after).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def bell_cases(cs):
    import torch

    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_dband as cdb

    f32, bf16 = torch.float32, torch.bfloat16
    a, _, valid, gen = cs._bench_bell()
    nb, bsz, k = a.nb, a.bsz, 128
    b = torch.randn(a.n, k, device="cuda", generator=gen) * 0.01
    b_bf = b.to(bf16)
    a_bf = BELL(cols=a.cols, blocks=a.blocks.to(bf16), n=a.n, bsz=bsz)
    bt = b[:, :32].T.contiguous()
    bt_bf = bt.to(bf16)
    kit = cb.bell_banded_prepare(a, row_tile=5, slot_valid=valid)
    kit_bf = cb.bell_banded_prepare(a, row_tile=5, compute_dtype=bf16,
                                    slot_valid=valid)
    kit_t = cb.bell_banded_prepare_t(a, slot_valid=valid)
    kit_tbf = cb.bell_banded_prepare_t(a, compute_dtype=bf16,
                                       slot_valid=valid)
    dplan = cb.build_banded_plan(a, row_tile=5, max_window=96)
    b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(dplan.W, bsz, k)])
    k8_args = {s: (cdb.densify_tiles(a, dplan, s), dplan.start, b3.to(s), nb,
                   bsz, k, dplan.W, 5, f32) for s in (f32, bf16)}
    return {
        "K3": lambda: cb.bell_spmm_fused(a, b),
        "K3 bf16": lambda: cb.bell_spmm_fused(a, b_bf, compute_dtype=bf16),
        "K4": lambda: cb.bell_spmm_banded(a, b, kit.plan, tiles=kit.tiles),
        "K4 bf16": lambda: cb.bell_spmm_banded(
            a, b_bf, kit_bf.plan, tiles=kit_bf.tiles, compute_dtype=bf16),
        "K5": lambda: cb.bell_spmm_banded_t(a, bt, kit_t),
        "K5 bf16": lambda: cb.bell_spmm_banded_t(a, bt_bf, kit_tbf),
        "K6": lambda: cb.bell_spmm_block(a, b),
        "K6 bf16": lambda: cb.bell_spmm_block(a_bf, b_bf),
        "K8": lambda: cdb.dband_spmm(*k8_args[f32]),
        "K8 bf16": lambda: cdb.dband_spmm(*k8_args[bf16]),
    }


def slab_cases(cs):
    import numpy as np
    import torch

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bsr

    _, rows, cols, bvals = cs._spgemm_fixture()
    nb, bsz = 2_000, 32
    idx = torch.from_numpy((rows * nb + cols).astype(np.int32)).cuda()
    blocks = torch.from_numpy(bvals).cuda()
    a = {dt: pt.BSR(indices=idx, blocks=blocks.to(dt), n=nb * bsz, bsz=bsz)
         for dt in (torch.float32, torch.bfloat16, torch.float64)}
    f32 = a[torch.float32]
    plan = pt.bsr_smsmm_prepare(f32, f32)
    pp = pt.bsr_smsmm_slab_prepare(plan, f32.nbz, f32.nbz)
    plans = pt.bsr_smsmm_slab_prepare_ad(plan, f32.nbz, f32.nbz)
    z = cuda_bsr._append_zero(f32.blocks, torch.float32)
    raw = ((pp.a_idx, pp.b_idx, pp.oloc, pp.first, pp.slab, z, z),
           dict(chunks=pp.chunks, bsz=bsz, g=pp.g, p=pp.p,
                nbz_out=pp.nbz_out, out_dtype=torch.float32,
                slab_start=pp.slab_start))
    ct = torch.randn(plan.nbz_out, bsz, bsz, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(12))
    leaf = f32.blocks.clone().requires_grad_(True)

    def ad():
        x = pt.BSR(indices=idx, blocks=leaf, n=f32.n, bsz=bsz)
        out = pt.bsr_smsmm_apply_slab_ad(plans, x, x)
        out.blocks.backward(ct)
        leaf.grad = None
        return out

    def chain():
        for _ in range(5):
            out = pt.bsr_smsmm_apply_slab(pp, f32, f32)
        return out

    cases = {"apply f32": lambda: pt.bsr_smsmm_apply_slab(pp, f32, f32)}
    for dt in (torch.bfloat16, torch.float64):
        x = a[dt]
        cases[f"apply {str(dt)[6:]}"] = (
            lambda x=x: pt.bsr_smsmm_apply_slab(pp, x, x))
    cases["raw f32"] = lambda: cuda_bsr.run_slabs_arrays(*raw[0], **raw[1])
    cases["chain x5"] = chain
    cases["AD fwd+bwd"] = ad
    return cases


def segtile_cases(cs):
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    band, ela = cs.phase4_band(), cs.phase5_elasticity()
    plan, v = band["plan"], band["v"]
    a, st = plan.state
    st32 = cuda_csr.build_seg_tiles(a, wsub=st.wsub, rows=32)
    eplan, ev = ela["plan"], ela["v"]
    ab, est = eplan.state
    vp = ev.reshape(-1, 2)[eplan.perm].reshape(-1)
    return {
        "K1": lambda: pt.csr_smvm_segtile(a, v, st),
        "K1-mxu": lambda: pt.csr_smvm_segtile(a, v, st, reduce="mxu"),
        "K1-r32": lambda: pt.csr_smvm_segtile(a, v, st32),
        "band apply": lambda: plan.apply(v),
        "K2": lambda: cuda_csr_block.bsr_smvm_segtile_block(ab, vp, est),
        "ela apply": lambda: eplan.apply(ev),
    }


def apply_cases(cs):
    import torch

    import sparse_tpu_torch.parallel as par

    band = cs.phase4_band()
    plan, v = band["plan"], band["v"]
    a = plan.state[0]
    mesh1 = par.make_1d_mesh(1)
    hs1 = par.halo_partition_segtile(a, mesh1)
    v1 = par.shard_vector(v.cpu(), hs1, mesh1)
    return {
        "band apply": lambda: plan.apply(v),
        "halo D=1": lambda: par.halo_spmv_segtile(hs1, v1, mesh1),
    }


SUITES = {"bell": bell_cases, "slab": slab_cases, "segtile": segtile_cases,
          "apply": apply_cases}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", required=True, choices=sorted(SUITES))
    ap.add_argument("--root", default=str(HERE),
                    help="directory holding the sparse_tpu_torch to time")
    ap.add_argument("--tag", default="this", help="name of this version")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import sparse_tpu_torch

    # this checkout's inputs and timing helpers, whatever DIR holds
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        raise SystemExit("ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ms, host_us = {}, {}
    for name, fn in SUITES[args.suite](cs).items():
        med, fastest = cs.pipelined_ms(fn)
        ms[name] = [med, fastest]
        host_us[name] = cs._host_us(fn)
        print(f"   {args.tag} {name:11s}: {med:.4f} ms back to back (median "
              f"window; fastest {fastest:.4f}), host {host_us[name]:.2f} us "
              f"a call [{card}]", flush=True)
    print(json.dumps({"suite": args.suite, "tag": args.tag,
                      "root": str(args.root),
                      "package": str(Path(sparse_tpu_torch.__file__).parent),
                      "card": card, "ms": ms, "host_us": host_us}),
          flush=True)


if __name__ == "__main__":
    main()
