"""Time one suite of kernels of one copy of ``sparse_tpu_torch``, to compare
two versions of the package on one card.

    python3 tools/ab.py --suite {bell,slab,segtile,apply} [--root DIR]
        [--tag NAME] [--cases NAME,NAME,...]

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
  K5): K3, K4, K5, K6 and K8 in float32, the bf16 streams of K3, K4,
  K5, K6 (bf16 blocks) and K8 with bf16 operands (K3's rounds the float32
  blocks on every call; "K3 bf16 kernel" launches K3's kernel alone on bf16
  blocks into a float32 C), the bf16x3 split of
  K3, K4, K5 and K6 (float32 operands), K3, K4, K5, K6 and K8 in
  float64 (float64 blocks, kits and tiles), and K3, K4 and K8 in int32
  (the blocks x 400, rounded; operand entries in [-8, 8]); K4 is timed on
  the kits' tiles (``bell_spmm_banded(..., tiles=kit.tiles)``, the vote
  body) and, as "K4 kit", through ``bell_spmm(a, b, plan=kit)`` in every
  kind (the mask body where the package has one); then K6 on the
  same band at bsz 128 (``chip_smoke.K6_WIDE_NB``: nb 3,907, n 500,096),
  k = 128, in float32, bf16 (blocks and operand), bf16x3, int32 and
  float64.
- ``slab``: the block-SpGEMM slab apply (K7) on the SpGEMM fixture
  (``benchmarks/measure_auto_block.py``'s ``C = A A``: nb 2,000, bsz 32,
  19,025 stored blocks, 181,214 block products, float32): the prepared
  ``bsr_smsmm_apply_slab`` in float32, bf16, float64 and int32 (the
  blocks x 400, rounded), the raw-array
  ``run_slabs_arrays`` on the plan's slot tables, a 5-step chain of
  prepared applies and the differentiable apply's forward + backward.
- ``segtile``: the segment-tile SpMV kernels: K1, K1-mxu and K1-r32
  through ``csr_smvm_segtile`` on band-10M (500k rows, ~10M entries,
  ``smvm_prepare``'s segtile plan), K2 through ``bsr_smvm_segtile_block``
  on elasticity-400k (the blockseg plan, on the block-permuted operand),
  K1, K1-mxu and K2 in float64, bf16 (bf16 operands) and int32 on the same
  streams, K1-r32 in float64 and bf16, and both plans' ``apply``
  (elasticity's: the folded K2 where the package has it, else the two
  gathers around K2).
- ``apply``: the host-bound K1 entry points on band-10M: ``plan.apply``
  and ``halo_spmv_segtile`` on a 1-shard in-process mesh.

Beside each back-to-back time it prints the host microseconds per call
(``chip_smoke._host_us``: 200 calls issued back to back, the card
synchronised only before and after) and a sha256 of the case's output
(one more call after the timing, its bytes hashed on the host), so turns
of two versions compare bits as well as time.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def bell_cases(cs):
    import torch

    from sparse_tpu_torch.formats.bell import BELL, bell_spmm
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_dband as cdb

    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
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
    a64 = BELL(cols=a.cols, blocks=a.blocks.double(), n=a.n, bsz=bsz)
    kit_t64 = cb.bell_banded_prepare_t(a64, slot_valid=valid)
    kit64 = cb.bell_banded_prepare(a64, row_tile=5, slot_valid=valid)
    bt64, b64 = bt.double(), b.double()
    dplan = cb.build_banded_plan(a, row_tile=5, max_window=96)
    b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(dplan.W, bsz, k)])
    k8_args = {s: (cdb.densify_tiles(a, dplan, s), dplan.start, b3.to(s), nb,
                   bsz, k, dplan.W, 5, f64 if s == f64 else f32)
               for s in (f32, bf16, f64)}
    w, _, _, gw = cs._bench_bell(cs.K6_WIDE_NB, cs.K6_WIDE_BSZ)
    bw = torch.randn(w.n, k, device="cuda", generator=gw) * 0.01
    wide = {dt: (BELL(cols=w.cols, blocks=w.blocks.to(dt), n=w.n, bsz=w.bsz),
                 bw.to(dt)) for dt in (bf16, f64)}
    wide[torch.int32] = (
        BELL(cols=w.cols, blocks=(w.blocks * 400).round().int(), n=w.n,
             bsz=w.bsz),
        torch.randint(-8, 9, bw.shape, device="cuda", generator=gw,
                      dtype=torch.int32))
    i32 = torch.int32
    ai = BELL(cols=a.cols, blocks=(a.blocks * 400).round().to(i32), n=a.n,
              bsz=bsz)
    bi = torch.randint(-8, 9, b.shape, device="cuda", generator=gen,
                       dtype=i32)
    kit_i = cb.bell_banded_prepare(ai, row_tile=5, slot_valid=valid)
    b3i = torch.cat([bi.reshape(nb, bsz, k), bi.new_zeros(dplan.W, bsz, k)])
    k8_args[i32] = (cdb.densify_tiles(ai, dplan, i32), dplan.start, b3i, nb,
                    bsz, k, dplan.W, 5, i32)
    # K3's bf16 kernel alone: the wrapper's "K3 bf16" rounds the float32
    # blocks to bf16 on every call
    from sparse_tpu_torch import _kernels

    blocks_bf, c32 = a.blocks.to(bf16), torch.empty(a.n, k, device="cuda")

    def k3_bf16_kernel():
        cb._launch("K3 bf16 kernel", _kernels.load().bell_fused,
                   cb._KIND[bf16], blocks_bf.data_ptr(), a.cols.data_ptr(),
                   b_bf.data_ptr(), c32.data_ptr(), nb, a.Lb, bsz, k,
                   device=c32.device)
        return c32

    return {
        "K3": lambda: cb.bell_spmm_fused(a, b),
        "K3 bf16": lambda: cb.bell_spmm_fused(a, b_bf, compute_dtype=bf16),
        "K3 bf16 kernel": k3_bf16_kernel,
        "K3 bf16x3": lambda: cb.bell_spmm_fused(a, b, precision="bf16x3"),
        "K3 f64": lambda: cb.bell_spmm_fused(a64, b64),
        "K4": lambda: cb.bell_spmm_banded(a, b, kit.plan, tiles=kit.tiles),
        "K4 bf16x3": lambda: cb.bell_spmm_banded(
            a, b, kit.plan, tiles=kit.tiles, precision="bf16x3"),
        "K4 bf16": lambda: cb.bell_spmm_banded(
            a, b_bf, kit_bf.plan, tiles=kit_bf.tiles, compute_dtype=bf16),
        "K4 f64": lambda: cb.bell_spmm_banded(a64, b64, kit64.plan,
                                              tiles=kit64.tiles),
        "K4 kit": lambda: bell_spmm(a, b, plan=kit),
        "K4 kit bf16x3": lambda: bell_spmm(a, b, plan=kit,
                                           precision="bf16x3"),
        "K4 kit bf16": lambda: bell_spmm(a, b_bf, plan=kit_bf),
        "K4 kit f64": lambda: bell_spmm(a64, b64, plan=kit64),
        "K5": lambda: cb.bell_spmm_banded_t(a, bt, kit_t),
        "K5 bf16": lambda: cb.bell_spmm_banded_t(a, bt_bf, kit_tbf),
        "K5 bf16x3": lambda: cb.bell_spmm_banded_t(a, bt, kit_t,
                                                   precision="bf16x3"),
        "K5 f64": lambda: cb.bell_spmm_banded_t(a64, bt64, kit_t64),
        "K6": lambda: cb.bell_spmm_block(a, b),
        "K6 bf16": lambda: cb.bell_spmm_block(a_bf, b_bf),
        "K6 bf16x3": lambda: cb.bell_spmm_block(a, b, precision="bf16x3"),
        "K6 f64": lambda: cb.bell_spmm_block(a64, b64),
        "K8": lambda: cdb.dband_spmm(*k8_args[f32]),
        "K8 bf16": lambda: cdb.dband_spmm(*k8_args[bf16]),
        "K8 f64": lambda: cdb.dband_spmm(*k8_args[f64]),
        "K3 i32": lambda: cb.bell_spmm_fused(ai, bi),
        "K4 i32": lambda: cb.bell_spmm_banded(ai, bi, kit_i.plan,
                                              tiles=kit_i.tiles),
        "K4 kit i32": lambda: bell_spmm(ai, bi, plan=kit_i),
        "K8 i32": lambda: cdb.dband_spmm(*k8_args[i32]),
        "K6 b128": lambda: cb.bell_spmm_block(w, bw),
        "K6 b128 bf16": lambda: cb.bell_spmm_block(*wide[bf16]),
        "K6 b128 bf16x3": lambda: cb.bell_spmm_block(w, bw,
                                                     precision="bf16x3"),
        "K6 b128 i32": lambda: cb.bell_spmm_block(*wide[torch.int32]),
        "K6 b128 f64": lambda: cb.bell_spmm_block(*wide[f64]),
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
    a[torch.int32] = pt.BSR(indices=idx, blocks=(blocks * 400).round().to(
        torch.int32), n=nb * bsz, bsz=bsz)
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
    for dt in (torch.bfloat16, torch.float64, torch.int32):
        x = a[dt]
        cases[f"apply {str(dt)[6:]}"] = (
            lambda x=x: pt.bsr_smsmm_apply_slab(pp, x, x))
    cases["raw f32"] = lambda: cuda_bsr.run_slabs_arrays(*raw[0], **raw[1])
    cases["chain x5"] = chain
    cases["AD fwd+bwd"] = ad
    return cases


def _kinds(x, field):
    """``x`` (a dataclass) with its tensor ``field`` in float64, bf16 and
    int32 (x 400, rounded): {suffix: copy}."""
    import dataclasses

    import torch

    t = getattr(x, field)
    return {"f64": dataclasses.replace(x, **{field: t.double()}),
            "bf16": dataclasses.replace(x, **{field: t.to(torch.bfloat16)}),
            "i32": dataclasses.replace(
                x, **{field: (t * 400).round().to(torch.int32)})}


def segtile_cases(cs):
    import dataclasses

    import torch

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    band, ela = cs.phase4_band(), cs.phase5_elasticity()
    plan, v = band["plan"], band["v"]
    a, st = plan.state
    st32 = cuda_csr.build_seg_tiles(a, wsub=st.wsub, rows=32)
    eplan, ev = ela["plan"], ela["v"]
    ab, est = eplan.state
    vp = ev.reshape(-1, 2)[eplan.perm].reshape(-1)
    gen = torch.Generator(device="cuda").manual_seed(21)

    def operand(x, sfx):
        if sfx == "i32":
            return torch.randint(-8, 9, x.shape, device="cuda",
                                 generator=gen, dtype=torch.int32)
        return x.double() if sfx == "f64" else x.to(torch.bfloat16)

    cases = {
        "K1": lambda: pt.csr_smvm_segtile(a, v, st),
        "K1-mxu": lambda: pt.csr_smvm_segtile(a, v, st, reduce="mxu"),
        "K1-r32": lambda: pt.csr_smvm_segtile(a, v, st32),
        "band apply": lambda: plan.apply(v),
        "K2": lambda: cuda_csr_block.bsr_smvm_segtile_block(ab, vp, est),
        "ela apply": lambda: eplan.apply(ev),
    }
    # the other kinds on the same streams
    streams = _kinds(st.stream, "vals")
    for sfx, ak in _kinds(a, "data").items():
        sk = dataclasses.replace(st, stream=streams[sfx])
        vk = operand(v, sfx)
        cases[f"K1 {sfx}"] = (
            lambda ak=ak, vk=vk, sk=sk: pt.csr_smvm_segtile(ak, vk, sk))
        cases[f"K1-mxu {sfx}"] = (
            lambda ak=ak, vk=vk, sk=sk: pt.csr_smvm_segtile(
                ak, vk, sk, reduce="mxu"))
    streams32 = _kinds(st32.stream, "vals")
    for sfx in ("f64", "bf16"):
        s32 = dataclasses.replace(st32, stream=streams32[sfx])
        ak, vk = _kinds(a, "data")[sfx], operand(v, sfx)
        cases[f"K1-r32 {sfx}"] = (
            lambda ak=ak, vk=vk, s32=s32: pt.csr_smvm_segtile(ak, vk, s32))
    estreams = _kinds(est.stream, "vals")
    for sfx, abk in _kinds(ab, "blocks").items():
        ek = dataclasses.replace(est, stream=estreams[sfx])
        vk = operand(vp, sfx)
        cases[f"K2 {sfx}"] = (
            lambda abk=abk, vk=vk, ek=ek:
            cuda_csr_block.bsr_smvm_segtile_block(abk, vk, ek))
    return cases


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


def digest(y) -> str:
    """sha256 of an output's bytes: a tensor, or the tensors of a
    dataclass (a BSR result) in field order."""
    import torch

    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().cpu().view(torch.uint8)
                     .numpy().tobytes())
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                add(getattr(x, f.name))

    add(y)
    return h.hexdigest()


SUITES = {"bell": bell_cases, "slab": slab_cases, "segtile": segtile_cases,
          "apply": apply_cases}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", required=True, choices=sorted(SUITES))
    ap.add_argument("--root", default=str(HERE),
                    help="directory holding the sparse_tpu_torch to time")
    ap.add_argument("--tag", default="this", help="name of this version")
    ap.add_argument("--cases", default="",
                    help="comma-separated case names to time (default: all)")
    args = ap.parse_args()
    only = {c.strip() for c in args.cases.split(",") if c.strip()}
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
    ms, host_us, sha = {}, {}, {}
    for name, fn in SUITES[args.suite](cs).items():
        if only and name not in only:
            continue
        med, fastest = cs.pipelined_ms(fn)
        ms[name] = [med, fastest]
        host_us[name] = cs._host_us(fn)
        sha[name] = digest(fn())  # outside the timed windows
        print(f"   {args.tag} {name:11s}: {med:.4f} ms back to back (median "
              f"window; fastest {fastest:.4f}), host {host_us[name]:.2f} us "
              f"a call, sha256 {sha[name][:16]} [{card}]", flush=True)
    print(json.dumps({"suite": args.suite, "tag": args.tag,
                      "root": str(args.root),
                      "package": str(Path(sparse_tpu_torch.__file__).parent),
                      "card": card, "ms": ms, "host_us": host_us,
                      "sha256": sha}),
          flush=True)


if __name__ == "__main__":
    main()
