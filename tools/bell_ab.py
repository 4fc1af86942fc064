"""Time the blocked-ELL SpMM kernels of one copy of ``sparse_tpu_torch`` on
``bench.py``'s band, to compare two versions of the package on one card.

    python3 tools/bell_ab.py [--root DIR] [--tag NAME]

Imports ``sparse_tpu_torch`` from ``DIR`` (default: this checkout), and
the band and the timing helper from this checkout's ``chip_smoke.py``:
``bench.py``'s 80M-entry block band (nb 15,625, bsz 32, 5-block band,
float32), k = 128 (k = 32 for K5).  Times back to back
(``chip_smoke.pipelined_ms``: the median of 5 windows of 20 calls, and the
fastest) K3, K4, K5, K6 and K8 in float32 and the bf16 streams of K3, K4,
K5 and K8 with bf16 operands, and prints one JSON line tagged NAME with
the card's name and power limit.  Compare two versions in one call, each
in its own process, in turns (A, B, B, A): back-to-back times move between
processes more than within one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="directory holding the sparse_tpu_torch to time")
    ap.add_argument("--tag", default="this", help="name of this version")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import sparse_tpu_torch
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_dband as cdb

    sys.path.insert(1, str(HERE))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("bell_ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    f32, bf16 = torch.float32, torch.bfloat16
    a, _, valid, gen = cs._bench_bell()
    nb, bsz, k = a.nb, a.bsz, 128
    b = torch.randn(a.n, k, device="cuda", generator=gen) * 0.01
    b_bf = b.to(bf16)
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
    cases = {
        "K3": lambda: cb.bell_spmm_fused(a, b),
        "K3 bf16": lambda: cb.bell_spmm_fused(a, b_bf, compute_dtype=bf16),
        "K4": lambda: cb.bell_spmm_banded(a, b, kit.plan, tiles=kit.tiles),
        "K4 bf16": lambda: cb.bell_spmm_banded(
            a, b_bf, kit_bf.plan, tiles=kit_bf.tiles, compute_dtype=bf16),
        "K5": lambda: cb.bell_spmm_banded_t(a, bt, kit_t),
        "K5 bf16": lambda: cb.bell_spmm_banded_t(a, bt_bf, kit_tbf),
        "K6": lambda: cb.bell_spmm_block(a, b),
        "K8": lambda: cdb.dband_spmm(*k8_args[f32]),
        "K8 bf16": lambda: cdb.dband_spmm(*k8_args[bf16]),
    }
    ms = {}
    for name, fn in cases.items():
        med, fastest = cs.pipelined_ms(fn)
        ms[name] = [med, fastest]
        print(f"   {args.tag} {name:8s}: {med:.4f} ms back to back (median "
              f"window; fastest {fastest:.4f}) [{card}]", flush=True)
    print(json.dumps({"tag": args.tag, "root": str(args.root),
                      "package": str(Path(sparse_tpu_torch.__file__).parent),
                      "card": card, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
