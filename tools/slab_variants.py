"""Time K7's float64 prepared apply built from variants of ``bsr_slab.cu``,
all in one process, on the SpGEMM fixture.

    python3 tools/slab_variants.py [--root DIR] [--kind float64]
        [--variant 'NAME=OLD=>NEW'] ...

Each variant is this checkout's ``sparse_tpu_torch/csrc`` with one text
replacement in ``bsr_slab.cu`` (OLD must occur in it); ``this`` is the
checkout as it is, and ``--root DIR`` adds ``DIR``'s package (e.g. a
parent's ``git archive``) as ``root``.  Each source is compiled alone,
all at once, with ``nvcc`` (sm_90a) into the ignored
``sparse_tpu_torch/_build/slab_variants/`` and loaded with ctypes.  On
``chip_smoke``'s spgemm-block-181k fixture (``C = A A``, nb 2,000, bsz
32, 181,214 block products) in the given kind, each variant's
``bsr_slab`` runs the prepared plan's product list: its result is
compared bit for bit with the package's ``bsr_smsmm_apply_slab``, then
the variants are timed back to back (``chip_smoke.pipelined_ms``) in
three rounds, forward, backward, forward.  Prints each variant's
registers (``-Xptxas -v``), the card's name and power limit, and one JSON
line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BUILD = HERE / "sparse_tpu_torch" / "_build" / "slab_variants"
KINDS = {"float32": 0, "bfloat16": 2, "float64": 3}


def build(dirs: dict, nvcc: str, flags) -> dict:
    """{name: (library, its registers)}: each dir's bsr_slab.cu compiled
    by its own nvcc, all started together."""
    procs = {name: subprocess.Popen(
        [nvcc, *flags, "-shared", "-o", str(BUILD / f"{name}.so"),
         str(d / "bsr_slab.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, d in dirs.items()}
    out = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"slab_variants: {name} did not build:\n"
                             f"{log[-4000:]}")
        lib = ctypes.CDLL(str(BUILD / f"{name}.so"))
        lib.bsr_slab.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                 + [ctypes.c_longlong] * 2
                                 + [ctypes.c_void_p] * 2)
        regs = [line.split("Used ")[1] for line in log.splitlines()
                if "Used " in line]
        out[name] = (lib, "; ".join(regs))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="a second package's directory")
    ap.add_argument("--kind", default="float64", choices=sorted(KINDS))
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=OLD=>NEW: bsr_slab.cu with OLD replaced")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import sparse_tpu_torch as pt
    from sparse_tpu_torch import _kernels

    if not torch.cuda.is_available():
        raise SystemExit("slab_variants: needs a CUDA card")
    nvcc = _kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("slab_variants: no nvcc")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    csrc = HERE / "sparse_tpu_torch" / "csrc"
    shutil.rmtree(BUILD, ignore_errors=True)
    BUILD.mkdir(parents=True)
    dirs = {"this": csrc}
    if args.root:
        dirs["root"] = Path(args.root).resolve() / "sparse_tpu_torch" / "csrc"
    for v in args.variant:
        name, rest = v.split("=", 1)
        old, new = rest.split("=>", 1)
        d = BUILD / name
        shutil.copytree(csrc, d)
        text = (d / "bsr_slab.cu").read_text()
        if old not in text:
            raise SystemExit(f"slab_variants: {name}: {old!r} is not in "
                             "bsr_slab.cu")
        (d / "bsr_slab.cu").write_text(text.replace(old, new))
        dirs[name] = d
    libs, regs = {}, {}
    for name, (lib, reg) in build(dirs, nvcc, _kernels.NVCC_FLAGS).items():
        libs[name], regs[name] = lib, reg
        print(f"   {name}: registers {reg}", flush=True)
    dt = getattr(torch, args.kind)
    _, rows, cols, bvals = cs._spgemm_fixture()
    nb, bsz = cs.SPGEMM_NB, 32
    idx = torch.from_numpy((rows * nb + cols).astype(np.int32)).cuda()
    a = pt.BSR(indices=idx, blocks=torch.from_numpy(bvals).cuda().to(dt),
               n=nb * bsz, bsz=bsz)
    pp = pt.bsr_smsmm_slab_prepare(pt.bsr_smsmm_prepare(a, a), a.nbz, a.nbz)
    ptr = pp.prod_ptr.int().contiguous()
    ab = pp.prod_ab.int().contiguous()
    n_out = ptr.numel() - 1
    z = a.blocks.contiguous()
    ref = pt.bsr_smsmm_apply_slab(pp, a, a).blocks

    def runner(lib):
        out = torch.empty(n_out, bsz, bsz, dtype=dt, device="cuda")

        def run():
            rc = lib.bsr_slab(KINDS[args.kind], z.data_ptr(), z.data_ptr(),
                              ptr.data_ptr(), ab.data_ptr(), out.data_ptr(),
                              n_out, bsz, None,
                              torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"bsr_slab: cudaError {rc}")
            return out
        return run

    same = {}
    for name, lib in libs.items():
        y = runner(lib)().clone()
        torch.cuda.synchronize()
        same[name] = bool(torch.equal(y, ref))
        print(f"   {name}: bitwise the package's apply: {same[name]}",
              flush=True)
    names = list(libs)
    ms = {n: [] for n in names}
    for order in (names, names[::-1], names):
        for n in order:
            ms[n].append(cs.pipelined_ms(runner(libs[n]))[0])
    for n in names:
        print(f"   {n}: " + " / ".join(f"{t:.4f}" for t in ms[n])
              + f" ms back to back [{card}]", flush=True)
    print(json.dumps({"card": card, "kind": args.kind, "ms": ms,
                      "bitwise": same, "registers": regs}), flush=True)


if __name__ == "__main__":
    main()
