"""Time K7's prepared apply built from variants of ``bsr_slab.cu``, all in
one process, on the SpGEMM fixture, and split it into its copies, its
multiply and its output stores.

    python3 tools/slab_variants.py [--root DIR] [--kind float32,bfloat16]
        [--form ring,ring-3] [--variant 'NAME=OLD=>NEW'] ...
        [--split this,root] [--bsz 32] [--offset 0] [--rounds 3]

Each variant is this checkout's ``sparse_tpu_torch/csrc`` with text
replacements in ``bsr_slab.cu`` (``NAME=OLD=>NEW``, several pairs joined
by ``&&``; each OLD must occur in the file, ``\\n`` in OLD or NEW is a
newline); ``this`` is the checkout as it is, and ``--root DIR`` adds
``DIR``'s package (e.g. a parent's ``git archive``) as ``root``.
``--form NAMES`` adds named forms (``FORMS``, text edits too): ``ring``
stages the float32, int32 and bf16 kinds' products as 16-wide k-slices
(``Geo::KD``) in a deeper ring, the form that lost to whole products;
``ring-3`` is a shallower one.
``--split NAMES`` adds, for each of those sources, four forms that give
wrong results and are timed only (the split of the apply):

- ``NAME/copies``: the multiply left out (copies and stores only);
- ``NAME/multiply``: no copy after the first fill of the ring (the walk's
  refills become empty cp.async groups; multiply and stores only);
- ``NAME/no-stores``: the output stores behind a test that never holds;
- ``NAME/no-a``: A's 16-byte copies left out (each product multiplies
  whatever its stage holds there), which bounds what reusing a staged A
  block could save.

Each source is compiled alone, all at once, with ``nvcc`` (sm_90a, the
package's flags) into the ignored ``sparse_tpu_torch/_build/
slab_variants/`` and loaded with ctypes.  On ``chip_smoke``'s
spgemm-block-181k fixture (``C = A A``, nb 2,000, bsz 32, 181,214 block
products; ``--bsz N`` keeps its block pattern with blocks of N x N drawn
from a seed, ``--offset E`` starts the blocks E elements past a 16-byte
boundary, both of which take the element copies) in each kind
(``float32``, ``bfloat16``, ``float64``, or ``int32``: the blocks x 400,
rounded), each form's ``bsr_slab`` runs the
prepared plan's product list; the whole forms are compared bit for bit
with this checkout's ``bsr_smsmm_apply_slab``, then all forms are timed
back to back (``chip_smoke.pipelined_ms``, median of 5 windows) in
``--rounds`` rounds, forward, backward, forward, ...  Prints each form's
registers and spills (``-Xptxas -v``), its geometry at the bsz in each kind
(``bsr_slab_geometry``: ring stages, shared bytes and resident blocks an
SM, registers and local bytes a thread), the card's name and power limit,
and one JSON line.  Needs a card and ``nvcc``: run it from the root of a
checkout on the card's machine, or as the one command of a remote run on
the card, e.g.

    python3 tools/slab_variants.py --kind float32,bfloat16 --form ring \\
        --split this

(about 40 s of builds and 15 s a kind and form for three rounds).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BUILD = HERE / "sparse_tpu_torch" / "_build" / "slab_variants"
KINDS = {"float32": 0, "bfloat16": 2, "float64": 3, "int32": 4}
GEOMETRY = ("stages", "shared_bytes", "blocks_per_sm", "registers",
            "local_bytes", "teams", "body", "k_slice", "pieces")
# named forms (--form): stages of 16-wide k-slices (Geo::KD) for the float32,
# int32 and bf16 kinds, and each Cfg's ring stages
_SLICE = ("static constexpr int KD = BS;",
          "static constexpr int KD = BS < 16 ? BS : 16;")
FORMS = {
    # the ring that lost to whole products in every kind: float32 and int32
    # 3 blocks an SM, bf16 3
    "ring": {"float": 4, "unsigned": 4, "__nv_bfloat16": 6},
    # the same, shallower: float32 and int32 4 blocks an SM, bf16 5
    "ring-3": {"float": 3, "unsigned": 3, "__nv_bfloat16": 4},
}

_MULTIPLY = "tile.multiply(ring + cs * G::kStage, lane, wt);"
_COPY_A = "sm90::cp_async16(st + G::a_at(r, c), a + r * BS + k0 + c, true);"
_STORE = "tile.store(out + o * bsz2, bsz, vec != 0, lane, wt);"
_REFILL = re.compile(r"^(\s*)produce\(\);$", re.M)


def _split(form: str, text: str) -> str:
    """``bsr_slab.cu``'s text for a split form."""
    if form == "copies":
        out, n = text.replace(_MULTIPLY, ""), text.count(_MULTIPLY)
    elif form == "multiply":
        out, n = _REFILL.subn(r"\1sm90::cp_async_commit();", text)
    elif form == "no-a":
        out, n = text.replace(_COPY_A, ""), text.count(_COPY_A)
    else:  # no-stores: bsz is never negative, the compiler cannot know it
        out, n = text.replace(_STORE, f"if (bsz < 0) {_STORE}"), \
            text.count(_STORE)
    if n == 0:
        raise SystemExit(f"slab_variants: {form}: its line is not in "
                         "bsr_slab.cu")
    return out


def _form(name: str, text: str) -> str:
    """``bsr_slab.cu``'s text for form ``name``: k-slices, and each listed
    Cfg's ring stages."""
    if _SLICE[0] not in text:
        raise SystemExit(f"slab_variants: --form {name}: {_SLICE[0]!r} is "
                         "not in bsr_slab.cu")
    text = text.replace(_SLICE[0], _SLICE[1])
    for ctype, stages in FORMS[name].items():
        pat = re.compile(r"(struct Cfg<" + re.escape(ctype)
                         + r"> \{\s*static constexpr int kStages = )\d+")
        text, n = pat.subn(lambda m: m.group(1) + str(stages), text)
        if n != 1:
            raise SystemExit(f"slab_variants: --form {name}: Cfg<{ctype}> "
                             "is not in bsr_slab.cu")
    return text


def build(dirs: dict, nvcc: str, flags) -> dict:
    """{name: (library, its ptxas lines)}: each dir's bsr_slab.cu compiled
    by its own nvcc, all started together."""
    procs = {name: subprocess.Popen(
        [nvcc, *flags, "-shared", "-o",
         str(BUILD / f"{name.replace('/', '_')}.so"),
         str(d / "bsr_slab.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, d in dirs.items()}
    out = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"slab_variants: {name} did not build:\n"
                             f"{log[-4000:]}")
        lib = ctypes.CDLL(str(BUILD / f"{name.replace('/', '_')}.so"))
        lib.bsr_slab.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                 + [ctypes.c_longlong] * 2
                                 + [ctypes.c_void_p] * 2)
        lib.bsr_slab_geometry.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_void_p]
        ptxas, kernel = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and ("Used " in line or "spill" in line):
                short = re.sub(r"^_ZN.*?bsr_slab\d+(\w+?)I(.+?)EEv.*$",
                               r"\1<\2>", kernel)
                ptxas.append(f"{short}: "
                             + line.split("info    :")[-1].strip())
        out[name] = (lib, ptxas)
    return out


def geometry(lib, kind: str, bsz: int) -> dict:
    """The launched geometry ``bsr_slab_geometry`` reports (an older
    library fills the fields it has; the others read -1)."""
    out = (ctypes.c_int * len(GEOMETRY))(*([-1] * len(GEOMETRY)))
    rc = lib.bsr_slab_geometry(KINDS[kind], bsz, out)
    if rc:
        raise RuntimeError(f"bsr_slab_geometry: cudaError {rc}")
    return dict(zip(GEOMETRY, out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="a second package's directory")
    ap.add_argument("--kind", default="float64",
                    help="comma-separated kinds: " + ", ".join(KINDS))
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=OLD=>NEW[&&OLD=>NEW]: bsr_slab.cu edited")
    ap.add_argument("--form", default="",
                    help="comma-separated named forms: " + ", ".join(FORMS))
    ap.add_argument("--split", default="",
                    help="comma-separated sources to split (this, root, "
                    "a variant's NAME)")
    ap.add_argument("--bsz", type=int, default=32,
                    help="block size (32: the fixture's own blocks)")
    ap.add_argument("--offset", type=int, default=0,
                    help="elements the blocks start past 16-byte alignment")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    kinds = [k.strip() for k in args.kind.split(",") if k.strip()]
    for k in kinds:
        if k not in KINDS:
            raise SystemExit(f"slab_variants: unknown kind {k!r}")
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

    def edited(name, base, edit):
        d = BUILD / name.replace("/", "_")
        shutil.copytree(base, d)
        f = d / "bsr_slab.cu"
        f.write_text(edit(f.read_text()))
        return d

    for v in args.variant:
        name, rest = v.split("=", 1)

        def apply(text, rest=rest, name=name):
            for pair in rest.split("&&"):
                old, new = (s.replace("\\n", "\n")
                            for s in pair.split("=>", 1))
                if old not in text:
                    raise SystemExit(f"slab_variants: {name}: {old!r} is "
                                     "not in bsr_slab.cu")
                text = text.replace(old, new)
            return text
        dirs[name] = edited(name, csrc, apply)
    for name in (s.strip() for s in args.form.split(",") if s.strip()):
        if name not in FORMS:
            raise SystemExit(f"slab_variants: unknown form {name!r}")
        dirs[name] = edited(name, csrc, lambda text, n=name: _form(n, text))
    whole = list(dirs)
    for name in (s.strip() for s in args.split.split(",") if s.strip()):
        if name not in dirs:
            raise SystemExit(f"slab_variants: --split {name}: no such source")
        for form in ("copies", "multiply", "no-stores", "no-a"):
            dirs[f"{name}/{form}"] = edited(
                f"{name}/{form}", dirs[name],
                lambda text, form=form: _split(form, text))
    libs = {}
    for name, (lib, lines) in build(dirs, nvcc, _kernels.NVCC_FLAGS).items():
        libs[name] = lib
        for line in lines:
            print(f"   {name}: {line}", flush=True)
    _, rows, cols, bvals = cs._spgemm_fixture()
    nb, bsz = cs.SPGEMM_NB, args.bsz
    if bsz != bvals.shape[-1]:
        bvals = np.random.default_rng(0).standard_normal(
            (rows.size, bsz, bsz)).astype(np.float32)
    idx = torch.from_numpy((rows * nb + cols).astype(np.int32)).cuda()
    f32 = torch.from_numpy(bvals).cuda()
    f32a = pt.BSR(indices=idx, blocks=f32, n=nb * bsz, bsz=bsz)
    pp = pt.bsr_smsmm_slab_prepare(pt.bsr_smsmm_prepare(f32a, f32a),
                                   f32a.nbz, f32a.nbz)
    ptr = pp.prod_ptr.int().contiguous()
    ab = pp.prod_ab.int().contiguous()
    n_out = ptr.numel() - 1
    geo, same, ms = {}, {}, {}
    for kind in kinds:
        dt = getattr(torch, kind)
        z = ((f32 * 400).round() if kind == "int32" else f32).to(dt)
        if args.offset:  # the same values, E elements off alignment
            buf = torch.empty(z.numel() + args.offset, dtype=dt,
                              device="cuda")
            buf[args.offset:] = z.reshape(-1)
            z = buf[args.offset:].view(z.shape)
        z = z.contiguous()
        a = pt.BSR(indices=idx, blocks=z, n=nb * bsz, bsz=bsz)
        ref = pt.bsr_smsmm_apply_slab(pp, a, a).blocks

        def runner(lib, dt=dt, z=z, kind=kind):
            out = torch.empty(n_out, bsz, bsz, dtype=dt, device="cuda")

            def run():
                rc = lib.bsr_slab(KINDS[kind], z.data_ptr(), z.data_ptr(),
                                  ptr.data_ptr(), ab.data_ptr(),
                                  out.data_ptr(), n_out, bsz, None,
                                  torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"bsr_slab: cudaError {rc}")
                return out
            return run

        for name, lib in libs.items():
            g = geometry(lib, kind, bsz)
            geo[f"{kind} {name}"] = g
            print(f"   {kind} {name}: {g['stages']} stages a team, k slice "
                  f"{g['k_slice']}, {g['shared_bytes']} shared bytes a "
                  f"block, {g['blocks_per_sm']} blocks an SM, "
                  f"{g['registers']} registers and {g['local_bytes']} local "
                  f"bytes a thread [{card}]", flush=True)
        for name in whole:
            y = runner(libs[name])().clone()
            torch.cuda.synchronize()
            same[f"{kind} {name}"] = bool(torch.equal(y, ref))
            print(f"   {kind} {name}: bitwise the package's apply: "
                  f"{same[f'{kind} {name}']}", flush=True)
        names = list(libs)
        t = {n: [] for n in names}
        for r in range(args.rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                t[n].append(cs.pipelined_ms(runner(libs[n]))[0])
        for n in names:
            ms[f"{kind} {n}"] = t[n]
            print(f"   {kind} {n}: " + " / ".join(f"{x:.4f}" for x in t[n])
                  + f" ms back to back [{card}]", flush=True)
        del z, a, ref
    print(json.dumps({"card": card, "kinds": kinds, "ms": ms,
                      "bitwise": same, "geometry": geo}), flush=True)


if __name__ == "__main__":
    main()
