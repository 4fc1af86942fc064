"""Time forms of K3's kernel (``fused_band_kernel`` in ``csrc/bell_spmm.cu``
on ``csrc/band_body.cuh``) on ``bench.py``'s band, to split its time into
copies and multiply-adds and to compare its grids.

    python3 tools/k3_probe.py [--root DIR] [--forms as-is,copies,...]
        [--cases "K3 f64,K3 bf16 kernel"] [--rounds 2]

Each form is a copy of the package under ``DIR`` (default: this checkout),
edited (``tools/_probe.py`` copies, builds and times them):

- ``as-is``: as it is;
- ``copies``: copies every chunk and multiplies none, so its time is the
  copies' and the votes';
- ``multiply``: copies nothing and multiplies every chunk (whatever the
  stages hold), so its time is the multiply-adds' and the barriers';
- ``run``: every kind on ``band::run``, a thread block a tile (where
  ``kWalks`` in ``bell_spmm.cu`` sends kinds to ``band::run_tiles``);
- several edits joined by ``-`` (``run-copies``, ...) make one form.

``copies`` and ``multiply`` give wrong results: they time and check
nothing.  The builds run side by side first, each printing the registers
and spills ``nvcc -Xptxas -v`` reports for ``fused_band_kernel``; then the
forms run in turns (reversed in every other round), each in its own
process.  Needs a card and ``nvcc`` (~2 min for four builds side by side;
~20 s a process for the default cases).
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import _probe

_MMA = "mma_chunk(stage_a(it), stage_b(it), acc);"
_LOAD_A = re.compile(r"load_a<S, VEC>\(stage_a\(it \+ kAhead\w*\),[^;]*\);")
_LOAD_B = re.compile(r"load_b<S, VEC>\(stage_b\([^;]*\);")
_VOTE = re.compile(r"mine_nonzero<S, VEC>\(stage_a\([^()]*\)\)")
_WALKS = re.compile(r"constexpr bool kWalks =[^;]*;")

_EDITS = {"copies", "multiply", "run"}


def _edit_body(form: str, src: str) -> str:
    """``band_body.cuh``'s text for ``form``."""
    edits = form.split("-")
    if "copies" in edits:
        src = _probe.sub(_MMA, "", src, "the multiply")
    if "multiply" in edits:
        src = _probe.sub(_LOAD_A, "(void)0;", src, "A's copy")
        src = _probe.sub(_LOAD_B, "(void)0;", src, "B's copy")
        src = _probe.sub(_VOTE, "true", src, "the vote")
    return src


def _edit_launch(form: str, src: str) -> str:
    """``bell_spmm.cu``'s text for ``form``."""
    if "run" in form.split("-"):
        src = _probe.sub(_WALKS, "constexpr bool kWalks = false;", src,
                         "kWalks")
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(_probe.HERE),
                    help="directory holding the sparse_tpu_torch to probe")
    ap.add_argument("--forms", default="as-is,copies,multiply")
    ap.add_argument("--cases", default="K3 f64,K3 bf16 kernel")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    forms = [f.strip() for f in args.forms.split(",") if f.strip()]
    unknown = {f for f in forms if f != "as-is" and set(f.split("-")) - _EDITS}
    if unknown:
        raise SystemExit(f"k3_probe: unknown forms {unknown}")
    _probe.run({f: {"band_body.cuh": lambda s, f=f: _edit_body(f, s),
                    "bell_spmm.cu": lambda s, f=f: _edit_launch(f, s)}
                for f in forms}, args.cases, args.rounds,
               root=Path(args.root).resolve(), report="fused_band_kernel")


if __name__ == "__main__":
    main()
