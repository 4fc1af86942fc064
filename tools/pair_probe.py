"""Time pair bodies for K4's and K8's float32 kind against the package's
``band::run`` / ``run_masked`` on ``bench.py``'s band: thread blocks of 64
output rows (two 32-row blocks, each B chunk copied once for both) in the
forms of ``tools/pair_body.cuh``.

    python3 tools/pair_probe.py [--forms run,pair,u2,...]
        [--cases "K4,K4 kit,K8"] [--rounds 2]

Each form is a copy of this checkout's package with the edits its name
joins with ``+`` (``tools/_probe.py`` copies, builds and times them).
Every form but ``run`` appends ``tools/pair_body.cuh`` to the copy's
``csrc/band_body.cuh`` and points its ``bell_banded.cu`` at the pair
body's launch geometry and bodies (``PairDense``, ``dense_run``,
``dense_run_masked``):

- ``run``: the package as it is (32-row blocks, 8 x 4 register tiles);
- ``pair``: the pair body as the file has it (``run_pair``: 128 threads,
  each on the wide body's 8 x 8 map over both halves, rows 8 apart on a
  swizzled 64 x 32 A stage; three bodies for both halves, the first, the
  second; three blocks an SM);
- ``u<N>``: ``mma_pair`` unrolls N of a chunk's eight 4-index steps
  (``kPairUnroll``, 8 in the file), the rest a loop;
- ``a<N>``: ``mma_pair`` reads A N indices a load (``kPairAStep``: 4 in
  the file, LDS.128; 2 LDS.64; 1 LDS.32);
- ``b<N>``: ``__launch_bounds__`` asks for N blocks an SM (3 in the file;
  2 lets a thread hold 255 registers);
- ``split``: warps 0-1 on the first half, 2-3 on the second, 4 x 16
  register tiles (``kPairHalfWarps``);
- ``wide``: ``run_pair2``: 256 threads, run's 8 x 4 map (``mma_chunk``),
  warps 0-3 the first half, 4-7 the second, two blocks an SM;
- ``int``: int32 on the same body as float32;
- ``one-body``: every kept chunk on the both-halves body (8 x 8 map);
- ``copies``: copies and votes, multiplies nothing;
- ``no-b``: copies no B chunk, multiplies whatever B's stages hold;
- ``multiply``: the mask bodies copy nothing and multiply each marked
  chunk, so K4's kit route times the multiply-adds and the barriers alone
  (the vote bodies then find nothing to multiply).

``copies``, ``no-b`` and ``multiply`` edit ``run``'s bodies too.
``one-body``, ``copies``, ``no-b`` and ``multiply`` give wrong results:
they time and check nothing; every other form prints the digest of
``run``'s C.  The builds run side by side first, each printing the
registers and spills ``nvcc -Xptxas -v`` reports for K4's and K8's float32
and int32 kernels; then the forms run in turns (reversed in every other
round), each in its own process.  Needs a card and ``nvcc`` (~3 min for
eight builds side by side; ~15-25 s a process).
"""

from __future__ import annotations

import argparse
import re

import _probe

PAIR = _probe.HERE / "tools" / "pair_body.cuh"

# a form's u, a and b: the pair body's constant each sets, and its value in
# the file
_CONSTS = {"u": ("kPairUnroll", 8), "a": ("kPairAStep", 4),
           "b": ("kPairMinBlocks", 3)}
_FLAGS = {"split": ("constexpr bool kPairHalfWarps = false;",
                    "constexpr bool kPairHalfWarps = true;"),
          "wide": ("constexpr int kFloatBody = 1;",
                   "constexpr int kFloatBody = 2;"),
          "int": ("constexpr bool kIntToo = false;",
                  "constexpr bool kIntToo = true;"),
          "one-body": ("if (halves == 3u)", "if (halves != 0u)")}
# the multiplies of every body; their B copies; the mask bodies' copies
_MMA = re.compile(r"mma_halves\((?:nzq|hv)[^;]*\);|"
                  r"mma_chunk\((?:stage_a\(it\)|sa \+ s)[^;]*\);")
_LOAD_B = re.compile(r"load_b(?:256)?<[ST], VEC>"
                     r"\((?:sb \+ s|stage_b\(ch\))[^;]*\);")
_FILL = re.compile(r"load_(?:a_pair|a256|b256|a|b)<[ST], VEC(?:, \w+)?>"
                   r"\(s[ab] \+ [^;]*\);")
_END = "}  // namespace band\n"
# bell_banded.cu's launch geometry and bodies, and what a pair form puts
# in their place
_DENSE = re.compile(r"template <typename S>\nstruct Dense \{.*?\n\};\n",
                    re.S)
_HOOKS = (("band::run<S, VEC>(d.p,", "band::dense_run<S, VEC>(d.p,"),
          ("band::run_masked<S, VEC>(d.p, mask + d.bid * nc,",
           "band::dense_run_masked<S, VEC>(d.p, mask, d.tile, d.bid, nc,"))


def _edits(form: str) -> list[str]:
    edits = form.split("+")
    for e in edits:
        if not (re.fullmatch(r"[uab]\d", e) or e in _FLAGS
                or e in ("run", "pair", "copies", "no-b", "multiply")):
            raise SystemExit(f"pair_probe: unknown edit {e!r}")
    return edits


def _edit_body(form: str, src: str) -> str:
    """``band_body.cuh``'s text for ``form``."""
    edits = _edits(form)
    if "run" not in edits:
        at = src.rindex(_END)
        src = src[:at] + _END + "\n" + PAIR.read_text() + src[at + len(_END):]
    for e in edits:
        if re.fullmatch(r"[uab]\d", e):
            name, was = _CONSTS[e[0]]
            src = _probe.sub(f"constexpr int {name} = {was};",
                             f"constexpr int {name} = {e[1]};", src, name)
        elif e in _FLAGS:
            src = _probe.sub(*_FLAGS[e], src, e)
        elif e == "copies":
            src = _probe.sub(_MMA, "(void)0;", src, "the multiply")
        elif e == "no-b":
            src = _probe.sub(_LOAD_B, "(void)0;", src, "B's copy")
        elif e == "multiply":
            src = _probe.sub(_FILL, "(void)0;", src, "the mask bodies' copies")
    return src


def _edit_launch(form: str, src: str) -> str:
    """``bell_banded.cu``'s text for ``form``."""
    if "run" in _edits(form):
        return src
    src = _probe.sub(_DENSE, "template <typename S>\n"
                     "using Dense = band::PairDense<S>;\n", src,
                     "K4/K8's launch geometry")
    for was, now in _HOOKS:
        src = _probe.sub(was, now, src, "K4/K8's body call")
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", default="run,pair")
    ap.add_argument("--cases", default="K4,K4 kit,K8")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    forms = [f.strip() for f in args.forms.split(",") if f.strip()]
    csrc = _probe.HERE / "sparse_tpu_torch" / "csrc"
    for f in forms:  # refuse a form that does not apply before any build
        _edit_body(f, (csrc / "band_body.cuh").read_text())
        _edit_launch(f, (csrc / "bell_banded.cu").read_text())
    _probe.run({f: {"band_body.cuh": lambda s, f=f: _edit_body(f, s),
                    "bell_banded.cu": lambda s, f=f: _edit_launch(f, s)}
                for f in forms}, args.cases, args.rounds,
               report=r"band(_mask)?_kernelI[fi]Lb")


if __name__ == "__main__":
    main()
