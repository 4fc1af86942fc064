"""Time forms of K4's mask body (``band::run_masked`` in
``csrc/band_body.cuh``) on ``bench.py``'s band, to find what holds the kit
route (``bell_spmm(a, b, plan=kit)``).

    python3 tools/k4_kit_probe.py [--forms mask,no-multiply,no-b,a-ahead]
        [--cases "K4 kit,K4 kit f64"] [--rounds 2]

Each form is a copy of this checkout's package with ``run_masked``
edited (``tools/_probe.py`` copies, builds and times them):

- ``mask``: as it is;
- ``no-multiply``: copies the marked chunks and multiplies none, so its
  time is the copies' (A's and B's marked chunks, one ring stage each);
- ``no-b``: copies A's marked chunks and multiplies them with whatever B's
  stage holds, so B's copies are what it leaves out;
- ``a-ahead``: A ``kAStages - 2`` marked chunks ahead in A's ring and B
  ``kBStages - 1`` ahead in B's, two cp.async groups a step (the vote
  body's rings, with a barrier in the place of the vote).

The last three give wrong results: they time and check nothing.  The forms
run in turns (reversed in every other round), each in its own process.
Needs a card and ``nvcc`` (the builds side by side, ~45 s; ~20 s a
process; ~3.5 min for the four forms in two rounds).
"""

from __future__ import annotations

import argparse

import _probe

_MMA = ("    mma_chunk(sa + s * kBM * Cf::kAPitch, sb + s * kBK * Cf::kBPitch,"
        " acc);\n")
_LOAD_B = ("    load_b<S, VEC>(sb + s * kBK * Cf::kBPitch, p, N, ch * kBK, "
           "n0);\n")

# run_masked with A and B in their own rings (``a-ahead``)
_A_AHEAD = r'''
template <typename S, bool VEC, class P>
__device__ __forceinline__ void run_masked(
    const P& p, const unsigned char* __restrict__ mk, typename Cfg<S>::Out* c,
    int M, int K, int N, int m0, int n0, unsigned long long* issued) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  constexpr int kBK = Cf::kBK;
  constexpr int kA = Cf::kAStages - 2, kB = Cf::kBStages - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kBM * Cf::kAPitch;
  const int nc = (K + kBK - 1) / kBK;
  typename Cf::Acc acc = {};
  auto next = [&](int ch) {
    for (++ch; ch < nc && __ldg(mk + ch) == 0; ++ch) {
    }
    return ch;
  };
  auto stage_a = [&](int i) {
    return sa + (i % Cf::kAStages) * kBM * Cf::kAPitch;
  };
  auto stage_b = [&](int i) {
    return sb + (i % Cf::kBStages) * kBK * Cf::kBPitch;
  };
  constexpr int kWait = 2 * kB - 1;
  int ca = next(-1), cb = ca, cm = ca;
  int kept = 0;
  for (int it = -kA; cm < nc; ++it) {
    if (ca < nc) {
      load_a<S, VEC>(stage_a(it + kA), p, M, K, m0, ca * kBK);
      ca = next(ca);
    }
    sm90::cp_async_commit();
    if (it + kB >= 0) {
      sm90::cp_async_wait<kWait>();
      __syncthreads();
      if (cb < nc) {
        load_b<S, VEC>(stage_b(it + kB), p, N, cb * kBK, n0);
        cb = next(cb);
      }
    }
    sm90::cp_async_commit();
    if (it >= 0) {
      mma_chunk(stage_a(it), stage_b(it), acc);
      ++kept;
      cm = next(cm);
    }
  }
  sm90::cp_async_wait<0>();
  store<VEC>(acc, c, M, N, m0, n0);
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}
'''


def _edit(form: str, src: str) -> str:
    """``band_body.cuh``'s text for ``form``."""
    if form == "mask":
        return src
    if form == "no-multiply":
        return _probe.sub(_MMA, "", src, "the multiply")
    if form == "no-b":
        return _probe.sub(_LOAD_B, "", src, "B's copy")
    if form == "a-ahead":
        start = src.index("template <typename S, bool VEC, class P>\n"
                          "__device__ __forceinline__ void run_masked(")
        end = src.index("// Lets kern", start)
        return src[:start] + _A_AHEAD.lstrip("\n") + "\n" + src[end:]
    raise SystemExit(f"k4_kit_probe: unknown form {form!r}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", default="mask,no-multiply,no-b,a-ahead")
    ap.add_argument("--cases", default="K4 kit,K4 kit bf16,K4 kit bf16x3,"
                    "K4 kit f64,K4 kit i32")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    forms = [f.strip() for f in args.forms.split(",") if f.strip()]
    _probe.run({f: {"band_body.cuh": lambda src, f=f: _edit(f, src)}
                for f in forms}, args.cases, args.rounds)


if __name__ == "__main__":
    main()
