"""Time forms of K1's bf16 row kernel on band-10M's compact stream, to find
what holds it back.

    python3 tools/k1_bf16_probe.py

Builds a small CUDA library with ``nvcc`` (sm_90a) into the ignored
``sparse_tpu_torch/_build/k1_bf16_probe/`` from ``segtile_csr.cu`` (so
from ``segtile_common.cuh``) and forms of the bf16 row kernel that change
one thing at a time:

  (a) the row kernel the bf16 kind ran before its window (``stream_rows``
      on ``WideEntries<bf16>``, operand gathered through the L1);
  (b) (a) with every gather read from one 128-byte line (column ``c & 63``):
      the gathers' share of (a);
  (c) the operand window (``window_rows`` with ``WindowBf16``, 12,288
      columns), and (c') the same with a 4,096-column window (8 KB);
  (d) (c) on 8-entry bf16 units: one 16-byte value load and two column
      loads a unit, lane group 4 (a different order of adds);
  (e) (c) in float32 (6,144 columns, 24 KB), for the record;
  (f), (g) (a) and (c) on a grid of one wave of resident blocks (the
      chunks a block grow to match) instead of 8 blocks an SM;
  (h), (i) (f) and (g) written out on 32-bit entry offsets; (j) (i) with
      the first chunk's loads issued before the window's barrier; (k),
      (l) (h) and (j) held to 64 registers; (m), (n) (h) and (j) at two
      rows a lane group;
  (o) the package's ``narrow_rows`` (the kernel K1's bf16 kind runs: (m)
      on ``segtile_common.cuh``, two rows a lane group, 6 blocks an SM),
      (p)-(r) it at 4, 5 and 8 blocks an SM, (s), (t) at four rows a lane
      group and 4 or 3 blocks an SM.

The window forms carry their own window code: the package has none.
On ``chip_smoke``'s band-10M (the float32 plan's streams at 8 and 32
rows, values and operand in bf16; short rows only), each form is run twice
(bitwise), held to the package's K1 (bitwise, but (b); within 2^-8
|A||v| for (d); (e) to the package's float32 K1 within 1e-5 |A||v|)
and timed back to back (``chip_smoke.pipelined_ms``) in two rounds beside
the package's K1 bf16, K1 float32, K1-mxu bf16 and ``CSR @ v`` in bf16.
Prints each form's registers, local bytes, dynamic shared bytes and
resident blocks an SM (the CUDA runtime's), the shared and generic loads
of each window kernel's SASS, the card's name and power limit, and one
JSON line.  About 2 minutes on a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BUILD = HERE / "sparse_tpu_torch" / "_build" / "k1_bf16_probe"

SOURCE = r"""
#include "segtile_csr.cu"

namespace {

using Bf16 = WideEntries<__nv_bfloat16>;  // the kind (a) ran

// ---- the operand window of a row block: forms (c)-(e), (g), (i)-(n) ----

__device__ __forceinline__ unsigned char* window_smem() {
  extern __shared__ __align__(16) unsigned char window_smem_[];
  return window_smem_;
}

// a block whose short rows read columns lo .. hi (hi < lo: none) stages
// them when they are at most `cap` columns
__host__ __device__ __forceinline__ bool window_fits(int lo, int hi,
                                                     int cap) {
  return hi < lo || hi - lo < cap;
}

__host__ __device__ constexpr int window_bytes(int cap, int size) {
  return cap * size + 16;
}

// v[lo .. hi] into window_smem(): 16-byte loads of the aligned chunks
// inside the range, element loads of the two it cuts; returns the column
// of the window's element 0
template <typename V>
__device__ __forceinline__ int stage_window(const V* v, int lo, int hi) {
  constexpr int kPer = 16 / sizeof(V);
  const unsigned long long a = reinterpret_cast<unsigned long long>(v + lo);
  const int off = static_cast<int>(a & 15) / static_cast<int>(sizeof(V));
  const int w0 = lo - off;
  const int n = hi - w0 + 1;
  const uint4* src = reinterpret_cast<const uint4*>(a - (a & 15));
  uint4* dst = reinterpret_cast<uint4*>(window_smem());
  V* dv = reinterpret_cast<V*>(window_smem());
  for (int k = threadIdx.x; k * kPer < n; k += kThreads) {
    if (k * kPer >= off && (k + 1) * kPer <= n) {
      dst[k] = __ldg(src + k);
    } else {
      for (int j = max(k * kPer, off); j < min((k + 1) * kPer, n); ++j)
        dv[j] = v[w0 + j];
    }
  }
  return w0;
}

// stream_rows (short rows only) where each row block's span (over its
// chunks' spans) fits WE::kCols: the block stages it and gathers through
// WE (E's gathers read from the window); a wider block gathers through E
template <class E, class WE, int G>
__global__ void __launch_bounds__(kThreads)
    window_rows(E ent, Rows rows, const int2* __restrict__ spans,
                long long n_row_blocks, long long per_block,
                typename E::T* __restrict__ partial,
                typename E::Out* __restrict__ y) {
  if (blockIdx.x < n_row_blocks) {
    constexpr int kChunkRows = kThreads / G * group_rows<E, G>;
    const long long n_chunks = (rows.n_rows + kChunkRows - 1) / kChunkRows;
    const long long c0 = blockIdx.x * per_block;
    const long long c1 = min(c0 + per_block, n_chunks);
    int lo = 0x7fffffff, hi = -1;
    for (long long c = c0; c < c1; ++c) {
      const int2 sp = __ldg(spans + c);
      lo = min(lo, sp.x);
      hi = max(hi, sp.y);
    }
    if (window_fits(lo, hi, WE::kCols)) {
      const int w0 = hi < lo ? 0 : stage_window(ent.v, lo, hi);
      __syncthreads();
      const WE went(ent, w0);
      for (long long c = c0; c < c1; ++c) chunk_rows<WE, G>(went, rows, c, y);
    } else {
      for (long long c = c0; c < c1; ++c) chunk_rows<E, G>(ent, rows, c, y);
    }
  }  // short rows only: no piece blocks
}

// (c): bf16 gathers from the window, 12,288 columns (24 KB)
struct WindowBf16 : Bf16 {
  using Elem = __nv_bfloat16;
  static constexpr int kCols = 12288;
  int w0;
  __device__ __forceinline__ WindowBf16(const Bf16& e, int w0_)
      : Bf16(e), w0(w0_) {}
  template <typename I>
  __device__ __forceinline__ void add(float (&acc)[1], const Unit& x, I u,
                                      I s, I e) const {
    const unsigned short* win =
        reinterpret_cast<const unsigned short*>(window_smem());
    const int cs[4] = {x.c.x, x.c.y, x.c.z, x.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const I i = 4 * u + j;
      if (i >= s && i < e)
        acc[0] += W::of(x.a[j]) *
                  __uint_as_float(static_cast<unsigned>(win[cs[j] - w0])
                                  << 16);
    }
  }
};

// (b): every gather from the first 64 columns, one 128-byte line
struct OneLine : Bf16 {
  __device__ __forceinline__ void add(float (&acc)[1], const Unit& x,
                                      long long u, long long s,
                                      long long e) const {
    const int cs[4] = {x.c.x, x.c.y, x.c.z, x.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * u + j;
      if (i >= s && i < e)
        acc[0] += W::of(x.a[j]) * W::gather(v, cs[j] & 63);
    }
  }
};

// (c'): a 4,096-column window
struct Window4k : WindowBf16 {
  static constexpr int kCols = 4096;
  __device__ __forceinline__ Window4k(const Bf16& e, int w0_)
      : WindowBf16(e, w0_) {}
};

// (d): 8-entry bf16 units
struct Bf16x8 {
  using W = Widen<__nv_bfloat16>;
  using T = float;
  using Out = __nv_bfloat16;
  static constexpr int kUnit = 8;
  static constexpr int kC = 1;
  const __nv_bfloat16* vals;  // padded to a multiple of 8 entries
  const int* cols;
  const __nv_bfloat16* v;
  struct Unit {
    uint4 a;
    int4 c0, c1;
  };
  __device__ __forceinline__ Unit load(long long u) const {
    Unit x;
    x.a = __ldcs(reinterpret_cast<const uint4*>(vals) + u);
    x.c0 = __ldcs(reinterpret_cast<const int4*>(cols) + 2 * u);
    x.c1 = __ldcs(reinterpret_cast<const int4*>(cols) + 2 * u + 1);
    return x;
  }
  __device__ __forceinline__ float gather(int c) const {
    return W::gather(v, c);
  }
  template <class Self>
  __device__ __forceinline__ static void add_with(const Self& self,
                                                  float (&acc)[1],
                                                  const Unit& x, long long u,
                                                  long long s, long long e) {
    const unsigned w[4] = {x.a.x, x.a.y, x.a.z, x.a.w};
    const int cs[8] = {x.c0.x, x.c0.y, x.c0.z, x.c0.w,
                       x.c1.x, x.c1.y, x.c1.z, x.c1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = 8 * u + j;
      const float a = __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u
                                            : w[j / 2] << 16);
      if (i >= s && i < e) acc[0] += a * self.gather(cs[j]);
    }
  }
  __device__ __forceinline__ void add(float (&acc)[1], const Unit& x,
                                      long long u, long long s,
                                      long long e) const {
    add_with(*this, acc, x, u, s, e);
  }
  __device__ __forceinline__ static long long out_row(long long r) {
    return r;
  }
  __device__ __forceinline__ static void store(float* out, long long i,
                                               const float (&acc)[1]) {
    out[i] = acc[0];
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* out,
                                               long long i,
                                               const float (&acc)[1]) {
    store_out(out + i, acc[0]);
  }
};

struct WindowX8 : Bf16x8 {
  using Elem = __nv_bfloat16;
  static constexpr int kCols = 12288;
  int w0;
  __device__ __forceinline__ WindowX8(const Bf16x8& e, int w0_)
      : Bf16x8(e), w0(w0_) {}
  __device__ __forceinline__ float gather(int c) const {
    return __uint_as_float(
        static_cast<unsigned>(
            reinterpret_cast<const unsigned short*>(window_smem())[c - w0])
        << 16);
  }
  __device__ __forceinline__ void add(float (&acc)[1], const Unit& x,
                                      long long u, long long s,
                                      long long e) const {
    add_with(*this, acc, x, u, s, e);
  }
};

// (e): float32 from a window
using F32 = ScalarEntries<float>;
struct WindowF32 : F32 {
  using Elem = float;
  static constexpr int kCols = 6144;
  int w0;
  __device__ __forceinline__ WindowF32(const F32& e, int w0_)
      : F32(e), w0(w0_) {}
  __device__ __forceinline__ void add(float (&acc)[1], const Unit& x,
                                      long long u, long long s,
                                      long long e) const {
    const float* win = reinterpret_cast<const float*>(window_smem());
    const int cs[4] = {x.c.x, x.c.y, x.c.z, x.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * u + j;
      if (i >= s && i < e) acc[0] += x.a[j] * win[cs[j] - w0];
    }
  }
};

// (f)-(n): the bf16 row kernel with 32-bit entry offsets, written out:
// a chunk's row ranges and first units (fetch), then its sums (compute),
// each row in the package's order of adds; WIN gathers from the window.
template <int G, int K>
struct Chunk32 {
  int s[K], e[K];
  bool mine[K];
  uint2 a[K];
  int4 c[K];
  __device__ __forceinline__ void fetch(const __nv_bfloat16* vals,
                                        const int* cols, const Rows& rows,
                                        int r0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = r0 + k * (kWarp / G);
      s[k] = e[k] = 0;
      mine[k] = false;
      if (r < rows.n_rows) {
        s[k] = __ldg(rows.row_ptr + r);
        e[k] = __ldg(rows.row_ptr + r + 1);
        mine[k] = e[k] - s[k] <= rows.long_min;
        if (!mine[k]) e[k] = s[k];
      }
    }
    const int g = threadIdx.x % G;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = s[k] / 4 + g;
      if (u * 4 < e[k]) {
        a[k] = __ldcs(reinterpret_cast<const uint2*>(vals) + u);
        c[k] = __ldcs(reinterpret_cast<const int4*>(cols) + u);
      }
    }
  }
};

template <bool WIN>
__device__ __forceinline__ float gather32(const __nv_bfloat16* v, int c,
                                          int w0) {
  if (WIN)
    return __uint_as_float(
        static_cast<unsigned>(
            reinterpret_cast<const unsigned short*>(window_smem())[c - w0])
        << 16);
  return Widen<__nv_bfloat16>::gather(v, c);
}

template <bool WIN>
__device__ __forceinline__ void add32(float& acc, uint2 a, int4 c, int u,
                                      int s, int e,
                                      const __nv_bfloat16* v, int w0) {
  const float x[4] = {__uint_as_float(a.x << 16),
                      __uint_as_float(a.x & 0xffff0000u),
                      __uint_as_float(a.y << 16),
                      __uint_as_float(a.y & 0xffff0000u)};
  const int cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * u + j;
    if (i >= s && i < e) acc += x[j] * gather32<WIN>(v, cs[j], w0);
  }
}

template <bool WIN, int G, int K>
__device__ __forceinline__ void compute32(const Chunk32<G, K>& ch,
                                          const __nv_bfloat16* vals,
                                          const int* cols,
                                          const __nv_bfloat16* v, int w0,
                                          int r0, __nv_bfloat16* y) {
  const int g = threadIdx.x % G;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = 0.f;
    const int u = ch.s[k] / 4 + g;
    if (u * 4 < ch.e[k])
      add32<WIN>(acc[k], ch.a[k], ch.c[k], u, ch.s[k], ch.e[k], v, w0);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int u = ch.s[k] / 4 + g + G; u * 4 < ch.e[k]; u += G)
      add32<WIN>(acc[k], __ldcs(reinterpret_cast<const uint2*>(vals) + u),
                 __ldcs(reinterpret_cast<const int4*>(cols) + u), u,
                 ch.s[k], ch.e[k], v, w0);
    acc[k] = group_sum<G>(acc[k]);
    if (ch.mine[k] && g == 0) store_out(y + r0 + k * (kWarp / G), acc[k]);
  }
}

template <bool WIN, int G, int K>
__device__ __forceinline__ void walk32(Chunk32<G, K> cur, int c0, int c1,
                                       const __nv_bfloat16* vals,
                                       const int* cols,
                                       const __nv_bfloat16* v, int w0,
                                       const Rows& rows, __nv_bfloat16* y) {
  auto row0 = [](int c) {
    return (c * kWarps + static_cast<int>(threadIdx.x) / kWarp) *
               (kWarp / G) * K +
           static_cast<int>(threadIdx.x % kWarp) / G;
  };
  for (int c = c0; c < c1; ++c) {
    if (c > c0) cur.fetch(vals, cols, rows, row0(c));
    compute32<WIN, G, K>(cur, vals, cols, v, w0, row0(c), y);
  }
}

// short rows only; WIN: the window where the block's span fits 12,288
// columns; EARLY: the first chunk's loads issued before the window's
// staging; MINB: __launch_bounds__' blocks an SM
template <bool WIN, int G, int K, int MINB, bool EARLY>
__global__ void __launch_bounds__(kThreads, MINB)
    form_rows(const __nv_bfloat16* __restrict__ vals,
              const int* __restrict__ cols,
              const __nv_bfloat16* __restrict__ v, Rows rows,
              const int2* __restrict__ spans, int per_block,
              __nv_bfloat16* __restrict__ y) {
  constexpr int kChunkRows = kThreads / G * K;
  const int n_chunks = (static_cast<int>(rows.n_rows) + kChunkRows - 1) /
                       kChunkRows;
  const int c0 = blockIdx.x * per_block;
  const int c1 = min(c0 + per_block, n_chunks);
  if (c0 >= c1) return;
  const int r00 = (c0 * kWarps + static_cast<int>(threadIdx.x) / kWarp) *
                      (kWarp / G) * K +
                  static_cast<int>(threadIdx.x % kWarp) / G;
  Chunk32<G, K> first;
  if (WIN) {
    int lo = 0x7fffffff, hi = -1;
    for (int c = c0; c < c1; ++c) {
      const int2 sp = __ldg(spans + c);
      lo = min(lo, sp.x);
      hi = max(hi, sp.y);
    }
    if (window_fits(lo, hi, 12288)) {
      if (EARLY) first.fetch(vals, cols, rows, r00);
      const int w0 = hi < lo ? 0 : stage_window(v, lo, hi);
      __syncthreads();
      if (!EARLY) first.fetch(vals, cols, rows, r00);
      walk32<true, G, K>(first, c0, c1, vals, cols, v, w0, rows, y);
      return;
    }
  }
  first.fetch(vals, cols, rows, r00);
  walk32<false, G, K>(first, c0, c1, vals, cols, v, 0, rows, y);
}

// (o)-(t): the package's narrow_rows (32-bit entry offsets, one wave) on
// NarrowBf16 (two rows a lane group) at 4-8 blocks an SM, and on Four
// (four rows a lane group)
struct Four : NarrowBf16 {};
template <>
constexpr bool kHalfRows<Four> = false;

struct Form {
  const void* fn;
  int kind;    // 0: stream_rows, 1: window_rows, 2: form_rows, 3:
               // narrow_rows arguments
  int dyn;     // dynamic shared bytes
  int rows;    // rows a chunk
  int spans;   // 1: takes spans at `rows` rows a chunk
  int f32;     // 1: float32 values and operand
  int per_sm;  // blocks an SM in the grid; 0: one wave of resident blocks
  const char* name;
};

#define FN(f) reinterpret_cast<const void*>(f)
constexpr int kW = window_bytes(12288, 2);

const Form kForms[] = {
    {FN((stream_rows<Bf16, 8>)), 0, 0, 128, 0, 0, 8,
     "(a) the row kernel before the window (stream_rows, __ldg gathers)"},
    {FN((stream_rows<OneLine, 8>)), 0, 0, 128, 0, 0, 8,
     "(b) (a) with every gather on one 128-byte line"},
    {FN((window_rows<Bf16, WindowBf16, 8>)), 1, kW, 128, 1, 0, 8,
     "(c) the operand window, 12,288 columns"},
    {FN((window_rows<Bf16, Window4k, 8>)), 1, window_bytes(4096, 2), 128, 1,
     0, 8, "(c') the operand window, 4,096 columns"},
    {FN((window_rows<Bf16x8, WindowX8, 4>)), 1, kW, 256, 1, 0, 8,
     "(d) (c) on 8-entry units, lane group 4"},
    {FN((window_rows<F32, WindowF32, 8>)), 1, window_bytes(6144, 4), 128, 1,
     1, 8, "(e) (c) in float32, 6,144 columns"},
    {FN((stream_rows<Bf16, 8>)), 0, 0, 128, 0, 0, 0,
     "(f) (a) in one wave of resident blocks"},
    {FN((window_rows<Bf16, WindowBf16, 8>)), 1, kW, 128, 1, 0, 0,
     "(g) (c) in one wave"},
    {FN((form_rows<false, 8, 4, 1, false>)), 2, 0, 128, 0, 0, 0,
     "(h) (f) on 32-bit entry offsets"},
    {FN((form_rows<true, 8, 4, 1, false>)), 2, kW, 128, 1, 0, 0,
     "(i) (g) on 32-bit entry offsets"},
    {FN((form_rows<true, 8, 4, 1, true>)), 2, kW, 128, 1, 0, 0,
     "(j) (i), the first chunk's loads before the window's barrier"},
    {FN((form_rows<false, 8, 4, 4, false>)), 2, 0, 128, 0, 0, 0,
     "(k) (h) held to 64 registers (4 blocks an SM)"},
    {FN((form_rows<true, 8, 4, 4, true>)), 2, kW, 128, 1, 0, 0,
     "(l) (j) held to 64 registers"},
    {FN((form_rows<false, 8, 2, 1, false>)), 2, 0, 64, 0, 0, 0,
     "(m) (h) at 2 rows a lane group"},
    {FN((form_rows<true, 8, 2, 1, true>)), 2, kW, 64, 1, 0, 0,
     "(n) (j) at 2 rows a lane group"},
    {FN((narrow_rows<NarrowBf16, 8, kBf16Blocks>)), 3, 0, 64, 0, 0, 0,
     "(o) the package's narrow_rows: 2 rows a lane group, 6 blocks an SM"},
    {FN((narrow_rows<NarrowBf16, 8, 4>)), 3, 0, 64, 0, 0, 0,
     "(p) (o) at 4 blocks an SM"},
    {FN((narrow_rows<NarrowBf16, 8, 5>)), 3, 0, 64, 0, 0, 0,
     "(q) (o) at 5 blocks an SM"},
    {FN((narrow_rows<NarrowBf16, 8, 8>)), 3, 0, 64, 0, 0, 0,
     "(r) (o) at 8 blocks an SM (32 registers)"},
    {FN((narrow_rows<Four, 8, 4>)), 3, 0, 128, 0, 0, 0,
     "(s) (o) at 4 rows a lane group, 4 blocks an SM"},
    {FN((narrow_rows<Four, 8, 3>)), 3, 0, 128, 0, 0, 0,
     "(t) (s) at 3 blocks an SM"},
};
constexpr int kNF = sizeof(kForms) / sizeof(kForms[0]);

struct Ptrs {  // an entry kind's fields: vals, cols, v
  const void* vals;
  const int* cols;
  const void* v;
};

}  // namespace

extern "C" {

int probe_count() { return kNF; }
const char* probe_name(int i) { return kForms[i].name; }
int probe_rows(int i) { return kForms[i].spans ? kForms[i].rows : 0; }
int probe_f32(int i) { return kForms[i].f32; }

// out: registers, local bytes, dynamic shared bytes, resident 256-thread
// blocks an SM
int probe_attr(int i, int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, kForms[i].fn);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kForms[i].fn, kThreads, kForms[i].dyn);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = kForms[i].dyn;
  out[3] = per_sm;
  return e;
}

// a: the stream's fixed arguments (short rows only); spans at the form's
// rows a chunk (or null)
int probe_run(int i, const StreamArgs* a, const int* spans, const void* vals,
              const void* v, void* y, void* stream) {
  const Form& f = kForms[i];
  Rows rows = rows_of(*a);
  const long long chunks = (a->n_rows + f.rows - 1) / f.rows;
  int dev = 0, sms = 0, per_sm = f.per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f.fn, kThreads,
                                                  f.dyn);
  const long long want = static_cast<long long>(sms) * per_sm;
  long long per_block = chunks > want ? (chunks + want - 1) / want : 1;
  long long grid = (chunks + per_block - 1) / per_block;
  int per_block32 = static_cast<int>(per_block);
  Ptrs ent{vals, a->cols, v};
  const int2* sp = reinterpret_cast<const int2*>(spans);
  void* partial = nullptr;
  void* args0[] = {&ent, &rows, &grid, &per_block, &partial, &y};
  void* args1[] = {&ent, &rows, &sp, &grid, &per_block, &partial, &y};
  void* args2[] = {&ent.vals, &ent.cols, &ent.v, &rows, &sp, &per_block32,
                   &y};
  int grid32 = static_cast<int>(grid);
  void* args3[] = {&ent, &rows, &grid32, &per_block32, &partial, &y};
  void** args = f.kind == 0   ? args0
                : f.kind == 1 ? args1
                : f.kind == 2 ? args2
                              : args3;
  cudaLaunchKernel(f.fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                   args, f.dyn, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

}  // extern "C"
"""


def chunk_col_spans(stream, chunk_rows):
    """The lowest and highest column the short rows of each
    ``chunk_rows``-row chunk of ``stream`` read: int32 ``(n_chunks, 2)``,
    ``(2**31 - 1, -1)`` for none (the window forms' spans)."""
    import torch

    n_chunks = -(-stream.n_rows // chunk_rows)
    dev = stream.cols.device
    lo = torch.full((n_chunks,), 2**31 - 1, dtype=torch.int32, device=dev)
    hi = torch.full((n_chunks,), -1, dtype=torch.int32, device=dev)
    lens = stream.row_ptr.diff()
    short = lens <= stream.long_min
    rows = torch.repeat_interleave(
        torch.arange(stream.n_rows, device=dev)[short], lens[short].long())
    cols = stream.cols[:stream.nnz][torch.repeat_interleave(short,
                                                            lens.long())]
    lo.scatter_reduce_(0, rows // chunk_rows, cols, "amin")
    hi.scatter_reduce_(0, rows // chunk_rows, cols, "amax")
    return torch.stack([lo, hi], 1).contiguous()


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(HERE))
    from sparse_tpu_torch import _kernels

    nvcc = _kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("k1_bf16_probe: no nvcc")
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "probe.cu", BUILD / "probe.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, *_kernels.NVCC_FLAGS[:-2], "-shared", "-I",
                    str(HERE / "sparse_tpu_torch" / "csrc"), "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_name.restype = ctypes.c_char_p
    dll.probe_attr.argtypes = [ctypes.c_int, ctypes.c_void_p]
    dll.probe_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    return dll


def sass_loads(lib: Path) -> dict:
    """{window kernel: (shared loads, generic loads)} in the library's
    SASS (``cuobjdump``, beside ``nvcc``)."""
    from sparse_tpu_torch import _kernels

    tool = str(Path(_kernels.find_nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"^\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "window_rows" in m.group(1) else None
            if name:
                counts[name] = [0, 0]
        elif name:
            if re.search(r"\bLDS(\.|\s)", line):
                counts[name][0] += 1
            elif re.search(r"\bLD(\.|\s)", line):
                counts[name][1] += 1
    return counts


def main():
    import numpy as np
    import torch

    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr

    if not torch.cuda.is_available():
        raise SystemExit("k1_bf16_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = build()
    loads = sass_loads(BUILD / "probe.so")
    for name, (lds, ld) in loads.items():
        print(f"   SASS {name}: {lds} shared loads, {ld} generic loads",
              flush=True)
    band = cs.phase4_band()
    plan, v = band["plan"], band["v"]
    a, st = plan.state
    st32 = cuda_csr.build_seg_tiles(a, wsub=st.wsub, rows=32)
    bf = torch.bfloat16
    ab, vb = dataclasses.replace(a, data=a.data.to(bf)), v.to(bf)
    mag = torch.from_numpy(abs(cs.sp_csr_f64(ab)) @ np.abs(
        vb.double().cpu().numpy())).cuda()
    mag32 = torch.from_numpy(abs(cs.sp_csr_f64(a)) @ np.abs(
        v.double().cpu().numpy())).cuda()
    csr = cs.torch_csr(ab, torch.int32)
    out = {"card": card, "sass_loads": loads, "forms": {}, "ms": {}}
    for tag, sp in (("rows 8", st), ("rows 32", st32)):
        sb = dataclasses.replace(sp.stream, vals=sp.stream.vals.to(bf))
        spb = dataclasses.replace(sp, stream=sb)
        if sb.n_long or sb.group != 8:
            raise SystemExit(f"k1_bf16_probe: {tag}: {sb.n_long} long rows, "
                             f"lane group {sb.group}; the forms take short "
                             "rows at lane group 8")
        pad = -sb.vals.numel() % 8
        vals8 = torch.cat([sb.vals, sb.vals.new_zeros(pad)])
        cols8 = torch.cat([sb.cols, sb.cols.new_zeros(pad)])
        s8 = dataclasses.replace(sb, vals=vals8, cols=cols8)
        ref = pt.csr_smvm_segtile(ab, vb, spb)
        ref32 = pt.csr_smvm_segtile(a, v, sp)
        _, addr, _ = cuda_csr._fixed_args(sb, "segtile_csr_bf16")
        _, addr8, _ = cuda_csr._fixed_args(s8, "segtile_csr_bf16")
        spans = {r: chunk_col_spans(sb, r) for r in (64, 128, 256)}
        y = torch.empty(sb.n_rows, dtype=bf, device="cuda")
        y32 = torch.empty(sb.n_rows, dtype=torch.float32, device="cuda")

        def form(i, sb=sb, s8=s8, sp=sp, addr=addr, addr8=addr8,
                 spans=spans, y=y, y32=y32):
            r, f32 = lib.probe_rows(i), lib.probe_f32(i)
            x8 = r == 256
            yy = y32 if f32 else y

            def run():
                rc = lib.probe_run(
                    i, addr8 if x8 else addr,
                    spans[r].data_ptr() if r else None,
                    (sp.stream.vals if f32 else s8.vals if x8
                     else sb.vals).data_ptr(),
                    (v if f32 else vb).data_ptr(), yy.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"form {i}: cudaError {rc}")
                return yy
            return run

        cases = {
            "package K1 bf16": lambda spb=spb: pt.csr_smvm_segtile(
                ab, vb, spb),
            "package K1 float32": lambda sp=sp: pt.csr_smvm_segtile(a, v, sp),
            "package K1-mxu bf16": lambda spb=spb: pt.csr_smvm_segtile(
                ab, vb, spb, reduce="mxu"),
            "CSR @ v bf16 (int32 indices)": lambda: csr @ vb,
        }
        for i in range(lib.probe_count()):
            name = lib.probe_name(i).decode()
            cases[name] = form(i)
            if tag == "rows 8":
                at = (ctypes.c_int * 4)()
                if lib.probe_attr(i, at):
                    raise RuntimeError(f"form {i}: attributes")
                out["forms"][name] = dict(registers=at[0],
                                          local_bytes=at[1],
                                          dynamic_shared_bytes=at[2],
                                          blocks_per_sm=at[3])
            y1, y2 = form(i)().clone(), form(i)().clone()
            torch.cuda.synchronize()
            if not torch.equal(y1, y2):
                raise AssertionError(f"{tag} {name}: not bitwise repeatable")
            f32 = lib.probe_f32(i)
            want = ref32 if f32 else ref
            same = torch.equal(y1, want)
            if not name.startswith(("(b)", "(d)", "(e)")) and not same:
                raise AssertionError(f"{tag} {name}: not the package's bits")
            if name.startswith(("(d)", "(e)")):
                tol, m = (1e-5, mag32) if f32 else (2.0 ** -8, mag)
                over = float(((y1.double() - want.double()).abs()
                              - tol * m).max())
                if not over <= 0:
                    raise AssertionError(f"{tag} {name}: off the package's "
                                         f"K1 by {over} past the gate")
            print(f"   {tag} {name}: {out['forms'][name]}, bitwise equal to "
                  f"the package's K1: {same}", flush=True)
        ms = out["ms"][tag] = {}
        for _ in range(2):
            for name, fn in cases.items():
                ms.setdefault(name, []).append(cs.pipelined_ms(fn)[0])
        for name, t in ms.items():
            print(f"   {tag} {name}: {t[0]:.4f} / {t[1]:.4f} ms back to back "
                  f"[{card}]", flush=True)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per = -(-spans[128].shape[0] // (sms * 8))  # (c)'s chunks a block
        n_b = -(-spans[128].shape[0] // per)
        lo = torch.full((n_b * per,), 2**31 - 1, dtype=torch.int64)
        hi = torch.full((n_b * per,), -1, dtype=torch.int64)
        lo[:spans[128].shape[0]] = spans[128][:, 0].cpu().long()
        hi[:spans[128].shape[0]] = spans[128][:, 1].cpu().long()
        width = (hi.view(n_b, per).max(1).values
                 - lo.view(n_b, per).min(1).values + 1)
        out.setdefault("widest_window", {})[tag] = int(width.max())
        print(f"   {tag}: (c)'s {n_b} row blocks of {per} chunks read at most "
              f"{int(width.max())} columns each", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
