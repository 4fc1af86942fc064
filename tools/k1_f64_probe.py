"""Time forms of K1's float64 row kernel on band-10M's compact stream, to
find what held the first one back.

    python3 tools/k1_f64_probe.py

Builds a small CUDA library with ``nvcc`` (sm_90a) into the ignored
``sparse_tpu_torch/_build/k1_f64_probe/`` holding the row kernel K1's
float64 kind ran before it had one of its own (``segtile_common.cuh``'s
``stream_rows`` on 4-entry units with 64-bit entry offsets, 4 rows a lane
group, 8 blocks an SM) and forms of it that change one thing at a time:
32-bit entry offsets; a grid of one wave (the SMs times the blocks the
occupancy call says fit) or of 2-8 blocks an SM; rows a lane group;
2-entry load units (one 16-byte value load and an 8-byte column load) on
twice the lanes; the next chunk's loads issued before this chunk's
gathers.  On ``chip_smoke``'s
band-10M (the float32 plan's streams at 8 and 32 rows, values in float64;
short rows only), each form is held to the package's K1 within 1e-12
(|A||v|), run twice (bitwise), and timed back to back
(``chip_smoke.pipelined_ms``) in two rounds beside the package's K1 and
K1-mxu in float64, K1 in float32 and ``CSR @ v`` in float64.  Prints each
form's registers, local bytes and resident blocks an SM (the CUDA
runtime's), the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BUILD = HERE / "sparse_tpu_torch" / "_build" / "k1_f64_probe"

SOURCE = r"""
#include "segtile_common.cuh"

namespace {

// the row kernel's entry kind before float64 had a kernel of its own
struct OldEntries {
  using T = double;
  using Out = double;
  static constexpr int kUnit = 4;
  static constexpr int kC = 1;
  const double* vals;
  const int* cols;
  const double* v;
  struct Unit {
    double a[4];
    int4 c;
  };
  __device__ __forceinline__ Unit load(long long u) const {
    Unit x;
    load4_stream(vals + 4 * u, x.a);
    x.c = __ldcs(reinterpret_cast<const int4*>(cols) + u);
    return x;
  }
  __device__ __forceinline__ void add(double (&acc)[1], const Unit& x,
                                      long long u, long long s,
                                      long long e) const {
    const int cs[4] = {x.c.x, x.c.y, x.c.z, x.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * u + j;
      if (i >= s && i < e) acc[0] += x.a[j] * __ldg(v + cs[j]);
    }
  }
  __device__ __forceinline__ static long long out_row(long long r) {
    return r;
  }
  __device__ __forceinline__ static void store(double* out, long long i,
                                               const double (&acc)[1]) {
    out[i] = acc[0];
  }
};

template <int UNIT>
struct U;
template <>
struct U<4> {
  double a[4];
  int c[4];
  template <typename I>
  __device__ __forceinline__ void load(const double* vals, const int* cols,
                                       I u) {
    const double2 t0 = __ldcs(reinterpret_cast<const double2*>(vals) + 2 * u);
    const double2 t1 =
        __ldcs(reinterpret_cast<const double2*>(vals) + 2 * u + 1);
    const int4 q = __ldcs(reinterpret_cast<const int4*>(cols) + u);
    a[0] = t0.x; a[1] = t0.y; a[2] = t1.x; a[3] = t1.y;
    c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
  }
};
template <>
struct U<2> {
  double a[2];
  int c[2];
  template <typename I>
  __device__ __forceinline__ void load(const double* vals, const int* cols,
                                       I u) {
    const double2 t = __ldcs(reinterpret_cast<const double2*>(vals) + u);
    const int2 q = __ldcs(reinterpret_cast<const int2*>(cols) + u);
    a[0] = t.x; a[1] = t.y;
    c[0] = q.x; c[1] = q.y;
  }
};

// a chunk's rows for one lane: entry ranges (type I) and first units
template <int UNIT, int G, int K, typename I>
struct Chunk {
  I s[K], e[K];
  bool mine[K];
  U<UNIT> x[K];
  __device__ __forceinline__ void fetch(const double* vals, const int* cols,
                                        const Rows& rows, long long r0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long r = r0 + k * (kWarp / G);
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
      const I u = s[k] / UNIT + g;
      if (u * UNIT < e[k]) x[k].load(vals, cols, u);
    }
  }
};

template <int UNIT, typename I>
__device__ __forceinline__ void add(double& acc, const U<UNIT>& x, I u, I s,
                                    I e, const double* v) {
#pragma unroll
  for (int j = 0; j < UNIT; ++j) {
    const I i = UNIT * u + j;
    if (i >= s && i < e) acc += x.a[j] * __ldg(v + x.c[j]);
  }
}

// short rows only: G lanes a row, K rows a lane group, UNIT entries a load
template <int UNIT, int G, int K, bool PIPE, typename I>
__global__ void __launch_bounds__(kThreads)
    form_rows(const double* __restrict__ vals, const int* __restrict__ cols,
              const double* __restrict__ v, Rows rows, long long per_block,
              double* __restrict__ y) {
  constexpr int kChunkRows = kThreads / G * K;
  constexpr int kGroups = kWarp / G;
  const long long n_chunks = (rows.n_rows + kChunkRows - 1) / kChunkRows;
  const long long c0 = blockIdx.x * per_block;
  const long long c1 = min(c0 + per_block, n_chunks);
  if (c0 >= c1) return;
  const int g = threadIdx.x % G;
  auto row0 = [&](long long c) {
    return (c * kWarps + threadIdx.x / kWarp) * kGroups * K +
           (threadIdx.x % kWarp) / G;
  };
  Chunk<UNIT, G, K, I> cur;
  cur.fetch(vals, cols, rows, row0(c0));
  for (long long c = c0; c < c1; ++c) {
    Chunk<UNIT, G, K, I> nxt;
    if (PIPE && c + 1 < c1) nxt.fetch(vals, cols, rows, row0(c + 1));
    double acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = 0.0;
      const I u = cur.s[k] / UNIT + g;
      if (u * UNIT < cur.e[k])
        add<UNIT, I>(acc[k], cur.x[k], u, cur.s[k], cur.e[k], v);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      for (I u = cur.s[k] / UNIT + g + G; u * UNIT < cur.e[k]; u += G) {
        U<UNIT> x;
        x.load(vals, cols, u);
        add<UNIT, I>(acc[k], x, u, cur.s[k], cur.e[k], v);
      }
      acc[k] = group_sum<G>(acc[k]);
      if (cur.mine[k] && g == 0) y[row0(c) + k * kGroups] = acc[k];
    }
    if (PIPE) {
      cur = nxt;
    } else if (c + 1 < c1) {
      cur.fetch(vals, cols, rows, row0(c + 1));
    }
  }
}

struct Form {
  const void* fn;
  int chunk_rows;
  int per_sm;  // blocks an SM in the grid; 0: as many as are resident
  int old;     // 1: stream_rows<OldEntries, 8> and its arguments
  const char* name;
};

#define F(UNIT, G, K, PIPE, I, PER_SM)                                      \
  Form{reinterpret_cast<const void*>(form_rows<UNIT, G, K, PIPE, I>),       \
       kThreads / G * K, PER_SM, 0,                                        \
       #I " offsets, " #UNIT "-entry units, G " #G ", " #K " rows a group"  \
       ", pipelined " #PIPE ", " #PER_SM " blocks an SM (0: resident)"}

const Form kForms[] = {
    Form{reinterpret_cast<const void*>(stream_rows<OldEntries, 8>),
         kThreads / 8 * 4, kBlocksPerSm, 1,
         "the first kernel (stream_rows, 8 blocks an SM)"},
    F(4, 8, 4, false, long long, 8),
    F(4, 8, 4, false, int, 8),
    F(4, 8, 4, false, int, 0),
    F(4, 8, 2, false, int, 0),
    F(4, 8, 2, false, int, 2),
    F(4, 8, 2, false, int, 3),
    F(4, 8, 2, false, int, 4),
    F(4, 8, 2, false, int, 8),
    F(4, 8, 2, false, long long, 0),
    F(4, 8, 3, false, int, 0),
    F(4, 8, 1, false, int, 0),
    F(2, 16, 2, false, int, 0),
    F(4, 8, 4, true, int, 0),
    F(2, 16, 2, true, int, 0),
};
constexpr int kNF = sizeof(kForms) / sizeof(kForms[0]);

}  // namespace

extern "C" {

int probe_count() { return kNF; }
const char* probe_name(int i) { return kForms[i].name; }

// out: registers, local bytes, resident 256-thread blocks an SM
int probe_attr(int i, int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, kForms[i].fn);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kForms[i].fn,
                                                      kThreads, 0);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = per_sm;
  return e;
}

int probe_run(int i, const StreamArgs* a, const void* vals, const void* v,
              void* y, void* stream) {
  const Form& f = kForms[i];
  Rows rows = rows_of(*a);
  const long long chunks = (a->n_rows + f.chunk_rows - 1) / f.chunk_rows;
  int dev = 0, sms = 0, per_sm = f.per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f.fn, kThreads, 0);
  const long long want = static_cast<long long>(sms) * per_sm;
  long long per_block = chunks > want ? (chunks + want - 1) / want : 1;
  const long long grid = (chunks + per_block - 1) / per_block;
  const double* pv = static_cast<const double*>(vals);
  const int* pc = a->cols;
  const double* pvv = static_cast<const double*>(v);
  double* py = static_cast<double*>(y);
  OldEntries ent{pv, pc, pvv};
  long long row_blocks = grid;
  double* partial = nullptr;
  void* old_args[] = {&ent, &rows, &row_blocks, &per_block, &partial, &py};
  void* args[] = {&pv, &pc, &pvv, &rows, &per_block, &py};
  cudaLaunchKernel(f.fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                   f.old ? old_args : args, 0,
                   static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

}  // extern "C"
"""


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(HERE))
    from sparse_tpu_torch import _kernels

    nvcc = _kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("k1_f64_probe: no nvcc")
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "probe.cu", BUILD / "probe.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, *_kernels.NVCC_FLAGS[:-2], "-shared", "-I",
                    str(HERE / "sparse_tpu_torch" / "csrc"), "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_name.restype = ctypes.c_char_p
    dll.probe_attr.argtypes = [ctypes.c_int, ctypes.c_void_p]
    dll.probe_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    return dll


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
        raise SystemExit("k1_f64_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = build()
    band = cs.phase4_band()
    plan, v = band["plan"], band["v"]
    a, st = plan.state
    st32 = cuda_csr.build_seg_tiles(a, wsub=st.wsub, rows=32)
    a64, v64 = dataclasses.replace(a, data=a.data.double()), v.double()
    mag = torch.from_numpy(abs(cs.sp_csr_f64(a64)) @ np.abs(
        v64.cpu().numpy())).cuda()
    csr = cs.torch_csr(a64)
    out = {"card": card, "forms": {}, "ms": {}}
    for tag, sp in (("rows 8", st), ("rows 32", st32)):
        s64 = dataclasses.replace(sp.stream, vals=sp.stream.vals.double())
        sp64 = dataclasses.replace(sp, stream=s64)
        if s64.n_long or s64.group != 8:
            raise SystemExit(f"k1_f64_probe: {tag}: {s64.n_long} long rows, "
                             f"lane group {s64.group}; the forms take short "
                             "rows at lane group 8")
        ref = pt.csr_smvm_segtile(a64, v64, sp64)
        _, addr, _ = cuda_csr._fixed_args(s64, "segtile_csr_f64")
        y = torch.empty(s64.n_rows, dtype=torch.float64, device="cuda")

        def form(i, y=y, addr=addr, s64=s64):
            def run():
                rc = lib.probe_run(i, addr, s64.vals.data_ptr(),
                                   v64.data_ptr(), y.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"form {i}: cudaError {rc}")
                return y
            return run

        cases = {
            "package K1 float64": lambda sp64=sp64: pt.csr_smvm_segtile(
                a64, v64, sp64),
            "package K1-mxu float64": lambda sp64=sp64: pt.csr_smvm_segtile(
                a64, v64, sp64, reduce="mxu"),
            "package K1 float32": lambda sp=sp: pt.csr_smvm_segtile(a, v, sp),
            "CSR @ v float64": lambda: csr @ v64,
        }
        for i in range(lib.probe_count()):
            name = lib.probe_name(i).decode()
            cases[name] = form(i)
            if tag == "rows 8":
                at = (ctypes.c_int * 3)()
                if lib.probe_attr(i, at):
                    raise RuntimeError(f"form {i}: attributes")
                out["forms"][name] = dict(registers=at[0],
                                          local_bytes=at[1],
                                          blocks_per_sm=at[2])
            y.fill_(float("nan"))
            y1, y2 = form(i)().clone(), form(i)().clone()
            torch.cuda.synchronize()
            over = float(((y1 - ref).abs() - 1e-12 * mag).max())
            if not torch.equal(y1, y2) or not over <= 0:
                raise AssertionError(f"{tag} {name}: not bitwise repeatable "
                                     f"or off the package's K1 by {over}")
            print(f"   {tag} {name}: {out['forms'][name]}, bitwise equal to "
                  f"the package's K1: {torch.equal(y1, ref)}", flush=True)
        ms = out["ms"][tag] = {}
        for _ in range(2):
            for name, fn in cases.items():
                ms.setdefault(name, []).append(cs.pipelined_ms(fn)[0])
        for name, t in ms.items():
            print(f"   {tag} {name}: {t[0]:.4f} / {t[1]:.4f} ms back to back "
                  f"[{card}]", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
