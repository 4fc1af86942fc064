"""Time 16-byte shared-memory loads (LDS.128) under the address patterns the
band and wide bodies' register maps issue, to count what each costs.

    python3 tools/lds_probe.py

Builds a small CUDA kernel with ``nvcc`` (sm_90a) into the ignored
``sparse_tpu_torch/_build/lds_probe/`` and, for each pattern, times 32 warps
an SM issuing back-to-back LDS.128 from one address a lane (CUDA events,
median of 5 launches).  Prints the card's name and power limit and one JSON
line: each pattern's ns per warp-wide LDS.128 per SM and its ratio to a
warp-wide broadcast.  Lane l, g = l % 8, h = l / 8:

- ``broadcast``: every lane one address (the band body's A fragments);
- ``32 chunks``: 16 l, 512 distinct bytes (the band body's B fragments);
- ``8 rows, swizzled``: row g's chunk g (128 g + 16 g), the same eight in
  every quarter warp (a 4 x 8 or 8 x 8 map's A fragments);
- ``one chunk a quarter``: 16 h, quarters differ (its B fragments);
- ``8 rows, unswizzled``: 128 g, eight rows in one bank group.

Then it counts each register map's shared-memory cycles per 32 FFMA
instructions of a warp from those costs, a broadcast taken as 2 cycles
(``MAPS``: the LDS.128 of each pattern a thread issues per 4 contraction
indices, and the multiply-adds they feed).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BUILD = HERE / "sparse_tpu_torch" / "_build" / "lds_probe"

PATTERNS = ["broadcast", "32 chunks", "8 rows, swizzled",
            "one chunk a quarter", "8 rows, unswizzled"]

# map -> ({pattern: LDS.128 a thread per 4 indices}, multiply-adds a thread
# per 4 indices): the band body's 8 x 4 (A broadcast, B 32 chunks); the
# wide body's 8 x 8, which tools/pair_body.cuh's pair body also takes
# (rows 8 apart on a swizzled A, two B chunks an index); the pair body's
# half-warps 4 x 16 (four B chunks an index)
MAPS = {"8x4 band body": ({"broadcast": 8, "32 chunks": 4}, 128),
        "8x8 wide / pair body": ({"8 rows, swizzled": 8,
                                  "one chunk a quarter": 8}, 256),
        "4x16 half-warps": ({"8 rows, swizzled": 4,
                             "one chunk a quarter": 16}, 256)}

SOURCE = r"""
#include <cuda_runtime.h>

// volatile: the assembler may neither merge nor drop repeated loads
__device__ __forceinline__ uint4 lds128(unsigned a) {
  uint4 v;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ unsigned offset(int pattern, int lane) {
  const unsigned g = lane % 8, h = lane / 8;
  switch (pattern) {
    case 0: return 0;
    case 1: return 16 * lane;
    case 2: return 128 * g + 16 * g;
    case 3: return 16 * h;
    default: return 128 * g;
  }
}

__global__ void probe(int pattern, int iters, unsigned* sink) {
  __shared__ __align__(16) unsigned buf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) buf[i] = i * 2654435761u;
  __syncthreads();
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(buf)) +
                     offset(pattern, threadIdx.x % 32);
  unsigned x[4] = {0, 0, 0, 0};  // four independent sums
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const uint4 v = lds128(a + ((u & 1) << 11));  // two 2 KB halves
      x[u % 4] += v.x;
    }
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x[0] ^ x[1] ^ x[2] ^ x[3];
}

extern "C" int lds_probe(int pattern, int iters, int blocks, int threads,
                         unsigned* sink) {
  probe<<<blocks, threads>>>(pattern, iters, sink);
  return static_cast<int>(cudaGetLastError());
}
"""


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(HERE))
    from sparse_tpu_torch import _kernels

    nvcc = _kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("lds_probe: no nvcc")
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "lds_probe.cu", BUILD / "lds_probe.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lds_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = build()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    threads, per_sm, iters = 256, 4, 4096  # 32 warps an SM
    blocks = n_sm * per_sm
    sink = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    warp_loads_per_sm = per_sm * threads // 32 * iters * 16
    out = {}
    for p, name in enumerate(PATTERNS):
        def run():
            rc = lib.lds_probe(p, iters, blocks, threads,
                               ctypes.c_void_p(sink.data_ptr()))
            if rc:
                raise RuntimeError(f"lds_probe: CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        out[name] = {"ms": ms, "ns_per_warp_lds_per_sm":
                     ms * 1e6 / warp_loads_per_sm}
    base = out["broadcast"]["ns_per_warp_lds_per_sm"]
    for name in PATTERNS:
        r = out[name]
        r["vs_broadcast"] = r["ns_per_warp_lds_per_sm"] / base
        print(f"   {name:20s}: {r['ms']:.4f} ms, "
              f"{r['ns_per_warp_lds_per_sm']:.4f} ns a warp LDS.128 an SM, "
              f"{r['vs_broadcast']:.2f}x the broadcast [{card}]", flush=True)
    maps = {}
    for name, (loads, fma) in MAPS.items():
        cycles = sum(n * 2 * out[p]["vs_broadcast"] for p, n in loads.items())
        maps[name] = cycles * 32 / fma
        print(f"   {name:20s}: {maps[name]:.2f} shared-memory cycles per 32 "
              f"FFMA of a warp [{card}]", flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card, "sm_clock_after": clock.strip(),
                      "patterns": out, "maps": maps}), flush=True)


if __name__ == "__main__":
    main()
