// Shared pieces of the segment-tile SpMV kernels (segtile_csr.cu,
// segtile_block.cu): streamed slot loads, the warp sum, and pass 2 — the
// deterministic per-row-block sum of per-tile partial row sums.
//
// Everything lives in an anonymous namespace so each translation unit keeps
// its own copy of the templates (both are linked into one library).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;     // rows of one warp-row group of a tile
constexpr int kLanes = 128;  // slots per tile row
constexpr int kWarp = 32;
constexpr int kTileThreads = kRows * kWarp;  // one warp per row of a group

// Four consecutive slot values.  The slot stream is read exactly once per
// SpMV, so it is loaded evict-first (__ldcs) to leave the L2 to the
// operand vector.  16-byte loads: the wrapper checks the alignment.
__device__ __forceinline__ void load4_stream(const float* p, float (&a)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  a[0] = t.x;
  a[1] = t.y;
  a[2] = t.z;
  a[3] = t.w;
}

__device__ __forceinline__ void load4_stream(const double* p,
                                             double (&a)[4]) {
  const double2 t0 = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 t1 = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  a[0] = t0.x;
  a[1] = t0.y;
  a[2] = t1.x;
  a[3] = t1.y;
}

// Four int8 window pointers (one 4-byte load).
__device__ __forceinline__ char4 load_q4(const signed char* p) {
  return __ldcs(reinterpret_cast<const char4*>(p));
}

// Butterfly sum over the warp: a fixed order, so the result is bitwise
// repeatable.
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Pass 2.  Output element j = (rb * kRows + r) * C + i (C components per
// row: 1 for scalar CSR, 2 for the 2x2 block kernel) is the sum, over the
// tiles of row block rb in the stable order `order[tile_ptr[rb] ..
// tile_ptr[rb+1])`, of partial[(tile * kRows + r) * C + i].  One thread per
// output element, no atomics: the same order on every run, whatever order
// the plan's tiles come in (padding tiles included).  A 32-row tile's
// partials are C = 4: (rb * 8 + r) * 4 + i = rb * 32 + row.
template <typename T, int C>
__global__ void segtile_rowblock_sum(const T* __restrict__ partial,
                                     const int* __restrict__ order,
                                     const int* __restrict__ tile_ptr,
                                     long long n_out, T* __restrict__ y) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  const long long rb = j / (kRows * C);
  const int within = static_cast<int>(j - rb * (kRows * C));
  const int k1 = tile_ptr[rb + 1];
  T acc = T(0);
  for (int k = tile_ptr[rb]; k < k1; ++k)
    acc += partial[static_cast<long long>(order[k]) * (kRows * C) + within];
  y[j] = acc;
}

template <typename T, int C>
cudaError_t launch_rowblock_sum(const T* partial, const int* order,
                                const int* tile_ptr, long long n_row_blocks,
                                T* y, cudaStream_t stream) {
  const long long n_out = n_row_blocks * kRows * C;
  if (n_out > 0) {
    const int threads = 256;
    const long long blocks = (n_out + threads - 1) / threads;
    segtile_rowblock_sum<T, C><<<static_cast<unsigned>(blocks), threads, 0,
                                 stream>>>(partial, order, tile_ptr, n_out,
                                           y);
  }
  return cudaGetLastError();
}

}  // namespace
