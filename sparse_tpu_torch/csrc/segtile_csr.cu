// K1 and K1-r32: scalar segment-tile CSR SpMV on Hopper.
//
// Replaces the TPU kernel sparse_tpu/ops/pallas_csr.py::segtile_apply
// (def :492, pallas_call :618, body kernel_vpu :531), at both tile heights
// R of the plan: 8 (K1) and 32 (K1-r32, the loop over 4 row groups at :550).
// It computes the same sum over the same plan arrays: for tile t, row r,
// lane l,
//   y[rb[t]*R + r] += vals[t,r,l] * v[(seg_of[t] + q[t,r,l])*128 + l],
// with columns at or past m reading 0 (the TPU kernel's zero guard rows).
//
// What bounds it on this card: the slot stream.  Every slot of every tile is
// read once, 5 bytes per slot in float32 (4-byte value + 1-byte int8 window
// pointer; 9 in float64), against 3.35 TB/s of HBM; padding slots cost the
// same as full ones, so the plan's fill sets the nnz rate (32-row tiles fill
// worse: one window serves rows that span more columns).  The operand (2 MB
// at 500k float32 columns) and the per-tile partial sums fit the 50 MB L2.
//
// What the design does about it:
//  * pass 1: one 256-thread block per tile, one warp per row of each 8-row
//    group (R / 8 groups, unrolled, so a warp has R / 8 independent loads in
//    flight); each thread takes 4 lanes with one 16-byte value load and one
//    4-byte pointer load, both evict-first (__ldcs) so the stream does not
//    push the operand out of L2; operand gathers go through the read-only
//    path (__ldg); the warp reduces its 128 products with a butterfly
//    (__shfl_xor_sync) and writes one partial sum per (tile, row).  The
//    TPU kernel shared one window slice among the 4 groups of a 32-row tile;
//    here the window is simply L2-resident gathers;
//  * pass 2 (segtile_common.cuh): the partials of each row block are summed
//    in a stable tile order computed by the wrapper, one thread per output
//    row, without atomics — bitwise repeatable, and right for any order of
//    the plan's tiles (kstep padding tiles and per-shard plans included).
// The TPU-specific plan padding (kstep, SMEM chunks) is consumed as is.

#include "segtile_common.cuh"

namespace {

template <typename T, int R>
__global__ void __launch_bounds__(kTileThreads)
    segtile_csr_rows(const T* __restrict__ vals,
                     const signed char* __restrict__ q,
                     const int* __restrict__ seg_of,
                     const T* __restrict__ v, long long m,
                     T* __restrict__ partial) {
  const long long t = blockIdx.x;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long col0 =
      static_cast<long long>(__ldg(seg_of + t)) * kLanes + lane * 4;
#pragma unroll
  for (int g = 0; g < R / kRows; ++g) {
    const int r = g * kRows + w;
    const long long slot = (t * R + r) * kLanes + lane * 4;
    T a[4];
    load4_stream(vals + slot, a);
    const char4 qq = load_q4(q + slot);
    const int qs[4] = {qq.x, qq.y, qq.z, qq.w};
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = col0 + static_cast<long long>(qs[j]) * kLanes + j;
      const T x = (c >= 0 && c < m) ? __ldg(v + c) : T(0);
      acc += a[j] * x;
    }
    acc = warp_sum(acc);
    if (lane == 0) partial[t * R + r] = acc;
  }
}

template <typename T, int R>
cudaError_t segtile_csr(const void* vals, const void* q, const void* seg_of,
                        const void* order, const void* tile_ptr,
                        const void* v, void* partial, void* y,
                        long long n_tiles, long long m, long long nbR,
                        cudaStream_t s) {
  if (n_tiles > 0) {
    segtile_csr_rows<T, R><<<static_cast<unsigned>(n_tiles), kTileThreads, 0,
                             s>>>(
        static_cast<const T*>(vals), static_cast<const signed char*>(q),
        static_cast<const int*>(seg_of), static_cast<const T*>(v), m,
        static_cast<T*>(partial));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_rowblock_sum<T, R / kRows>(
      static_cast<const T*>(partial), static_cast<const int*>(order),
      static_cast<const int*>(tile_ptr), nbR, static_cast<T*>(y), s);
}

template <typename T>
int segtile_csr_any(const void* vals, const void* q, const void* seg_of,
                    const void* order, const void* tile_ptr, const void* v,
                    void* partial, void* y, long long n_tiles, long long m,
                    long long nbR, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8:
      return static_cast<int>(segtile_csr<T, 8>(
          vals, q, seg_of, order, tile_ptr, v, partial, y, n_tiles, m, nbR,
          s));
    case 32:
      return static_cast<int>(segtile_csr<T, 32>(
          vals, q, seg_of, order, tile_ptr, v, partial, y, n_tiles, m, nbR,
          s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// vals (n_tiles, rows, 128), q int8 (n_tiles, rows, 128), seg_of int32
// (n_tiles), order int32 (n_tiles): tiles stably sorted by row block,
// tile_ptr int32 (nbR + 1): each row block's range in `order`, v (m),
// partial scratch (n_tiles * rows), y (nbR * rows); rows is 8 or 32.
// Returns cudaGetLastError().
int segtile_csr_f32(const void* vals, const void* q, const void* seg_of,
                    const void* order, const void* tile_ptr, const void* v,
                    void* partial, void* y, long long n_tiles, long long m,
                    long long nbR, int rows, void* stream) {
  return segtile_csr_any<float>(vals, q, seg_of, order, tile_ptr, v, partial,
                                y, n_tiles, m, nbR, rows, stream);
}

int segtile_csr_f64(const void* vals, const void* q, const void* seg_of,
                    const void* order, const void* tile_ptr, const void* v,
                    void* partial, void* y, long long n_tiles, long long m,
                    long long nbR, int rows, void* stream) {
  return segtile_csr_any<double>(vals, q, seg_of, order, tile_ptr, v,
                                 partial, y, n_tiles, m, nbR, rows, stream);
}

}  // extern "C"
