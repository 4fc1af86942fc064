// K2: block-granule (2x2 BSR) segment-tile SpMV on Hopper.
//
// Replaces the TPU kernel
// sparse_tpu/ops/pallas_csr_block.py::bsr_smvm_segtile_block (def :229,
// pallas_call :309, kernel :259).  One slot holds a whole 2x2 block: four
// value planes share one int8 window pointer.  For tile t, row r, lane l,
// with block column c = (seg_of[t] + q[t,r,l])*128 + l:
//   y[2*(rb[t]*8 + r) + 0] += vals[t,0,r,l]*v[2c] + vals[t,1,r,l]*v[2c+1]
//   y[2*(rb[t]*8 + r) + 1] += vals[t,2,r,l]*v[2c] + vals[t,3,r,l]*v[2c+1]
// Block columns at or past nb read 0 (the TPU kernel's zero guard rows).
// The operand is indexed directly (v[2c+i]); the TPU kernel's interleaved
// operand planes with guard rows are not needed here.
//
// What bounds it on this card: the slot stream, 17 bytes per slot in
// float32 (four 4-byte values + one 1-byte pointer; 33 in float64), against
// 3.35 TB/s of HBM.  The operand (3.2 MB for 400k float64 rows) stays in
// the 50 MB L2.
//
// What the design does about it: the K1 shape (segtile_csr.cu) with four
// value planes — one block per tile, one warp per tile row, 16-byte
// evict-first loads of each plane, the shared pointer loaded once and the
// two operand values of a block column gathered once for all four planes;
// then the deterministic pass 2 of segtile_common.cuh with two components
// per row.

#include "segtile_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    segtile_block_rows(const T* __restrict__ vals,
                       const signed char* __restrict__ q,
                       const int* __restrict__ seg_of,
                       const T* __restrict__ v, long long nb,
                       T* __restrict__ partial) {
  const long long t = blockIdx.x;
  const int r = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  constexpr long long kPlane = static_cast<long long>(kRows) * kLanes;
  // vals (n_tiles, 4, 8, 128): element (t, p, r, l) at ((t*4+p)*8+r)*128+l
  const T* base = vals + (t * 4 * kRows + r) * kLanes + lane * 4;
  T a0[4], a1[4], a2[4], a3[4];
  load4_stream(base, a0);
  load4_stream(base + kPlane, a1);
  load4_stream(base + 2 * kPlane, a2);
  load4_stream(base + 3 * kPlane, a3);
  const char4 qq = load_q4(q + (t * kRows + r) * kLanes + lane * 4);
  const int qs[4] = {qq.x, qq.y, qq.z, qq.w};
  const long long col0 =
      static_cast<long long>(__ldg(seg_of + t)) * kLanes + lane * 4;
  T acc0 = T(0), acc1 = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long c = col0 + static_cast<long long>(qs[j]) * kLanes + j;
    T x0 = T(0), x1 = T(0);
    if (c >= 0 && c < nb) {
      x0 = __ldg(v + 2 * c);
      x1 = __ldg(v + 2 * c + 1);
    }
    acc0 += a0[j] * x0 + a1[j] * x1;
    acc1 += a2[j] * x0 + a3[j] * x1;
  }
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
  if (lane == 0) {
    partial[(t * kRows + r) * 2] = acc0;
    partial[(t * kRows + r) * 2 + 1] = acc1;
  }
}

template <typename T>
cudaError_t segtile_block(const void* vals, const void* q,
                          const void* seg_of, const void* order,
                          const void* tile_ptr, const void* v, void* partial,
                          void* y, long long n_tiles, long long nb,
                          long long nbRb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    segtile_block_rows<T><<<static_cast<unsigned>(n_tiles), kTileThreads, 0,
                            s>>>(
        static_cast<const T*>(vals), static_cast<const signed char*>(q),
        static_cast<const int*>(seg_of), static_cast<const T*>(v), nb,
        static_cast<T*>(partial));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_rowblock_sum<T, 2>(
      static_cast<const T*>(partial), static_cast<const int*>(order),
      static_cast<const int*>(tile_ptr), nbRb, static_cast<T*>(y), s);
}

}  // namespace

extern "C" {

// vals (n_tiles, 4, 8, 128), q int8 (n_tiles, 8, 128), seg_of int32,
// order/tile_ptr as in segtile_csr.cu, v (2*nb), partial scratch
// (n_tiles * 16), y (nbRb * 16) with y[2*row + i].  Returns
// cudaGetLastError().
int segtile_block_f32(const void* vals, const void* q, const void* seg_of,
                      const void* order, const void* tile_ptr,
                      const void* v, void* partial, void* y,
                      long long n_tiles, long long nb, long long nbRb,
                      void* stream) {
  return static_cast<int>(segtile_block<float>(vals, q, seg_of, order,
                                               tile_ptr, v, partial, y,
                                               n_tiles, nb, nbRb, stream));
}

int segtile_block_f64(const void* vals, const void* q, const void* seg_of,
                      const void* order, const void* tile_ptr,
                      const void* v, void* partial, void* y,
                      long long n_tiles, long long nb, long long nbRb,
                      void* stream) {
  return static_cast<int>(segtile_block<double>(vals, q, seg_of, order,
                                                tile_ptr, v, partial, y,
                                                n_tiles, nb, nbRb, stream));
}

}  // extern "C"
