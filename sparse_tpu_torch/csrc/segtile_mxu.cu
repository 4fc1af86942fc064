// K1-mxu: segment-tile CSR SpMV with the lane sums on the tensor cores.
//
// Replaces the TPU kernel sparse_tpu/ops/pallas_csr.py::segtile_apply with
// reduce="mxu" (body kernel_mxu :565-595, pallas_call :618), at tile
// heights R = 8 and 32.  The TPU kernel wrote each grid step's products to
// a VMEM scratch and reduced every tile's 128 lanes with one matrix-unit
// product against an all-ones (128, 8) matrix at Precision.HIGHEST.  The sum
// is K1's: for tile t, row r, lane l,
//   y[rb[t]*R + r] += vals[t,r,l] * v[(seg_of[t] + q[t,r,l])*128 + l],
// with columns at or past m reading 0.
//
// What bounds it on this card: the slot stream, as K1 (5 bytes per slot in
// float32, 9 in float64, against 3.35 TB/s); the reduction moves no device
// memory, but it costs a shared-memory round trip of every product where K1
// keeps them in registers and sums them with warp shuffles.
//
// What the design does:
//  * phase 1: a 256-thread block takes G = 64 / R tiles (64 product rows);
//    each warp gathers and multiplies 8 rows as K1 does (16-byte evict-first
//    slot loads, __ldg operand gathers) and stores the products in dynamic
//    shared memory (rows padded to 132 elements);
//  * phase 2: warps reduce strips of rows with nvcuda::wmma against an
//    all-ones B fragment.  Float32: 16-row strips in m16n16k8 TF32 products,
//    each product split into hi = tf32(p) and lo = tf32(p - hi), both
//    multiplied into one float32 accumulator, so the sum keeps float32
//    accuracy (the repository's "float32 means full float32"; ones are exact
//    in TF32).  Float64: 8-row strips in m8n8k4 double products (DMMA),
//    exact as an FMA chain.  Column 0 of the accumulator is the row sums,
//    written to partial[t*R + r];
//  * pass 2 (segtile_common.cuh) as K1: each row block's partials summed in
//    a stable tile order, no atomics, bitwise repeatable.

#include <mma.h>

#include "segtile_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBlockRows = 64;   // product rows per thread block (G * R)
constexpr int kLd = kLanes + 4;  // shared-memory row stride in elements

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&x)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
}

// Phase 1: product row rr of the block (tile t0 + rr / R, row rr % R) into
// prod[rr * kLd + lane], zeros for rows past the last tile.
template <typename T, int R>
__device__ __forceinline__ void products(const T* __restrict__ vals,
                                         const signed char* __restrict__ q,
                                         const int* __restrict__ seg_of,
                                         const T* __restrict__ v, long long m,
                                         long long n_tiles, long long t0,
                                         T* prod) {
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int i = 0; i < kBlockRows / kRows; ++i) {
    const int rr = i * kRows + w;
    const long long t = t0 + rr / R;
    T p[4] = {T(0), T(0), T(0), T(0)};
    if (t < n_tiles) {
      const long long slot = (t * R + rr % R) * kLanes + lane * 4;
      T a[4];
      load4_stream(vals + slot, a);
      const char4 qq = load_q4(q + slot);
      const int qs[4] = {qq.x, qq.y, qq.z, qq.w};
      const long long col0 =
          static_cast<long long>(__ldg(seg_of + t)) * kLanes + lane * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long c = col0 + static_cast<long long>(qs[j]) * kLanes + j;
        p[j] = a[j] * ((c >= 0 && c < m) ? __ldg(v + c) : T(0));
      }
    }
    store4(prod + rr * kLd + lane * 4, p);
  }
}

// Phase 2, float32: warp w < 4 sums rows [16w, 16w + 16) of `prod` into
// column 0 of its strip; returns the strip's row count (0: idle warp).
__device__ __forceinline__ int strip_sums(float* prod) {
  constexpr int kStrip = 16;
  const int w = threadIdx.x / kWarp;
  if (w >= kBlockRows / kStrip) return 0;
  float* strip = prod + w * kStrip * kLd;
  wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                 wmma::row_major>
      ones;
  wmma::fill_fragment(ones, wmma::__float_to_tf32(1.0f));
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
  for (int k = 0; k < kLanes; k += 8) {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                   wmma::row_major>
        hi, lo;
    wmma::load_matrix_sync(hi, strip + k, kLd);
#pragma unroll
    for (int e = 0; e < hi.num_elements; ++e) {
      const float x = hi.x[e];
      const float h = wmma::__float_to_tf32(x);
      hi.x[e] = h;
      lo.x[e] = wmma::__float_to_tf32(x - h);
    }
    wmma::mma_sync(acc, hi, ones, acc);
    wmma::mma_sync(acc, lo, ones, acc);
  }
  __syncwarp();
  wmma::store_matrix_sync(strip, acc, kLd, wmma::mem_row_major);
  __syncwarp();
  return kStrip;
}

// Phase 2, float64: warp w sums rows [8w, 8w + 8) exactly (m8n8k4 DMMA).
__device__ __forceinline__ int strip_sums(double* prod) {
  constexpr int kStrip = 8;
  const int w = threadIdx.x / kWarp;
  double* strip = prod + w * kStrip * kLd;
  wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::row_major> ones;
  wmma::fill_fragment(ones, 1.0);
  wmma::fragment<wmma::accumulator, 8, 8, 4, double> acc;
  wmma::fill_fragment(acc, 0.0);
#pragma unroll 4
  for (int k = 0; k < kLanes; k += 4) {
    wmma::fragment<wmma::matrix_a, 8, 8, 4, double, wmma::row_major> a;
    wmma::load_matrix_sync(a, strip + k, kLd);
    wmma::mma_sync(acc, a, ones, acc);
  }
  __syncwarp();
  wmma::store_matrix_sync(strip, acc, kLd, wmma::mem_row_major);
  __syncwarp();
  return kStrip;
}

template <typename T, int R>
__global__ void __launch_bounds__(kTileThreads)
    segtile_mxu_rows(const T* __restrict__ vals,
                     const signed char* __restrict__ q,
                     const int* __restrict__ seg_of,
                     const T* __restrict__ v, long long m, long long n_tiles,
                     T* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* prod = reinterpret_cast<T*>(smem);
  constexpr int G = kBlockRows / R;
  const long long t0 = static_cast<long long>(blockIdx.x) * G;
  products<T, R>(vals, q, seg_of, v, m, n_tiles, t0, prod);
  __syncthreads();
  const int strip = strip_sums(prod);
  const int lane = threadIdx.x % kWarp;
  if (lane < strip) {
    const int rr = (threadIdx.x / kWarp) * strip + lane;
    const long long t = t0 + rr / R;
    if (t < n_tiles) partial[t * R + rr % R] = prod[rr * kLd];
  }
}

template <typename T, int R>
cudaError_t segtile_mxu(const void* vals, const void* q, const void* seg_of,
                        const void* order, const void* tile_ptr,
                        const void* v, void* partial, void* y,
                        long long n_tiles, long long m, long long nbR,
                        cudaStream_t s) {
  if (n_tiles > 0) {
    constexpr int G = kBlockRows / R;
    const int smem = kBlockRows * kLd * static_cast<int>(sizeof(T));
    cudaError_t e = cudaFuncSetAttribute(
        segtile_mxu_rows<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    const long long grid = (n_tiles + G - 1) / G;
    segtile_mxu_rows<T, R><<<static_cast<unsigned>(grid), kTileThreads, smem,
                             s>>>(
        static_cast<const T*>(vals), static_cast<const signed char*>(q),
        static_cast<const int*>(seg_of), static_cast<const T*>(v), m,
        n_tiles, static_cast<T*>(partial));
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_rowblock_sum<T, R / kRows>(
      static_cast<const T*>(partial), static_cast<const int*>(order),
      static_cast<const int*>(tile_ptr), nbR, static_cast<T*>(y), s);
}

template <typename T>
int segtile_mxu_any(const void* vals, const void* q, const void* seg_of,
                    const void* order, const void* tile_ptr, const void* v,
                    void* partial, void* y, long long n_tiles, long long m,
                    long long nbR, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8:
      return static_cast<int>(segtile_mxu<T, 8>(
          vals, q, seg_of, order, tile_ptr, v, partial, y, n_tiles, m, nbR,
          s));
    case 32:
      return static_cast<int>(segtile_mxu<T, 32>(
          vals, q, seg_of, order, tile_ptr, v, partial, y, n_tiles, m, nbR,
          s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The arguments of segtile_csr_f32/_f64 (segtile_csr.cu).  Returns
// cudaGetLastError().
int segtile_mxu_f32(const void* vals, const void* q, const void* seg_of,
                    const void* order, const void* tile_ptr, const void* v,
                    void* partial, void* y, long long n_tiles, long long m,
                    long long nbR, int rows, void* stream) {
  return segtile_mxu_any<float>(vals, q, seg_of, order, tile_ptr, v, partial,
                                y, n_tiles, m, nbR, rows, stream);
}

int segtile_mxu_f64(const void* vals, const void* q, const void* seg_of,
                    const void* order, const void* tile_ptr, const void* v,
                    void* partial, void* y, long long n_tiles, long long m,
                    long long nbR, int rows, void* stream) {
  return segtile_mxu_any<double>(vals, q, seg_of, order, tile_ptr, v,
                                 partial, y, n_tiles, m, nbR, rows, stream);
}

}  // extern "C"
