// K1-mxu: segment-tile CSR SpMV with the row sums on the tensor cores, over
// the plan's compact stream.
//
// Replaces the TPU kernel sparse_tpu/ops/pallas_csr.py::segtile_apply with
// reduce="mxu" (body kernel_mxu :565-595, pallas_call :618), at tile heights
// 8 and 32.  The TPU kernel wrote each grid step's products to a VMEM
// scratch and reduced every tile row's 128 lanes with one matrix-unit
// product against an all-ones (128, 8) matrix at Precision.HIGHEST.  The sum
// is K1's, y[r] = sum of vals[i] * v[cols[i]] over row r's stored entries,
// read from the same compact stream (segtile_csr.cu).
//
// What bounds it on this card: the stream, as K1 (8 bytes per stored entry
// in float32, 12 in float64, 6 in bf16, against 3.35 TB/s); the reduction moves no
// device memory, but every product makes a shared-memory round trip where
// K1 keeps it in registers.
//
// What the design does:
//  * one warp per strip of S rows (S = 16 in float32, 8 in float64): for
//    each chunk of 32 entries of every row of the strip (the strip's longest
//    row sets the chunk count), lane l gathers and multiplies entry l of each
//    row (coalesced evict-first stream loads, __ldg operand gathers) and
//    stores the product in shared memory, zeros past the row's end;
//  * the warp then sums the staged S x 32 products with nvcuda::wmma against
//    an all-ones B fragment.  Float32: m16n16k8 TF32 products, each product
//    split into hi = tf32(p) and lo = tf32(p - hi), both multiplied into one
//    float32 accumulator, so the sum keeps float32 accuracy (ones are exact
//    in TF32).  bf16: values and operand widened exactly to float32, whose
//    product is exact, then the float32 kind's strip, y rounded once to
//    bf16.  Float64: m8n8k4 double products (DMMA).  int32 runs K1's
//    kernel (segtile_csr.cu): sm_90's tensor cores take no 32-bit integer
//    operands, and a sum modulo 2^32 is one result whichever unit adds it.  Column 0 of the
//    accumulator is the row sums, each written once to y: one pass, no
//    partials, no atomics;
//  * long rows: the pieces of segtile_common.cuh, each a strip of S pieces
//    of piece / S entries summed the same way, its S sums added in order by
//    lane 0; the pieces' sums are added in order per row.

#include <mma.h>

#include "segtile_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kChunk = 32;       // entries of a strip row per chunk
constexpr int kLd = kChunk + 4;  // shared-memory row stride in elements

template <typename T>
struct Mma;

// Float32: 16-row strips, TF32 hi + lo into one float32 accumulator.
template <>
struct Mma<float> {
  static constexpr int kRows = 16;
  wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                 wmma::row_major>
      ones;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc;

  __device__ Mma() {
    wmma::fill_fragment(ones, wmma::__float_to_tf32(1.0f));
    wmma::fill_fragment(acc, 0.0f);
  }

  __device__ void add(const float* tile) {
#pragma unroll
    for (int k = 0; k < kChunk; k += 8) {
      wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                     wmma::row_major>
          hi, lo;
      wmma::load_matrix_sync(hi, tile + k, kLd);
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
  }

  __device__ void store(float* tile) {
    wmma::store_matrix_sync(tile, acc, kLd, wmma::mem_row_major);
  }
};

// Float64: 8-row strips, m8n8k4 DMMA.
template <>
struct Mma<double> {
  static constexpr int kRows = 8;
  wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::row_major> ones;
  wmma::fragment<wmma::accumulator, 8, 8, 4, double> acc;

  __device__ Mma() {
    wmma::fill_fragment(ones, 1.0);
    wmma::fill_fragment(acc, 0.0);
  }

  __device__ void add(const double* tile) {
#pragma unroll
    for (int k = 0; k < kChunk; k += 4) {
      wmma::fragment<wmma::matrix_a, 8, 8, 4, double, wmma::row_major> a;
      wmma::load_matrix_sync(a, tile + k, kLd);
      wmma::mma_sync(acc, a, ones, acc);
    }
  }

  __device__ void store(double* tile) {
    wmma::store_matrix_sync(tile, acc, kLd, wmma::mem_row_major);
  }
};

// Per value type V: T, the type of the products, the staged tile and the
// sums (partial too); Out, y's; product(vals, cols, v, i), stream entry i's
// product.  float32 and float64 in their own type; bf16 widened exactly to
// float32, where a product of two bf16 values is exact, so the float32
// kind's TF32 hi + lo lane sum applies unchanged, then y is rounded once.
template <typename V>
struct Val {
  using T = V;
  using Out = V;
  __device__ static __forceinline__ T product(const V* vals, const int* cols,
                                              const V* v, long long i) {
    return __ldcs(vals + i) * __ldg(v + __ldcs(cols + i));
  }
};
template <>
struct Val<__nv_bfloat16> {
  using T = float;
  using Out = __nv_bfloat16;
  __device__ static __forceinline__ float product(const __nv_bfloat16* vals,
                                                  const int* cols,
                                                  const __nv_bfloat16* v,
                                                  long long i) {
    const unsigned a =
        __ldcs(reinterpret_cast<const unsigned short*>(vals) + i);
    return __uint_as_float(a << 16) *
           Widen<__nv_bfloat16>::gather(v, __ldcs(cols + i));
  }
};

// Lane i < S holds strip row i's entry range [s, e).  On return
// tile[i * kLd] is row i's sum (every lane of the warp takes part).
template <typename V, typename T = typename Val<V>::T>
__device__ __forceinline__ void strip_sums(const V* __restrict__ vals,
                                           const int* __restrict__ cols,
                                           const V* __restrict__ v,
                                           long long s, long long e,
                                           T* tile) {
  constexpr int S = Mma<T>::kRows;
  const int lane = threadIdx.x % kWarp;
  const int n_chunks = __reduce_max_sync(
      0xffffffffu, static_cast<int>((e - s + kChunk - 1) / kChunk));
  Mma<T> mma;
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const long long idx =
          __shfl_sync(0xffffffffu, s, i) + c * kChunk + lane;
      T p = T(0);
      if (idx < __shfl_sync(0xffffffffu, e, i))
        p = Val<V>::product(vals, cols, v, idx);
      tile[i * kLd + lane] = p;
    }
    __syncwarp();
    mma.add(tile);
    __syncwarp();
  }
  mma.store(tile);
  __syncwarp();
}

// Blocks [0, n_strip_blocks) take the short rows, one strip a warp; the
// blocks after them take the pieces.
template <typename V, typename T = typename Val<V>::T,
          typename Out = typename Val<V>::Out>
__global__ void __launch_bounds__(kThreads)
    segtile_mxu_rows(const V* __restrict__ vals, const int* __restrict__ cols,
                     const V* __restrict__ v, Rows rows,
                     long long n_strip_blocks, T* __restrict__ partial,
                     Out* __restrict__ y) {
  constexpr int S = Mma<T>::kRows;
  __shared__ __align__(32) T tiles[kWarps * S * kLd];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  T* tile = tiles + w * S * kLd;
  long long s = 0, e = 0;
  if (blockIdx.x < n_strip_blocks) {
    const long long r =
        (static_cast<long long>(blockIdx.x) * kWarps + w) * S + lane;
    bool mine = false;
    if (lane < S && r < rows.n_rows) {
      s = __ldg(rows.row_ptr + r);
      e = __ldg(rows.row_ptr + r + 1);
      mine = e - s <= rows.long_min;
      if (!mine) e = s;  // a long row: its pieces sum it
    }
    strip_sums(vals, cols, v, s, e, tile);
    if (mine) store_out(y + r, tile[lane * kLd]);
  } else {
    const long long pc =
        (static_cast<long long>(blockIdx.x) - n_strip_blocks) * kWarps + w;
    long long ps, pe;
    piece_range(rows, pc, ps, pe);
    const long long width = rows.piece / S;
    if (lane < S) {
      s = min(ps + lane * width, pe);
      e = min(s + width, pe);
    }
    strip_sums(vals, cols, v, s, e, tile);
    if (lane == 0 && pc < rows.n_pieces) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) acc += tile[i * kLd];
      partial[pc] = acc;
    }
  }
}

template <typename V>
int segtile_mxu_any(const void* vals, const void* cols, const void* row_ptr,
                    const void* long_rows, const void* piece_ptr,
                    const void* piece_row, const void* v, void* partial,
                    void* y, long long n_rows, long long n_long,
                    long long n_pieces, int long_min, int piece,
                    void* stream) {
  using T = typename Val<V>::T;
  using Out = typename Val<V>::Out;
  constexpr int S = Mma<T>::kRows;
  if (piece % (S * kChunk) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{static_cast<const int*>(row_ptr),
                  static_cast<const int*>(long_rows),
                  static_cast<const int*>(piece_ptr),
                  static_cast<const int*>(piece_row), n_rows, n_pieces,
                  long_min, piece};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long strips = (n_rows + S - 1) / S;
  const long long strip_blocks = (strips + kWarps - 1) / kWarps;
  const long long grid = strip_blocks + (n_pieces + kWarps - 1) / kWarps;
  if (grid > 0) {
    segtile_mxu_rows<V><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const V*>(vals), static_cast<const int*>(cols),
        static_cast<const V*>(v), rows, strip_blocks,
        static_cast<T*>(partial), static_cast<Out*>(y));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_long_row_sum<T, 1, Out>(
      static_cast<const T*>(partial), rows, n_long, static_cast<Out*>(y), s));
}

}  // namespace

extern "C" {

// The arguments of segtile_csr_f32/_f64 (segtile_csr.cu) without the lane
// group; piece must be a multiple of 512 entries (256 in float64).
// Returns cudaGetLastError().
int segtile_mxu_f32(const void* vals, const void* cols, const void* row_ptr,
                    const void* long_rows, const void* piece_ptr,
                    const void* piece_row, const void* v, void* partial,
                    void* y, long long n_rows, long long n_long,
                    long long n_pieces, int long_min, int piece,
                    void* stream) {
  return segtile_mxu_any<float>(vals, cols, row_ptr, long_rows, piece_ptr,
                                piece_row, v, partial, y, n_rows, n_long,
                                n_pieces, long_min, piece, stream);
}

int segtile_mxu_f64(const void* vals, const void* cols, const void* row_ptr,
                    const void* long_rows, const void* piece_ptr,
                    const void* piece_row, const void* v, void* partial,
                    void* y, long long n_rows, long long n_long,
                    long long n_pieces, int long_min, int piece,
                    void* stream) {
  return segtile_mxu_any<double>(vals, cols, row_ptr, long_rows, piece_ptr,
                                 piece_row, v, partial, y, n_rows, n_long,
                                 n_pieces, long_min, piece, stream);
}

// bf16: vals, v and y bf16, partial float32 scratch; piece a multiple of
// 512 entries.  (int32 has no kind here: the tensor cores take no 32-bit
// integer operands, and the wrapper launches segtile_csr_i32 instead.)
int segtile_mxu_bf16(const void* vals, const void* cols, const void* row_ptr,
                     const void* long_rows, const void* piece_ptr,
                     const void* piece_row, const void* v, void* partial,
                     void* y, long long n_rows, long long n_long,
                     long long n_pieces, int long_min, int piece,
                     void* stream) {
  return segtile_mxu_any<__nv_bfloat16>(
      vals, cols, row_ptr, long_rows, piece_ptr, piece_row, v, partial, y,
      n_rows, n_long, n_pieces, long_min, piece, stream);
}

}  // extern "C"
