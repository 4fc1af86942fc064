// K4 and K5: banded (consecutive-column) blocked-ELL SpMM on Hopper.
//
// Replaces the TPU kernels in sparse_tpu/ops/pallas_bell.py:
//   K4 bell_spmm_pallas_banded (def :430; super-tile kernel_super :478 /
//      pallas_call :504, per-tile kernel :520 / pallas_call :540): per row
//      tile t, C[t] (rt*bsz, k) = tiles[t] (rt*bsz, W*bsz)
//                                 @ B[start[t]*bsz : +W*bsz] (W*bsz, k);
//   K5 bell_spmm_pallas_banded_t (def :675; super :717 / :746, per-tile
//      :761 / :782): the same product in transposed storage,
//      C^T[:, t*rt*bsz : +rt*bsz] (k, rt*bsz)
//          = B^T[:, start[t]*bsz : +W*bsz] (k, W*bsz) @ tiles_t[t] (W*bsz,
//            rt*bsz),
//      with B^T (k, n) or (k, n_pad) and C^T (k, n_pad).
// Each TPU kernel is a pair of pallas_calls: the super-tile one shares one
// operand window among S row tiles to save DMA.  Since start[t] ==
// sup[t / S] + rel[t] by construction, one kernel that reads start[t]
// computes both; the plan keeps S/SW/rel/sup for parity only.
//
// What bounds it on this card: the densified tiles are mostly zeros
// (W/Lb times the packed blocks), so the work is 2*ntiles*rt*bsz*W*bsz*k
// flops — 49 GFLOP at the bench band (nb 15,625, bsz 32, rt 5, W 12,
// k 128), 2.4x the useful 20.5 GFLOP — against ~1.36 GB of tiles, windows
// and output.  In full float32 on the CUDA cores (67 TFLOP/s on the data
// sheet, no TF32) that is arithmetic-bound: >= 0.73 ms against ~0.41 ms of
// HBM time.  At small k (K5, k = 32) the tiles' bytes dominate instead.
//
// What the design does about it: K4 and K5 are one body with swapped
// strides (bell_common.cuh).  A thread block owns one (row tile, 64-row
// block, 64-column chunk of k) output tile, reads its window straight from
// B at start[t]*bsz (no gathered window in device memory), keeps the sums in
// registers across the whole W*bsz contraction and writes each output once.
// Consecutive thread blocks share one tile, so its bytes are read from HBM
// about once and re-read from L2.  No atomics: bitwise repeatable.

#include "bell_common.cuh"

namespace {

using namespace bell;

constexpr int kTileBM = 64;  // output rows per thread block

// K4: tiles (ntiles, M, K) row-major, b (b_rows, N) row-major, C
// (ntiles*M, N).  M = rt*bsz, K = W*bsz, N = k.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(Shape<kTileBM>::kThreads)
    bell_banded_kernel(const T* __restrict__ tiles,
                       const int* __restrict__ start, const T* __restrict__ b,
                       typename AccOf<T>::type* __restrict__ c, int M, int K,
                       int N, int bsz, long long b_rows) {
  using S = typename AccOf<T>::type;
  __shared__ Smem<S, kTileBM> sm;
  const TilePos p = tile_pos<kTileBM>(M, N);
  const T* a = tiles + p.tile * M * K;
  const long long row0 = static_cast<long long>(__ldg(start + p.tile)) * bsz;
  auto la = [&](int i, int kk) -> S {
    return widen(a[static_cast<long long>(i) * K + kk]);
  };
  auto lb = [&](int kk, int n) -> S {
    const long long row = row0 + kk;
    return row < b_rows ? widen(b[row * N + n]) : S(0);
  };
  S acc[kTM][kTN] = {};
  accumulate<S, SPLIT, kTileBM, true, true>(sm, la, lb, M, N, K, p.m0, p.n0,
                                            acc);
  store<S, kTileBM>(acc, c + p.tile * M * N, N, 1, M, N, p.m0, p.n0);
}

// K5: tiles_t (ntiles, K, M) row-major, bt (N, bt_cols) row-major, C^T
// (N, out_cols) with out_cols = ntiles*M.  Columns of bt at or past bt_cols
// read 0, so an unpadded (k, n) operand needs no padded copy.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(Shape<kTileBM>::kThreads)
    bell_banded_t_kernel(const T* __restrict__ tiles_t,
                         const int* __restrict__ start,
                         const T* __restrict__ bt,
                         typename AccOf<T>::type* __restrict__ ct, int M,
                         int K, int N, int bsz, long long bt_cols,
                         long long out_cols) {
  using S = typename AccOf<T>::type;
  __shared__ Smem<S, kTileBM> sm;
  const TilePos p = tile_pos<kTileBM>(M, N);
  const T* a = tiles_t + p.tile * M * K;
  const long long col0 = static_cast<long long>(__ldg(start + p.tile)) * bsz;
  auto la = [&](int i, int kk) -> S {
    return widen(a[static_cast<long long>(kk) * M + i]);
  };
  auto lb = [&](int kk, int n) -> S {
    const long long col = col0 + kk;
    return col < bt_cols ? widen(bt[n * bt_cols + col]) : S(0);
  };
  S acc[kTM][kTN] = {};
  accumulate<S, SPLIT, kTileBM, false, false>(sm, la, lb, M, N, K, p.m0,
                                              p.n0, acc);
  store<S, kTileBM>(acc, ct + p.tile * M, 1, out_cols, M, N, p.m0, p.n0);
}

template <typename T, bool SPLIT>
cudaError_t launch(bool transposed, const void* tiles, const void* start,
                   const void* b, void* c, long long ntiles, long long M,
                   long long K, long long N, long long bsz, long long b_extent,
                   long long out_cols, void* stream) {
  using S = typename AccOf<T>::type;
  const long long grid = grid_blocks(ntiles, M, N, kTileBM);
  if (grid <= 0) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  constexpr int kThreads = Shape<kTileBM>::kThreads;
  if (transposed) {
    bell_banded_t_kernel<T, SPLIT><<<g, kThreads, 0, s>>>(
        static_cast<const T*>(tiles), static_cast<const int*>(start),
        static_cast<const T*>(b), static_cast<S*>(c), static_cast<int>(M),
        static_cast<int>(K), static_cast<int>(N), static_cast<int>(bsz),
        b_extent, out_cols);
  } else {
    bell_banded_kernel<T, SPLIT><<<g, kThreads, 0, s>>>(
        static_cast<const T*>(tiles), static_cast<const int*>(start),
        static_cast<const T*>(b), static_cast<S*>(c), static_cast<int>(M),
        static_cast<int>(K), static_cast<int>(N), static_cast<int>(bsz),
        b_extent);
  }
  return cudaGetLastError();
}

int dispatch(int kind, bool transposed, const void* tiles, const void* start,
             const void* b, void* c, long long ntiles, long long M,
             long long K, long long N, long long bsz, long long b_extent,
             long long out_cols, void* stream) {
  switch (kind) {
    case kF32:
      return launch<float, false>(transposed, tiles, start, b, c, ntiles, M,
                                  K, N, bsz, b_extent, out_cols, stream);
    case kF32Split:
      return launch<float, true>(transposed, tiles, start, b, c, ntiles, M,
                                 K, N, bsz, b_extent, out_cols, stream);
    case kBF16:
      return launch<__nv_bfloat16, false>(transposed, tiles, start, b, c,
                                          ntiles, M, K, N, bsz, b_extent,
                                          out_cols, stream);
    case kF64:
      return launch<double, false>(transposed, tiles, start, b, c, ntiles, M,
                                   K, N, bsz, b_extent, out_cols, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kind as in bell_spmm.cu.  tiles (ntiles, M, K) and b (b_rows, N) in the
// stream type, start (ntiles,) int32, C (ntiles*M, N) in float32 (float64
// for kind 3).  Returns cudaGetLastError() after the launch.
int bell_banded(int kind, const void* tiles, const void* start,
                const void* b, void* c, long long ntiles, long long M,
                long long K, long long N, long long bsz, long long b_rows,
                void* stream) {
  return dispatch(kind, false, tiles, start, b, c, ntiles, M, K, N, bsz,
                  b_rows, 0, stream);
}

// tiles_t (ntiles, K, M) and bt (N, bt_cols) in the stream type, C^T
// (N, ntiles*M).
int bell_banded_t(int kind, const void* tiles_t, const void* start,
                  const void* bt, void* ct, long long ntiles, long long M,
                  long long K, long long N, long long bsz, long long bt_cols,
                  void* stream) {
  return dispatch(kind, true, tiles_t, start, bt, ct, ntiles, M, K, N, bsz,
                  bt_cols, ntiles * M, stream);
}

}  // extern "C"
