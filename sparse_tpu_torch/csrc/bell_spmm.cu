// K3 and K6: blocked-ELL SpMM, C[n, k] = A @ B, on Hopper.
//
// Replaces the TPU kernels in sparse_tpu/ops/pallas_bell.py:
//   K3 bell_spmm_pallas_fused (def :141, pallas_call :205): per block row r,
//      C[r] (bsz, k) = [A_r0 | ... | A_r,Lb-1] (bsz, Lb*bsz) @ the stacked
//      panels B[cols[r, l]] (Lb*bsz, k) — one wide contraction;
//   K6 bell_spmm_pallas (def :58, pallas_call :89, kernel :41): one step per
//      stored block, C[r] += A[r, l] (bsz, bsz) @ B[cols[r, l]] (bsz, k).
// blocks (nb, Lb, bsz, bsz), cols (nb, Lb) int32 (padding slots hold zero
// blocks), b (nb*bsz, k) and C (nb*bsz, k) row-major.
//
// What bounds it on this card: at bsz = 32, k = 128 each stored block costs
// 2*32*32*128 flops against 4 KB of block and one 16 KB operand panel (the
// panels of a band are shared by neighbouring rows and mostly hit the 50 MB
// L2), so the float32 form runs on the CUDA cores (67 TFLOP/s on the data
// sheet; full float32 is the contract, no TF32) — arithmetic-bound, not
// stream-bound.
//
// What the design does about it: the TPU's DMA gathers become loads of the
// block's panel rows inside the kernel (no gathered intermediate in device
// memory, as on the TPU).  One thread block owns one (block row, 64-column
// chunk of k) and keeps its output in registers (4 x 4 per thread) across
// the whole contraction: K3 stages the wide row in chunks of 16 contraction
// indices that run across block boundaries, K6 walks the Lb stored blocks
// one at a time.  No atomics, so the two runs of one input agree bitwise.
// Measured on an H100 at bench.py's band (PERF.md): K6 0.96 ms, K3 1.93 ms
// for the same products — K3's loads divide the contraction index by bsz
// and load a column id per element, which K6's per-block loop avoids.

#include "bell_common.cuh"

namespace {

using namespace bell;

constexpr int kRowsBM = 32;  // output rows per thread block (bsz-high rows)

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(Shape<kRowsBM>::kThreads)
    bell_fused_kernel(const T* __restrict__ blocks,
                      const int* __restrict__ cols, const T* __restrict__ b,
                      typename AccOf<T>::type* __restrict__ c, int Lb,
                      int bsz, int k) {
  using S = typename AccOf<T>::type;
  __shared__ Smem<S, kRowsBM> sm;
  const TilePos p = tile_pos<kRowsBM>(bsz, k);
  const long long r = p.tile;
  const T* blk = blocks + r * Lb * bsz * bsz;
  const int* col = cols + r * Lb;
  // contraction index kk = l*bsz + j: block l's column j
  auto la = [&](int i, int kk) -> S {
    const int l = kk / bsz, j = kk - l * bsz;
    return widen(blk[(static_cast<long long>(l) * bsz + i) * bsz + j]);
  };
  auto lb = [&](int kk, int n) -> S {
    const int l = kk / bsz, j = kk - l * bsz;
    const long long row = static_cast<long long>(__ldg(col + l)) * bsz + j;
    return widen(b[row * k + n]);
  };
  S acc[kTM][kTN] = {};
  accumulate<S, SPLIT, kRowsBM, true, true>(sm, la, lb, bsz, k, Lb * bsz,
                                            p.m0, p.n0, acc);
  store<S, kRowsBM>(acc, c + r * bsz * k, k, 1, bsz, k, p.m0, p.n0);
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(Shape<kRowsBM>::kThreads)
    bell_block_kernel(const T* __restrict__ blocks,
                      const int* __restrict__ cols, const T* __restrict__ b,
                      typename AccOf<T>::type* __restrict__ c, int Lb,
                      int bsz, int k) {
  using S = typename AccOf<T>::type;
  __shared__ Smem<S, kRowsBM> sm;
  const TilePos p = tile_pos<kRowsBM>(bsz, k);
  const long long r = p.tile;
  S acc[kTM][kTN] = {};
  for (int l = 0; l < Lb; ++l) {
    const T* blk = blocks + (r * Lb + l) * bsz * bsz;
    const T* panel = b + static_cast<long long>(__ldg(cols + r * Lb + l)) *
                             bsz * k;
    auto la = [&](int i, int j) -> S {
      return widen(blk[static_cast<long long>(i) * bsz + j]);
    };
    auto lb = [&](int j, int n) -> S {
      return widen(panel[static_cast<long long>(j) * k + n]);
    };
    accumulate<S, SPLIT, kRowsBM, true, true>(sm, la, lb, bsz, k, bsz, p.m0,
                                              p.n0, acc);
  }
  store<S, kRowsBM>(acc, c + r * bsz * k, k, 1, bsz, k, p.m0, p.n0);
}

template <typename T, bool SPLIT, bool FUSED>
cudaError_t launch(const void* blocks, const void* cols, const void* b,
                   void* c, long long nb, long long Lb, long long bsz,
                   long long k, void* stream) {
  using S = typename AccOf<T>::type;
  const long long grid = grid_blocks(nb, bsz, k, kRowsBM);
  if (grid <= 0) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel =
      FUSED ? bell_fused_kernel<T, SPLIT> : bell_block_kernel<T, SPLIT>;
  kernel<<<static_cast<unsigned>(grid), Shape<kRowsBM>::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(cols),
      static_cast<const T*>(b), static_cast<S*>(c), static_cast<int>(Lb),
      static_cast<int>(bsz), static_cast<int>(k));
  return cudaGetLastError();
}

template <bool FUSED>
int dispatch(int kind, const void* blocks, const void* cols, const void* b,
             void* c, long long nb, long long Lb, long long bsz, long long k,
             void* stream) {
  switch (kind) {
    case kF32:
      return launch<float, false, FUSED>(blocks, cols, b, c, nb, Lb, bsz, k,
                                         stream);
    case kF32Split:
      return launch<float, true, FUSED>(blocks, cols, b, c, nb, Lb, bsz, k,
                                        stream);
    case kBF16:
      return launch<__nv_bfloat16, false, FUSED>(blocks, cols, b, c, nb, Lb,
                                                 bsz, k, stream);
    case kF64:
      return launch<double, false, FUSED>(blocks, cols, b, c, nb, Lb, bsz, k,
                                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kind: 0 float32, 1 float32 with the bf16x3 split, 2 bf16 stream, 3
// float64.  blocks (nb, Lb, bsz, bsz) and b (nb*bsz, k) in the stream type,
// cols (nb, Lb) int32, C (nb*bsz, k) in float32 (float64 for kind 3).
// Returns cudaGetLastError() after the launch.
int bell_fused(int kind, const void* blocks, const void* cols, const void* b,
               void* c, long long nb, long long Lb, long long bsz,
               long long k, void* stream) {
  return dispatch<true>(kind, blocks, cols, b, c, nb, Lb, bsz, k, stream);
}

int bell_block(int kind, const void* blocks, const void* cols, const void* b,
               void* c, long long nb, long long Lb, long long bsz,
               long long k, void* stream) {
  return dispatch<false>(kind, blocks, cols, b, c, nb, Lb, bsz, k, stream);
}

}  // extern "C"
