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
// stream-bound.  The int32 kinds run the float32 tiling with integer
// multiply-adds, which Hopper issues at half the float32 rate (64 INT32
// lanes an SM against 128 FP32).
//
// What the design does about it: the TPU's DMA gathers become loads of the
// block's panel rows inside the kernel (no gathered intermediate in device
// memory, as on the TPU).  K3's float32, int32, bf16 and bf16x3 streams
// run the body of band_body.cuh (K4's) on each block row's wide row: 32 output rows
// x 128 columns per thread block, 32-index contraction chunks (one stored
// block at bsz 32), a cp.async ring (A ahead, B one chunk ahead), one
// __syncthreads_or vote per chunk so the zero blocks of padding slots skip
// their operand copy and their multiply-adds, 8x4 float32 register tiles,
// bf16 on mma.sync, bf16x3 as three bf16 mma.sync products a float32
// fragment pair.  Each chunk resolves its block and column id once, and
// the row's column ids are prefetched into L1 at the start: the first body
// paid a division and a column load per element (1.94 ms at the bench
// shape on an H100, PERF.md), once per copied operand row it was 0.83 ms,
// once per chunk 0.70.  bell_fused_issued counts the multiply-adds the
// vote kept.  Behaviour: a padding slot's zero block never multiplies the
// operand, so Inf or NaN in B opposite it gives the sparse product's
// answer.
//
// K6's float32, int32, bf16 and bf16x3 streams (bsz <= 64) run the
// persistent
// body of block_body.cuh: thread blocks walk the output tiles (one block
// row x 128 columns) in order with a cp.async ring of stored blocks and
// operand panels that runs across block rows, one vote per stored block (a
// padding slot's zero block skips its panel and its multiply-adds), 8x8
// float32 register tiles (int32: the same tiles in unsigned), bf16 on
// mma.sync, bf16x3 as three bf16 mma.sync products a float32 fragment pair
// (band_body.cuh's split_chunk);
// bell_block_issued counts the multiply-adds the vote kept.  K6's float64
// kind (and every kind past bsz 64), and K3's float64 kind, run the first
// body (bell_common.cuh): one thread block owns one (block row, 64-column
// chunk of k) and keeps its output in registers (4 x 4 per thread) across
// the whole contraction; K3 stages the wide row in chunks of 16
// contraction indices that run across block boundaries, K6 walks the Lb
// stored blocks one at a time; it skips no zero (int32 past bsz 64 sums in
// unsigned there).  Every int32 kind sums modulo 2^32: the reference's
// wrapping int32 result, in any order.  No atomics, so two runs of one
// input agree bitwise.

#include "band_body.cuh"
#include "bell_common.cuh"
#include "bell_kinds.cuh"
#include "block_body.cuh"

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

// K3 for float32, bf16, bf16x3 and int32 streams: blocks (nb, Lb, bsz, bsz)
// and b (nb*bsz, k) in the stream kind S's element type, C (nb*bsz, k) in
// Cfg<S>::Out (float32; int32 for int32).
// Block (block row, 32-row block, 128-column block), column blocks fastest.
template <typename S, bool VEC>
__global__ void __launch_bounds__(band::kThreads, band::Cfg<S>::kMinBlocks)
    fused_band_kernel(const typename band::Cfg<S>::T* __restrict__ blocks,
                      const int* __restrict__ cols,
                      const typename band::Cfg<S>::T* __restrict__ b,
                      typename band::Cfg<S>::Out* __restrict__ c, int Lb,
                      int bsz, int k, unsigned long long* __restrict__ issued) {
  using T = typename band::Cfg<S>::T;
  const int n_blocks = (k + band::kBN - 1) / band::kBN;
  const int m_blocks = (bsz + band::kBM - 1) / band::kBM;
  long long bid = blockIdx.x;
  const int n0 = static_cast<int>(bid % n_blocks) * band::kBN;
  bid /= n_blocks;
  const int m0 = static_cast<int>(bid % m_blocks) * band::kBM;
  const long long r = bid / m_blocks;
  const int K = Lb * bsz;
  const band::WideRow<T> p{blocks + r * Lb * bsz * bsz, cols + r * Lb, b,
                           bsz, K, k};
  // the row's column ids into L1 while A's first chunks are copied: the
  // first operand copy waits on them
  if (threadIdx.x == 0) sm90::prefetch_l1(cols + r * Lb);
  band::run<S, VEC>(p, c + r * bsz * k, bsz, K, k, m0, n0, issued);
}

template <typename S>
cudaError_t launch_fused_band(const void* blocks, const void* cols,
                              const void* b, void* c, long long nb,
                              long long Lb, long long bsz, long long k,
                              unsigned long long* issued, void* stream) {
  using band::kBM;
  using band::kBN;
  using T = typename band::Cfg<S>::T;
  constexpr long long kMax = 0x7fffffffLL;
  if (nb <= 0 || bsz <= 0 || k <= 0) return cudaSuccess;
  // 32-bit index math inside a block row's blocks and its output
  if (Lb * bsz * bsz > kMax || bsz * k > kMax) return cudaErrorInvalidValue;
  const long long grid = nb * ((bsz + kBM - 1) / kBM) * ((k + kBN - 1) / kBN);
  if (grid > kMax) return cudaErrorInvalidConfiguration;
  constexpr long long V = 16 / sizeof(T);
  // 16-byte copies: a vector of the wide row stays inside one block, and
  // operand rows are whole vectors
  const bool vec = bsz % V == 0 && k % V == 0 && band::aligned16(blocks) &&
                   band::aligned16(b) && band::aligned16(c);
  auto kern = vec ? fused_band_kernel<S, true> : fused_band_kernel<S, false>;
  constexpr int smem = band::smem_bytes<S>();
  const cudaError_t rc = band::allow_smem<smem>(kern);
  if (rc != cudaSuccess) return rc;
  kern<<<static_cast<unsigned>(grid), band::kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(cols),
      static_cast<const T*>(b), static_cast<typename band::Cfg<S>::Out*>(c),
      static_cast<int>(Lb), static_cast<int>(bsz), static_cast<int>(k),
      issued);
  return cudaGetLastError();
}

// K3's band-body kinds: float32, bf16, bf16x3 and int32.
cudaError_t fused_band_kinds(int kind, const void* blocks, const void* cols,
                             const void* b, void* c, long long nb,
                             long long Lb, long long bsz, long long k,
                             unsigned long long* issued, void* stream) {
  switch (kind) {
    case kF32:
      return launch_fused_band<float>(blocks, cols, b, c, nb, Lb, bsz, k,
                                      issued, stream);
    case kI32:
      return launch_fused_band<int>(blocks, cols, b, c, nb, Lb, bsz, k,
                                    issued, stream);
    case kF32Split:
      return launch_fused_band<band::Split>(blocks, cols, b, c, nb, Lb, bsz,
                                            k, issued, stream);
    case kBF16:
      return launch_fused_band<__nv_bfloat16>(blocks, cols, b, c, nb, Lb,
                                              bsz, k, issued, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K6 for float32, bf16, bf16x3 and int32 streams: blocks (nb, Lb, bsz,
// bsz), b (nb*bsz, k) and C (nb*bsz, k) in the stream kind S's element type
// T (float32 for bf16x3).
template <typename S, int BK, bool VEC>
__global__ void __launch_bounds__(bbody::kThreads)
    block_tile_kernel(const typename bbody::Cfg<S>::T* __restrict__ blocks,
                      const int* __restrict__ cols,
                      const typename bbody::Cfg<S>::T* __restrict__ b,
                      typename bbody::Cfg<S>::T* __restrict__ c, int nb,
                      int Lb, int bsz, int k,
                      unsigned long long* __restrict__ issued) {
  bbody::run<S, BK, VEC>(blocks, cols, b, c, nb, Lb, bsz, k, issued);
}

template <typename S, int BK, bool VEC>
cudaError_t launch_block_tiles(const void* blocks, const void* cols,
                               const void* b, void* c, long long nb,
                               long long Lb, long long bsz, long long k,
                               unsigned long long* issued, void* stream) {
  using T = typename bbody::Cfg<S>::T;
  auto kern = block_tile_kernel<S, BK, VEC>;
  constexpr int smem = bbody::Geo<S, BK>::kBytes;
  cudaError_t rc = band::allow_smem<smem>(kern);
  if (rc != cudaSuccess) return rc;
  constexpr int threads = bbody::kThreads;
  static int per_sm = 0;  // resident thread blocks per SM
  if (per_sm == 0) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                       threads, smem);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const long long tiles = nb * ((bsz + bbody::kBM - 1) / bbody::kBM) *
                          ((k + bbody::kBN - 1) / bbody::kBN);
  const long long cap = static_cast<long long>(sms) * per_sm;
  kern<<<static_cast<unsigned>(tiles < cap ? tiles : cap), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(cols),
      static_cast<const T*>(b), static_cast<T*>(c), static_cast<int>(nb),
      static_cast<int>(Lb), static_cast<int>(bsz), static_cast<int>(k),
      issued);
  return cudaGetLastError();
}

// The persistent K6 body's kinds, float32, bf16, bf16x3 and int32, at bsz
// <= 64.
template <typename S>
cudaError_t launch_block_body(const void* blocks, const void* cols,
                              const void* b, void* c, long long nb,
                              long long Lb, long long bsz, long long k,
                              unsigned long long* issued, void* stream) {
  using T = typename bbody::Cfg<S>::T;
  constexpr long long kMax = 0x7fffffffLL;
  if (nb <= 0 || Lb <= 0 || bsz <= 0 || k <= 0) return cudaSuccess;
  // 32-bit index math inside a block row's output and the step count
  if (bsz > 64 || bsz * k > kMax || nb * Lb * 2 * ((k + 127) / 128) > kMax)
    return cudaErrorInvalidValue;
  constexpr long long V = 16 / sizeof(T);
  const bool vec = bsz % V == 0 && k % V == 0 && band::aligned16(blocks) &&
                   band::aligned16(b) && band::aligned16(c);
  if (bsz <= 32)
    return vec ? launch_block_tiles<S, 32, true>(blocks, cols, b, c, nb, Lb,
                                                 bsz, k, issued, stream)
               : launch_block_tiles<S, 32, false>(blocks, cols, b, c, nb, Lb,
                                                  bsz, k, issued, stream);
  return vec ? launch_block_tiles<S, 64, true>(blocks, cols, b, c, nb, Lb,
                                               bsz, k, issued, stream)
             : launch_block_tiles<S, 64, false>(blocks, cols, b, c, nb, Lb,
                                                bsz, k, issued, stream);
}

// K6's persistent kinds; counter may be null.  Other kinds return
// cudaErrorInvalidValue.
cudaError_t block_body_kinds(int kind, const void* blocks, const void* cols,
                             const void* b, void* c, long long nb,
                             long long Lb, long long bsz, long long k,
                             unsigned long long* issued, void* stream) {
  switch (kind) {
    case kF32:
      return launch_block_body<float>(blocks, cols, b, c, nb, Lb, bsz, k,
                                      issued, stream);
    case kI32:
      return launch_block_body<int>(blocks, cols, b, c, nb, Lb, bsz, k,
                                    issued, stream);
    case kF32Split:
      return launch_block_body<band::Split>(blocks, cols, b, c, nb, Lb, bsz,
                                            k, issued, stream);
    case kBF16:
      return launch_block_body<__nv_bfloat16>(blocks, cols, b, c, nb, Lb,
                                              bsz, k, issued, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool SPLIT, bool FUSED>
cudaError_t launch(const void* blocks, const void* cols, const void* b,
                   void* c, long long nb, long long Lb, long long bsz,
                   long long k, void* stream) {
  using S = typename AccOf<T>::type;
  const long long grid = grid_blocks(nb, bsz, k, kRowsBM);
  if (grid <= 0) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel = bell_block_kernel<T, SPLIT>;
  if constexpr (FUSED) kernel = bell_fused_kernel<T, SPLIT>;
  kernel<<<static_cast<unsigned>(grid), Shape<kRowsBM>::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(cols),
      static_cast<const T*>(b), static_cast<S*>(c), static_cast<int>(Lb),
      static_cast<int>(bsz), static_cast<int>(k));
  return cudaGetLastError();
}

// The first body's kinds: float64 for K3 and K6, and every kind of K6 past
// bsz 64 (int32 among them).
template <bool FUSED>
int dispatch(int kind, const void* blocks, const void* cols, const void* b,
             void* c, long long nb, long long Lb, long long bsz, long long k,
             void* stream) {
  switch (kind) {
    case kF32:
      if constexpr (!FUSED)
        return launch<float, false, FUSED>(blocks, cols, b, c, nb, Lb, bsz,
                                           k, stream);
      return cudaErrorInvalidValue;
    case kF32Split:
      if constexpr (!FUSED)
        return launch<float, true, FUSED>(blocks, cols, b, c, nb, Lb, bsz, k,
                                          stream);
      return cudaErrorInvalidValue;
    case kBF16:
      if constexpr (!FUSED)
        return launch<__nv_bfloat16, false, FUSED>(blocks, cols, b, c, nb,
                                                   Lb, bsz, k, stream);
      return cudaErrorInvalidValue;
    case kF64:
      return launch<double, false, FUSED>(blocks, cols, b, c, nb, Lb, bsz, k,
                                          stream);
    case kI32:  // K6 past bsz 64: sums in unsigned, C int32
      if constexpr (!FUSED)
        return launch<int, false, FUSED>(blocks, cols, b, c, nb, Lb, bsz, k,
                                         stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kind (bell_kinds.cuh): 0 float32, 1 float32 with the bf16x3 split, 2 bf16
// stream, 3 float64, 4 int32.  blocks (nb, Lb, bsz, bsz) and b (nb*bsz, k)
// in the stream type, cols (nb, Lb) int32, C (nb*bsz, k) in float32
// (float64 for kind 3, int32 for kind 4, bf16 for K6's kind 2 at bsz <=
// 64).  K3's float32, bf16, bf16x3 and int32 kinds run the band body,
// float64 the first body.  Returns cudaGetLastError() after
// the launch, or the error of a shape the kernel cannot index.
int bell_fused(int kind, const void* blocks, const void* cols, const void* b,
               void* c, long long nb, long long Lb, long long bsz,
               long long k, void* stream) {
  if (kind == kF64)
    return dispatch<true>(kind, blocks, cols, b, c, nb, Lb, bsz, k, stream);
  return fused_band_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k, nullptr,
                          stream);
}

// bell_fused for the float32, bf16, bf16x3 and int32 kinds (float64
// returns cudaErrorInvalidValue), also adding to *issued (on the card, zeroed by
// the caller) the multiply-adds the body issues: 32 x 32 x 128 for every
// chunk of a wide row its vote kept (once for bf16x3).
int bell_fused_issued(int kind, const void* blocks, const void* cols,
                      const void* b, void* c, long long nb, long long Lb,
                      long long bsz, long long k, void* issued,
                      void* stream) {
  return fused_band_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                          static_cast<unsigned long long*>(issued), stream);
}

// K6.  The float32, bf16, bf16x3 and int32 kinds at bsz <= 64 run the
// persistent body, float64 and bsz > 64 the first body.  The persistent
// body's bf16 kind writes a bf16 C (the result's dtype), the first body's
// float32; int32 writes int32 on both.
int bell_block(int kind, const void* blocks, const void* cols, const void* b,
               void* c, long long nb, long long Lb, long long bsz,
               long long k, void* stream) {
  if (bsz <= 64 && kind != kF64)
    return block_body_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                            nullptr, stream);
  return dispatch<false>(kind, blocks, cols, b, c, nb, Lb, bsz, k, stream);
}

// bell_block for the float32, bf16, bf16x3 and int32 kinds at bsz <= 64 (C
// in the stream type, float32 for bf16x3; others return
// cudaErrorInvalidValue),
// also adding to *issued (on the card, zeroed by the caller) the
// multiply-adds the persistent body's vote kept: rows x bsz x columns of a
// tile for each stored block it kept there (once for bf16x3).
int bell_block_issued(int kind, const void* blocks, const void* cols,
                      const void* b, void* c, long long nb, long long Lb,
                      long long bsz, long long k, void* issued,
                      void* stream) {
  if (bsz > 64) return cudaErrorInvalidValue;
  return block_body_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                          static_cast<unsigned long long*>(issued), stream);
}

}  // extern "C"
