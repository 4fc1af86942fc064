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
// lanes an SM against 128 FP32).  float64 runs on the FP64 tensor cores
// (67 TFLOP/s), where its bytes, twice float32's, bind it: at bell-band-80M
// its copies alone (the blocks, and operand chunks that cross the L2 once
// for each stored block) took 0.76 ms and its multiply-adds alone 0.45 on
// an H100 SXM at 700 W (tools/k3_probe.py).
//
// What the design does about it: the TPU's DMA gathers become loads of the
// block's panel rows inside the kernel (no gathered intermediate in device
// memory, as on the TPU).  Every kind of K3 runs the body of band_body.cuh
// (K4's) on each block row's wide row: tiles of 32 output rows x 128
// columns, 32-index contraction chunks (one stored block at bsz 32), a
// cp.async ring (A ahead, B one chunk ahead), one __syncthreads_or vote per
// chunk so the zero blocks of padding slots skip their operand copy and
// their multiply-adds, 8x4 float32 register tiles (8 shared-memory cycles
// per 32 FFMA of a warp; int32 on the same map), bf16 on mma.sync, bf16x3
// as three bf16 mma.sync products a float32 fragment pair, float64 on
// Hopper's m16n8k8 DMMA from swizzled stages.  bf16, bf16x3 and float64
// walk their tiles on the resident thread blocks with one ring each
// (kWalks below); float32 and int32 take a thread block a tile.  Each
// chunk resolves its block and column id once, and a tile's column ids are
// prefetched into L1 (a tile ahead where the kind walks): a division and a
// column load per element cost float32 1.94 ms at the bench shape on an
// H100 (PERF.md), once per copied operand row 0.83 ms, once per chunk 0.70.
// bell_fused_issued counts the multiply-adds the vote kept.
//
// Every kind of K6 at bsz <= 64 (float64: 32) runs the persistent body of
// block_body.cuh:
// thread blocks walk the output tiles (one block row x 128 columns) in
// order with a cp.async ring of stored blocks and operand panels that runs
// across block rows, one vote per stored block (a padding slot's zero
// block skips its panel and its multiply-adds), 8x8 float32 register tiles
// (int32: the same tiles in unsigned), bf16 on mma.sync, bf16x3 as three
// bf16 mma.sync products a float32 fragment pair (band_body.cuh's
// split_chunk), float64 on m8n8k4 DMMA (band_body.cuh's dmma_chunk).  Past
// bsz 64, where a stored block no longer fits the persistent body's stages,
// K6's float32, bf16, bf16x3 and float64 kinds run the wide-block body of
// wide_body.cuh where TMA can describe the arrays (bsz and k times the
// element size multiples of 16 bytes): one thread block an SM walks tiles
// of up to 128 rows of a block row x 128 columns (float64: 64), fed by a
// TMA ring on mbarriers, float32 on 8 x 8 FFMA register tiles whose
// fragment loads are one shared-memory wavefront each, bf16 on wgmma,
// bf16x3 on wgmma from B's bf16 planes with A split in registers, float64
// on Hopper's m16n8k8 DMMA, a vote per warpgroup and 32-index slice.  The
// other shapes past it (int32 at every bsz past 64, float64 at bsz 33-64,
// and shapes TMA cannot describe) run K3's band-body kernel: it computes
// the same C = sum_l A[r, l] @ B[cols[r, l]], one 32-index chunk of the
// wide row at a time.
// k6_body names the rule.  bell_block_issued counts the multiply-adds the
// vote kept.
//
// Behaviour: a skipped zero chunk or block never multiplies the operand, so
// Inf or NaN in B opposite it gives the sparse product's answer (a chunk
// that straddles a stored block and a padding block, bsz not a multiple of
// 32, is multiplied whole).  Every int32 kind sums modulo 2^32: the
// reference's wrapping int32 result, in any order.  No atomics on the
// output, so two runs of one input agree bitwise.

#include <type_traits>

#include "band_body.cuh"
#include "bell_kinds.cuh"
#include "block_body.cuh"
#include "wide_body.cuh"

namespace {

// Whether K3's kind S walks its tiles on the resident thread blocks with
// one ring (band::run_tiles) or launches a thread block a tile (band::run).
// On an H100 SXM at 700 W at bell-band-80M, in turns against band::run's
// kernel (same m16n8k8 multiply, bits equal, tools/k3_probe.py's "run"),
// the walk took float64 0.94-0.95 ms against 1.01, the bf16 kernel
// 0.279-0.281 against 0.281-0.286 and bf16x3 0.540-0.553 against
// 0.555-0.565; float32 took 2% longer walking and int32 6.5% (11.5% at bsz
// 128, where K6 runs this kernel), so those two keep a thread block a tile.
template <typename S>
constexpr bool kWalks =
    !std::is_same<S, float>::value && !std::is_same<S, int>::value;

// K3, and K6 past bsz 64: blocks (nb, Lb, bsz, bsz) and b (nb*bsz, k) in
// the stream kind S's element type, C (nb*bsz, k) in Cfg<S>::Out (float32;
// float64 for float64, int32 for int32).  Tiles (block row, 32-row block,
// 128-column block), column blocks fastest: walked by each thread block,
// blockIdx.x, + gridDim.x, ..., where kWalks<S>, else tile blockIdx.x.
template <typename S, bool VEC>
__global__ void __launch_bounds__(band::kThreads, band::Cfg<S>::kMinBlocks)
    fused_band_kernel(const typename band::Cfg<S>::T* __restrict__ blocks,
                      const int* __restrict__ cols,
                      const typename band::Cfg<S>::T* __restrict__ b,
                      typename band::Cfg<S>::Out* __restrict__ c, int nb,
                      int Lb, int bsz, int k,
                      unsigned long long* __restrict__ issued) {
  using T = typename band::Cfg<S>::T;
  if constexpr (kWalks<S>) {
    const band::WideRows<T> w{blocks, cols, b, Lb, bsz, k};
    band::run_tiles<S, VEC>(w, c, nb, bsz, Lb * bsz, k, issued);
  } else {
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
}

// The grid of fused_band_kernel<S, VEC> over `tiles` tiles of nc chunks
// each: where kWalks<S>, the thread blocks resident at once on the current
// device (its SMs times the kernel's blocks an SM, from the occupancy call,
// read once), no more than the tiles, and enough that no thread block
// walks more than 2^31 - 8 steps; else the tiles.  Gives the blocks an SM
// where per_sm_out is not null; a kind that does not walk asks the device
// nothing else.
template <typename S, bool VEC>
cudaError_t fused_grid(long long tiles, long long nc, long long* grid,
                       int* per_sm_out) {
  constexpr long long kMax = 0x7fffffffLL;
  auto kern = fused_band_kernel<S, VEC>;
  constexpr int smem = band::smem_bytes<S>();
  cudaError_t rc = band::allow_smem<smem>(kern);
  if (rc != cudaSuccess) return rc;
  *grid = tiles;
  if (!kWalks<S> && per_sm_out == nullptr) return cudaSuccess;
  static int per_sm = 0;
  if (per_sm == 0) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                       band::kThreads, smem);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) per_sm = 1;
  }
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  if (!kWalks<S>) return cudaSuccess;
  int dev = 0, sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const long long cap = static_cast<long long>(sms) * per_sm;
  long long g = tiles < cap ? tiles : cap;
  const long long most = (kMax - 8) / nc;  // tiles a thread block may walk
  if ((tiles + g - 1) / g > most) g = (tiles + most - 1) / most;
  *grid = g;
  return cudaSuccess;
}

// The tiles and chunks a tile of K3's walk, or an error where the kernel
// cannot index the shape (32-bit index math inside a block row's blocks
// and its output, at most 2^31 - 1 tiles).
inline cudaError_t fused_shape(long long nb, long long Lb, long long bsz,
                               long long k, long long* tiles, long long* nc) {
  using band::kBM;
  using band::kBN;
  constexpr long long kMax = 0x7fffffffLL;
  if (Lb < 0 || Lb * bsz * bsz > kMax || bsz * k > kMax)
    return cudaErrorInvalidValue;
  *tiles = nb * ((bsz + kBM - 1) / kBM) * ((k + kBN - 1) / kBN);
  if (*tiles > kMax) return cudaErrorInvalidConfiguration;
  *nc = Lb > 0 ? (Lb * bsz + 31) / 32 : 1;  // band_body.cuh's kBK
  return cudaSuccess;
}

// 16-byte copies: a vector of the wide row stays inside one block, and
// operand rows are whole vectors.
template <typename S>
bool fused_vec(long long bsz, long long k) {
  constexpr long long V = 16 / sizeof(typename band::Cfg<S>::T);
  return bsz % V == 0 && k % V == 0;
}

template <typename S>
cudaError_t launch_fused_band(const void* blocks, const void* cols,
                              const void* b, void* c, long long nb,
                              long long Lb, long long bsz, long long k,
                              unsigned long long* issued, void* stream) {
  using T = typename band::Cfg<S>::T;
  if (nb <= 0 || bsz <= 0 || k <= 0) return cudaSuccess;
  long long tiles = 0, nc = 0, grid = 0;
  cudaError_t rc = fused_shape(nb, Lb, bsz, k, &tiles, &nc);
  if (rc != cudaSuccess) return rc;
  const bool vec = fused_vec<S>(bsz, k) && band::aligned16(blocks) &&
                   band::aligned16(b) && band::aligned16(c);
  rc = vec ? fused_grid<S, true>(tiles, nc, &grid, nullptr)
           : fused_grid<S, false>(tiles, nc, &grid, nullptr);
  if (rc != cudaSuccess) return rc;
  auto kern = vec ? fused_band_kernel<S, true> : fused_band_kernel<S, false>;
  kern<<<static_cast<unsigned>(grid), band::kThreads, band::smem_bytes<S>(),
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(cols),
      static_cast<const T*>(b), static_cast<typename band::Cfg<S>::Out*>(c),
      static_cast<int>(nb), static_cast<int>(Lb), static_cast<int>(bsz),
      static_cast<int>(k), issued);
  return cudaGetLastError();
}

// K3's launched geometry for (nb, Lb, bsz, k), 16-byte aligned arrays:
// out[0..7] = registers and local (spilled) bytes a thread, dynamic shared
// bytes a block, resident blocks an SM, tiles, thread blocks launched,
// chunks a tile and whether the kind walks its tiles, on the current
// device.
template <typename S>
cudaError_t fused_geometry(long long nb, long long Lb, long long bsz,
                           long long k, int* out) {
  if (nb <= 0 || bsz <= 0 || k <= 0) return cudaErrorInvalidValue;
  long long tiles = 0, nc = 0, grid = 0;
  cudaError_t rc = fused_shape(nb, Lb, bsz, k, &tiles, &nc);
  if (rc != cudaSuccess) return rc;
  const bool vec = fused_vec<S>(bsz, k);
  int per_sm = 0;
  rc = vec ? fused_grid<S, true>(tiles, nc, &grid, &per_sm)
           : fused_grid<S, false>(tiles, nc, &grid, &per_sm);
  cudaFuncAttributes at;
  if (rc == cudaSuccess)
    rc = cudaFuncGetAttributes(&at, vec ? fused_band_kernel<S, true>
                                        : fused_band_kernel<S, false>);
  if (rc != cudaSuccess) return rc;
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = band::smem_bytes<S>();
  out[3] = per_sm;
  out[4] = static_cast<int>(tiles);
  out[5] = static_cast<int>(grid);
  out[6] = static_cast<int>(nc);
  out[7] = kWalks<S>;
  return cudaSuccess;
}

// The band-body kinds of K3 (and of K6 past bsz 64): float32, bf16,
// bf16x3, float64 and int32; counter may be null.
cudaError_t fused_band_kinds(int kind, const void* blocks, const void* cols,
                             const void* b, void* c, long long nb,
                             long long Lb, long long bsz, long long k,
                             unsigned long long* issued, void* stream) {
  return bell::with_kind(kind, [&](auto s) {
    return launch_fused_band<typename decltype(s)::type>(
        blocks, cols, b, c, nb, Lb, bsz, k, issued, stream);
  });
}

// K6 at bsz <= 64: blocks (nb, Lb, bsz, bsz), b (nb*bsz, k) and C (nb*bsz,
// k) in the stream kind S's element type T (float32 for bf16x3).
template <typename S, int BK, bool VEC>
__global__ void __launch_bounds__(bbody::Geo<S, BK>::kThreads)
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
  constexpr int threads = bbody::Geo<S, BK>::kThreads;
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

// The largest bsz K6's persistent body takes in kind `kind`: a stored
// block fits its stages (BK <= 64); float64's ring at BK 64 would hold one
// thread block an SM (192 KB), so float64 takes BK 32 only.
constexpr long long persistent_bsz(int kind) {
  return kind == bell::kF64 ? 32 : 64;
}

// The element bytes of the kinds the wide-block body takes (float32, bf16,
// bf16x3's float32, float64); 0 for the others.
constexpr long long wide_elem(int kind) {
  return kind == bell::kBF16                            ? 2
         : kind == bell::kF32 || kind == bell::kF32Split ? 4
         : kind == bell::kF64                           ? 8
                                                        : 0;
}

// K6's body for kind `kind` at (bsz, k): the persistent body up to
// persistent_bsz; past bsz 64 the wide-block body for the kinds it takes
// where a TMA map can describe the arrays (bsz and k times the element size
// multiples of 16 bytes); else K3's band body.  The rule reads shapes and
// the kind only (ops/cuda_bell.py's _k6_body mirrors it); the wrapper makes
// the wide body's arrays 16-byte aligned.
enum K6Body { kPersistentBody = 0, kWideBody = 1, kBandBody = 2 };
constexpr K6Body k6_body(int kind, long long bsz, long long k) {
  return bsz <= persistent_bsz(kind) ? kPersistentBody
         : bsz > 64 && wide_elem(kind) > 0 &&
                 bsz * wide_elem(kind) % 16 == 0 &&
                 k * wide_elem(kind) % 16 == 0
             ? kWideBody
             : kBandBody;
}

// The persistent K6 body's kinds, float32, bf16, bf16x3, float64 and
// int32, up to persistent_bsz.
template <typename S>
cudaError_t launch_block_body(const void* blocks, const void* cols,
                              const void* b, void* c, long long nb,
                              long long Lb, long long bsz, long long k,
                              unsigned long long* issued, void* stream) {
  using T = typename bbody::Cfg<S>::T;
  constexpr long long kMax = 0x7fffffffLL;
  constexpr bool kF64 = std::is_same<S, double>::value;
  if (nb <= 0 || Lb <= 0 || bsz <= 0 || k <= 0) return cudaSuccess;
  // 32-bit index math inside a block row's output and the step count
  if (bsz > (kF64 ? 32 : 64) || bsz * k > kMax ||
      nb * Lb * 2 * ((k + 127) / 128) > kMax)
    return cudaErrorInvalidValue;
  constexpr long long V = 16 / sizeof(T);
  const bool vec = bsz % V == 0 && k % V == 0 && band::aligned16(blocks) &&
                   band::aligned16(b) && band::aligned16(c);
  if (bsz <= 32)
    return vec ? launch_block_tiles<S, 32, true>(blocks, cols, b, c, nb, Lb,
                                                 bsz, k, issued, stream)
               : launch_block_tiles<S, 32, false>(blocks, cols, b, c, nb, Lb,
                                                  bsz, k, issued, stream);
  if constexpr (!kF64)
    return vec ? launch_block_tiles<S, 64, true>(blocks, cols, b, c, nb, Lb,
                                                 bsz, k, issued, stream)
               : launch_block_tiles<S, 64, false>(blocks, cols, b, c, nb, Lb,
                                                  bsz, k, issued, stream);
  return cudaErrorInvalidValue;
}

// K6's persistent kinds; counter may be null.  Other kinds return
// cudaErrorInvalidValue.
cudaError_t block_body_kinds(int kind, const void* blocks, const void* cols,
                             const void* b, void* c, long long nb,
                             long long Lb, long long bsz, long long k,
                             unsigned long long* issued, void* stream) {
  return bell::with_kind(kind, [&](auto s) {
    return launch_block_body<typename decltype(s)::type>(
        blocks, cols, b, c, nb, Lb, bsz, k, issued, stream);
  });
}


// K6's wide-block body: blocks (nb, Lb, bsz, bsz), b (nb*bsz, k) in the
// stream kind S's element type, C (nb*bsz, k) in wide::Cfg<S>::Out
// (float32, bf16, float32 for bf16x3, float64).
template <typename S>
__global__ void __launch_bounds__(wide::kThreads, 1)
    wide_block_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const int* __restrict__ cols,
                      typename wide::Cfg<S>::Out* __restrict__ c, int Lb,
                      int bsz, int k, int tiles,
                      unsigned long long* __restrict__ issued) {
  wide::run<S>(&map_a, &map_b, cols, c, Lb, bsz, k, tiles, issued);
}

// Shapes the body cannot take return cudaErrorInvalidValue (bsz or k times
// the element size not a multiple of 16 bytes, a pointer not 16-byte
// aligned, more than 2^31 - 1 slots or tiles); a tensor map the driver
// refuses returns cudaErrorNotSupported.  Nothing falls back.
template <typename S>
cudaError_t launch_wide(const void* blocks, const void* cols, const void* b,
                        void* c, long long nb, long long Lb, long long bsz,
                        long long k, unsigned long long* issued,
                        void* stream) {
  using Cf = wide::Cfg<S>;
  using G = wide::Geo<S>;
  constexpr long long kMax = 0x7fffffffLL;
  constexpr long long E = sizeof(typename Cf::T);
  if (nb <= 0 || Lb <= 0 || bsz <= 0 || k <= 0) return cudaSuccess;
  const long long tiles = nb * ((bsz + wide::kBM - 1) / wide::kBM) *
                          ((k + Cf::kBN - 1) / Cf::kBN);
  if (bsz * E % 16 || k * E % 16 || !band::aligned16(blocks) ||
      !band::aligned16(b) || !band::aligned16(c) || nb * Lb > kMax ||
      tiles > kMax || bsz * k > kMax)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!sm90::encode_3d(&map_a, Cf::kType, E, blocks, bsz, bsz, nb * Lb,
                       G::kRow, wide::kBM) ||
      !sm90::encode_3d(&map_b, Cf::kType, E, b, k, bsz, nb, G::kRow,
                       Cf::kKC))
    return cudaErrorNotSupported;
  auto kern = wide_block_kernel<S>;
  cudaError_t rc = band::allow_smem<G::kBytes>(kern);
  if (rc != cudaSuccess) return rc;
  int dev = 0, sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  kern<<<static_cast<unsigned>(tiles < sms ? tiles : sms), wide::kThreads,
         G::kBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const int*>(cols),
      static_cast<typename Cf::Out*>(c), static_cast<int>(Lb),
      static_cast<int>(bsz), static_cast<int>(k), static_cast<int>(tiles),
      issued);
  return cudaGetLastError();
}

// The wide-block body's kinds: float32, bf16, bf16x3 and float64; counter
// may be null.  Other kinds return cudaErrorInvalidValue.
cudaError_t wide_body_kinds(int kind, const void* blocks, const void* cols,
                            const void* b, void* c, long long nb,
                            long long Lb, long long bsz, long long k,
                            unsigned long long* issued, void* stream) {
  return bell::with_kind(kind, [&](auto s) {
    using S = typename decltype(s)::type;
    if constexpr (std::is_same<S, int>::value)
      return cudaErrorInvalidValue;
    else
      return launch_wide<S>(blocks, cols, b, c, nb, Lb, bsz, k, issued,
                            stream);
  });
}


// K6 on the body k6_body names; counter may be null.
cudaError_t block_kinds(int kind, const void* blocks, const void* cols,
                        const void* b, void* c, long long nb, long long Lb,
                        long long bsz, long long k,
                        unsigned long long* issued, void* stream) {
  switch (k6_body(kind, bsz, k)) {
    case kPersistentBody:
      return block_body_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                              issued, stream);
    case kWideBody:
      return wide_body_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                             issued, stream);
    default:
      return fused_band_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                              issued, stream);
  }
}

}  // namespace

extern "C" {

// kind (bell_kinds.cuh): 0 float32, 1 float32 with the bf16x3 split, 2 bf16
// stream, 3 float64, 4 int32.  blocks (nb, Lb, bsz, bsz) and b (nb*bsz, k)
// in the stream type, cols (nb, Lb) int32, C (nb*bsz, k) in float32
// (float64 for kind 3, int32 for kind 4).  Every kind runs the band body.
// Returns cudaGetLastError() after the launch, or the error of a shape the
// kernel cannot index.
int bell_fused(int kind, const void* blocks, const void* cols, const void* b,
               void* c, long long nb, long long Lb, long long bsz,
               long long k, void* stream) {
  return fused_band_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k, nullptr,
                          stream);
}

// bell_fused, also adding to *issued (on the card, zeroed by the caller) the
// multiply-adds the body issues: 32 x 32 x 128 for every chunk of a wide
// row its vote kept (once for bf16x3).
int bell_fused_issued(int kind, const void* blocks, const void* cols,
                      const void* b, void* c, long long nb, long long Lb,
                      long long bsz, long long k, void* issued,
                      void* stream) {
  return fused_band_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                          static_cast<unsigned long long*>(issued), stream);
}

// K3's launched geometry in kind `kind` for blocks (nb, Lb, bsz, bsz) and
// k columns (16-byte aligned arrays): out[0..7] = registers and local
// bytes a thread, dynamic shared bytes a block, resident blocks an SM,
// tiles, thread blocks launched, chunks a tile and 1 where the kind walks
// its tiles, on the current device.  Returns a cudaError_t.
int bell_fused_geometry(int kind, long long nb, long long Lb, long long bsz,
                        long long k, int* out) {
  return bell::with_kind(kind, [&](auto s) {
    return fused_geometry<typename decltype(s)::type>(nb, Lb, bsz, k, out);
  });
}

// K6, bell_fused's arguments, on the body k6_body names.  Up to
// persistent_bsz (64; float64 32) every kind runs the persistent body, whose
// bf16 kind writes a bf16 C (the result's dtype); past it float32, bf16,
// bf16x3 and float64 run the wide-block body where TMA can describe the
// arrays (bf16 writes bf16 C), the rest K3's band-body kernel, whose bf16
// kind writes a float32 C.  float32 and bf16x3 write float32, float64
// float64, int32 int32.
int bell_block(int kind, const void* blocks, const void* cols, const void* b,
               void* c, long long nb, long long Lb, long long bsz,
               long long k, void* stream) {
  return block_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k, nullptr,
                     stream);
}

// bell_block, also adding to *issued (on the card, zeroed by the caller) the
// multiply-adds its body's vote kept: on the persistent body rows x bsz x
// columns of a tile for each stored block it kept there; on the wide-block
// body a warpgroup's useful rows x a 32-index slice's useful indices x the
// tile's useful columns for each slice it kept; on K3's band body
// bell_fused_issued's count (each once for bf16x3).
int bell_block_issued(int kind, const void* blocks, const void* cols,
                      const void* b, void* c, long long nb, long long Lb,
                      long long bsz, long long k, void* issued,
                      void* stream) {
  return block_kinds(kind, blocks, cols, b, c, nb, Lb, bsz, k,
                     static_cast<unsigned long long*>(issued), stream);
}

}  // extern "C"
