// K4 and K5: banded (consecutive-column) blocked-ELL SpMM on Hopper; K8,
// the dense-band SpMM of benchmarks/measure_dband.py, is K4's product.
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
//      with B^T (k, n) or (k, n_pad) and C^T (k, n_pad);
// and benchmarks/measure_dband.py::dband_spmm (def :57 / pallas_call :82),
// K8: K4's per-tile product on a (panels, bsz, k) operand.
// Each TPU kernel is a pair of pallas_calls: the super-tile one shares one
// operand window among S row tiles to save DMA.  Since start[t] ==
// sup[t / S] + rel[t] by construction, one kernel that reads start[t]
// computes both; the plan keeps S/SW/rel/sup for parity only.
//
// What bounds it on this card: the densified tiles are mostly zeros (W/Lb
// times the packed blocks).  At the bench band (nb 15,625, bsz 32, rt 5,
// W 12, k 128) a full product of every tile is 49.2 GFLOP for 20.5 useful,
// against 768 MB of float32 tiles, the operand and a 256 MB output.  The
// useful flops in full float32 on the CUDA cores (67 TFLOP/s on the data
// sheet, no TF32) bind it: >= 0.306 ms; the tiles alone take >= 0.23 ms of
// HBM time, since finding the zeros means reading them.  At small k (K5,
// k = 32) the tiles' bytes dominate instead.
//
// K4/K8 (band_kernel below) run the body of band_body.cuh on the tile in
// every stream kind (float32, int32, bf16, bf16x3, float64): 32 x 128
// output blocks (one block row at bsz 32, all of k = 128, so each tile's A
// comes from device memory once), a cp.async ring, and a vote that skips
// the tile's all-zero 32 x 32 chunks (their B copy and multiply-adds),
// which brings the work issued at the bench shape back to the useful
// flops.  (Thread blocks over two 32-row blocks sharing each B chunk, on
// the wide body's 8 x 8 map or on this one, ran 10-60% slower in float32
// on an H100: tools/pair_probe.py, PERF.md section 6.)  bf16x3 keeps the
// float32 tiles and ring and splits each pair of fragments into three
// bf16 products on mma.sync (3 x 20.5 GFLOP at the bench band, a small
// share of the tensor cores' rate);
// its floor is the 768 MB of float32 tiles it must read to vote on them
// (>= 0.23 ms).  float64 votes on 64-bit words and multiplies on Hopper's
// m16n8k8 DMMA (the FP64 tensor cores, 67 TFLOP/s on the data sheet, twice
// the DFMA rate; a quarter of Ampere's m8n8k4 instructions, under which
// the vote route took 1.08 ms at the bench band and the kit route 0.88,
// where m16n8k8 takes 0.96 and 0.70 on an H100 SXM at 700 W), C in
// float64: its floor is the 1536 MB of float64 tiles it reads to vote, the
// 512 MB operand and the 512 MB output (>= 0.76 ms); the 20.5 GFLOP useful
// take >= 0.31 ms of the FP64 tensor cores.  bell_banded_issued launches
// the same body with a counter on the card: what the skip saves is
// measured.
//
// K4 on a kit (bell_spmm(plan=kit)): to find the zero chunks, the vote
// reads every chunk of the densified tiles, 2.4x the non-zero ones at the
// bench band (12 chunks a 32-row block, 5 of them with data).  A kit
// carries its tiles' chunk mask (BandedKit.chunk_nz, built once with the
// kit), so band_mask_kernel copies and multiplies the marked chunks only
// (band::run_masked: A and B of a chunk in one ring stage, one barrier a
// chunk): 640 of 1536 MB of float64 tiles read at the bench band, 320 of
// 768 in float32.  It keeps the vote's chunks in the vote's order, so its
// C and its count are band_kernel's, bit for bit.  Raw tiles without a kit
// (K4's tiles route, the BandedPlan route, K8) keep the vote.
//
// K5 (band_t_kernel below): at k = 32 it is bound by the tile bytes (769
// MB of transposed float32 tiles at the bench band, of which the 20
// non-zero 32 x 32 chunks per tile are 320 MB: >= 0.134 ms with the operand
// and C^T; twice that in float64).  So it does not vote on what it has
// read: it walks the kit's chunk mask, built once per kit, and copies only
// the non-zero chunks.  32-row blocks of k (no padding at k = 32), one
// 32-column slice of the tile per warp.  Five kinds: float32 (8x4 register
// tiles), int32 (the same tiles, multiply-adds in unsigned), bf16
// (mma.sync), bf16x3 (float32 stages in band_body.cuh's
// swizzled layouts, its split_chunk: three bf16 mma.sync products a float32
// pair) and float64 (band_body.cuh's dmma_chunk on DMMA, two stages).
// bell_banded_t_issued also counts the tile bytes it copied.
//
// Every int32 kind sums in unsigned, modulo 2^32: the reference's wrapping
// int32 result, in any order.  Integer multiply-adds issue at half the
// float32 rate on Hopper (64 INT32 lanes an SM against 128 FP32).
//
// Behaviour: a skipped chunk never multiplies the operand, so where B holds
// Inf or NaN opposite a densified zero the result is the sparse product's
// (what SciPy and BSR @ B give), not the NaN of the dense tile product.
// Every kind of K4, K5 and K8 skips.

#include "band_body.cuh"
#include "bell_kinds.cuh"

namespace {

using namespace bell;

// -- K4/K8 --------------------------------------------------------------------

// K4's and K8's launch geometry in the stream kind S: thread blocks of
// band::kThreads threads over 32 output rows and 128 columns, on band::run
// (band_kernel) and band::run_masked (band_mask_kernel).
template <typename S>
struct Dense {
  static constexpr int kBM = band::kBM;
  static constexpr int kThreads = band::kThreads;
  static constexpr int kMinBlocks = band::Cfg<S>::kMinBlocks;
  static constexpr int kSmem = band::smem_bytes<S>();
};

// A thread block's place in K4/K8's grid and its tile's address policy:
// block (tile, row block of kRows rows, 128-column block), column blocks
// fastest; bid is (tile, row block) as one index.
template <typename T>
struct DenseBlock {
  long long tile, bid;
  int m0, n0;
  band::DenseTile<T> p;
};

template <int kRows, typename T>
__device__ __forceinline__ DenseBlock<T> dense_block(
    const T* __restrict__ tiles, const int* __restrict__ start,
    const T* __restrict__ b, int M, int K, int N, int bsz,
    long long b_rows) {
  const int n_blocks = (N + band::kBN - 1) / band::kBN;
  const int m_blocks = (M + kRows - 1) / kRows;
  long long bid = blockIdx.x;
  const int n0 = static_cast<int>(bid % n_blocks) * band::kBN;
  bid /= n_blocks;
  const int m0 = static_cast<int>(bid % m_blocks) * kRows;
  const long long tile = bid / m_blocks;
  const long long row0 = static_cast<long long>(__ldg(start + tile)) * bsz;
  const long long left = b_rows - row0;  // window rows inside the operand
  const int rows_ok = left <= 0 ? 0 : left >= K ? K : static_cast<int>(left);
  return {tile, bid, m0, n0,
          {tiles + tile * M * K, rows_ok > 0 ? b + row0 * N : b, K, N,
           rows_ok}};
}

// tiles (ntiles, M, K) and b (b_rows, N) in the stream kind S's element
// type, C (ntiles*M, N) in Cfg<S>::Out (float64 for float64, float32
// otherwise).
template <typename S, bool VEC>
__global__ void __launch_bounds__(Dense<S>::kThreads, Dense<S>::kMinBlocks)
    band_kernel(const typename band::Cfg<S>::T* __restrict__ tiles,
                const int* __restrict__ start,
                const typename band::Cfg<S>::T* __restrict__ b,
                typename band::Cfg<S>::Out* __restrict__ c, int M, int K,
                int N, int bsz, long long b_rows,
                unsigned long long* __restrict__ issued) {
  const auto d =
      dense_block<Dense<S>::kBM>(tiles, start, b, M, K, N, bsz, b_rows);
  band::run<S, VEC>(d.p, c + d.tile * M * N, M, K, N, d.m0, d.n0, issued);
}

// band_kernel on a kit's tiles with its chunk mask (ntiles, ceil(M/32),
// ceil(K/32)) uint8: the body walks the marked chunks of its row block only
// (band::run_masked), bitwise band_kernel's C.
template <typename S, bool VEC>
__global__ void __launch_bounds__(Dense<S>::kThreads, Dense<S>::kMinBlocks)
    band_mask_kernel(const typename band::Cfg<S>::T* __restrict__ tiles,
                     const int* __restrict__ start,
                     const unsigned char* __restrict__ mask,
                     const typename band::Cfg<S>::T* __restrict__ b,
                     typename band::Cfg<S>::Out* __restrict__ c, int M, int K,
                     int N, int bsz, long long b_rows,
                     unsigned long long* __restrict__ issued) {
  const int nc = (K + band::Cfg<S>::kBK - 1) / band::Cfg<S>::kBK;
  const auto d =
      dense_block<Dense<S>::kBM>(tiles, start, b, M, K, N, bsz, b_rows);
  band::run_masked<S, VEC>(d.p, mask + d.bid * nc, c + d.tile * M * N, M, K,
                           N, d.m0, d.n0, issued);
}

template <typename S>
cudaError_t launch_band(const void* tiles, const void* start, const void* mask,
                        const void* b, void* c, long long ntiles, long long M,
                        long long K, long long N, long long bsz,
                        long long b_rows, unsigned long long* issued,
                        void* stream) {
  using band::kBN;
  using T = typename band::Cfg<S>::T;
  using O = typename band::Cfg<S>::Out;
  constexpr long long kMax = 0x7fffffffLL, kBM = Dense<S>::kBM;
  if (ntiles <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  // 32-bit index math inside a tile, its window and its output
  if (M * K > kMax || K * N > kMax || M * N > kMax)
    return cudaErrorInvalidValue;
  const long long grid = ntiles * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (grid > kMax) return cudaErrorInvalidConfiguration;
  constexpr long long V = 16 / sizeof(T);
  const bool vec = K % V == 0 && N % V == 0 && band::aligned16(tiles) &&
                   band::aligned16(b) && band::aligned16(c);
  constexpr int smem = Dense<S>::kSmem;
  // the mask, where there is one, goes between start and b
  auto go = [&](auto kern, auto... mask_arg) {
    const cudaError_t rc = band::allow_smem<smem>(kern);
    if (rc != cudaSuccess) return rc;
    kern<<<static_cast<unsigned>(grid), Dense<S>::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(tiles), static_cast<const int*>(start),
        mask_arg..., static_cast<const T*>(b), static_cast<O*>(c),
        static_cast<int>(M), static_cast<int>(K), static_cast<int>(N),
        static_cast<int>(bsz), b_rows, issued);
    return cudaGetLastError();
  };
  if (mask == nullptr)
    return go(vec ? band_kernel<S, true> : band_kernel<S, false>);
  return go(vec ? band_mask_kernel<S, true> : band_mask_kernel<S, false>,
            static_cast<const unsigned char*>(mask));
}

// The band body's stream kinds: float32, bf16, bf16x3, float64 and int32;
// band_mask_kernel where a chunk mask is given, band_kernel where it is null.
cudaError_t band_kinds(int kind, const void* tiles, const void* start,
                       const void* mask, const void* b, void* c,
                       long long ntiles, long long M, long long K, long long N,
                       long long bsz, long long b_rows,
                       unsigned long long* issued, void* stream) {
  return with_kind(kind, [&](auto s) {
    return launch_band<typename decltype(s)::type>(
        tiles, start, mask, b, c, ntiles, M, K, N, bsz, b_rows, issued,
        stream);
  });
}

// K4's / K8's launched geometry in kind S for tiles (., M, K) and N operand
// columns, 16-byte aligned arrays, the mask body where masked: out[0..4] =
// registers and local (spilled) bytes a thread, shared bytes a block
// (dynamic and static), resident blocks an SM and output rows a thread
// block, on the current device.
template <typename S>
cudaError_t band_geometry(bool masked, long long M, long long K, long long N,
                          int* out) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  constexpr long long V = 16 / sizeof(typename band::Cfg<S>::T);
  const bool vec = K % V == 0 && N % V == 0;
  constexpr int smem = Dense<S>::kSmem;
  auto read = [&](auto kern) {
    cudaError_t rc = band::allow_smem<smem>(kern);
    cudaFuncAttributes at;
    if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&at, kern);
    int per_sm = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, Dense<S>::kThreads, smem);
    if (rc != cudaSuccess) return rc;
    out[0] = at.numRegs;
    out[1] = static_cast<int>(at.localSizeBytes);
    out[2] = smem + static_cast<int>(at.sharedSizeBytes);
    out[3] = per_sm;
    out[4] = Dense<S>::kBM;
    return cudaSuccess;
  };
  if (masked)
    return vec ? read(band_mask_kernel<S, true>)
               : read(band_mask_kernel<S, false>);
  return vec ? read(band_kernel<S, true>) : read(band_kernel<S, false>);
}

// -- K5 ----------------------------------------------------------------------
//
// C^T (N, out_cols) = B^T window (N, K) @ tiles_t[t] (K, M) per tile: the
// operand is the dense factor and the tile the sparse one.  One thread
// block owns C^T rows n0 .. n0+31 (of k) and 128 of the tile's M columns,
// one 32-column slice per warp (at bsz 32 a slice is one block row).  The
// kit's chunk mask (ntiles, P = ceil(K/32), Q = ceil(M/32)) says which
// 32 x 32 chunks of the tile hold data; the block walks only the 32-row
// panels where one of its slices does, so an all-zero panel costs nothing.
// Each panel's operand chunk (32 x 32 of B^T's window) is shared by the
// block; each warp copies and multiplies its own slice's chunk only where
// the mask is set (warp-uniform, no divergence).  A cp.async ring keeps
// kStages - 1 panels in flight behind one barrier per panel.  Float32:
// 8x4 register tiles per thread in full float32; bf16: mma.sync m16n8k16,
// the operand chunk by ldmatrix, the tile chunk by ldmatrix.trans; bf16x3:
// float32 stages, the operand chunk in the layout of the band body's
// bf16x3 A and the tile chunk in that of its B, multiplied by its
// split_chunk (three bf16 products a float32 pair, float32 sums); float64:
// DMMA (mma.sync m8n8k4), C^T in float64.  Every output is written once
// after a fixed-order loop: bitwise repeatable.

namespace band_t {

constexpr int kBN = 32;     // C^T rows (columns of k) per thread block
constexpr int kBK = 32;     // contraction rows of a panel
constexpr int kSlice = 32;  // output columns per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = kSlice * kWarps;  // output columns per thread block

// Per stream kind S (float, int, __nv_bfloat16, band::Split, double): T, the
// element type in memory and in shared memory; Out, C^T's; kPitch, a
// staged row's length; op_at(r, c) and tile_at(r, c) place element (r, c)
// of the operand chunk and of a tile chunk in their stage.
template <typename S>
struct Cfg;
template <>
struct Cfg<float> {
  using T = float;
  using Out = float;
  using Bits = unsigned;
  using Acc = float[8][4];   // 8 rows x 4 columns of the warp's 32 x 32
  static constexpr int kPitch = 32;  // broadcast / 128-byte row reads
  static constexpr int kStages = 3;  // two panels in flight
  static constexpr int kMinBlocks = 3;
  __device__ static __forceinline__ int op_at(int r, int c) {
    return r * kPitch + c;
  }
  __device__ static __forceinline__ int tile_at(int r, int c) {
    return r * kPitch + c;
  }
};
// int32: the float32 kind's stages and tiles, multiply-adds in unsigned.
template <>
struct Cfg<int> {
  using T = int;
  using Out = int;
  using Bits = unsigned;
  using Acc = unsigned[8][4];
  static constexpr int kPitch = 32;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 3;
  __device__ static __forceinline__ int op_at(int r, int c) {
    return r * kPitch + c;
  }
  __device__ static __forceinline__ int tile_at(int r, int c) {
    return r * kPitch + c;
  }
};
template <>
struct Cfg<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using Out = float;
  using Bits = unsigned short;
  using Acc = float[2][4][4];  // 2 m16 x 4 n8 mma tiles per warp
  static constexpr int kPitch = 40;  // 80-byte rows: ldmatrix conflict-free
  static constexpr int kStages = 4;
  static constexpr int kMinBlocks = 4;
  __device__ static __forceinline__ int op_at(int r, int c) {
    return r * kPitch + c;
  }
  __device__ static __forceinline__ int tile_at(int r, int c) {
    return r * kPitch + c;
  }
};
// bf16x3: the float32 kind's ring (60 KB), the bf16 kind's mma tiles.
// Rows stay unpadded and swizzled as the band body's bf16x3 stages, so
// every fragment read of split_chunk meets 32 banks and 16-byte cp.async
// vectors stay whole.
template <>
struct Cfg<band::Split> {
  using T = float;
  using Out = float;
  using Bits = unsigned;
  using Acc = float[2][4][4];
  static constexpr int kPitch = 32;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 3;
  __device__ static __forceinline__ int op_at(int r, int c) {
    return band::split_a_at(r, c);
  }
  __device__ static __forceinline__ int tile_at(int r, int c) {
    return band::split_b_at<kPitch>(r, c);
  }
};
// float64 on DMMA (mma.sync m8n8k4): a stage is 40 KB, so two stages (one
// panel in flight behind the one being multiplied, 80 KB) let two blocks
// share an SM.  The operand chunk is the band body's float64 A, the tile
// chunk its B (band_body.cuh: dmma_a_at, dmma_b_at, swizzled so that every
// fragment read of dmma_chunk meets 32 banks a half warp, and 16-byte
// cp.async vectors stay whole).
template <>
struct Cfg<double> {
  using T = double;
  using Out = double;
  using Bits = unsigned long long;
  using Acc = double[4][4][2];  // 4 x 4 m8n8 tiles of the warp's 32 x 32
  static constexpr int kPitch = 32;
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = 2;
  __device__ static __forceinline__ int op_at(int r, int c) {
    return band::dmma_a_at(r, c);
  }
  __device__ static __forceinline__ int tile_at(int r, int c) {
    return band::dmma_b_at<kPitch>(r, c);
  }
};

// One stage: the operand chunk [kBN][kBK], then each warp's tile chunk
// [kBK][kSlice], every row kPitch long.
template <typename S>
__host__ __device__ constexpr int stage_elems() {
  return (1 + kWarps) * kBK * Cfg<S>::kPitch;
}
template <typename S>
constexpr int smem_bytes() {
  return Cfg<S>::kStages * stage_elems<S>() *
         static_cast<int>(sizeof(typename Cfg<S>::T));
}

// B^T rows n0 .. n0+31, window columns k0 .. k0+31 into the stage; rows >=
// N, window columns >= K and operand columns >= bt_cols read 0.
template <typename S, bool VEC>
__device__ __forceinline__ void load_op(typename Cfg<S>::T* so,
                                        const typename Cfg<S>::T* bt,
                                        long long bt_cols, int N, int n0,
                                        long long col0, int K, int k0) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kBK / V;
#pragma unroll
    for (int s = 0; s < kBN * kRow / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int r = e / kRow, c = (e % kRow) * V;
      const int gn = n0 + r, kk = k0 + c;
      const long long col = col0 + kk;
      const bool ok = gn < N && kk < K && col < bt_cols;
      sm90::cp_async16(so + Cf::op_at(r, c),
                       ok ? bt + gn * bt_cols + col : bt, ok);
    }
  } else {
    using B = typename Cf::Bits;
    const B* src = reinterpret_cast<const B*>(bt);
    B* dst = reinterpret_cast<B*>(so);
#pragma unroll 4
    for (int s = 0; s < kBN * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int gn = n0 + r, kk = k0 + c;
      const long long col = col0 + kk;
      dst[Cf::op_at(r, c)] =
          (gn < N && kk < K && col < bt_cols) ? src[gn * bt_cols + col] : B(0);
    }
  }
}

// This warp's chunk: tile rows k0 .. k0+31, columns i0 .. i0+31 (rows >= K
// and columns >= M read 0).
template <typename S, bool VEC>
__device__ __forceinline__ void load_tile(typename Cfg<S>::T* st,
                                          const typename Cfg<S>::T* tt,
                                          int M, int K, int k0, int i0) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  const int lane = threadIdx.x % 32;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kSlice / V;
#pragma unroll
    for (int s = 0; s < kBK * kRow / 32; ++s) {
      const int e = lane + s * 32;
      const int r = e / kRow, c = (e % kRow) * V;
      const int gk = k0 + r, gi = i0 + c;
      const bool ok = gk < K && gi < M;
      sm90::cp_async16(st + Cf::tile_at(r, c), ok ? tt + gk * M + gi : tt,
                       ok);
    }
  } else {
    using B = typename Cf::Bits;
    const B* src = reinterpret_cast<const B*>(tt);
    B* dst = reinterpret_cast<B*>(st);
    const int gi = i0 + lane;
#pragma unroll 4
    for (int r = 0; r < kBK; ++r) {
      const int gk = k0 + r;
      dst[Cf::tile_at(r, lane)] =
          (gk < K && gi < M) ? src[gk * M + gi] : B(0);
    }
  }
}

// acc += operand chunk (32 x 32) @ the warp's tile chunk (32 x 32),
// float32: lane l owns rows 8*(l/8) .. +7 and columns 4*(l%8) .. +3.
__device__ __forceinline__ void mma_slice(const float* so, const float* st,
                                          float (&acc)[8][4]) {
  constexpr int kP = Cfg<float>::kPitch;
  const int lane = threadIdx.x % 32;
  const float* pa = so + (lane / 8) * 8 * kP;
  const float* pb = st + (lane % 8) * 4;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      a[r] = *reinterpret_cast<const float4*>(pa + r * kP + kq);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = *reinterpret_cast<const float4*>(pb + (kq + q) * kP);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float x = q == 0 ? a[r].x : q == 1 ? a[r].y
                      : q == 2 ? a[r].z : a[r].w;
        acc[r][0] = fmaf(x, b.x, acc[r][0]);
        acc[r][1] = fmaf(x, b.y, acc[r][1]);
        acc[r][2] = fmaf(x, b.z, acc[r][2]);
        acc[r][3] = fmaf(x, b.w, acc[r][3]);
      }
    }
  }
}

// The same in int32, multiply-adds in unsigned.
__device__ __forceinline__ void mma_slice(const int* so, const int* st,
                                          unsigned (&acc)[8][4]) {
  constexpr int kP = Cfg<int>::kPitch;
  const int lane = threadIdx.x % 32;
  const int* pa = so + (lane / 8) * 8 * kP;
  const int* pb = st + (lane % 8) * 4;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    uint4 a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      a[r] = *reinterpret_cast<const uint4*>(pa + r * kP + kq);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 b = *reinterpret_cast<const uint4*>(pb + (kq + q) * kP);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const unsigned x = q == 0 ? a[r].x : q == 1 ? a[r].y
                         : q == 2 ? a[r].z : a[r].w;
        acc[r][0] += x * b.x;
        acc[r][1] += x * b.y;
        acc[r][2] += x * b.z;
        acc[r][3] += x * b.w;
      }
    }
  }
}

// The same in bf16 on the tensor cores: 2 x 4 m16n8 tiles per warp.
__device__ __forceinline__ void mma_slice(const __nv_bfloat16* so,
                                          const __nv_bfloat16* st,
                                          float (&acc)[2][4][4]) {
  constexpr int kP = Cfg<__nv_bfloat16>::kPitch;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      sm90::ldmatrix_x4(
          a[mt], so + (mt * 16 + lane % 16) * kP + ks + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned r[4];
      sm90::ldmatrix_x4_trans(
          r, st + (ks + (lane / 8) % 2 * 8 + lane % 8) * kP + np * 16 +
                 (lane / 16) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sm90::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
  }
}

// bf16x3 (float32 stages in Cfg<band::Split>'s layouts, the mma tiles'
// accumulator): the operand chunk is the split's A, the tile chunk its B
// (operand-hi x tile-lo is the hi*lo product, as in _tile_dot).
__device__ __forceinline__ void mma_slice(const float* so, const float* st,
                                          float (&acc)[2][4][4]) {
  band::split_chunk<Cfg<band::Split>::kPitch>(so, st, 0, acc);
}

// float64 (the band body's A and B layouts): its DMMA chunk step.
__device__ __forceinline__ void mma_slice(const double* so, const double* st,
                                          double (&acc)[4][4][2]) {
  band::dmma_chunk<Cfg<double>::kPitch>(so, st, 0, acc);
}

// C^T rows n0 + ., columns i0 + . of this warp's slice; ct points at the
// tile's first column, rows out_cols apart.
template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[8][4], float* ct,
                                      long long out_cols, int M, int N,
                                      int n0, int i0) {
  const int lane = threadIdx.x % 32;
  const int gi = i0 + (lane % 8) * 4;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gn = n0 + (lane / 8) * 8 + r;
    if (gn >= N) continue;
    float* row = ct + gn * out_cols;
    if constexpr (VEC) {
      if (gi < M)
        *reinterpret_cast<float4*>(row + gi) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gi + j < M) row[gi + j] = acc[r][j];
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store(const unsigned (&acc)[8][4], int* ct,
                                      long long out_cols, int M, int N,
                                      int n0, int i0) {
  const int lane = threadIdx.x % 32;
  const int gi = i0 + (lane % 8) * 4;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gn = n0 + (lane / 8) * 8 + r;
    if (gn >= N) continue;
    int* row = ct + gn * out_cols;
    if constexpr (VEC) {
      if (gi < M)
        *reinterpret_cast<uint4*>(row + gi) =
            make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gi + j < M) row[gi + j] = static_cast<int>(acc[r][j]);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[2][4][4], float* ct,
                                      long long out_cols, int M, int N,
                                      int n0, int i0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int gi = i0 + nt * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + mt * 16 + lane / 4 + h * 8;
        if (gn >= N) continue;
        float* row = ct + gn * out_cols;
        const float x = acc[mt][nt][2 * h], y = acc[mt][nt][2 * h + 1];
        if constexpr (VEC) {
          if (gi < M) *reinterpret_cast<float2*>(row + gi) = make_float2(x, y);
        } else {
          if (gi < M) row[gi] = x;
          if (gi + 1 < M) row[gi + 1] = y;
        }
      }
    }
}

template <bool VEC>
__device__ __forceinline__ void store(const double (&acc)[4][4][2],
                                      double* ct, long long out_cols, int M,
                                      int N, int n0, int i0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int gn = n0 + mt * 8 + lane / 4;
    if (gn >= N) continue;
    double* row = ct + gn * out_cols;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int gi = i0 + nt * 8 + (lane % 4) * 2;
      const double x = acc[mt][nt][0], y = acc[mt][nt][1];
      if constexpr (VEC) {
        if (gi < M) *reinterpret_cast<double2*>(row + gi) = make_double2(x, y);
      } else {
        if (gi < M) row[gi] = x;
        if (gi + 1 < M) row[gi + 1] = y;
      }
    }
  }
}

// tiles_t (ntiles, K, M) and bt (N, bt_cols) in the kind's element type T,
// mask (ntiles, P, Q) uint8, C^T (N, out_cols) in Out (float64 for
// float64, float32 otherwise).  Block (tile, 128-column block, 32-row
// block of k), k fastest.  counts, when given: [0] the multiply-adds
// issued (each multiplied chunk at its full 32 x 32 x 32, once for
// bf16x3), [1] the tile bytes copied (each copied chunk's elements inside
// the tile).
template <typename S, bool VEC>
__global__ void __launch_bounds__(kThreads, Cfg<S>::kMinBlocks)
    band_t_kernel(const typename Cfg<S>::T* __restrict__ tiles_t,
                  const int* __restrict__ start,
                  const unsigned char* __restrict__ mask,
                  const typename Cfg<S>::T* __restrict__ bt,
                  typename Cfg<S>::Out* __restrict__ ct, int M, int K, int N,
                  int bsz, long long bt_cols, long long out_cols,
                  unsigned long long* __restrict__ counts) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  constexpr int kS = Cf::kStages, kAhead = kS - 1, kP = Cf::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int n_blocks = (N + kBN - 1) / kBN;
  const int m_blocks = (M + kBM - 1) / kBM;
  long long bid = blockIdx.x;
  const int n0 = static_cast<int>(bid % n_blocks) * kBN;
  bid /= n_blocks;
  const int m0 = static_cast<int>(bid % m_blocks) * kBM;
  const long long tile = bid / m_blocks;
  const int warp = threadIdx.x / 32;
  const int i0 = m0 + warp * kSlice;  // this warp's slice
  const T* tt = tiles_t + tile * M * K;
  const long long col0 = static_cast<long long>(__ldg(start + tile)) * bsz;
  const int P = (K + kBK - 1) / kBK, Q = (M + kSlice - 1) / kSlice;
  const int q0 = m0 / kSlice;
  const unsigned char* mk = mask + tile * P * Q;
  // bit w: warp w's chunk of panel p holds data (uniform in the block)
  auto bits = [&](int p) {
    unsigned m = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (q0 + w < Q && __ldg(mk + p * Q + q0 + w) != 0) m |= 1u << w;
    return m;
  };
  auto next = [&](int p) {  // the first panel after p with data, or P
    for (++p; p < P && bits(p) == 0; ++p) {
    }
    return p;
  };
  auto stage = [&](int s) { return ring + s * stage_elems<S>(); };
  long long copied = 0;  // this warp's tile bytes
  auto fill = [&](int s, int p) {
    T* st = stage(s);
    load_op<S, VEC>(st, bt, bt_cols, N, n0, col0, K, p * kBK);
    if ((bits(p) >> warp) & 1u) {
      load_tile<S, VEC>(st + (1 + warp) * kBK * kP, tt, M, K, p * kBK, i0);
      copied += static_cast<long long>(min(kBK, K - p * kBK)) *
                min(kSlice, M - i0) * static_cast<int>(sizeof(T));
    }
  };
  typename Cf::Acc acc = {};
  int pl = next(-1);  // the next panel to copy
  int pc = pl;        // the next panel to multiply
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (pl < P) {
      fill(s, pl);
      pl = next(pl);
    }
    sm90::cp_async_commit();
  }
  int kept = 0;  // chunks this warp multiplied
  for (int it = 0; pc < P; ++it) {
    // one group per step: panel it has landed once kAhead - 1 younger
    // ones may still be in flight; the barrier also says every warp is
    // done reading the stage refilled below (panel it - 1's)
    sm90::cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (pl < P) {
      fill((it + kAhead) % kS, pl);
      pl = next(pl);
    }
    sm90::cp_async_commit();
    if ((bits(pc) >> warp) & 1u) {
      const T* st = stage(it % kS);
      mma_slice(st, st + (1 + warp) * kBK * kP, acc);
      ++kept;
    }
    pc = next(pc);
  }
  sm90::cp_async_wait<0>();
  store<VEC>(acc, ct + tile * M, out_cols, M, N, n0, i0);
  if (counts != nullptr && threadIdx.x % 32 == 0 && kept > 0) {
    atomicAdd(counts, static_cast<unsigned long long>(kept) * kBN * kBK *
                          kSlice);
    atomicAdd(counts + 1, static_cast<unsigned long long>(copied));
  }
}

template <typename S>
cudaError_t launch(const void* tiles_t, const void* start, const void* mask,
                   const void* bt, void* ct, long long ntiles, long long M,
                   long long K, long long N, long long bsz,
                   long long bt_cols, unsigned long long* counts,
                   void* stream) {
  using T = typename Cfg<S>::T;
  constexpr long long kMax = 0x7fffffffLL;
  if (ntiles <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  if (M * K > kMax) return cudaErrorInvalidValue;  // 32-bit inside a tile
  const long long grid = ntiles * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (grid > kMax) return cudaErrorInvalidConfiguration;
  constexpr long long V = 16 / sizeof(T);
  // 16-byte copies: tile rows and operand rows in whole vectors, each
  // window's first column (start*bsz) on a vector
  const bool vec = M % V == 0 && K % V == 0 && bsz % V == 0 &&
                   bt_cols % V == 0 && band::aligned16(tiles_t) &&
                   band::aligned16(bt) && band::aligned16(ct);
  auto kern = vec ? band_t_kernel<S, true> : band_t_kernel<S, false>;
  constexpr int smem = smem_bytes<S>();
  const cudaError_t rc = band::allow_smem<smem>(kern);
  if (rc != cudaSuccess) return rc;
  kern<<<static_cast<unsigned>(grid), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tiles_t), static_cast<const int*>(start),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(bt),
      static_cast<typename Cfg<S>::Out*>(ct), static_cast<int>(M),
      static_cast<int>(K), static_cast<int>(N), static_cast<int>(bsz),
      bt_cols, ntiles * M, counts);
  return cudaGetLastError();
}

}  // namespace band_t

// K5's five stream kinds, all on band_t_kernel; counts may be null.
cudaError_t band_t_kinds(int kind, const void* tiles_t, const void* start,
                         const void* mask, const void* bt, void* ct,
                         long long ntiles, long long M, long long K,
                         long long N, long long bsz, long long bt_cols,
                         unsigned long long* counts, void* stream) {
  return with_kind(kind, [&](auto s) {
    return band_t::launch<typename decltype(s)::type>(
        tiles_t, start, mask, bt, ct, ntiles, M, K, N, bsz, bt_cols, counts,
        stream);
  });
}

}  // namespace

extern "C" {

// kind as in bell_spmm.cu (bell_kinds.cuh).  tiles (ntiles, M, K) and b
// (b_rows, N) in the stream type, start (ntiles,) int32, C (ntiles*M, N) in
// float32 (float64 for kind 3, int32 for kind 4).  Every kind runs
// band_kernel.  Returns cudaGetLastError() after the launch, or the error
// of a shape the kernel cannot index.
int bell_banded(int kind, const void* tiles, const void* start,
                const void* b, void* c, long long ntiles, long long M,
                long long K, long long N, long long bsz, long long b_rows,
                void* stream) {
  return band_kinds(kind, tiles, start, nullptr, b, c, ntiles, M, K, N, bsz,
                    b_rows, nullptr, stream);
}

// bell_banded, also adding to *issued (on the card, zeroed by the caller)
// the multiply-adds the body issues: kBM x kBK x kBN for every chunk its
// vote kept (once for bf16x3, whose three products a pair are the same
// multiply-adds split), in every kind.
int bell_banded_issued(int kind, const void* tiles, const void* start,
                       const void* b, void* c, long long ntiles, long long M,
                       long long K, long long N, long long bsz,
                       long long b_rows, void* issued, void* stream) {
  return band_kinds(kind, tiles, start, nullptr, b, c, ntiles, M, K, N, bsz,
                    b_rows, static_cast<unsigned long long*>(issued), stream);
}

// bell_banded on a kit's tiles with its chunk mask (ntiles, ceil(M/32),
// ceil(K/32)) uint8, 1 where a 32 x 32 chunk holds a non-zero element:
// every kind runs band_mask_kernel, which copies and multiplies the marked
// chunks only.  The same C as bell_banded where the mask is the tiles' own.
int bell_banded_masked(int kind, const void* tiles, const void* start,
                       const void* mask, const void* b, void* c,
                       long long ntiles, long long M, long long K,
                       long long N, long long bsz, long long b_rows,
                       void* stream) {
  return band_kinds(kind, tiles, start, mask, b, c, ntiles, M, K, N, bsz,
                    b_rows, nullptr, stream);
}

// bell_banded_masked, also adding to *issued the multiply-adds of every
// chunk it multiplied, counted as bell_banded_issued counts them.
int bell_banded_masked_issued(int kind, const void* tiles, const void* start,
                              const void* mask, const void* b, void* c,
                              long long ntiles, long long M, long long K,
                              long long N, long long bsz, long long b_rows,
                              void* issued, void* stream) {
  return band_kinds(kind, tiles, start, mask, b, c, ntiles, M, K, N, bsz,
                    b_rows, static_cast<unsigned long long*>(issued), stream);
}

// K4's / K8's launched geometry in kind `kind` for tiles (., M, K) and N
// operand columns (16-byte aligned arrays), band_mask_kernel's where masked
// is not 0, band_kernel's where it is: out[0..4] = registers and local
// bytes a thread, shared bytes a block, resident blocks an SM and output
// rows a thread block, on the current device.  Returns a cudaError_t.
int bell_banded_geometry(int kind, int masked, long long M, long long K,
                         long long N, int* out) {
  return bell::with_kind(kind, [&](auto s) {
    return band_geometry<typename decltype(s)::type>(masked != 0, M, K, N,
                                                     out);
  });
}

// tiles_t (ntiles, K, M) and bt (N, bt_cols) in the stream type, mask
// (ntiles, ceil(K/32), ceil(M/32)) uint8, C^T (N, ntiles*M) in float32
// (float64 for kind 3, int32 for kind 4).  Every kind runs band_t_kernel.
int bell_banded_t(int kind, const void* tiles_t, const void* start,
                  const void* mask, const void* bt, void* ct,
                  long long ntiles, long long M, long long K, long long N,
                  long long bsz, long long bt_cols, void* stream) {
  return band_t_kinds(kind, tiles_t, start, mask, bt, ct, ntiles, M, K, N,
                      bsz, bt_cols, nullptr, stream);
}

// bell_banded_t, also adding to counts[0] the multiply-adds the body issues
// (kBN x kBK x kSlice for every chunk a warp multiplied, once for bf16x3)
// and to counts[1] the tile bytes it copied, at the kind's element width
// (on the card, zeroed by the caller).
int bell_banded_t_issued(int kind, const void* tiles_t, const void* start,
                         const void* mask, const void* bt, void* ct,
                         long long ntiles, long long M, long long K,
                         long long N, long long bsz, long long bt_cols,
                         void* counts, void* stream) {
  return band_t_kinds(kind, tiles_t, start, mask, bt, ct, ntiles, M, K, N,
                      bsz, bt_cols, static_cast<unsigned long long*>(counts),
                      stream);
}

}  // extern "C"
