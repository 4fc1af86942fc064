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
// K4/K8 for float32 and bf16 streams (band_kernel below): one thread block
// owns 32 output rows of one tile (one block row at bsz 32, so its chunks
// line up with the band's panels) and 128 output columns (all of k = 128,
// so each tile's A comes from device memory once).  The contraction runs in
// 32-column chunks through a ring in shared memory filled by cp.async: A two
// chunks ahead, B one.  Once a chunk of A has landed the block takes one
// vote (__syncthreads_or, the loop's only barrier): a chunk that is zero
// throughout skips its B copy and its multiply-adds, which brings the work
// issued at the bench shape back to the useful flops.  The vote reads A
// only, so the result stays bitwise repeatable, and a NaN stored in A
// counts as non-zero.  Float32: each thread keeps an 8x4 register tile, fed
// by broadcast 16-byte shared loads, in full float32.  bf16 (tiles and
// operand bf16, sums float32): the same tiling feeds mma.sync m16n8k16 from
// ldmatrix fragments, each warp a 32x32 piece.  Index math is 32-bit inside
// a tile; copies are 16-byte vectors, with a masked element path where k,
// W*bsz or a pointer's alignment does not allow them.  Every output is
// written once, after one fixed-order loop: no atomics on the output.
// bell_banded_issued launches the same body with a counter on the card, to
// which each thread block adds the multiply-adds of the chunks its vote
// kept: what the skip saves is measured, not modelled.
//
// Behaviour: a skipped chunk never multiplies the operand, so where B holds
// Inf or NaN opposite a densified zero the result is the sparse product's
// (what SciPy and BSR @ B give), not the NaN of the dense tile product.
//
// The float64 and bf16x3 kinds of K4/K8, and K5, stay on the first body
// (bell_common.cuh): a thread block owns one (row tile, 64-row block,
// 64-column chunk of k) output tile, stages A and B in shared memory 16 deep
// and keeps a 4x4 register tile per thread.

#include "bell_common.cuh"
#include "sm90_async.cuh"

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

// -- K4/K8 for float32 and bf16 streams ---------------------------------------

namespace band {

constexpr int kBM = 32;        // output rows per thread block
constexpr int kBN = 128;       // output columns per thread block
constexpr int kThreads = 128;  // four warps

// Per stream type: kBK, the contraction chunk (one vote each); kVote, how
// many chunks ahead of the one being multiplied the block votes (and starts
// that chunk's B copy); kAhead (> kVote), how many ahead A is copied.  The
// rings hold what is in flight plus what is being read.
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  using Bits = unsigned;
  using Acc = float[8][4];              // 8 rows x 4 columns per thread
  static constexpr unsigned kWord = 0x7fffffffu;  // magnitude bits
  static constexpr int kBK = 32;
  static constexpr int kAPitch = kBK;   // fragments are broadcast loads
  static constexpr int kBPitch = kBN;
  static constexpr int kVote = 1, kAhead = 2;
  static constexpr int kAStages = kAhead + 2, kBStages = kVote + 1;
  static constexpr int kMinBlocks = 4;  // per SM: at most 128 registers
};
template <>
struct Cfg<__nv_bfloat16> {
  using Bits = unsigned short;
  using Acc = float[2][4][4];           // 2 m16 x 4 n8 mma tiles per warp
  static constexpr unsigned kWord = 0x7fff7fffu;
  static constexpr int kBK = 32;
  static constexpr int kAPitch = kBK + 8;  // 80-byte rows: ldmatrix without
  static constexpr int kBPitch = kBN + 8;  // bank conflicts (272-byte rows)
  static constexpr int kVote = 2, kAhead = 3;  // the multiply is short
  static constexpr int kAStages = kAhead + 2, kBStages = kVote + 1;
  static constexpr int kMinBlocks = 4;
};

template <typename T>
constexpr int smem_bytes() {
  return (Cfg<T>::kAStages * kBM * Cfg<T>::kAPitch +
          Cfg<T>::kBStages * Cfg<T>::kBK * Cfg<T>::kBPitch) *
         static_cast<int>(sizeof(T));
}

// A[m0 : m0+32, k0 : k0+32] of one tile (M, K) into a stage; rows >= M and
// columns >= K are zero.  VEC: 16-byte cp.async, else one element at a time.
template <typename T, bool VEC>
__device__ __forceinline__ void load_a(T* sa, const T* a, int M, int K,
                                       int m0, int k0) {
  constexpr int kP = Cfg<T>::kAPitch, kBK = Cfg<T>::kBK;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kBK / V;
#pragma unroll
    for (int s = 0; s < kBM * kRow / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int i = e / kRow, col = (e % kRow) * V;
      const int gi = m0 + i, gk = k0 + col;
      const bool ok = gi < M && gk < K;
      sm90::cp_async16(sa + i * kP + col, ok ? a + gi * K + gk : a, ok);
    }
  } else {
    using B = typename Cfg<T>::Bits;
    const B* src = reinterpret_cast<const B*>(a);
    B* dst = reinterpret_cast<B*>(sa);
#pragma unroll 4
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int i = e / kBK, col = e % kBK;
      const int gi = m0 + i, gk = k0 + col;
      dst[i * kP + col] = (gi < M && gk < K) ? src[gi * K + gk] : B(0);
    }
  }
}

// Whether any element this thread copied by load_a is non-zero (NaN is).
template <typename T, bool VEC>
__device__ __forceinline__ bool mine_nonzero(const T* sa) {
  constexpr int kP = Cfg<T>::kAPitch, kBK = Cfg<T>::kBK;
  const int tid = threadIdx.x;
  unsigned any = 0;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kBK / V;
#pragma unroll
    for (int s = 0; s < kBM * kRow / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const uint4 w = *reinterpret_cast<const uint4*>(
          sa + (e / kRow) * kP + (e % kRow) * V);
      any |= (w.x | w.y | w.z | w.w) & Cfg<T>::kWord;
    }
  } else {
    using B = typename Cfg<T>::Bits;
    const B* src = reinterpret_cast<const B*>(sa);
#pragma unroll 4
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      any |= src[(e / kBK) * kP + e % kBK] & Cfg<T>::kWord;
    }
  }
  return any != 0;
}

// Operand rows k0 .. k0+31 of the tile's window bw (rows >= rows_ok read
// 0), columns n0 .. n0+127 (columns >= N read 0), into a stage.
template <typename T, bool VEC>
__device__ __forceinline__ void load_b(T* sb, const T* bw, int rows_ok, int N,
                                       int k0, int n0) {
  constexpr int kP = Cfg<T>::kBPitch, kBK = Cfg<T>::kBK;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kBN / V;
#pragma unroll
    for (int s = 0; s < kBK * kRow / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int kk = e / kRow, col = (e % kRow) * V;
      const int gk = k0 + kk, gn = n0 + col;
      const bool ok = gk < rows_ok && gn < N;
      sm90::cp_async16(sb + kk * kP + col, ok ? bw + gk * N + gn : bw, ok);
    }
  } else {
    using B = typename Cfg<T>::Bits;
    const B* src = reinterpret_cast<const B*>(bw);
    B* dst = reinterpret_cast<B*>(sb);
#pragma unroll 4
    for (int s = 0; s < kBK * kBN / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int kk = e / kBN, col = e % kBN;
      const int gk = k0 + kk, gn = n0 + col;
      dst[kk * kP + col] = (gk < rows_ok && gn < N) ? src[gk * N + gn] : B(0);
    }
  }
}

// acc += A chunk (32 x 32) @ B chunk (32 x 128), float32: thread (warp w,
// lane l) owns rows 8w .. 8w+7 and columns 4l .. 4l+3.
__device__ __forceinline__ void mma_chunk(const float* sa, const float* sb,
                                          float (&acc)[8][4]) {
  constexpr int kBK = Cfg<float>::kBK;
  const float* pa = sa + (threadIdx.x / 32) * 8 * kBK;
  const float* pb = sb + (threadIdx.x % 32) * 4;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      a[r] = *reinterpret_cast<const float4*>(pa + r * kBK + kq);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = *reinterpret_cast<const float4*>(pb + (kq + q) * kBN);
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

// The same for bf16 on the tensor cores: warp w owns all 32 rows and
// columns 32w .. 32w+31, as 2 x 4 m16n8 tiles.
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* sa,
                                          const __nv_bfloat16* sb,
                                          float (&acc)[2][4][4]) {
  constexpr int kPA = Cfg<__nv_bfloat16>::kAPitch;
  constexpr int kPB = Cfg<__nv_bfloat16>::kBPitch;
  constexpr int kBK = Cfg<__nv_bfloat16>::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      sm90::ldmatrix_x4(
          a[mt], sa + (mt * 16 + lane % 16) * kPA + ks + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned r[4];
      sm90::ldmatrix_x4_trans(
          r, sb + (ks + (lane / 8) % 2 * 8 + lane % 8) * kPB + warp * 32 +
                 np * 16 + (lane / 16) * 8);
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

// C[m0 + ., n0 + .] of one tile's output (M, N) from the register tiles.
template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[8][4], float* c,
                                      int M, int N, int m0, int n0) {
  const int gn = n0 + (threadIdx.x % 32) * 4;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gi = m0 + (threadIdx.x / 32) * 8 + r;
    if (gi >= M) continue;
    float* row = c + gi * N;
    if constexpr (VEC) {
      if (gn < N)
        *reinterpret_cast<float4*>(row + gn) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) row[gn + j] = acc[r][j];
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[2][4][4], float* c,
                                      int M, int N, int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int gn = n0 + warp * 32 + nt * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = m0 + mt * 16 + lane / 4 + h * 8;
        if (gi >= M) continue;
        float* row = c + gi * N;
        const float x = acc[mt][nt][2 * h], y = acc[mt][nt][2 * h + 1];
        if constexpr (VEC) {
          if (gn < N) *reinterpret_cast<float2*>(row + gn) = make_float2(x, y);
        } else {
          if (gn < N) row[gn] = x;
          if (gn + 1 < N) row[gn + 1] = y;
        }
      }
    }
}

// tiles (ntiles, M, K) and b (b_rows, N) in the stream type T, C
// (ntiles*M, N) float32.  Block (tile, 32-row block, 128-column block),
// column blocks fastest.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kMinBlocks)
    band_kernel(const T* __restrict__ tiles, const int* __restrict__ start,
                const T* __restrict__ b, float* __restrict__ c, int M, int K,
                int N, int bsz, long long b_rows,
                unsigned long long* __restrict__ issued) {
  using Cf = Cfg<T>;
  constexpr int kVote = Cf::kVote, kAhead = Cf::kAhead, kBK = Cf::kBK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kBM * Cf::kAPitch;
  const int n_blocks = (N + kBN - 1) / kBN;
  const int m_blocks = (M + kBM - 1) / kBM;
  long long bid = blockIdx.x;
  const int n0 = static_cast<int>(bid % n_blocks) * kBN;
  bid /= n_blocks;
  const int m0 = static_cast<int>(bid % m_blocks) * kBM;
  const long long tile = bid / m_blocks;
  const T* a = tiles + tile * M * K;
  const long long row0 = static_cast<long long>(__ldg(start + tile)) * bsz;
  const long long left = b_rows - row0;  // window rows inside the operand
  const int rows_ok = left <= 0 ? 0 : left >= K ? K : static_cast<int>(left);
  const T* bw = rows_ok > 0 ? b + row0 * N : b;
  const int nc = (K + kBK - 1) / kBK;
  typename Cf::Acc acc = {};
  auto stage_a = [&](int ch) {
    return sa + (ch % Cf::kAStages) * kBM * Cf::kAPitch;
  };
  auto stage_b = [&](int ch) {
    return sb + (ch % Cf::kBStages) * kBK * Cf::kBPitch;
  };
  auto vote = [&](int ch) {  // the loop's only barrier
    const bool nz =
        __syncthreads_or(ch < nc && mine_nonzero<T, VEC>(stage_a(ch)));
    if (nz) load_b<T, VEC>(stage_b(ch), bw, rows_ok, N, ch * kBK, n0);
    return nz;
  };
  // Step it copies A(it + kAhead), votes on chunk it + kVote and copies its
  // B, then multiplies chunk it; the first kAhead steps only fill the ring.
  // Each thread commits two cp.async groups per step, A's then B's (empty
  // where there is nothing to copy), so the wait before a vote can leave in
  // flight only what is younger than A(it + kVote) and B(it).
  constexpr int kWait = 2 * (kAhead - kVote) < 2 * kVote - 1
                            ? 2 * (kAhead - kVote) : 2 * kVote - 1;
  unsigned nzq = 0;  // bit i: chunk it + i is non-zero
  int kept = 0;      // chunks multiplied
  for (int it = -kAhead; it < nc; ++it) {
    // stage (it + kAhead) % kAStages was last read by chunk it - 2, before
    // the last barrier; B's stage by chunk it - 1, before this step's one
    if (it + kAhead < nc)
      load_a<T, VEC>(stage_a(it + kAhead), a, M, K, m0, (it + kAhead) * kBK);
    sm90::cp_async_commit();
    if (it + kVote >= 0) {
      sm90::cp_async_wait<kWait>();
      nzq |= static_cast<unsigned>(vote(it + kVote)) << kVote;
    }
    sm90::cp_async_commit();
    if (it >= 0 && (nzq & 1u)) {
      mma_chunk(stage_a(it), stage_b(it), acc);
      ++kept;
    }
    nzq >>= 1;
  }
  sm90::cp_async_wait<0>();
  store<VEC>(acc, c + tile * M * N, M, N, m0, n0);
  // each kept chunk at its full size, padding rows and columns included
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

template <typename T>
cudaError_t launch(const void* tiles, const void* start, const void* b,
                   void* c, long long ntiles, long long M, long long K,
                   long long N, long long bsz, long long b_rows,
                   unsigned long long* issued, void* stream) {
  constexpr long long kMax = 0x7fffffffLL;
  if (ntiles <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  // 32-bit index math inside a tile, its window and its output
  if (M * K > kMax || K * N > kMax || M * N > kMax)
    return cudaErrorInvalidValue;
  const long long grid = ntiles * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (grid > kMax) return cudaErrorInvalidConfiguration;
  constexpr long long V = 16 / sizeof(T);
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = K % V == 0 && N % V == 0 && aligned(tiles) &&
                   aligned(b) && aligned(c);
  auto kern = vec ? band_kernel<T, true> : band_kernel<T, false>;
  constexpr int smem = smem_bytes<T>();
  if constexpr (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  kern<<<static_cast<unsigned>(grid), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(start),
      static_cast<const T*>(b), static_cast<float*>(c), static_cast<int>(M),
      static_cast<int>(K), static_cast<int>(N), static_cast<int>(bsz),
      b_rows, issued);
  return cudaGetLastError();
}

}  // namespace band

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
// for kind 3).  Float32 and bf16 streams run band_kernel, the others the
// first body.  Returns cudaGetLastError() after the launch, or the error of
// a shape the kernel cannot index.
int bell_banded(int kind, const void* tiles, const void* start,
                const void* b, void* c, long long ntiles, long long M,
                long long K, long long N, long long bsz, long long b_rows,
                void* stream) {
  switch (kind) {
    case kF32:
      return band::launch<float>(tiles, start, b, c, ntiles, M, K, N, bsz,
                                 b_rows, nullptr, stream);
    case kBF16:
      return band::launch<__nv_bfloat16>(tiles, start, b, c, ntiles, M, K,
                                         N, bsz, b_rows, nullptr, stream);
    default:
      return dispatch(kind, false, tiles, start, b, c, ntiles, M, K, N, bsz,
                      b_rows, 0, stream);
  }
}

// bell_banded for the float32 and bf16 kinds (others return
// cudaErrorInvalidValue), also adding to *issued (on the card, zeroed by
// the caller) the multiply-adds the body issues: kBM x kBK x kBN for every
// chunk its vote kept.
int bell_banded_issued(int kind, const void* tiles, const void* start,
                       const void* b, void* c, long long ntiles, long long M,
                       long long K, long long N, long long bsz,
                       long long b_rows, void* issued, void* stream) {
  auto* count = static_cast<unsigned long long*>(issued);
  switch (kind) {
    case kF32:
      return band::launch<float>(tiles, start, b, c, ntiles, M, K, N, bsz,
                                 b_rows, count, stream);
    case kBF16:
      return band::launch<__nv_bfloat16>(tiles, start, b, c, ntiles, M, K,
                                         N, bsz, b_rows, count, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
