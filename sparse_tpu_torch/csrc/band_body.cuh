// The body of the blocked-ELL SpMM kernels K3 (bell_spmm.cu), K4 and K8
// (bell_banded.cu) for float32, int32, bf16, bf16x3 and float64 streams:
// C (M, N) = A (M, K) @ B (K, N) for one output matrix, where A is a
// mostly-zero band and B the dense operand.  The kernels differ only in
// where A's rows and B's rows live, which an address policy says
// (DenseTile: K4/K8's densified tile and operand window; WideRow: K3's
// block row [A_r0 | ... | A_r,Lb-1] and the operand panels its slots name).
//
// A tile is 32 output rows and 128 output columns.  Its contraction runs in
// 32-index chunks through a ring in shared memory filled by cp.async: A
// kAhead chunks ahead, B one chunk (kVote) ahead.  Once a chunk of A has
// landed the block takes one vote (__syncthreads_or, the loop's only
// barrier): a chunk that is zero throughout skips its B copy and its
// multiply-adds.  The vote reads A only, so the result stays bitwise
// repeatable, and reads magnitude bits, so a NaN stored in A counts as
// non-zero and -0 does not.  K4 and K8, and K3 in float32 and int32, run a
// tile a thread block (run, run_masked).  K3's bf16, bf16x3 and float64
// kinds (run_tiles) launch at most the thread blocks resident at once,
// each walking its tiles in order with one ring across them, so that the
// next tile's first chunks are in flight while the last chunk of the
// current one multiplies (bell_spmm.cu's kWalks says which kinds, and why).
// Float32: each thread keeps an 8x4 register tile
// fed by 16-byte shared loads, A's as warp-wide broadcasts, in full float32
// (no TF32): 8 shared-memory cycles per 32 FFMA instructions of a warp,
// the fewest a 32-accumulator map can cost (mma_chunk).  int32 (A, B and C
// int32): the float32 kind's ring, tiling and map (one mma_chunk and one
// store for both), integer multiply-adds in unsigned (sums modulo 2^32, the
// reference's wrapping int32 result), a vote on every bit of a word.  bf16
// (A and B bf16, sums float32): the same tiling feeds mma.sync m16n8k16 from
// ldmatrix fragments, each warp a 32x32 piece.  bf16x3 (the Split kind:
// float32 A and B, precision="bf16x3"): the float32 ring and vote, and the
// bf16 kind's mma.sync tiling; each thread splits its float32 fragments in
// registers into a bf16 high part and a bf16 residual and issues three
// products into one float32 accumulator, hi*hi, hi*lo and lo*hi (lo*lo is
// dropped), as sparse_tpu/ops/pallas_bell.py::_dot_bf16x3 defines them
// (split_chunk, which K5's bf16x3 kind in bell_banded.cu and K6's in
// block_body.cuh share).  float64 (A, B and C float64): the same ring and
// vote on 64-bit words, each warp's 32 x 32 piece on Hopper's DMMA
// (mma.sync m16n8k8, 32 instructions a warp a chunk where Ampere's m8n8k4
// takes 128: K3's multiply-adds alone took 0.44-0.46 ms at bell-band-80M
// where m8n8k4's took 0.69, on an H100 SXM at 700 W, tools/k3_probe.py)
// from swizzled stages; dmma_chunk, m8n8k4 on the same stages, stays for
// K5's and K6's float64 kinds.  Copies are 16-byte vectors (VEC), or one
// element at a time where a shape or a pointer's alignment does not allow
// them.  Every output
// is written once, after its tile's fixed-order loop: no atomics on the
// output.  With a counter, each thread block adds the multiply-adds of the
// chunks its vote kept, at their full size (once for bf16x3: the useful
// products).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sm90_async.cuh"
#include "sm90_tma.cuh"

namespace band {

constexpr int kBM = 32;        // output rows per thread block
constexpr int kBN = 128;       // output columns per thread block
constexpr int kThreads = 128;  // four warps

// The bf16x3 stream kind: float32 in memory and in shared memory, three
// bf16 products on the tensor cores.
struct Split {};

// Per stream kind S (float, int, __nv_bfloat16, Split, double): T, the element
// type in memory and in shared memory; Out, C's; kBK, the contraction chunk
// (one vote each);
// kVote, how many chunks ahead of the one being multiplied the block votes
// (and starts that chunk's B copy); kAhead (> kVote), how many ahead A is
// copied.  The rings hold what is in flight plus what is being read.
// a_at(i, c) and b_at(kk, c) place A's element (i, c) and B's (kk, c) of a
// chunk in its stage.
template <typename S>
struct Cfg;
template <>
struct Cfg<float> {
  using T = float;
  using Out = float;
  using Bits = unsigned;
  using Acc = float[8][4];              // 8 rows x 4 columns per thread
  static constexpr unsigned kWord = 0x7fffffffu;  // magnitude bits
  static constexpr int kBK = 32;
  static constexpr int kAPitch = kBK;   // fragments are broadcast loads
  static constexpr int kBPitch = kBN;
  static constexpr int kVote = 1, kAhead = 2;
  static constexpr int kAStages = kAhead + 2, kBStages = kVote + 1;
  static constexpr int kMinBlocks = 4;  // per SM: at most 128 registers
  __device__ static __forceinline__ int a_at(int i, int c) {
    return i * kAPitch + c;
  }
  __device__ static __forceinline__ int b_at(int kk, int c) {
    return kk * kBPitch + c;
  }
};
// int32: the float32 kind's ring, register map and broadcast loads, with
// integer multiply-adds in unsigned (sums modulo 2^32, the reference's
// wrapping int32 result in any order) and C int32.  Every bit of a word
// counts in the vote: an int has no -0 and no NaN.
template <>
struct Cfg<int> {
  using T = int;
  using Out = int;
  using Bits = unsigned;
  using Acc = unsigned[8][4];
  static constexpr unsigned kWord = 0xffffffffu;
  static constexpr int kBK = 32;
  static constexpr int kAPitch = kBK;
  static constexpr int kBPitch = kBN;
  static constexpr int kVote = 1, kAhead = 2;
  static constexpr int kAStages = kAhead + 2, kBStages = kVote + 1;
  static constexpr int kMinBlocks = 4;
  __device__ static __forceinline__ int a_at(int i, int c) {
    return i * kAPitch + c;
  }
  __device__ static __forceinline__ int b_at(int kk, int c) {
    return kk * kBPitch + c;
  }
};
template <>
struct Cfg<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using Out = float;
  using Bits = unsigned short;
  using Acc = float[2][4][4];           // 2 m16 x 4 n8 mma tiles per warp
  static constexpr unsigned kWord = 0x7fff7fffu;
  static constexpr int kBK = 32;
  static constexpr int kAPitch = kBK + 8;  // 80-byte rows: ldmatrix without
  static constexpr int kBPitch = kBN + 8;  // bank conflicts (272-byte rows)
  static constexpr int kVote = 2, kAhead = 3;  // the multiply is short
  static constexpr int kAStages = kAhead + 2, kBStages = kVote + 1;
  static constexpr int kMinBlocks = 4;
  __device__ static __forceinline__ int a_at(int i, int c) {
    return i * kAPitch + c;
  }
  __device__ static __forceinline__ int b_at(int kk, int c) {
    return kk * kBPitch + c;
  }
};
// bf16x3: the float32 kind's ring (48 KB at 4 A and 2 B stages) and the
// bf16 kind's tiling.  A thread reads its mma fragments as float32 from
// shared memory: A's as 8-byte pairs along the contraction (rows g, g+8 of
// a 16-row tile, columns 2t, 2t+1 and 2t+8, 2t+9, for lane 4g + t), B's
// one element at a time (rows 2t, 2t+1, 2t+8, 2t+9, column g).  Unpadded
// rows would put those reads on 2 to 8 threads a bank, and padding them
// (A to 40, B to 132 floats) would cost 53 KB, so the rows stay unpadded
// and a row's columns are swizzled (split_a_at, split_b_at): column c of
// A's row i sits at c ^ 8 * (i % 4), of B's row kk at c ^ 8 * (kk / 2 %
// 4).  Every read of a fragment then meets 32 distinct banks (per half
// warp for A's 8-byte reads), and a 16-byte vector stays whole for
// cp.async.  K5's bf16x3 kind (bell_banded.cu) stages its operand and tile
// chunks in the same two layouts, K6's (block_body.cuh) its stored block
// and panel, with A's rows 64 floats long at bsz 33-64: the swizzle stays
// inside each 32-column half, so a half is a 32-index chunk of pitch 64.
template <int kPitch = 32>
__device__ __forceinline__ int split_a_at(int i, int c) {
  return i * kPitch + (c ^ ((i & 3) << 3));
}
template <int kPitch>
__device__ __forceinline__ int split_b_at(int kk, int c) {
  return kk * kPitch + (c ^ (((kk >> 1) & 3) << 3));
}
template <>
struct Cfg<Split> {
  using T = float;
  using Out = float;
  using Bits = unsigned;
  using Acc = float[2][4][4];           // 2 m16 x 4 n8 mma tiles per warp
  static constexpr unsigned kWord = 0x7fffffffu;
  static constexpr int kBK = 32;
  static constexpr int kAPitch = kBK;
  static constexpr int kBPitch = kBN;
  static constexpr int kVote = 1, kAhead = 2;  // three products a pair
  static constexpr int kAStages = kAhead + 2, kBStages = kVote + 1;
  static constexpr int kMinBlocks = 4;
  __device__ static __forceinline__ int a_at(int i, int c) {
    return split_a_at(i, c);
  }
  __device__ static __forceinline__ int b_at(int kk, int c) {
    return split_b_at<kBPitch>(kk, c);
  }
};
// float64 on DMMA, C in float64.  A fragment read takes one double a lane
// (lane 4g + t): for m16n8k8 A's rows g and g + 8 of a 16-row tile at
// columns t and t + 4, B's rows t and t + 4 at column g; for m8n8k4 (K5's
// and K6's dmma_chunk) A's row g at column t, B's row t at column g.
// Unpadded rows (32 and 128 doubles) would put 4 lanes of a half warp on
// one bank, so a row's columns are swizzled: A's row i at c ^ 4 * (i % 8),
// B's row kk at c ^ 4 * (kk % 4) (dmma_a_at, dmma_b_at).  Rows g and g + 8
// share i % 8, and rows t and t + 4 share kk % 4, so every fragment read of
// either shape meets 32 banks a half warp, and 16-byte cp.async vectors
// (column pairs) stay whole.  K5's float64 kind (bell_banded.cu) stages its
// operand and tile chunks in the same layouts.  A stage is 8 KB of A and 32
// KB of B: 96 KB at 4 A and 2 B stages, two thread blocks an SM (on an H100
// at bell-band-80M, k 128, a vote two chunks ahead at one block an SM took
// 1.5x as long, A three chunks ahead and streaming stores of C no less).
__device__ __forceinline__ int dmma_a_at(int i, int c) {
  return i * 32 + (c ^ ((i & 7) << 2));  // rows of 32 doubles
}
template <int kPitch>
__device__ __forceinline__ int dmma_b_at(int kk, int c) {
  return kk * kPitch + (c ^ ((kk & 3) << 2));
}
template <>
struct Cfg<double> {
  using T = double;
  using Out = double;
  using Bits = unsigned long long;
  using Acc = double[2][4][4];          // 2 m16 x 4 n8 DMMA tiles per warp
  static constexpr int kBK = 32;
  static constexpr int kAPitch = kBK;
  static constexpr int kBPitch = kBN;
  static constexpr int kVote = 1, kAhead = 2;
  static constexpr int kAStages = kAhead + 2, kBStages = kVote + 1;
  static constexpr int kMinBlocks = 2;  // 96 KB of shared memory each
  __device__ static __forceinline__ int a_at(int i, int c) {
    return dmma_a_at(i, c);
  }
  __device__ static __forceinline__ int b_at(int kk, int c) {
    return dmma_b_at<kBPitch>(kk, c);
  }
};

template <typename S>
constexpr int smem_bytes() {
  return (Cfg<S>::kAStages * kBM * Cfg<S>::kAPitch +
          Cfg<S>::kBStages * Cfg<S>::kBK * Cfg<S>::kBPitch) *
         static_cast<int>(sizeof(typename Cfg<S>::T));
}

// -- address policies ----------------------------------------------------
// A policy resolves a chunk's addresses once per chunk: a_chunk(k0).at(i, c)
// is A's element (i, k0 + c), for i < M and k0 + c < K (16-byte vectors
// along c never cross a contiguous run when VEC holds); b_chunk(k0).row(c)
// is operand row k0 + c, for b_has(k0 + c), which says whether the row
// holds data (else it reads 0; never past the contraction, K).  a_any and
// b_any are valid addresses handed to a masked copy, which reads nothing
// from them.

// K4/K8: one densified tile (M, K) row-major and the tile's operand window
// of rows_ok rows (rows past the operand's end read 0), 32-bit indices.
template <typename T>
struct DenseTile {
  const T* a;
  const T* bw;
  int K, N, rows_ok;
  // (the index math of K4's first vote body, kept as it was: K4 and K8
  // are FMA-bound, and other forms of it cost them 4% on an H100)
  struct AChunk {
    const T* a;
    int K, k0;
    __device__ __forceinline__ const T* at(int i, int c) const {
      return a + i * K + (k0 + c);
    }
  };
  struct BChunk {
    const T* bw;
    int N, k0;
    __device__ __forceinline__ const T* row(int c) const {
      return bw + (k0 + c) * N;
    }
  };
  __device__ __forceinline__ AChunk a_chunk(int k0) const {
    return {a, K, k0};
  }
  __device__ __forceinline__ BChunk b_chunk(int k0) const {
    return {bw, N, k0};
  }
  __device__ __forceinline__ bool b_has(int kk) const { return kk < rows_ok; }
  __device__ __forceinline__ const T* a_any() const { return a; }
  __device__ __forceinline__ const T* b_any() const { return bw; }
};

// K3: block row r's Lb blocks (Lb, bsz, bsz) and cols[r, :]; the wide row's
// element (i, l*bsz + j) is block l's (i, j), and contraction index kk reads
// operand row cols[r, kk / bsz]*bsz + kk % bsz.  A chunk resolves its first
// index's block and column id once; indices inside that block follow by
// arithmetic, and only an index in a later block (bsz not a multiple of
// 32) divides and reads its column id.
template <typename T>
struct WideRow {
  const T* blk;
  const int* col;
  const T* b;
  int bsz, K, N;
  struct AChunk {
    const T* blk;
    int bsz, l0, j0;
    __device__ __forceinline__ const T* at(int i, int c) const {
      int l = l0, j = j0 + c;
      if (j >= bsz) {
        l += j / bsz;
        j -= (l - l0) * bsz;
      }
      return blk + (l * bsz + i) * bsz + j;
    }
  };
  struct BChunk {
    const int* col;
    const T* b;
    const T* row0;  // operand row of the chunk's first index
    int bsz, N, l0, j0;
    __device__ __forceinline__ const T* row(int c) const {
      const int j = j0 + c;
      if (j < bsz) return row0 + static_cast<long long>(c) * N;
      const int l = l0 + j / bsz;
      const long long r = static_cast<long long>(__ldg(col + l)) * bsz +
                          (j - (l - l0) * bsz);
      return b + r * N;
    }
  };
  __device__ __forceinline__ AChunk a_chunk(int k0) const {
    const int l0 = k0 / bsz;
    return {blk, bsz, l0, k0 - l0 * bsz};
  }
  __device__ __forceinline__ BChunk b_chunk(int k0) const {
    const int l0 = k0 / bsz, j0 = k0 - l0 * bsz;
    const long long r0 = static_cast<long long>(__ldg(col + l0)) * bsz + j0;
    return {col, b, b + r0 * N, bsz, N, l0, j0};
  }
  __device__ __forceinline__ bool b_has(int kk) const { return kk < K; }
  __device__ __forceinline__ const T* a_any() const { return blk; }
  __device__ __forceinline__ const T* b_any() const { return b; }
};

// K3's outputs for run_tiles: output r is block row r, read through its
// WideRow; prefetch(r) asks for the row's column ids in L1.
template <typename T>
struct WideRows {
  const T* blocks;
  const int* cols;
  const T* b;
  int Lb, bsz, N;
  __device__ __forceinline__ WideRow<T> at(int r) const {
    const long long l = static_cast<long long>(r) * Lb;
    return {blocks + l * bsz * bsz, cols + l, b, bsz, Lb * bsz, N};
  }
  __device__ __forceinline__ void prefetch(int r) const {
    sm90::prefetch_l1(cols + static_cast<long long>(r) * Lb);
  }
};

// -- copies -------------------------------------------------------------------

// A[m0 : m0+32, k0 : k0+32] into a stage; rows >= M and columns >= K are
// zero.
template <typename S, bool VEC, class P>
__device__ __forceinline__ void load_a(typename Cfg<S>::T* sa, const P& p,
                                       int M, int K, int m0, int k0) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  constexpr int kBK = Cf::kBK;
  const int tid = threadIdx.x;
  const auto v = p.a_chunk(k0);
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kBK / V;
#pragma unroll
    for (int s = 0; s < kBM * kRow / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int i = e / kRow, col = (e % kRow) * V;
      const int gi = m0 + i, gk = k0 + col;
      const bool ok = gi < M && gk < K;
      sm90::cp_async16(sa + Cf::a_at(i, col), ok ? v.at(gi, col) : p.a_any(),
                       ok);
    }
  } else {
    using B = typename Cf::Bits;
    B* dst = reinterpret_cast<B*>(sa);
#pragma unroll 4
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int i = e / kBK, col = e % kBK;
      const int gi = m0 + i, gk = k0 + col;
      dst[Cf::a_at(i, col)] =
          (gi < M && gk < K) ? *reinterpret_cast<const B*>(v.at(gi, col))
                             : B(0);
    }
  }
}

// Whether any element this thread copied by load_a is non-zero (NaN is).
// A double's sign is bit 31 of its high word (the second 32-bit word).
template <typename S, bool VEC>
__device__ __forceinline__ bool mine_nonzero(const typename Cfg<S>::T* sa) {
  using Cf = Cfg<S>;
  constexpr int kBK = Cf::kBK;
  constexpr bool k64 = sizeof(typename Cf::T) == 8;
  const int tid = threadIdx.x;
  unsigned any = 0;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(typename Cf::T), kRow = kBK / V;
#pragma unroll
    for (int s = 0; s < kBM * kRow / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const uint4 w = *reinterpret_cast<const uint4*>(
          sa + Cf::a_at(e / kRow, (e % kRow) * V));
      if constexpr (k64)
        any |= w.x | w.z | ((w.y | w.w) & 0x7fffffffu);
      else
        any |= (w.x | w.y | w.z | w.w) & Cf::kWord;
    }
  } else {
    using B = typename Cf::Bits;
    const B* src = reinterpret_cast<const B*>(sa);
#pragma unroll 4
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      if constexpr (k64)
        any |= (src[Cf::a_at(e / kBK, e % kBK)] << 1) != 0;
      else
        any |= src[Cf::a_at(e / kBK, e % kBK)] & Cf::kWord;
    }
  }
  return any != 0;
}

// Operand rows k0 .. k0+31 (rows without data, those >= K among them, read
// 0), columns n0 .. n0+127 (columns >= N read 0), into a stage; called for
// k0 < K.
template <typename S, bool VEC, class P>
__device__ __forceinline__ void load_b(typename Cfg<S>::T* sb, const P& p,
                                       int N, int k0, int n0) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  constexpr int kBK = Cf::kBK;
  const int tid = threadIdx.x;
  const auto v = p.b_chunk(k0);
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kBN / V;
#pragma unroll
    for (int s = 0; s < kBK * kRow / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int kk = e / kRow, col = (e % kRow) * V;
      const int gk = k0 + kk, gn = n0 + col;
      const bool ok = p.b_has(gk) && gn < N;
      sm90::cp_async16(sb + Cf::b_at(kk, col),
                       ok ? v.row(kk) + gn : p.b_any(), ok);
    }
  } else {
    using B = typename Cf::Bits;
    B* dst = reinterpret_cast<B*>(sb);
    // one operand row per thread and pass: its address is resolved once
    constexpr int kRowsPer = kThreads / 32;  // rows per pass
    const int lane = tid % 32;
#pragma unroll 2
    for (int kk = tid / 32; kk < kBK; kk += kRowsPer) {
      const int gk = k0 + kk;
      const bool row_ok = p.b_has(gk);
      const B* src =
          row_ok ? reinterpret_cast<const B*>(v.row(kk)) : nullptr;
#pragma unroll
      for (int c = lane; c < kBN; c += 32) {
        const int gn = n0 + c;
        dst[Cf::b_at(kk, c)] = (row_ok && gn < N) ? src[gn] : B(0);
      }
    }
  }
}

// -- multiply-adds ------------------------------------------------------------

// One multiply-add of the float32 kind (fmaf, full float32) and of the
// int32 kind (unsigned, modulo 2^32).
__device__ __forceinline__ void madd(float& acc, float x, float b) {
  acc = fmaf(x, b, acc);
}
__device__ __forceinline__ void madd(unsigned& acc, unsigned x, unsigned b) {
  acc += x * b;
}

// acc += A chunk (32 x 32) @ B chunk (32 x 128), float32 or int32 (T float
// or int, Acc float or unsigned): thread (warp w, lane l) owns rows 8w ..
// 8w+7 and columns 4l .. 4l+3.  Shared memory serves an LDS.128 a quarter
// warp a cycle, or two quarters a cycle where each reads one 16-byte chunk:
// a warp-wide broadcast costs 2 cycles, 8 distinct chunks a quarter 4
// (tools/lds_probe.py on an H100).  For each 4 indices a thread issues 8
// LDS.128 of A (broadcasts) and 4 of B (32 distinct chunks), against 128
// multiply-adds: 8 cycles per 32 FFMA instructions of a warp, so at four
// thread blocks an SM shared memory is as busy as FFMA issue before the
// fills and votes.  With 32 accumulators a thread no map costs fewer: the
// 8 lanes of a quarter own different outputs, so its A or its B loads
// read 8 chunks a quarter.  (A thread owning rows 8 apart and two
// 4-column runs, on a row-swizzled A stage, also costs 8, and K3, K4 and
// K8 ran 6-11% slower so on an H100, PERF.md section 6.)  Each output's
// sum runs in index order, one multiply-add at a time.
template <typename T, typename Acc>
__device__ __forceinline__ void mma_chunk(const T* sa, const T* sb,
                                          Acc (&acc)[8][4]) {
  using V = std::conditional_t<std::is_same_v<Acc, float>, float4, uint4>;
  constexpr int kBK = Cfg<T>::kBK;
  const T* pa = sa + (threadIdx.x / 32) * 8 * kBK;
  const T* pb = sb + (threadIdx.x % 32) * 4;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    V a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      a[r] = *reinterpret_cast<const V*>(pa + r * kBK + kq);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const V b = *reinterpret_cast<const V*>(pb + (kq + q) * kBN);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const Acc x = q == 0 ? a[r].x : q == 1 ? a[r].y
                    : q == 2 ? a[r].z : a[r].w;
        madd(acc[r][0], x, b.x);
        madd(acc[r][1], x, b.y);
        madd(acc[r][2], x, b.z);
        madd(acc[r][3], x, b.w);
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

// x0 and x1 as packed bf16 high parts (x0 in the low half, as an mma
// operand register holds its lower contraction index) and bf16 residuals:
// hi = bf16(x), lo = bf16(x - hi), the difference exact in float32.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// acc += A (32 x 32: rows kAPitch floats) @ B (32 x 32: columns n0 ..
// n0+31 of a stage whose rows are kBPitch floats) with the bf16x3 split,
// float32 stages in the swizzled layouts (split_a_at<kAPitch>,
// split_b_at<kBPitch>), the mma tiles' accumulator: the warp owns all 32
// rows and those 32 columns as 2 x 4 m16n8 tiles.  Per 16-index step each
// thread splits its A fragments (2 tiles x 4 registers) and B fragments (4
// tiles x 2 registers), then issues hi*hi for every tile, then hi*lo, then
// lo*hi, each into the tile's one float32 accumulator.  The one copy of
// that order: K3's and K4's chunks (A the band, B the operand), K5's (A the
// operand, B the tile) and K6's (A the stored block, B its panel) all run
// it.
template <int kBPitch, int kAPitch = 32>
__device__ __forceinline__ void split_chunk(const float* sa, const float* sb,
                                            int n0, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < 32; ks += 16) {
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r: row g (+8 for odd r), columns 2t, 2t+1 (+8 for r >= 2)
        const int i = mt * 16 + g + (r & 1) * 8;
        const int c = ks + 2 * t + (r >> 1) * 8;
        const float2 x = *reinterpret_cast<const float2*>(
            sa + split_a_at<kAPitch>(i, c));
        split2(x.x, x.y, ah[mt][r], al[mt][r]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // register r: rows 2t, 2t+1 (+8 for r = 1), column g
        const int kk = ks + 2 * t + r * 8, n = n0 + nt * 8 + g;
        split2(sb[split_b_at<kBPitch>(kk, n)],
               sb[split_b_at<kBPitch>(kk + 1, n)], bh[nt][r], bl[nt][r]);
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sm90::mma_bf16_16816(acc[mt][nt], ah[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sm90::mma_bf16_16816(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sm90::mma_bf16_16816(acc[mt][nt], al[mt], bh[nt]);
  }
}

// The same for the band body's bf16x3 kind (Cfg<Split>'s stages): warp w
// owns all 32 rows and columns 32w .. 32w+31, as the bf16 kind does.
__device__ __forceinline__ void mma_chunk(const float* sa, const float* sb,
                                          float (&acc)[2][4][4]) {
  split_chunk<Cfg<Split>::kBPitch, Cfg<Split>::kAPitch>(
      sa, sb, (threadIdx.x / 32) * 32, acc);
}

// acc += A (32 x 32, rows of 32 doubles) @ B (32 x 32: columns n0 .. n0+31
// of a stage whose rows are kBPitch doubles) in float64 on DMMA, stages in
// the swizzled layouts (dmma_a_at, dmma_b_at<kBPitch>): the warp owns all
// 32 rows and those 32 columns as 4 x 4 m8n8 tiles.  Per 4-index step each
// lane reads one double of each fragment and the warp issues the 16
// products in a fixed order.  The one copy: K4's and K8's chunks (A the
// band, B the operand) and K5's (A the operand, B the tile) run it.
template <int kBPitch>
__device__ __forceinline__ void dmma_chunk(const double* sa, const double* sb,
                                           int n0, double (&acc)[4][4][2]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kq = 0; kq < 32; kq += 4) {
    double a[4], b[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) a[mt] = sa[dmma_a_at(mt * 8 + g, kq + t)];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      b[nt] = sb[dmma_b_at<kBPitch>(kq + t, n0 + nt * 8 + g)];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        sm90::mma_f64_884(acc[mt][nt], a[mt], b[nt]);
  }
}

// The same for the band body's float64 kind on Hopper's m16n8k8 DMMA: warp
// w owns all 32 rows and columns 32w .. 32w+31 as 2 m16 x 4 n8 tiles.  Per
// 8-index step each lane reads its four A doubles of both m16 tiles, then
// for each n8 tile its two B doubles and issues the tile's two products;
// the steps run in index order, as dmma_chunk's do.
__device__ __forceinline__ void mma_chunk(const double* sa, const double* sb,
                                          double (&acc)[2][4][4]) {
  constexpr int kPB = Cfg<double>::kBPitch;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, n0 = (threadIdx.x / 32) * 32;
#pragma unroll
  for (int ks = 0; ks < 32; ks += 8) {
    double a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r)  // rows g (+8 for odd r), column t (+4)
        a[mt][r] = sa[dmma_a_at(mt * 16 + g + (r & 1) * 8,
                                ks + t + (r >> 1) * 4)];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8 + g;
      const double b[2] = {sb[dmma_b_at<kPB>(ks + t, n)],
                           sb[dmma_b_at<kPB>(ks + t + 4, n)]};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) sm90::mma_f64_16808(acc[mt][nt], a[mt], b);
    }
  }
}

// -- output -------------------------------------------------------------------

// Four sums of a register tile into C: float32 as they are, int32 as their
// bits.
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(int* p, const unsigned (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// C[m0 + ., n0 + .] of one output (M, N) from mma_chunk's register tiles
// (float32 or int32).
template <bool VEC, typename Acc, typename O>
__device__ __forceinline__ void store(const Acc (&acc)[8][4], O* c, int M,
                                      int N, int m0, int n0) {
  const int gn = n0 + (threadIdx.x % 32) * 4;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gi = m0 + (threadIdx.x / 32) * 8 + r;
    if (gi >= M) continue;
    O* row = c + gi * N;
    if constexpr (VEC) {
      if (gn < N) put4(row + gn, acc[r]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) row[gn + j] = static_cast<O>(acc[r][j]);
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

// The float64 kind's C from the m16n8k8 layout: lane l holds columns 8nt +
// 2(l%4) .. +1 of rows 16mt + l/4 and 16mt + l/4 + 8 of the warp's 32
// columns.
template <bool VEC>
__device__ __forceinline__ void store(const double (&acc)[2][4][4], double* c,
                                      int M, int N, int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = m0 + mt * 16 + lane / 4 + h * 8;
      if (gi >= M) continue;
      double* row = c + gi * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + warp * 32 + nt * 8 + (lane % 4) * 2;
        const double x = acc[mt][nt][2 * h], y = acc[mt][nt][2 * h + 1];
        if constexpr (VEC) {
          if (gn < N)
            *reinterpret_cast<double2*>(row + gn) = make_double2(x, y);
        } else {
          if (gn < N) row[gn] = x;
          if (gn + 1 < N) row[gn + 1] = y;
        }
      }
    }
}

// Sets every accumulator of a register tile (any kind's Acc) to zero.
template <typename A>
__device__ __forceinline__ void zero(A& acc) {
  if constexpr (std::is_array_v<A>) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(std::extent_v<A>); ++i) zero(acc[i]);
  } else {
    acc = A(0);
  }
}

// -- the body -----------------------------------------------------------------

// C[m0 : m0+32, n0 : n0+128] of one output (M, N) at c (row-major, leading
// dimension N, in Cfg<S>::Out) = A @ B over the whole contraction K, A and
// B read through the policy p, in the stream kind S.  Needs smem_bytes<S>()
// of dynamic shared memory.
template <typename S, bool VEC, class P>
__device__ __forceinline__ void run(const P& p, typename Cfg<S>::Out* c,
                                    int M, int K, int N, int m0, int n0,
                                    unsigned long long* issued) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  constexpr int kVote = Cf::kVote, kAhead = Cf::kAhead, kBK = Cf::kBK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kBM * Cf::kAPitch;
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
        __syncthreads_or(ch < nc && mine_nonzero<S, VEC>(stage_a(ch)));
    if (nz) load_b<S, VEC>(stage_b(ch), p, N, ch * kBK, n0);
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
      load_a<S, VEC>(stage_a(it + kAhead), p, M, K, m0, (it + kAhead) * kBK);
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
  store<VEC>(acc, c, M, N, m0, n0);
  // each kept chunk at its full size, padding rows and columns included
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

// run over many outputs, each (M, N) row-major, output r at c + r * M * N
// = A_r @ B_r over its contraction K, read through the policy w.at(r) (a
// WideRows): the thread block walks the tiles blockIdx.x, + gridDim.x, ...
// in order (tile t: output t / (mb * nb), then its 32-row block, then its
// 128-column block fastest, for mb 32-row and nb 128-column blocks an
// output) with one ring.  The chunk counter, the stages and the vote's
// queue run on across tiles, so the next tile's first A chunks and its
// vote are in flight while the current tile's last chunk multiplies; a
// tile's accumulators are stored once after its last chunk, then zeroed.
// Each tile multiplies run's chunks in run's order, so C and the issued
// count are run's.  A tile of K = 0 walks one chunk of zeros, so that it
// stores zeros.  The launcher keeps the tiles and a thread block's steps
// (its tiles times the chunks a tile) under 2^31 - 8.
template <typename S, bool VEC, class W>
__device__ __forceinline__ void run_tiles(const W& w, typename Cfg<S>::Out* c,
                                          int outputs, int M, int K, int N,
                                          unsigned long long* issued) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  constexpr int kVote = Cf::kVote, kAhead = Cf::kAhead, kBK = Cf::kBK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kBM * Cf::kAPitch;
  const int nc = K > 0 ? (K + kBK - 1) / kBK : 1;  // chunks a tile
  const unsigned mb = (M + kBM - 1) / kBM, nb = (N + kBN - 1) / kBN;
  const unsigned tiles = static_cast<unsigned>(outputs) * mb * nb;
  if (blockIdx.x >= tiles) return;
  const int ns =  // steps: this block's tiles times nc
      static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * nc;
  auto stage_a = [&](int it) {
    return sa + (it % Cf::kAStages) * kBM * Cf::kAPitch;
  };
  auto stage_b = [&](int it) {
    return sb + (it % Cf::kBStages) * kBK * Cf::kBPitch;
  };
  // a position of the pipeline: chunk ch of tile t, whose output is r and
  // whose block starts at row m0, column n0 (decoded once a tile)
  struct Pos {
    int ch;
    unsigned t;
    int r, m0, n0;
  };
  auto decode = [&](Pos& q) {
    q.n0 = static_cast<int>(q.t % nb) * kBN;
    const unsigned rest = q.t / nb;
    q.m0 = static_cast<int>(rest % mb) * kBM;
    q.r = static_cast<int>(rest / mb);
  };
  auto next = [&](Pos& q) {  // whether q enters a new tile
    if (++q.ch < nc) return false;
    q.ch = 0;
    q.t += gridDim.x;
    decode(q);
    return true;
  };
  // the column ids of tile t's output into L1, a tile before the copies
  // that read them
  auto prefetch = [&](unsigned t) {
    if (threadIdx.x != 0 || t >= tiles) return;
    Pos q{0, t, 0, 0, 0};
    decode(q);
    w.prefetch(q.r);
  };
  Pos ca{0, blockIdx.x, 0, 0, 0};  // the next A copy
  Pos cv = ca;                     // the next vote and B copy
  decode(ca);
  decode(cv);
  prefetch(blockIdx.x);
  prefetch(blockIdx.x + gridDim.x);
  typename Cf::Acc acc;
  zero(acc);
  // Step it votes on step it + kVote and copies its B, then copies
  // A(it + kAheadW), then multiplies step it.  Its A copy comes after the
  // step's barrier, so it may take the stage of step it - 1, read before
  // that barrier: A runs one step further ahead than run's, in as many
  // stages.  Two cp.async groups a step, B's then A's (empty where there is
  // nothing to copy), so the wait before a vote leaves in flight only what
  // is younger than B(it) and A(it + kVote): A has two steps to land, B
  // kVote.
  constexpr int kAheadW = kAhead + 1;
  static_assert(Cf::kAStages == kAheadW + 1, "A's stages hold the ring");
  constexpr int kWait = 2 * kVote - 1 < 2 * (kAheadW - kVote - 1)
                            ? 2 * kVote - 1 : 2 * (kAheadW - kVote - 1);
  unsigned nzq = 0;  // bit i: step it + i is non-zero
  int kept = 0;      // chunks multiplied
  int it = -kAheadW;
  auto copies = [&] {  // step it's vote and copies
    if (it + kVote >= 0) {
      sm90::cp_async_wait<kWait>();
      const bool live = it + kVote < ns;
      const bool nz = __syncthreads_or(
          live && mine_nonzero<S, VEC>(stage_a(it + kVote)));
      if (nz)
        load_b<S, VEC>(stage_b(it + kVote), w.at(cv.r), N, cv.ch * kBK,
                       cv.n0);
      nzq |= static_cast<unsigned>(nz) << kVote;
      if (live) next(cv);
    }
    sm90::cp_async_commit();
    if (it + kAheadW < ns) {
      load_a<S, VEC>(stage_a(it + kAheadW), w.at(ca.r), M, K, ca.m0,
                     ca.ch * kBK);
      if (next(ca) && ca.t < tiles) prefetch(ca.t + gridDim.x);
    }
    sm90::cp_async_commit();
  };
  for (; it < 0; ++it) {  // the first copies
    copies();
    nzq >>= 1;
  }
  for (unsigned t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int ch = 0; ch < nc; ++ch, ++it) {
      copies();
      if (nzq & 1u) {
        mma_chunk(stage_a(it), stage_b(it), acc);
        ++kept;
      }
      nzq >>= 1;
    }
    Pos q{0, t, 0, 0, 0};
    decode(q);
    store<VEC>(acc, c + static_cast<long long>(q.r) * M * N, M, N, q.m0,
               q.n0);
    zero(acc);
  }
  sm90::cp_async_wait<0>();
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

// The same product where a mask says which chunks hold data: mk[ch] != 0
// for each 32-index chunk ch of A's rows m0 .. m0+31 that is not zero
// throughout, as the vote would find it (K4's kit: BandedKit.chunk_nz).
// The loop walks the marked chunks only: their A and B copies go into one
// ring of kBStages stages (the A stages it leaves unused keep the vote
// body's shared-memory size), issued together as one cp.async group a
// chunk, kBStages - 1 chunks ahead, one barrier a chunk, no vote.  It
// multiplies the chunks the vote keeps in the same order, so C and the
// issued count are bitwise run's; a block with no marked chunk stores
// zeros.
template <typename S, bool VEC, class P>
__device__ __forceinline__ void run_masked(const P& p,
                                           const unsigned char* __restrict__ mk,
                                           typename Cfg<S>::Out* c, int M,
                                           int K, int N, int m0, int n0,
                                           unsigned long long* issued) {
  using Cf = Cfg<S>;
  using T = typename Cf::T;
  constexpr int kBK = Cf::kBK, kS = Cf::kBStages, kAhead = kS - 1;
  static_assert(kBK == 32 && kBM == 32, "a mask chunk is 32 x 32");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kBM * Cf::kAPitch;
  const int nc = (K + kBK - 1) / kBK;
  typename Cf::Acc acc = {};
  auto next = [&](int ch) {  // the first marked chunk after ch, or nc
    for (++ch; ch < nc && __ldg(mk + ch) == 0; ++ch) {
    }
    return ch;
  };
  // stage s was last read by the multiply of chunk it - 1, before this
  // step's barrier
  auto fill = [&](int s, int ch) {
    load_a<S, VEC>(sa + s * kBM * Cf::kAPitch, p, M, K, m0, ch * kBK);
    load_b<S, VEC>(sb + s * kBK * Cf::kBPitch, p, N, ch * kBK, n0);
  };
  int cl = next(-1);  // the next chunk to copy
  int cm = cl;        // the next chunk to multiply
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (cl < nc) {
      fill(s, cl);
      cl = next(cl);
    }
    sm90::cp_async_commit();
  }
  int kept = 0;
  for (int it = 0; cm < nc; ++it) {
    // one group a step: chunk it has landed once kAhead - 1 younger ones
    // may still be in flight
    sm90::cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (cl < nc) {
      fill((it + kAhead) % kS, cl);
      cl = next(cl);
    }
    sm90::cp_async_commit();
    const int s = it % kS;
    mma_chunk(sa + s * kBM * Cf::kAPitch, sb + s * kBK * Cf::kBPitch, acc);
    ++kept;
    cm = next(cm);
  }
  sm90::cp_async_wait<0>();
  store<VEC>(acc, c, M, N, m0, n0);
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

// Lets kern (a __global__ wrapper of run) take smem bytes of dynamic shared
// memory where that is more than the default 48 KB.
template <int SMEM, class K>
cudaError_t allow_smem(K kern) {
  if constexpr (SMEM > 48 * 1024)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return cudaSuccess;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace band
