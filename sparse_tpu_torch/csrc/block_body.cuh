// K6's body (bell_spmm.cu) at bsz <= 64, for float32, int32, bf16, bf16x3
// and float64 streams: C[r] (bsz, k) = sum over the stored slots l of block
// row r of blocks[r, l] (bsz, bsz) @ the operand panel B[cols[r, l]*bsz :
// +bsz] (bsz, k), one stored block at a time, as
// sparse_tpu/ops/pallas_bell.py::bell_spmm_pallas (def :58, pallas_call
// :89, kernel :41-55) steps its grid.  Past bsz 64 K6 runs K3's band body
// on the wide row instead (bell_spmm.cu).
//
// Output tiles: one block row's 32 rows (a row group; bsz > 32 gives two)
// by 128 columns (k > 128 gives more), column tiles fastest.  A thread block
// of two warps is persistent: it walks the tiles blockIdx.x, + gridDim.x,
// ... in order, so the blocks running at one time work on neighbouring
// block rows and share their operand panels in L2.  Its steps are the
// (tile, stored slot) pairs of those tiles, one after the other, and a
// cp.async ring runs across tile boundaries: the stored block's rows of the
// tile (A) kAhead steps ahead, the operand panel (B) kVote steps ahead, so
// the next block row's first block and panel are in flight while a tile's
// last block multiplies and its output is stored.  Once a step's A has
// landed the block takes one vote (__syncthreads_or on magnitude bits, the
// loop's only barrier, as band_body.cuh votes): a zero block (a padding
// slot) skips its panel copy and its multiply-adds; NaN counts as non-zero,
// -0 does not.  Float32: each thread keeps an 8x8 register tile (rows
// r + 4q, columns 4c .. 4c+3 and 64 + 4c .. +3: 64 FMAs per four 16-byte
// shared loads, conflict-free), in full float32.  int32: the same tile and
// ring, integer multiply-adds in unsigned (sums modulo 2^32, the
// reference's wrapping int32 result), a vote on every bit, C int32.  bf16
// (A and B bf16, sums float32): each warp a 32 x 64 piece on mma.sync
// m16n8k16 from ldmatrix fragments, the sums rounded to bf16 once as they
// are stored.  bf16x3 (band::Split: float32 A and B, precision="bf16x3"):
// the float32 ring and vote with unpadded stages in band_body.cuh's
// swizzled bf16x3 layouts, each warp's 32 x 64 piece as two 32-column
// halves, each 32-index chunk of a step multiplied by band_body.cuh's
// split_chunk (hi*hi, hi*lo, lo*hi a 16-index step, into one float32
// accumulator a tile), C in float32.  float64 (A, B and C float64, bsz
// <= 32): the same ring and a vote on 64-bit words, unpadded stages in
// band_body.cuh's swizzled DMMA layouts, four warps, each a 32 x 32 piece,
// each 32-index chunk of a step multiplied by band_body.cuh's dmma_chunk
// (mma.sync m8n8k4).  Each output is written once, in the
// result type (float32, float64, int32 or bf16), after its tile's
// fixed-order loop, with streaming stores (__stcs; the mma layout's bf16
// pairs are traded within each lane quad into 16-byte runs).  The block's
// column ids are read one step before their panel copy needs them.  With
// a counter, each thread block adds rows x bsz x columns of its tile for
// every step its vote kept: bsz * bsz * k per kept stored block at bsz <=
// 32 (once for bf16x3: its three products split the same multiply-adds).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "band_body.cuh"
#include "sm90_async.cuh"

namespace bbody {

constexpr int kBM = 32;       // output rows of a tile
constexpr int kBN = 128;      // output columns of a tile
constexpr int kThreads = 64;  // two warps (float64: Geo's four)

// Per stream kind S (float, int, __nv_bfloat16, band::Split, double): T,
// the element type in memory, in shared memory and of C.
template <typename S>
struct Cfg;
template <>
struct Cfg<float> {
  using T = float;
  using Bits = unsigned;
  using Acc = float[8][8];
  static constexpr unsigned kWord = 0x7fffffffu;  // magnitude bits
  static constexpr int kPadA = 4, kPadB = 0;
  static constexpr int kVote = 1, kAhead = 2;
};
// int32: the float32 kind's ring and 8x8 register tile, multiply-adds in
// unsigned (sums modulo 2^32), C int32; the vote counts every bit.
template <>
struct Cfg<int> {
  using T = int;
  using Bits = unsigned;
  using Acc = unsigned[8][8];
  static constexpr unsigned kWord = 0xffffffffu;
  static constexpr int kPadA = 4, kPadB = 0;
  static constexpr int kVote = 1, kAhead = 2;
};
template <>
struct Cfg<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using Bits = unsigned short;
  using Acc = float[2][8][4];  // per warp 2 m16 x 8 n8 mma tiles
  static constexpr unsigned kWord = 0x7fff7fffu;
  static constexpr int kPadA = 8, kPadB = 8;  // ldmatrix without conflicts
  static constexpr int kVote = 2, kAhead = 3;  // the multiply is short
};
// bf16x3: the float32 ring (48 KB at BK 32, 96 KB at BK 64), rows unpadded
// and swizzled (placed by Geo's a_at / b_at); per warp two 32-column
// halves of 2 m16 x 4 n8 mma tiles, split_chunk's accumulator each.
template <>
struct Cfg<band::Split> {
  using T = float;
  using Bits = unsigned;
  using Acc = float[2][2][4][4];
  static constexpr unsigned kWord = 0x7fffffffu;
  static constexpr int kPadA = 0, kPadB = 0;
  static constexpr int kVote = 1, kAhead = 2;
};
// float64, at BK 32 only (at 64 the ring would be 192 KB, one thread block
// an SM): the float32 ring (96 KB, two thread blocks an SM), unpadded
// stages in band_body.cuh's DMMA layouts (dmma_a_at, dmma_b_at: an A stage
// is a stage of the band body's float64 kind).  Four warps (Geo::kThreads),
// each a 32 x 32 piece of 4 m8 x 4 n8 DMMA tiles, dmma_chunk's accumulator:
// 64 doubles a lane (two warps of 32 x 64, 128 a lane, ran no faster than
// K3's band body at bsz 32 on an H100, and at BK 64 far slower).  The
// launcher takes it at bsz <= 32 (bell_spmm.cu).  The vote reads 64-bit
// words: a double's sign is bit 31 of its high word.
template <>
struct Cfg<double> {
  using T = double;
  using Bits = unsigned long long;
  using Acc = double[4][4][2];
  static constexpr int kPadA = 0, kPadB = 0;
  static constexpr int kVote = 1, kAhead = 2;
};

// BK: a step's contraction (the stored block's columns), 32 or 64.
// a_at(i, c) and b_at(j, c) place A's element (i, c) and B's (j, c) in
// their stages.
template <typename S, int BK>
struct Geo {
  using T = typename Cfg<S>::T;
  static constexpr bool kSplit = std::is_same<S, band::Split>::value;
  static constexpr bool kF64 = std::is_same<S, double>::value;
  static_assert(!kF64 || BK == 32, "float64 steps are 32 indices");
  static constexpr int kThreads = kF64 ? 2 * bbody::kThreads : bbody::kThreads;
  static constexpr int PA = BK + Cfg<S>::kPadA, PB = kBN + Cfg<S>::kPadB;
  static constexpr int kAStages = Cfg<S>::kAhead + 2;
  static constexpr int kBStages = Cfg<S>::kVote + 1;
  static constexpr int kAStage = kBM * PA, kBStage = BK * PB;
  static constexpr int kBytes =
      (kAStages * kAStage + kBStages * kBStage) * static_cast<int>(sizeof(T));
  __device__ static __forceinline__ int a_at(int i, int c) {
    if constexpr (kSplit) return band::split_a_at<PA>(i, c);
    if constexpr (kF64) return band::dmma_a_at(i, c);
    return i * PA + c;
  }
  __device__ static __forceinline__ int b_at(int j, int c) {
    if constexpr (kSplit) return band::split_b_at<PB>(j, c);
    if constexpr (kF64) return band::dmma_b_at<PB>(j, c);
    return j * PB + c;
  }
};

// Where a step lies: stored slot l of tile t = (block row r, row group at
// m0, column tile at n0).  A thread block walks the tiles blockIdx.x,
// + gridDim.x, ..., Lb steps each; a cursor follows one position of the
// pipeline through them, dividing once per tile.
struct Cursor {
  int l, t, r, m0, n0;
  __device__ __forceinline__ void decode(int m_groups, int n_tiles) {
    n0 = (t % n_tiles) * kBN;
    const int rest = t / n_tiles;
    m0 = (rest % m_groups) * kBM;
    r = rest / m_groups;
  }
  __device__ __forceinline__ void start(int m_groups, int n_tiles) {
    l = 0;
    t = blockIdx.x;
    decode(m_groups, n_tiles);
  }
  __device__ __forceinline__ void next(int Lb, int m_groups, int n_tiles) {
    if (++l == Lb) {
      l = 0;
      t += gridDim.x;
      decode(m_groups, n_tiles);
    }
  }
};

// A: rows m0 .. m0+31 of the stored block (bsz x bsz at blk), all bsz
// columns, into a (32 x BK) stage; rows and columns past bsz are zero.
template <typename S, int BK, bool VEC>
__device__ __forceinline__ void load_a(typename Cfg<S>::T* sa,
                                       const typename Cfg<S>::T* blk, int bsz,
                                       int m0) {
  using T = typename Cfg<S>::T;
  using G = Geo<S, BK>;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = BK / V;
#pragma unroll
    for (int s = 0; s < kBM * kRow / G::kThreads; ++s) {
      const int e = tid + s * G::kThreads;
      const int i = e / kRow, c = (e % kRow) * V;
      const int gi = m0 + i;
      const bool ok = gi < bsz && c < bsz;
      sm90::cp_async16(sa + G::a_at(i, c), ok ? blk + gi * bsz + c : blk, ok);
    }
  } else {
    using B = typename Cfg<S>::Bits;
    B* dst = reinterpret_cast<B*>(sa);
    const B* src = reinterpret_cast<const B*>(blk);
#pragma unroll 4
    for (int s = 0; s < kBM * BK / G::kThreads; ++s) {
      const int e = tid + s * G::kThreads;
      const int i = e / BK, c = e % BK;
      const int gi = m0 + i;
      dst[G::a_at(i, c)] = (gi < bsz && c < bsz) ? src[gi * bsz + c] : B(0);
    }
  }
}

// Whether any element this thread copied by load_a is non-zero (NaN is).
// A double's sign is bit 31 of its high word (the second 32-bit word).
template <typename S, int BK, bool VEC>
__device__ __forceinline__ bool mine_nonzero(const typename Cfg<S>::T* sa) {
  using T = typename Cfg<S>::T;
  using G = Geo<S, BK>;
  const int tid = threadIdx.x;
  unsigned any = 0;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = BK / V;
#pragma unroll
    for (int s = 0; s < kBM * kRow / G::kThreads; ++s) {
      const int e = tid + s * G::kThreads;
      const uint4 w = *reinterpret_cast<const uint4*>(
          sa + G::a_at(e / kRow, (e % kRow) * V));
      if constexpr (G::kF64)
        any |= w.x | w.z | ((w.y | w.w) & 0x7fffffffu);
      else
        any |= (w.x | w.y | w.z | w.w) & Cfg<S>::kWord;
    }
  } else {
    using B = typename Cfg<S>::Bits;
    const B* src = reinterpret_cast<const B*>(sa);
#pragma unroll 4
    for (int s = 0; s < kBM * BK / G::kThreads; ++s) {
      const int e = tid + s * G::kThreads;
      if constexpr (G::kF64)
        any |= (src[G::a_at(e / BK, e % BK)] << 1) != 0;
      else
        any |= src[G::a_at(e / BK, e % BK)] & Cfg<S>::kWord;
    }
  }
  return any != 0;
}

// B: panel rows 0 .. BK-1 (rows past bsz read 0) at panel (row-major,
// leading dimension k), columns n0 .. n0+127 (past k read 0), into a stage.
template <typename S, int BK, bool VEC>
__device__ __forceinline__ void load_b(typename Cfg<S>::T* sb,
                                       const typename Cfg<S>::T* panel,
                                       int bsz, int k, int n0) {
  using T = typename Cfg<S>::T;
  using G = Geo<S, BK>;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), kRow = kBN / V;
#pragma unroll
    for (int s = 0; s < BK * kRow / G::kThreads; ++s) {
      const int e = tid + s * G::kThreads;
      const int j = e / kRow, c = (e % kRow) * V;
      const bool ok = j < bsz && n0 + c < k;
      sm90::cp_async16(sb + G::b_at(j, c),
                       ok ? panel + static_cast<long long>(j) * k + n0 + c
                          : panel,
                       ok);
    }
  } else {
    using B = typename Cfg<S>::Bits;
    B* dst = reinterpret_cast<B*>(sb);
    const int lane = tid % 32;
#pragma unroll 2
    for (int j = tid / 32; j < BK; j += G::kThreads / 32) {
      const bool row_ok = j < bsz;
      const B* src = reinterpret_cast<const B*>(
          panel + (row_ok ? static_cast<long long>(j) * k : 0));
#pragma unroll
      for (int c = lane; c < kBN; c += 32)
        dst[G::b_at(j, c)] = (row_ok && n0 + c < k) ? src[n0 + c] : B(0);
    }
  }
}

// acc += A stage (32 x BK) @ B stage (BK x 128), float32: thread t owns
// rows r + 4q (r = t / 16) and columns 4c .. 4c+3, 64 + 4c .. (c = t % 16).
template <int BK>
__device__ __forceinline__ void mma_step(const float* sa, const float* sb,
                                         float (&acc)[8][8]) {
  using G = Geo<float, BK>;
  const float* pa = sa + (threadIdx.x / 16) * G::PA;
  const float* pb = sb + (threadIdx.x % 16) * 4;
#pragma unroll
  for (int kq = 0; kq < BK; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      a[q] = *reinterpret_cast<const float4*>(pa + 4 * q * G::PA + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(pb + (kq + kk) * G::PB);
      const float4 b1 =
          *reinterpret_cast<const float4*>(pb + (kq + kk) * G::PB + 64);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float x = kk == 0 ? a[q].x : kk == 1 ? a[q].y
                      : kk == 2 ? a[q].z : a[q].w;
        acc[q][0] = fmaf(x, b0.x, acc[q][0]);
        acc[q][1] = fmaf(x, b0.y, acc[q][1]);
        acc[q][2] = fmaf(x, b0.z, acc[q][2]);
        acc[q][3] = fmaf(x, b0.w, acc[q][3]);
        acc[q][4] = fmaf(x, b1.x, acc[q][4]);
        acc[q][5] = fmaf(x, b1.y, acc[q][5]);
        acc[q][6] = fmaf(x, b1.z, acc[q][6]);
        acc[q][7] = fmaf(x, b1.w, acc[q][7]);
      }
    }
  }
}

// The same for int32, multiply-adds in unsigned.
template <int BK>
__device__ __forceinline__ void mma_step(const int* sa, const int* sb,
                                         unsigned (&acc)[8][8]) {
  using G = Geo<int, BK>;
  const int* pa = sa + (threadIdx.x / 16) * G::PA;
  const int* pb = sb + (threadIdx.x % 16) * 4;
#pragma unroll
  for (int kq = 0; kq < BK; kq += 4) {
    uint4 a[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      a[q] = *reinterpret_cast<const uint4*>(pa + 4 * q * G::PA + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint4 b0 = *reinterpret_cast<const uint4*>(pb + (kq + kk) * G::PB);
      const uint4 b1 =
          *reinterpret_cast<const uint4*>(pb + (kq + kk) * G::PB + 64);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const unsigned x = kk == 0 ? a[q].x : kk == 1 ? a[q].y
                         : kk == 2 ? a[q].z : a[q].w;
        acc[q][0] += x * b0.x;
        acc[q][1] += x * b0.y;
        acc[q][2] += x * b0.z;
        acc[q][3] += x * b0.w;
        acc[q][4] += x * b1.x;
        acc[q][5] += x * b1.y;
        acc[q][6] += x * b1.z;
        acc[q][7] += x * b1.w;
      }
    }
  }
}

// The same for bf16 on the tensor cores: warp w owns all 32 rows and
// columns 64w .. 64w+63, as 2 x 8 m16n8 tiles.
template <int BK>
__device__ __forceinline__ void mma_step(const __nv_bfloat16* sa,
                                         const __nv_bfloat16* sb,
                                         float (&acc)[2][8][4]) {
  using G = Geo<__nv_bfloat16, BK>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    unsigned a[2][4], b[8][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      sm90::ldmatrix_x4(
          a[mt], sa + (mt * 16 + lane % 16) * G::PA + ks + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      sm90::ldmatrix_x4_trans(
          r, sb + (ks + (lane / 8) % 2 * 8 + lane % 8) * G::PB + warp * 64 +
                 np * 16 + (lane / 16) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        sm90::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
  }
}

// The same in bf16x3 (Geo<band::Split, BK>'s stages): warp w owns all 32
// rows and columns 64w .. 64w+63 as two 32-column halves, and each
// 32-index chunk of the step (one at BK 32, two at BK 64: a half of A's
// 64-float rows, 32 of B's rows) goes through split_chunk for each half.
template <int BK>
__device__ __forceinline__ void mma_step(const float* sa, const float* sb,
                                         float (&acc)[2][2][4][4]) {
  using G = Geo<band::Split, BK>;
  const int n0 = (threadIdx.x / 32) * 64;
#pragma unroll 1
  for (int k0 = 0; k0 < BK; k0 += 32)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      band::split_chunk<G::PB, G::PA>(sa + k0, sb + k0 * G::PB, n0 + 32 * h,
                                      acc[h]);
}

// The same in float64 (Geo<double, 32>'s stages, four warps): warp w owns
// all 32 rows and columns 32w .. 32w+31 of the step's one 32-index chunk,
// through dmma_chunk.
template <int BK>
__device__ __forceinline__ void mma_step(const double* sa, const double* sb,
                                         double (&acc)[4][4][2]) {
  band::dmma_chunk<Geo<double, BK>::PB>(sa, sb, (threadIdx.x / 32) * 32,
                                        acc);
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}
__device__ __forceinline__ void zero(unsigned (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;
}
__device__ __forceinline__ void zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
}

__device__ __forceinline__ void zero(float (&acc)[2][2][4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][m][n][i] = 0.f;
}

__device__ __forceinline__ void zero(double (&acc)[4][4][2]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n][0] = acc[m][n][1] = 0.0;
}

// C rows m0 + . (< M) and columns n0 + . (< N) of one block row's output
// (row-major, leading dimension N) from the register tile.
template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[8][8], float* c,
                                      int M, int N, int m0, int n0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int gi = m0 + t / 16 + 4 * q;
    if (gi >= M) continue;
    float* row = c + static_cast<long long>(gi) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + (t % 16) * 4;
      const float* v = &acc[q][4 * h];
      if constexpr (VEC) {
        if (gn < N)
          __stcs(reinterpret_cast<float4*>(row + gn),
                 make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) __stcs(row + gn + j, v[j]);
      }
    }
  }
}

// The int32 kind's C: the float32 kind's layout, each sum's bits.
template <bool VEC>
__device__ __forceinline__ void store(const unsigned (&acc)[8][8], int* c,
                                      int M, int N, int m0, int n0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int gi = m0 + t / 16 + 4 * q;
    if (gi >= M) continue;
    int* row = c + static_cast<long long>(gi) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + (t % 16) * 4;
      const unsigned* v = &acc[q][4 * h];
      if constexpr (VEC) {
        if (gn < N)
          __stcs(reinterpret_cast<uint4*>(row + gn),
                 make_uint4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) __stcs(row + gn + j, static_cast<int>(v[j]));
      }
    }
  }
}

__device__ __forceinline__ unsigned pick(const unsigned (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// The bf16 result from the mma layout: lane l holds columns 8nt + 2(l%4)
// .. +1 of rows 16mt + l/4 (+8), rounded once to a bf16 pair.  Aligned:
// for each group of four n-tiles, the four lanes of a quad trade their
// pairs (a 4 x 4 transpose by shuffles), so lane q holds n-tile 4g + q's
// eight columns and writes them as one 16-byte store.
template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[2][8][4],
                                      __nv_bfloat16* c, int M, int N, int m0,
                                      int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = m0 + mt * 16 + lane / 4 + h * 8;
      __nv_bfloat16* row = c + static_cast<long long>(gi) * N;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int col0 = n0 + warp * 64 + g * 32;
        if constexpr (VEC) {
          unsigned w[4], got[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 p = __floats2bfloat162_rn(
                acc[mt][4 * g + i][2 * h], acc[mt][4 * g + i][2 * h + 1]);
            w[i] = *reinterpret_cast<const unsigned*>(&p);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // lane q receives from lane (q - j) & 3 that lane's pair of
            // n-tile q
            const int src = (q - j) & 3;
            const unsigned v =
                __shfl_sync(0xffffffffu, pick(w, (q + j) & 3), quad + src);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              if (src == s) got[s] = v;
          }
          const int gn = col0 + q * 8;
          if (gi < M && gn < N)
            __stcs(reinterpret_cast<uint4*>(row + gn),
                   make_uint4(got[0], got[1], got[2], got[3]));
        } else if (gi < M) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gn = col0 + i * 8 + 2 * q + e;
              if (gn < N)
                row[gn] = __float2bfloat16_rn(acc[mt][4 * g + i][2 * h + e]);
            }
        }
      }
    }
}

// The float32 result of the bf16x3 kind from the mma layout: lane l holds
// columns 8nt + 2(l%4) .. +1 of rows 16mt + l/4 (+8) of each half, written
// as 8-byte streaming stores (a lane quad's four make one 32-byte run).
template <bool VEC>
__device__ __forceinline__ void store(const float (&acc)[2][2][4][4],
                                      float* c, int M, int N, int m0,
                                      int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gi = m0 + mt * 16 + lane / 4 + r * 8;
      if (gi >= M) continue;
      float* row = c + static_cast<long long>(gi) * N;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int gn = n0 + warp * 64 + h * 32 + nt * 8 + (lane % 4) * 2;
          const float x = acc[h][mt][nt][2 * r], y = acc[h][mt][nt][2 * r + 1];
          if constexpr (VEC) {
            if (gn < N)
              __stcs(reinterpret_cast<float2*>(row + gn), make_float2(x, y));
          } else {
            if (gn < N) __stcs(row + gn, x);
            if (gn + 1 < N) __stcs(row + gn + 1, y);
          }
        }
    }
}

// The float64 result from the DMMA layout: lane l holds columns 8nt +
// 2(l%4) .. +1 of row 8mt + l/4 of its warp's 32, written as 16-byte
// streaming stores (a lane quad's four make one 64-byte run).
template <bool VEC>
__device__ __forceinline__ void store(const double (&acc)[4][4][2],
                                      double* c, int M, int N, int m0,
                                      int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int gi = m0 + mt * 8 + lane / 4;
    if (gi >= M) continue;
    double* row = c + static_cast<long long>(gi) * N;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int gn = n0 + warp * 32 + nt * 8 + (lane % 4) * 2;
      const double x = acc[mt][nt][0], y = acc[mt][nt][1];
      if constexpr (VEC) {
        if (gn < N)
          __stcs(reinterpret_cast<double2*>(row + gn), make_double2(x, y));
      } else {
        if (gn < N) __stcs(row + gn, x);
        if (gn + 1 < N) __stcs(row + gn + 1, y);
      }
    }
  }
}

// The persistent body.  blocks (nb, Lb, bsz, bsz), cols (nb, Lb), b
// (nb*bsz, k) and c (nb*bsz, k) in the stream kind S's element type T.
// Needs Geo<S, BK>::kBytes of dynamic shared memory.
template <typename S, int BK, bool VEC>
__device__ __forceinline__ void run(
    const typename Cfg<S>::T* __restrict__ blocks,
    const int* __restrict__ cols, const typename Cfg<S>::T* __restrict__ b,
    typename Cfg<S>::T* __restrict__ c, int nb, int Lb, int bsz, int k,
    unsigned long long* issued) {
  using T = typename Cfg<S>::T;
  using Cf = Cfg<S>;
  using G = Geo<S, BK>;
  constexpr int kVote = Cf::kVote, kAhead = Cf::kAhead;
  static_assert(kAhead - kVote == 1, "column ids are read one step ahead");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + G::kAStages * G::kAStage;
  const int m_groups = (bsz + kBM - 1) / kBM, n_tiles = (k + kBN - 1) / kBN;
  const int tiles = nb * m_groups * n_tiles;  // the launcher checks the range
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int nc = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * Lb;
  const long long bsz2 = static_cast<long long>(bsz) * bsz;
  auto stage_a = [&](int s) { return sa + (s % G::kAStages) * G::kAStage; };
  auto stage_b = [&](int s) { return sb + (s % G::kBStages) * G::kBStage; };
  // Step it copies A(it + kAhead) and reads its column id, votes on step
  // it + kVote and copies its B, multiplies step it, and stores a tile
  // after its last step.  Each thread commits two cp.async groups per step,
  // A's then B's (empty where there is nothing to copy), so the wait before
  // a vote leaves in flight only what is younger than A(it + kVote) and
  // B(it).
  constexpr int kWait = 2 * (kAhead - kVote) < 2 * kVote - 1
                            ? 2 * (kAhead - kVote) : 2 * kVote - 1;
  Cursor ca, cv, cm;  // the steps copied, voted on and multiplied
  ca.start(m_groups, n_tiles);
  cv.start(m_groups, n_tiles);
  cm.start(m_groups, n_tiles);
  typename Cf::Acc acc;
  zero(acc);
  unsigned nzq = 0;              // bit i: step it + i is non-zero
  unsigned long long madds = 0;  // multiply-adds the vote kept
  int col_vote = 0;              // column id of step it + kVote
  for (int it = -kAhead; it < nc; ++it) {
    // stage (it + kAhead) % kAStages was last read by step it - 2, before
    // the last barrier; B's stage by step it - 1, before this step's one
    int col_new = 0;
    if (it + kAhead < nc) {
      const long long slot = static_cast<long long>(ca.r) * Lb + ca.l;
      col_new = __ldg(cols + slot);
      load_a<S, BK, VEC>(stage_a(it + kAhead), blocks + slot * bsz2, bsz,
                         ca.m0);
      ca.next(Lb, m_groups, n_tiles);
    }
    sm90::cp_async_commit();
    if (it + kVote >= 0) {
      sm90::cp_async_wait<kWait>();
      const bool live = it + kVote < nc;
      const bool nz = __syncthreads_or(
          live && mine_nonzero<S, BK, VEC>(stage_a(it + kVote)));
      if (nz) {
        load_b<S, BK, VEC>(stage_b(it + kVote),
                           b + static_cast<long long>(col_vote) * bsz * k,
                           bsz, k, cv.n0);
        const int rows = bsz - cv.m0 < kBM ? bsz - cv.m0 : kBM;
        const int cols_n = k - cv.n0 < kBN ? k - cv.n0 : kBN;
        madds += static_cast<unsigned long long>(rows) * bsz * cols_n;
      }
      nzq |= static_cast<unsigned>(nz) << kVote;
      cv.next(Lb, m_groups, n_tiles);
    }
    sm90::cp_async_commit();
    col_vote = col_new;
    if (it >= 0) {
      if (nzq & 1u) mma_step<BK>(stage_a(it), stage_b(it), acc);
      if (cm.l == Lb - 1) {  // the tile's last stored block
        store<VEC>(acc, c + static_cast<long long>(cm.r) * bsz * k, bsz, k,
                   cm.m0, cm.n0);
        zero(acc);
      }
      cm.next(Lb, m_groups, n_tiles);
    }
    nzq >>= 1;
  }
  sm90::cp_async_wait<0>();
  if (issued != nullptr && threadIdx.x == 0 && madds > 0)
    atomicAdd(issued, madds);
}

}  // namespace bbody
