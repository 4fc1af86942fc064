// The first body of the blocked-ELL SpMM kernels, which keeps the float64
// kinds of K3 and K6 and every kind of K6 past bsz 64 (bell_spmm.cu; the
// stream kinds are bell_kinds.cuh's): one thread block
// accumulates one (BM x 64) output tile
// of C = A @ B over the whole contraction, staging A and B in shared memory
// in chunks of 16 along the contraction; each thread holds a 4 x 4 register
// tile.  The caller says how A(i, kk) and B(kk, n) are read (a functor each,
// plus which index is contiguous in memory, so neighbouring threads load
// neighbouring addresses) and where the tile lies.  No atomics, no
// cross-block sums: every output element is written once, by one thread,
// after one fixed-order loop — bitwise repeatable.
//
// Types: the stream T is float, __nv_bfloat16, double or int; the
// shared-memory and accumulator type S is double for double, unsigned for
// int (K6's int32 kind past bsz 64: sums modulo 2^32, C written as their
// bits) and float otherwise (bf16 is widened exactly on the way into shared
// memory).  With SPLIT (precision
// "bf16x3", float streams only) each operand is split in registers into a
// bf16 high part and a bf16 residual and the tile sums hi*hi + hi*lo + lo*hi
// in float, as sparse_tpu/ops/pallas_bell.py::_dot_bf16x3 does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bell_kinds.cuh"

namespace bell {

constexpr int kBK = 16;  // contraction chunk staged per step
constexpr int kTM = 4;   // output rows per thread
constexpr int kTN = 4;   // output columns per thread
constexpr int kBN = 64;  // output columns per thread block
constexpr int kPad = 4;  // shared-memory row padding (keeps 16-byte rows)

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};
template <>
struct AccOf<int> {
  using type = unsigned;  // int32 sums modulo 2^32, stored as their bits
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ unsigned widen(int x) {
  return static_cast<unsigned>(x);
}

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ unsigned mad(unsigned a, unsigned b, unsigned c) {
  return a * b + c;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename S, int BM>
struct Smem {
  __align__(16) S a[kBK][BM + kPad];   // A chunk, contraction-major
  __align__(16) S b[kBK][kBN + kPad];  // B chunk, contraction-major
};

template <int BM>
struct Shape {
  static constexpr int TX = kBN / kTN;  // threads along the columns
  static constexpr int TY = BM / kTM;   // threads along the rows
  static constexpr int kThreads = TX * TY;
};

template <typename S>
__device__ __forceinline__ void lds4(const S* p, S (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = p[i];
}
template <>
__device__ __forceinline__ void lds4<float>(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}
template <>
__device__ __forceinline__ void lds4<double>(const double* p,
                                             double (&r)[4]) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  r[0] = v0.x;
  r[1] = v0.y;
  r[2] = v1.x;
  r[3] = v1.y;
}

template <typename S, bool SPLIT>
__device__ __forceinline__ void fma_frag(const S (&a)[kTM], const S (&b)[kTN],
                                         S (&acc)[kTM][kTN]) {
  if constexpr (SPLIT) {
    float ah[kTM], al[kTM], bh[kTN], bl[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      ah[i] = bf16_round(a[i]);
      al[i] = bf16_round(a[i] - ah[i]);
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      bh[j] = bf16_round(b[j]);
      bl[j] = bf16_round(b[j] - bh[j]);
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] = fmaf(ah[i], bh[j], acc[i][j]);
        acc[i][j] = fmaf(ah[i], bl[j], acc[i][j]);
        acc[i][j] = fmaf(al[i], bh[j], acc[i][j]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
  }
}

// acc += A[m0:m0+BM, 0:K] @ B[0:K, n0:n0+64] (rows >= M, columns >= N and
// contraction indices >= K read 0).  la(i, kk) and lb(kk, n) return S.
// A_K_FAST: A's contraction index is the contiguous one (else its row
// index); B_N_FAST: B's column index is (else its contraction index).
template <typename S, bool SPLIT, int BM, bool A_K_FAST, bool B_N_FAST,
          class LA, class LB>
__device__ __forceinline__ void accumulate(Smem<S, BM>& sm, const LA& la,
                                           const LB& lb, int M, int N, int K,
                                           int m0, int n0,
                                           S (&acc)[kTM][kTN]) {
  using Sh = Shape<BM>;
  constexpr int kAPer = BM * kBK / Sh::kThreads;
  constexpr int kBPer = kBK * kBN / Sh::kThreads;
  const int tid = threadIdx.x;
  const int tx = tid % Sh::TX;
  const int ty = tid / Sh::TX;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    S ra[kAPer], rb[kBPer];
#pragma unroll
    for (int s = 0; s < kAPer; ++s) {
      const int e = tid + s * Sh::kThreads;
      const int i = A_K_FAST ? e / kBK : e % BM;
      const int kk = A_K_FAST ? e % kBK : e / BM;
      const int gi = m0 + i, gk = k0 + kk;
      ra[s] = (gi < M && gk < K) ? la(gi, gk) : S(0);
    }
#pragma unroll
    for (int s = 0; s < kBPer; ++s) {
      const int e = tid + s * Sh::kThreads;
      const int n = B_N_FAST ? e % kBN : e / kBK;
      const int kk = B_N_FAST ? e / kBN : e % kBK;
      const int gn = n0 + n, gk = k0 + kk;
      rb[s] = (gn < N && gk < K) ? lb(gk, gn) : S(0);
    }
    __syncthreads();  // every thread is done reading the previous chunk
#pragma unroll
    for (int s = 0; s < kAPer; ++s) {
      const int e = tid + s * Sh::kThreads;
      const int i = A_K_FAST ? e / kBK : e % BM;
      const int kk = A_K_FAST ? e % kBK : e / BM;
      sm.a[kk][i] = ra[s];
    }
#pragma unroll
    for (int s = 0; s < kBPer; ++s) {
      const int e = tid + s * Sh::kThreads;
      const int n = B_N_FAST ? e % kBN : e / kBK;
      const int kk = B_N_FAST ? e / kBN : e % kBK;
      sm.b[kk][n] = rb[s];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      S fa[kTM], fb[kTN];
      lds4(&sm.a[kk][ty * kTM], fa);
      lds4(&sm.b[kk][tx * kTN], fb);
      fma_frag<S, SPLIT>(fa, fb, acc);
    }
  }
}

// C(m0 + ty*4 + i, n0 + tx*4 + j) = acc[i][j] inside (M, N); element (i, n)
// of C at c[i * c_si + n * c_sn].
template <typename S, int BM>
__device__ __forceinline__ void store(const S (&acc)[kTM][kTN], S* c,
                                      long long c_si, long long c_sn, int M,
                                      int N, int m0, int n0) {
  using Sh = Shape<BM>;
  const int tx = threadIdx.x % Sh::TX;
  const int ty = threadIdx.x / Sh::TX;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gi = m0 + ty * kTM + i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) c[gi * c_si + gn * c_sn] = acc[i][j];
    }
  }
}

// Position of this thread block: (output tile, row block, column block),
// column blocks fastest so blocks that share a tile's A run together.
struct TilePos {
  long long tile;
  int m0, n0;
};

template <int BM>
__device__ __forceinline__ TilePos tile_pos(int M, int N) {
  const int n_blocks = (N + kBN - 1) / kBN;
  const int m_blocks = (M + BM - 1) / BM;
  const long long bid = blockIdx.x;
  TilePos p;
  p.n0 = static_cast<int>(bid % n_blocks) * kBN;
  const long long rest = bid / n_blocks;
  p.m0 = static_cast<int>(rest % m_blocks) * BM;
  p.tile = rest / m_blocks;
  return p;
}

inline long long grid_blocks(long long tiles, long long M, long long N,
                             int BM) {
  return tiles * ((M + BM - 1) / BM) * ((N + kBN - 1) / kBN);
}

}  // namespace bell
