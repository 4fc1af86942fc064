// Pair bodies for K4's and K8's float32 kind, timed by tools/pair_probe.py
// against the package's band::run / run_masked (32-row thread blocks, 8 x
// 4 register tiles).  They are not part of the package: the probe appends
// this file to a copy of csrc/band_body.cuh (inside namespace band) and
// points that copy's bell_banded.cu at dense_run / dense_run_masked and
// PairDense below.  Every body keeps run's vote grain (a 32 x 32 chunk of
// one 32-row block), its order of multiply-adds and its issued count, so
// C is bitwise run's.  On an H100 every form ran slower than run on the
// bench band (PERF.md section 6).

namespace band {

// -- the pair body: K4 and K8 in float32 --------------------------------------
//
// The same product on a thread block of 64 output rows (two 32-row halves)
// by 128 columns, for the DenseTile policy in float32 (T float) or int32
// (T int, with kIntToo).  Each thread owns an 8 x 8 register tile, the map
// of wide_body.cuh's float32 kind: thread 32w + l (g = l % 8, h = l / 8)
// owns rows g + 8j (j = 0..7: j < 4 in the first half,
// j >= 4 in the second) and columns 32w + 4h .. +3 and 32w + 16 + 4h .. +3.
// A stage of A is 64 x 32 with its rows swizzled (pair_a_at: row i's
// 16-byte chunk q at q ^ (i % 8)), so that a quarter warp's eight A loads
// (rows g + 8j, chunk q ^ g) meet eight bank groups: 4 shared-memory cycles
// a warp.  B's stage stays 32 x 128 unswizzled: a quarter warp reads one
// chunk, 2 cycles.  For 4 indices a thread issues 8 A and 8 B LDS.128
// against 256 multiply-adds: 6 cycles per 32 FFMA instructions of a warp
// where run's 8 x 4 map costs 8 (tools/lds_probe.py's costs), and each B
// chunk is copied once for both halves.
//
// The vote grain stays a 32 x 32 chunk of one half: each half votes on its
// own rows, B is copied where either half is kept, and each half's
// multiply-adds run only where its own vote kept them (a block-uniform
// branch between three bodies: both halves, the first, the second).  So
// every output sums the chunks run keeps for its 32-row block, in the same
// order, one multiply-add at a time, from the same +0: C is bitwise run's,
// and the counter adds kBM x kBK x kBN for each half a chunk keeps, as run
// does.  __syncthreads_or gives one bit, so each warp ORs its threads' two
// bits (redux.sync) into its byte of a shared word before the loop's one
// barrier; a word for each parity of the chunk, so a vote's word is not
// the next vote's until every thread has passed the barrier between them.
// A second half that lies past M is neither copied nor voted on.
// 64 KB of shared memory (4 A stages of 8 KB, 2 B stages of 16 KB) and
// 64 accumulators a thread: three thread blocks an SM.
constexpr int kPairBM = 64;
constexpr int kPairMinBlocks = 3;
constexpr int kPairAStep = 4;   // indices an A load reads: LDS.128
constexpr int kPairUnroll = 8;  // 4-index steps unrolled: all of a chunk
// Warps 0-1 on the first half and 2-3 on the second, each thread 4 rows x
// 16 columns (mma_split), where true; every thread in both halves, 8 x 8
// (mma_pair), where false.
constexpr bool kPairHalfWarps = false;
constexpr int kPairRows = kPairHalfWarps ? 4 : 8, kPairCols = 64 / kPairRows;

template <typename S>
constexpr int pair_smem_bytes() {
  return (Cfg<S>::kAStages * kPairBM * Cfg<S>::kAPitch +
          Cfg<S>::kBStages * Cfg<S>::kBK * Cfg<S>::kBPitch) *
         static_cast<int>(sizeof(typename Cfg<S>::T));
}

// Element (i, c) of the pair body's 64 x 32 A stage.
__device__ __forceinline__ int pair_a_at(int i, int c) {
  return i * 32 + ((((c >> 2) ^ i) & 7) << 2) + (c & 3);
}

// A 16-byte load from shared memory at a 32-bit shared-window address, as
// float32 or as unsigned words.
__device__ __forceinline__ void lds128(unsigned addr, float4& v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
}
__device__ __forceinline__ void lds128(unsigned addr, uint4& v) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
}

// The first N (4, 2 or 1) words at a 32-bit shared-window address into
// v's first N components.
template <int N, typename V>
__device__ __forceinline__ void lds(unsigned addr, V& v) {
  if constexpr (N == 4) {
    lds128(addr, v);
  } else if constexpr (N == 2) {
    unsigned x, y;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(x), "=r"(y)
                 : "r"(addr));
    v.x = *reinterpret_cast<const decltype(v.x)*>(&x);
    v.y = *reinterpret_cast<const decltype(v.y)*>(&y);
  } else {
    unsigned x;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(x) : "r"(addr));
    v.x = *reinterpret_cast<const decltype(v.x)*>(&x);
  }
}

// A[m0 : m0+64, k0 : k0+32] into a pair stage, only the halves set in
// `halves` (bit 0: rows m0 .. m0+31, bit 1: the next 32); rows >= M and
// columns >= K are zero.  VEC: thread t copies chunk t % 8 of rows t / 8 +
// 16s (s < 2 the first half); else element t % 32 of rows t / 32 + 4s (s <
// 8 the first half).
template <typename T, bool VEC, class P>
__device__ __forceinline__ void load_a_pair(T* sa, const P& p, int M, int K,
                                            int m0, int k0, unsigned halves) {
  const int tid = threadIdx.x;
  const auto v = p.a_chunk(k0);
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!((halves >> (s / 2)) & 1u)) continue;
      const int i = tid / 8 + 16 * s, col = (tid % 8) * 4;
      const int gi = m0 + i, gk = k0 + col;
      const bool ok = gi < M && gk < K;
      sm90::cp_async16(sa + pair_a_at(i, col), ok ? v.at(gi, col) : p.a_any(),
                       ok);
    }
  } else {
    using B = typename Cfg<T>::Bits;
    B* dst = reinterpret_cast<B*>(sa);
#pragma unroll 4
    for (int s = 0; s < 16; ++s) {
      if (!((halves >> (s / 8)) & 1u)) continue;
      const int i = tid / 32 + 4 * s, col = tid % 32;
      const int gi = m0 + i, gk = k0 + col;
      dst[pair_a_at(i, col)] =
          (gi < M && gk < K) ? *reinterpret_cast<const B*>(v.at(gi, col))
                             : B(0);
    }
  }
}

// Bit h set where an element this thread copied into half h (of `halves`)
// by load_a_pair is non-zero (NaN is, -0 is not in float32).
template <typename T, bool VEC>
__device__ __forceinline__ unsigned pair_nonzero(const T* sa,
                                                 unsigned halves) {
  constexpr unsigned kWord = Cfg<T>::kWord;
  const int tid = threadIdx.x;
  unsigned any[2] = {0, 0};
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!((halves >> (s / 2)) & 1u)) continue;
      const uint4 w = *reinterpret_cast<const uint4*>(
          sa + pair_a_at(tid / 8 + 16 * s, (tid % 8) * 4));
      any[s / 2] |= (w.x | w.y | w.z | w.w) & kWord;
    }
  } else {
    const unsigned* src = reinterpret_cast<const unsigned*>(sa);
#pragma unroll 4
    for (int s = 0; s < 16; ++s) {
      if (!((halves >> (s / 8)) & 1u)) continue;
      any[s / 8] |= src[pair_a_at(tid / 32 + 4 * s, tid % 32)] & kWord;
    }
  }
  return static_cast<unsigned>(any[0] != 0) |
         (static_cast<unsigned>(any[1] != 0) << 1);
}

// The block's vote on chunk ch's two halves, from each thread's bits
// `mine`: bit h set where any thread's is.  The loop's one barrier.
__device__ __forceinline__ unsigned pair_vote(unsigned mine, unsigned* words,
                                              int ch) {
  const unsigned w = __reduce_or_sync(0xffffffffu, mine);
  if (threadIdx.x % 32 == 0)
    reinterpret_cast<unsigned char*>(words + (ch & 1))[threadIdx.x / 32] =
        static_cast<unsigned char>(w);
  __syncthreads();
  unsigned f = words[ch & 1];
  f |= f >> 16;
  f |= f >> 8;
  return f & 3u;
}

// acc += A stage (64 x 32, pair_a_at) @ B stage (32 x 128) for the halves in
// kH (3 both, 1 the first, 2 the second), at 32-bit shared addresses sa and
// sb; see the pair body's note for the map.  A is read kPairAStep indices
// a load (LDS.128: 4), B two LDS.128 an index; the chunk's eight 4-index
// steps run kPairUnroll at a time, unrolled.  Each output's sum runs in
// index order, one multiply-add at a time.
template <unsigned kH, typename Acc>
__device__ __forceinline__ void mma_pair(unsigned sa, unsigned sb,
                                         Acc (&acc)[8][8]) {
  using V = std::conditional_t<std::is_same_v<Acc, float>, float4, uint4>;
  constexpr int j0 = (kH & 1u) ? 0 : 4, j1 = (kH & 2u) ? 8 : 4;
  constexpr int kA = kPairAStep, kU = kPairUnroll;
  const int lane = threadIdx.x % 32, g = lane % 8, h = lane / 8;
  const unsigned pa = sa + g * 32 * 4;  // row g
  const unsigned pb = sb + (32 * (threadIdx.x / 32) + 4 * h) * 4;
#pragma unroll 1
  for (int qq = 0; qq < 8; qq += kU)
#pragma unroll
    for (int q = qq; q < qq + kU; ++q)
#pragma unroll
      for (int p = 0; p < 4; p += kA) {
        V a[8];
        const unsigned aq = pa + ((q ^ g) << 4) + 4 * p;
#pragma unroll
        for (int j = j0; j < j1; ++j) lds<kA>(aq + j * 8 * 32 * 4, a[j]);
#pragma unroll
        for (int i = 0; i < kA; ++i) {
          const unsigned row = pb + (4 * q + p + i) * kBN * 4;
          V b0, b1;
          lds128(row, b0);
          lds128(row + 16 * 4, b1);
          const Acc b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int j = j0; j < j1; ++j) {
            const Acc x = i == 0 ? a[j].x : i == 1 ? a[j].y
                        : i == 2 ? a[j].z : a[j].w;
#pragma unroll
            for (int n = 0; n < 8; ++n) madd(acc[j][n], x, b[n]);
          }
        }
      }
}

// The half-warps map: warp w owns rows 32(w/2) + g + 8j (j = 0..3) and
// columns 64(w%2) + 16m + 4h .. +3 (m = 0..3), so each half is two warps'.
// For 4 indices a thread issues 4 A LDS.128 (rows 8 apart, chunk q ^ g: 4
// cycles each) and 16 of B (a quarter one chunk, the quarters' chunks
// adjacent: 2 cycles each) against 256 multiply-adds: 6 cycles per 32
// FFMA, as mma_pair's.  A warp adds the stage to its rows where its half
// was kept.
template <typename Acc>
__device__ __forceinline__ void mma_split(unsigned sa, unsigned sb,
                                          Acc (&acc)[4][16]) {
  using V = std::conditional_t<std::is_same_v<Acc, float>, float4, uint4>;
  constexpr int kU = kPairUnroll;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % 8, h = lane / 8;
  const unsigned pa = sa + (32 * (warp / 2) + g) * 32 * 4;
  const unsigned pb = sb + (64 * (warp % 2) + 4 * h) * 4;
#pragma unroll 1
  for (int qq = 0; qq < 8; qq += kU)
#pragma unroll
    for (int q = qq; q < qq + kU; ++q) {
      V a[4];
      const unsigned aq = pa + ((q ^ g) << 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) lds128(aq + j * 8 * 32 * 4, a[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned row = pb + (4 * q + i) * kBN * 4;
        V b[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) lds128(row + 16 * 4 * m, b[m]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Acc x = i == 0 ? a[j].x : i == 1 ? a[j].y
                      : i == 2 ? a[j].z : a[j].w;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            madd(acc[j][4 * m], x, b[m].x);
            madd(acc[j][4 * m + 1], x, b[m].y);
            madd(acc[j][4 * m + 2], x, b[m].z);
            madd(acc[j][4 * m + 3], x, b[m].w);
          }
        }
      }
    }
}

// The pair body's multiply for the halves a chunk's vote or mask kept
// (none: nothing).
template <typename T, typename Acc>
__device__ __forceinline__ void mma_halves(
    unsigned halves, const T* sa, const T* sb,
    Acc (&acc)[kPairRows][kPairCols]) {
  const unsigned a = sm90::smem_addr(sa), b = sm90::smem_addr(sb);
  if constexpr (kPairHalfWarps) {
    if ((halves >> (threadIdx.x / 64)) & 1u) mma_split(a, b, acc);
  } else {
    if (halves == 3u)
      mma_pair<3u>(a, b, acc);
    else if (halves == 1u)
      mma_pair<1u>(a, b, acc);
    else if (halves == 2u)
      mma_pair<2u>(a, b, acc);
  }
}

// C[m0 + ., n0 + .] of one output (M, N) from the pair body's register
// tiles: row r and columns e0 .. e0+3 of C for each row j and column run u
// of a thread's tile.
template <bool VEC, typename Acc, typename O>
__device__ __forceinline__ void store_pair(
    const Acc (&acc)[kPairRows][kPairCols], O* c, int M, int N, int m0,
    int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % 8, h = lane / 8;
#pragma unroll
  for (int j = 0; j < kPairRows; ++j) {
    const int gi = m0 + g + 8 * j + (kPairHalfWarps ? 32 * (warp / 2) : 0);
    if (gi >= M) continue;
    O* row = c + gi * N;
#pragma unroll
    for (int u = 0; u < kPairCols / 4; ++u) {
      const int gn = n0 + 4 * h +
                     (kPairHalfWarps ? 64 * (warp % 2) + 16 * u
                                     : 32 * warp + 16 * u);
      const Acc v[4] = {acc[j][4 * u], acc[j][4 * u + 1], acc[j][4 * u + 2],
                        acc[j][4 * u + 3]};
      if constexpr (VEC) {
        if (gn < N) put4(row + gn, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < N) row[gn + e] = static_cast<O>(v[e]);
      }
    }
  }
}

// run on the pair body: C[m0 : m0+64, n0 : n0+128] of one output (M, N),
// A and B read through the DenseTile policy p, in float32 (T float) or
// int32 (T int).  Needs pair_smem_bytes<T>() of dynamic shared memory.
// run's ring and order: A kAhead chunks ahead, the vote and B kVote ahead.
template <typename T, bool VEC, class P>
__device__ __forceinline__ void run_pair(const P& p, typename Cfg<T>::Out* c,
                                         int M, int K, int N, int m0, int n0,
                                         unsigned long long* issued) {
  using Cf = Cfg<T>;
  using Acc = std::remove_all_extents_t<typename Cf::Acc>;
  constexpr int kVote = Cf::kVote, kAhead = Cf::kAhead, kBK = Cf::kBK;
  static_assert(kBK == 32 && Cf::kAPitch == 32 && Cf::kBPitch == kBN,
                "the pair body's stages");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned words[2];  // the votes' words
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kPairBM * kBK;
  const int nc = (K + kBK - 1) / kBK;
  const unsigned rows = m0 + 32 < M ? 3u : 1u;  // the halves inside M
  Acc acc[kPairRows][kPairCols];
  zero(acc);
  auto stage_a = [&](int ch) {
    return sa + (ch % Cf::kAStages) * kPairBM * kBK;
  };
  auto stage_b = [&](int ch) { return sb + (ch % Cf::kBStages) * kBK * kBN; };
  auto vote = [&](int ch) {
    const unsigned kept = pair_vote(
        ch < nc ? pair_nonzero<T, VEC>(stage_a(ch), rows) : 0u, words, ch);
    if (kept) load_b<T, VEC>(stage_b(ch), p, N, ch * kBK, n0);
    return kept;
  };
  constexpr int kWait = 2 * (kAhead - kVote) < 2 * kVote - 1
                            ? 2 * (kAhead - kVote) : 2 * kVote - 1;
  unsigned nzq = 0;  // bits 2i, 2i + 1: the halves of chunk it + i
  int kept = 0;      // halves multiplied
  for (int it = -kAhead; it < nc; ++it) {
    if (it + kAhead < nc)
      load_a_pair<T, VEC>(stage_a(it + kAhead), p, M, K, m0,
                          (it + kAhead) * kBK, rows);
    sm90::cp_async_commit();
    if (it + kVote >= 0) {
      sm90::cp_async_wait<kWait>();
      nzq |= vote(it + kVote) << (2 * kVote);
    }
    sm90::cp_async_commit();
    if (it >= 0) {
      mma_halves(nzq & 3u, stage_a(it), stage_b(it), acc);
      kept += __popc(nzq & 3u);
    }
    nzq >>= 2;
  }
  sm90::cp_async_wait<0>();
  store_pair<VEC>(acc, c, M, N, m0, n0);
  // each kept half at its full size, padding rows and columns included
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

// run_masked on the pair body: mk[ch] and, where the second half lies
// inside M, mk[nc + ch] are the chunk mask's bytes of the two halves (the
// mask's rows m0 / 32 and m0 / 32 + 1).  The block walks the union of the
// two halves' marked chunks in index order, copying A for the marked
// halves only and B for every chunk it walks, and multiplies each half
// where its own byte is set: bitwise run_pair's C and count.
template <typename T, bool VEC, class P>
__device__ __forceinline__ void run_pair_masked(
    const P& p, const unsigned char* __restrict__ mk,
    typename Cfg<T>::Out* c, int M, int K, int N, int m0, int n0,
    unsigned long long* issued) {
  using Cf = Cfg<T>;
  using Acc = std::remove_all_extents_t<typename Cf::Acc>;
  constexpr int kBK = Cf::kBK, kS = Cf::kBStages, kAhead = kS - 1;
  static_assert(kBK == 32 && kBM == 32, "a mask chunk is 32 x 32");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kPairBM * kBK;
  const int nc = (K + kBK - 1) / kBK;
  const bool two = m0 + 32 < M;
  Acc acc[kPairRows][kPairCols];
  zero(acc);
  auto halves = [&](int ch) {
    return static_cast<unsigned>(__ldg(mk + ch) != 0) |
           (static_cast<unsigned>(two && __ldg(mk + nc + ch) != 0) << 1);
  };
  auto next = [&](int ch) {  // the first chunk after ch either half marks
    for (++ch; ch < nc && halves(ch) == 0; ++ch) {
    }
    return ch;
  };
  // stage s was last read by the multiply of chunk it - 1, before this
  // step's barrier
  auto fill = [&](int s, int ch) {
    load_a_pair<T, VEC>(sa + s * kPairBM * kBK, p, M, K, m0, ch * kBK,
                        halves(ch));
    load_b<T, VEC>(sb + s * kBK * kBN, p, N, ch * kBK, n0);
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
    sm90::cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (cl < nc) {
      fill((it + kAhead) % kS, cl);
      cl = next(cl);
    }
    sm90::cp_async_commit();
    const int s = it % kS;
    const unsigned hv = halves(cm);
    mma_halves(hv, sa + s * kPairBM * kBK, sb + s * kBK * kBN, acc);
    kept += __popc(hv);
    cm = next(cm);
  }
  sm90::cp_async_wait<0>();
  store_pair<VEC>(acc, c, M, N, m0, n0);
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

// -- the wide pair: K4 and K8 in float32 on 256 threads -------------------
//
// The pair body's 64-row block on eight warps, each thread on run's 8 x 4
// map (mma_chunk): warp w owns rows 8w .. 8w+7, so warps 0-3 are the first
// half's and 4-7 the second's, and a half's warps multiply only where its
// vote kept the chunk (warp-uniform).  The A stage is 64 x 32 unswizzled,
// B's 32 x 128; each B chunk is copied once for both halves.  128
// registers a thread, two blocks an SM: run's 16 warps an SM.
constexpr int kPair2Threads = 256;

// load_a (rows m0 .. m0+kRows-1 of a chunk, unswizzled, kRows 32 or 64) and
// load_b on the wide pair's 256 threads.
template <typename T, bool VEC, int kRows, class P>
__device__ __forceinline__ void load_a256(T* sa, const P& p, int M, int K,
                                          int m0, int k0) {
  constexpr int kThr = kPair2Threads;
  const int tid = threadIdx.x;
  const auto v = p.a_chunk(k0);
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < kRows * 8 / kThr; ++s) {
      const int e = tid + s * kThr;
      const int i = e / 8, col = (e % 8) * 4;
      const int gi = m0 + i, gk = k0 + col;
      const bool ok = gi < M && gk < K;
      sm90::cp_async16(sa + i * 32 + col, ok ? v.at(gi, col) : p.a_any(), ok);
    }
  } else {
    using B = typename Cfg<T>::Bits;
    B* dst = reinterpret_cast<B*>(sa);
#pragma unroll
    for (int s = 0; s < kRows * 32 / kThr; ++s) {
      const int e = tid + s * kThr;
      const int i = e / 32, col = e % 32;
      const int gi = m0 + i, gk = k0 + col;
      dst[i * 32 + col] = (gi < M && gk < K)
                              ? *reinterpret_cast<const B*>(v.at(gi, col))
                              : B(0);
    }
  }
}

template <typename T, bool VEC, class P>
__device__ __forceinline__ void load_b256(T* sb, const P& p, int N, int k0,
                                          int n0) {
  constexpr int kThr = kPair2Threads;
  const int tid = threadIdx.x;
  const auto v = p.b_chunk(k0);
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < 32 * 32 / kThr; ++s) {
      const int e = tid + s * kThr;
      const int kk = e / 32, col = (e % 32) * 4;
      const int gk = k0 + kk, gn = n0 + col;
      const bool ok = p.b_has(gk) && gn < N;
      sm90::cp_async16(sb + kk * kBN + col, ok ? v.row(kk) + gn : p.b_any(),
                       ok);
    }
  } else {
    using B = typename Cfg<T>::Bits;
    B* dst = reinterpret_cast<B*>(sb);
    for (int kk = tid / 32; kk < 32; kk += kThr / 32) {
      const int gk = k0 + kk;
      const bool row_ok = p.b_has(gk);
      const B* src = row_ok ? reinterpret_cast<const B*>(v.row(kk)) : nullptr;
#pragma unroll
      for (int c = tid % 32; c < kBN; c += 32)
        dst[kk * kBN + c] = (row_ok && n0 + c < N) ? src[n0 + c] : B(0);
    }
  }
}

// Bit h set where an element this thread copied into half h by
// load_a256<..., kPairBM> is non-zero (VEC: one vector a half; else four
// elements a half).
template <typename T, bool VEC>
__device__ __forceinline__ unsigned pair2_nonzero(const T* sa) {
  using Cf = Cfg<T>;
  constexpr unsigned kWord = Cf::kWord;
  const int tid = threadIdx.x;
  unsigned any[2] = {0, 0};
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          sa + Cf::a_at(tid / 8 + 32 * s, (tid % 8) * 4));
      any[s] |= (w.x | w.y | w.z | w.w) & kWord;
    }
  } else {
    const unsigned* src = reinterpret_cast<const unsigned*>(sa);
#pragma unroll
    for (int s = 0; s < 8; ++s)
      any[s / 4] |= src[Cf::a_at(tid / 32 + 8 * s, tid % 32)] & kWord;
  }
  return static_cast<unsigned>(any[0] != 0) |
         (static_cast<unsigned>(any[1] != 0) << 1);
}

// pair_vote on eight warps: a byte a warp in two words a parity.
__device__ __forceinline__ unsigned pair2_vote(unsigned mine, uint2* words,
                                               int ch) {
  const unsigned w = __reduce_or_sync(0xffffffffu, mine);
  if (threadIdx.x % 32 == 0)
    reinterpret_cast<unsigned char*>(words + (ch & 1))[threadIdx.x / 32] =
        static_cast<unsigned char>(w);
  __syncthreads();
  const uint2 v = words[ch & 1];
  unsigned f = v.x | v.y;
  f |= f >> 16;
  f |= f >> 8;
  return f & 3u;
}

// run on the wide pair: C[m0 : m0+64, n0 : n0+128], as run_pair.
template <typename T, bool VEC, class P>
__device__ __forceinline__ void run_pair2(const P& p,
                                          typename Cfg<T>::Out* c, int M,
                                          int K, int N, int m0, int n0,
                                          unsigned long long* issued) {
  using Cf = Cfg<T>;
  constexpr int kVote = Cf::kVote, kAhead = Cf::kAhead, kBK = Cf::kBK;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint2 words[2];  // the votes' words
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kPairBM * kBK;
  const int nc = (K + kBK - 1) / kBK;
  const bool two = m0 + 32 < M;  // whether the second half is inside M
  const unsigned half = threadIdx.x / 128;
  typename Cf::Acc acc = {};
  auto stage_a = [&](int ch) {
    return sa + (ch % Cf::kAStages) * kPairBM * kBK;
  };
  auto stage_b = [&](int ch) { return sb + (ch % Cf::kBStages) * kBK * kBN; };
  auto vote = [&](int ch) {
    const unsigned mine =
        ch < nc ? pair2_nonzero<T, VEC>(stage_a(ch)) & (two ? 3u : 1u) : 0u;
    const unsigned kept = pair2_vote(mine, words, ch);
    if (kept) load_b256<T, VEC>(stage_b(ch), p, N, ch * kBK, n0);
    return kept;
  };
  constexpr int kWait = 2 * (kAhead - kVote) < 2 * kVote - 1
                            ? 2 * (kAhead - kVote) : 2 * kVote - 1;
  unsigned nzq = 0;  // bits 2i, 2i + 1: the halves of chunk it + i
  int kept = 0;      // halves multiplied
  for (int it = -kAhead; it < nc; ++it) {
    if (it + kAhead < nc)
      load_a256<T, VEC, kPairBM>(stage_a(it + kAhead), p, M, K, m0,
                                 (it + kAhead) * kBK);
    sm90::cp_async_commit();
    if (it + kVote >= 0) {
      sm90::cp_async_wait<kWait>();
      nzq |= vote(it + kVote) << (2 * kVote);
    }
    sm90::cp_async_commit();
    if (it >= 0) {
      if ((nzq >> half) & 1u) mma_chunk(stage_a(it), stage_b(it), acc);
      kept += __popc(nzq & 3u);
    }
    nzq >>= 2;
  }
  sm90::cp_async_wait<0>();
  store<VEC>(acc, c, M, N, m0, n0);
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

// run_pair_masked on the wide pair.
template <typename T, bool VEC, class P>
__device__ __forceinline__ void run_pair2_masked(
    const P& p, const unsigned char* __restrict__ mk,
    typename Cfg<T>::Out* c, int M, int K, int N, int m0, int n0,
    unsigned long long* issued) {
  using Cf = Cfg<T>;
  constexpr int kBK = Cf::kBK, kS = Cf::kBStages, kAhead = kS - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cf::kAStages * kPairBM * kBK;
  const int nc = (K + kBK - 1) / kBK;
  const bool two = m0 + 32 < M;
  const unsigned half = threadIdx.x / 128;
  typename Cf::Acc acc = {};
  auto halves = [&](int ch) {
    return static_cast<unsigned>(__ldg(mk + ch) != 0) |
           (static_cast<unsigned>(two && __ldg(mk + nc + ch) != 0) << 1);
  };
  auto next = [&](int ch) {
    for (++ch; ch < nc && halves(ch) == 0; ++ch) {
    }
    return ch;
  };
  auto fill = [&](int s, int ch) {  // A of the marked halves only
    const unsigned hv = halves(ch);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if ((hv >> h) & 1u)
        load_a256<T, VEC, kBM>(sa + (s * kPairBM + h * kBM) * kBK, p, M, K,
                               m0 + h * kBM, ch * kBK);
    load_b256<T, VEC>(sb + s * kBK * kBN, p, N, ch * kBK, n0);
  };
  int cl = next(-1);
  int cm = cl;
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
    sm90::cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (cl < nc) {
      fill((it + kAhead) % kS, cl);
      cl = next(cl);
    }
    sm90::cp_async_commit();
    const int s = it % kS;
    const unsigned hv = halves(cm);
    if ((hv >> half) & 1u)
      mma_chunk(sa + s * kPairBM * kBK, sb + s * kBK * kBN, acc);
    kept += __popc(hv);
    cm = next(cm);
  }
  sm90::cp_async_wait<0>();
  store<VEC>(acc, c, M, N, m0, n0);
  if (issued != nullptr && threadIdx.x == 0 && kept > 0)
    atomicAdd(issued, static_cast<unsigned long long>(kept) * kBM * kBK * kBN);
}

// -- the probe's choice ------------------------------------------------------

constexpr int kFloatBody = 1;   // float32 on: 1 the pair body, 2 the wide pair
constexpr bool kIntToo = false;  // int32 on the same body

// K4's and K8's launch geometry in kind S (bell_banded.cu's Dense).
template <typename S>
struct PairDense {
  static constexpr int kBody =
      std::is_same_v<S, float> || (kIntToo && std::is_same_v<S, int>)
          ? kFloatBody : 0;
  static constexpr bool kPair = kBody != 0;
  static constexpr int kBM = kPair ? kPairBM : band::kBM;
  static constexpr int kThreads = kBody == 2 ? kPair2Threads : band::kThreads;
  static constexpr int kMinBlocks = kBody == 1   ? kPairMinBlocks
                                    : kBody == 2 ? 2
                                                 : Cfg<S>::kMinBlocks;
  static constexpr int kSmem = kPair ? pair_smem_bytes<S>() : smem_bytes<S>();
};

// band_kernel's body in kind S.
template <typename S, bool VEC, class P>
__device__ __forceinline__ void dense_run(const P& p,
                                          typename Cfg<S>::Out* c, int M,
                                          int K, int N, int m0, int n0,
                                          unsigned long long* issued) {
  if constexpr (PairDense<S>::kBody == 2)
    run_pair2<S, VEC>(p, c, M, K, N, m0, n0, issued);
  else if constexpr (PairDense<S>::kBody == 1)
    run_pair<S, VEC>(p, c, M, K, N, m0, n0, issued);
  else
    run<S, VEC>(p, c, M, K, N, m0, n0, issued);
}

// band_mask_kernel's body in kind S: bid is (tile, row block), nc the
// mask's chunks a row.  A pair body reads its two halves' mask rows m0 /
// 32 and m0 / 32 + 1.
template <typename S, bool VEC, class P>
__device__ __forceinline__ void dense_run_masked(
    const P& p, const unsigned char* __restrict__ mask, long long tile,
    long long bid, int nc, typename Cfg<S>::Out* c, int M, int K, int N,
    int m0, int n0, unsigned long long* issued) {
  const long long row = tile * ((M + kBM - 1) / kBM) + m0 / kBM;
  if constexpr (PairDense<S>::kBody == 2)
    run_pair2_masked<S, VEC>(p, mask + row * nc, c, M, K, N, m0, n0, issued);
  else if constexpr (PairDense<S>::kBody == 1)
    run_pair_masked<S, VEC>(p, mask + row * nc, c, M, K, N, m0, n0, issued);
  else
    run_masked<S, VEC>(p, mask + bid * nc, c, M, K, N, m0, n0, issued);
}

}  // namespace band
