// K7: block-SpGEMM slab apply on Hopper, C[o] = sum of Z1[a] @ Z2[b] over
// the products (a, b) aimed at output block o, in list order.
//
// Replaces the TPU kernel in sparse_tpu/ops/pallas_bsr.py::run_slabs_arrays
// (def :467, pallas_call :562, kernel :486-518).  The TPU walks slab
// schedules (per step, g slots of an A slot, a B slot and a row within a
// p-block slab; pads read zero blocks).  Here the schedule is first turned
// into a product list (ops/cuda_bsr.py: built once per plan, or per call
// on the device for the raw-array route): prod_ptr (n_out+1) gives each
// output block's first product and prod_ab (F, 2) each product's A slot
// and B slot, in slot order within its output block.
//
// What bounds it on this card: at bsz 32 in float32 a product is 64 KFLOP
// against two 4 KB blocks that mostly come from the 50 MB L2 (each stored
// block feeds ~10 products), and every output block (4 KB) is written once
// to device memory.  At the SpGEMM fixture both bounds sit near 0.19 ms:
// 11.9 GFLOP on the CUDA cores (full float32 is the contract: no TF32) and
// a 570 MB output stream.  Three quarters of its outputs have one product.
//
// What the design does about it: persistent teams (one warp per output
// block for bsz <= 32, four warps for bsz <= 64), about (SMs x teams per
// SM) of them.  The list is cut into kPieces ranges of output blocks per
// team, balanced by products plus one per output (binary searches of
// prod_ptr at the start); a team walks its kPieces ranges in turn, so the
// teams running at one time work on one stretch of the output and meet
// the factor blocks it needs in L2 (one contiguous range per team spread
// them over the whole output: 0.55 ms against 0.39 at the fixture on an
// H100, PERF.md).  One kernel serves every kind: a team keeps a ring of
// three stages in shared memory (Cfg / Geo below, DmmaGeo for float64
// past bsz 8), filled by 16-byte cp.async two stages ahead ACROSS
// products, output blocks and pieces; the copy into the stage consumed
// one step before is issued before each multiply, so two stages' copies
// are in flight while one is multiplied and while an output with one
// product is stored.  float32, int32 and bf16: stages of whole products
// (A block | B block); a ring of 16-wide k-slices with more warps an SM
// ran slower in all three (Cfg).  float64 past bsz 8: stages of 16-wide
// k-slices, a product bsz / 16 of them multiplied in k order (so each
// output's sums keep a whole product's order).
// One barrier per stage (the team's).  Float32, int32 (as unsigned:
// multiply-adds modulo 2^32, the reference's wrapping int32 result in any
// order) and float64 at bsz <= 8: each lane keeps an 8x4 tile of a
// 32 x 32 output (rows r + 4q, so the padded A rows give conflict-free
// 16-byte loads; B rows are broadcast 16-byte loads).  bf16: mma.sync
// m16n8k16 from ldmatrix fragments (rows padded by 16 bytes), float32
// sums rounded once.  float64 past bsz 8: Hopper's m16n8k8 DMMA on
// unpadded slices with swizzled rows (DmmaGeo below): the CUDA cores'
// float64 FMA tile ran at half the float64 tensor rate and paid two
// 8-byte operands a 16-byte load.  Each output block is written once,
// from registers, with 16-byte streaming stores (__stcs) so the output
// stream does not push factor blocks out of L2; an output with no product
// is written as zeros.  Products are summed in list order, no atomics on
// the output: two runs are bitwise equal.  Block sizes that are not 8, 16,
// 32 or 64 (or unaligned pointers) take element copies (into whole-product
// stages whose padding the kernel zeroed once; float64's slices with zeros
// past bsz) and guarded element stores.  With a counter, each team
// adds the products it multiplied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90_async.cuh"
#include "sm90_tma.cuh"

namespace {

// Element types of the C entry point.
enum Kind { kF32 = 0, kBF16 = 2, kF64 = 3, kI32 = 4 };

constexpr int kThreads = 128;  // four warps per thread block
constexpr unsigned kFull = 0xffffffffu;

// Per element type: ring depth, and the row padding of the staged A and B
// blocks (elements).  The float32, int32 and bf16 kinds stage whole
// products: 16-wide k-slices, 3-6 stages a team and 12-20 warps an SM, ran
// slower in each of them at the SpGEMM fixture on an H100 (float32
// 0.43-0.45 ms against 0.39-0.42, bf16 0.29 against 0.23, int32 0.53
// against 0.50; tools/slab_variants.py --form ring, PERF.md).  Copies hold
// these kinds, and an A slice reads half of each block row, so a
// product's copies take twice the L1 requests for A's bytes and twice the
// waits, barriers and producer steps: bf16's copies alone went 0.23 ->
// 0.28 ms.
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kStages = 3, kPadA = 4, kPadB = 0;
};
// float64 at BS 8 (the FMA tile; DMMA's m16 would pad it to twice the
// work); BS 16-64 run DmmaGeo's ring below.
template <>
struct Cfg<double> {
  static constexpr int kStages = 3, kPadA = 4, kPadB = 0;
};
// int32 runs as unsigned: the float32 team body's stages and padding, sums
// modulo 2^32 (the reference's wrapping int32 result in any order), the
// blocks and C read and written as their bits.
template <>
struct Cfg<unsigned> {
  static constexpr int kStages = 3, kPadA = 4, kPadB = 0;
};
// rows padded by 16 bytes, so each ldmatrix phase's eight row addresses
// fall in eight bank groups
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kStages = 3, kPadA = 8, kPadB = 8;
};

// BS: the block size padded to 8, 16, 32 or 64.  A team is one warp (one
// 32 x 32 tile) for BS <= 32, four warps (a 2 x 2 grid of tiles) for 64.
// A stage holds one product: A's BS x BS block in rows of pitch PA, then
// B's in rows of pitch PB.  The walk and the copies take a product as
// kParts k-slices of KD, as DmmaGeo's are; here KD = BS, one stage.
template <typename T, int BS>
struct Geo {
  static constexpr int W = BS > 32 ? 4 : 1;
  static constexpr int kTeams = kThreads / (32 * W);
  static constexpr int TS = BS > 32 ? 32 : BS;  // a warp's tile side
  static constexpr int KD = BS;
  static constexpr int kParts = BS / KD;        // stages a product
  static constexpr int PA = KD + Cfg<T>::kPadA, PB = BS + Cfg<T>::kPadB;
  static constexpr int kStage = BS * PA + KD * PB;  // elements
  static constexpr int kStages = Cfg<T>::kStages;
  static constexpr int kPieces = 8;  // output ranges a team
  static constexpr int kTeamElems = kStages * kStage;
  static constexpr int kBytes =
      kTeams * kTeamElems * static_cast<int>(sizeof(T));
  // offsets (elements) of A part element (r, c), c < KD, and of B part
  // element (k, n), k < KD
  __device__ static __forceinline__ int a_at(int r, int c) {
    return r * PA + c;
  }
  __device__ static __forceinline__ int b_at(int k, int n) {
    return BS * PA + k * PB + n;
  }
};

template <int W>
__device__ __forceinline__ void team_sync() {
  if constexpr (W == 1)
    __syncwarp();
  else
    __syncthreads();  // a four-warp team is the whole thread block
}

// Smallest o in [0, n] with prod_ptr[o] + o >= t (prod_ptr[n] + n is the
// total), for two targets t1 and t2 at once: one binary search each, their
// loads side by side.
__device__ __forceinline__ int2 find_starts(const int* __restrict__ prod_ptr,
                                            int n, long long t1,
                                            long long t2) {
  int lo1 = 0, hi1 = n, lo2 = 0, hi2 = n;
  while (lo1 < hi1 || lo2 < hi2) {
    const int m1 = (lo1 + hi1) >> 1, m2 = (lo2 + hi2) >> 1;
    if (lo1 < hi1) {
      if (static_cast<long long>(__ldg(prod_ptr + m1)) + m1 >= t1)
        hi1 = m1;
      else
        lo1 = m1 + 1;
    }
    if (lo2 < hi2) {
      if (static_cast<long long>(__ldg(prod_ptr + m2)) + m2 >= t2)
        hi2 = m2;
      else
        lo2 = m2 + 1;
    }
  }
  return make_int2(lo1, lo2);
}

// src[i] for a warp walking i = start, start+1, ...: lane l holds
// src[base + l] and src[base + 32 + l], so each value was asked for 32
// steps before it is read.  Entries at or past n read 0.
template <typename V>
struct Ahead {
  const V* src;
  int n, base;
  V cur, nxt;
  __device__ __forceinline__ V ld(int i) const {
    return i < n ? __ldg(src + i) : V{};
  }
  __device__ __forceinline__ void init(const V* s, int n_, int start,
                                       int lane) {
    src = s;
    n = n_;
    base = start;
    cur = ld(base + lane);
    nxt = ld(base + 32 + lane);
  }
  __device__ __forceinline__ V get(int i, int lane) {
    if (i >= base + 32) {
      base += 32;
      cur = nxt;
      nxt = ld(base + 32 + lane);
    }
    return shfl(cur, i - base);
  }
  __device__ __forceinline__ static int shfl(int v, int l) {
    return __shfl_sync(kFull, v, l);
  }
  __device__ __forceinline__ static int2 shfl(int2 v, int l) {
    return make_int2(__shfl_sync(kFull, v.x, l), __shfl_sync(kFull, v.y, l));
  }
};

// -- float32 / float64 / int32: 8x4 (BS 32, 64), 4x2 (16), 2x1 (8) lane tiles
// Lane l: r = l / 8 owns rows R0 + r + 4q, c = l % 8 owns columns
// C0 + c*TC .. +TC-1 of the warp's tile (R0, C0).

template <typename S, int N>
struct Vec {
  S v[N];
};

template <typename S, int N>
__device__ __forceinline__ Vec<S, N> lds(const S* p) {
  Vec<S, N> r;
  if constexpr (sizeof(S) * N >= 16) {
    constexpr int P = 16 / static_cast<int>(sizeof(S));
#pragma unroll
    for (int i = 0; i < N; i += P) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const S* s = reinterpret_cast<const S*>(&u);
#pragma unroll
      for (int j = 0; j < P; ++j) r.v[i + j] = s[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = p[i];
  }
  return r;
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

template <typename S, int BS>
struct FmaTile {
  using G = Geo<S, BS>;
  static constexpr int TR = G::TS / 4, TC = G::TS / 8;
  S acc[TR][TC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < TR; ++q)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[q][j] = S(0);
  }

  // one stage: k = 0 .. KD-1 of the slice, in order
  __device__ __forceinline__ void multiply(const S* st, int lane, int wt) {
    const int R0 = (wt / 2) * 32, C0 = (wt % 2) * 32;
    const S* pa = st + (R0 + lane / 8) * G::PA;
    const S* pb = st + BS * G::PA + C0 + (lane % 8) * TC;
#pragma unroll
    for (int k = 0; k < G::KD; k += 4) {
      Vec<S, 4> a[TR];
#pragma unroll
      for (int q = 0; q < TR; ++q) a[q] = lds<S, 4>(pa + 4 * q * G::PA + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const Vec<S, TC> b = lds<S, TC>(pb + (k + kk) * G::PB);
#pragma unroll
        for (int q = 0; q < TR; ++q)
#pragma unroll
          for (int j = 0; j < TC; ++j)
            acc[q][j] = mad(a[q].v[kk], b.v[j], acc[q][j]);
      }
    }
  }

  __device__ __forceinline__ void store(S* dst, int bsz, bool vec, int lane,
                                        int wt) const {
    const int R0 = (wt / 2) * 32, C0 = (wt % 2) * 32;
    const int c0 = C0 + (lane % 8) * TC;
#pragma unroll
    for (int q = 0; q < TR; ++q) {
      const int row = R0 + lane / 8 + 4 * q;
      if (vec) {  // bsz == BS: whole rows of whole vectors
        S* p = dst + row * BS + c0;
        if constexpr (sizeof(S) * TC >= 16) {
          constexpr int P = 16 / static_cast<int>(sizeof(S));
#pragma unroll
          for (int j = 0; j < TC; j += P) {
            uint4 u;
            S* s = reinterpret_cast<S*>(&u);
#pragma unroll
            for (int i = 0; i < P; ++i) s[i] = acc[q][j + i];
            __stcs(reinterpret_cast<uint4*>(p + j), u);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TC; ++j) __stcs(p + j, acc[q][j]);
        }
      } else if (row < bsz) {
#pragma unroll
        for (int j = 0; j < TC; ++j)
          if (c0 + j < bsz) dst[row * bsz + c0 + j] = acc[q][j];
      }
    }
  }
};

// -- bf16: mma.sync m16n8k16, MT x NT tiles per warp -----------------------

template <int BS>
struct MmaTile {
  using T = __nv_bfloat16;
  using G = Geo<T, BS>;
  static constexpr int MT = G::TS / 16, NT = G::TS / 8;
  float acc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  }

  // one stage: its k-slice of 16 (one m16n8k16 step)
  __device__ __forceinline__ void multiply(const T* st, int lane, int wt) {
    const int R0 = (wt / 2) * 32, C0 = (wt % 2) * 32;
    const T* sa = st;
    const T* sb = st + BS * G::PA;
#pragma unroll
    for (int ks = 0; ks < G::KD; ks += 16) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        sm90::ldmatrix_x4(a[mt], sa + (R0 + mt * 16 + lane % 16) * G::PA +
                                     ks + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        sm90::ldmatrix_x4_trans(
            r, sb + (ks + (lane / 8) % 2 * 8 + lane % 8) * G::PB + C0 +
                   np * 16 + (lane / 16) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          sm90::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
    }
  }

  static __device__ __forceinline__ unsigned pick(const unsigned (&w)[4],
                                                  int i) {
    return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
  }

  // Element (row mt*16 + lane/4 + 8h, column nt*8 + 2*(lane%4) + e) of the
  // warp's tile is acc[mt][nt][2h + e].  Aligned blocks: the four lanes of
  // a quad trade their bf16 pairs (a 4 x 4 transpose by shuffles) so lane
  // q holds n-tile q's eight columns and writes them as one 16-byte store.
  __device__ __forceinline__ void store(T* dst, int bsz, bool vec, int lane,
                                        int wt) const {
    const int R0 = (wt / 2) * 32, C0 = (wt % 2) * 32;
    const int q = lane & 3, quad = lane & ~3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = R0 + mt * 16 + lane / 4 + 8 * h;
        if (vec) {
          unsigned w[4], got[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            w[nt] = 0u;
            if (nt < NT) {
              const __nv_bfloat162 p = __floats2bfloat162_rn(
                  acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
              w[nt] = *reinterpret_cast<const unsigned*>(&p);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // lane q receives from lane (q - j) & 3 that lane's word q
            const int src = (q - j) & 3;
            const unsigned v =
                __shfl_sync(kFull, pick(w, (q + j) & 3), quad + src);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              if (src == s) got[s] = v;
          }
          if (q < NT)
            __stcs(reinterpret_cast<uint4*>(dst + row * BS + C0 + q * 8),
                   make_uint4(got[0], got[1], got[2], got[3]));
        } else if (row < bsz) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = C0 + nt * 8 + 2 * q + e;
              if (col < bsz)
                dst[row * bsz + col] =
                    __float2bfloat16_rn(acc[mt][nt][2 * h + e]);
            }
        }
      }
  }
};

// -- float64 on Hopper's m16n8k8 DMMA, BS 16, 32, 64 ------------------------
//
// A stage holds a k-slice of KD = 16 of one product, unpadded, each
// row's 16-byte chunks XOR-swizzled by 2 * (row % 4), so
// every fragment load (a lane's double) is one shared-memory wavefront per
// half warp: A's lanes (g, t) read rows g, in chunks (kk + t) / 2 ^ 2g,
// B's rows kk + t in chunks n / 2 ^ 2t, 16 distinct 8-byte slots of a
// 128-byte line either way.  Three stages a team keep two stages' copies
// in flight while a third is multiplied, in 24 KB a one-warp team at BS 32
// (two 128-thread blocks an SM; 48 KB a four-warp team at BS 64); with
// two, one copy in flight, the apply took 0.82 ms against 0.70 at the
// SpGEMM fixture (tools/slab_variants.py).

template <int BS>
struct DmmaGeo {
  static constexpr int W = BS > 32 ? 4 : 1;  // warps a team
  static constexpr int kTeams = kThreads / (32 * W);
  static constexpr int TS = BS > 32 ? 32 : BS;  // a warp's tile side
  static constexpr int MT = TS / 16, NT = TS / 8;
  static constexpr int KD = 16;            // k of a stage
  static constexpr int kParts = BS / KD;   // stages a product
  static constexpr int kStage = 2 * BS * KD;  // doubles: A part, B part
  static constexpr int kStages = 3;
  static constexpr int kTeamElems = kStages * kStage;
  static constexpr int kBytes = kTeams * kTeamElems * 8;
  // output ranges a team: the teams running at one time walk 1/kPieces of
  // the outputs, whose factor blocks then fit the L2 in float64 too (at
  // the SpGEMM fixture's band, by its block counts, ~46 MB at 8 and ~17
  // MB at 32 of A's 156 MB; 0.83 ms at 8, 0.73 at 16, 0.70 at 32 on an
  // H100, tools/slab_variants.py)
  static constexpr int kPieces = 32;
  // offsets (doubles) of A part element (r, c), c < KD, and of B part
  // element (k, n), k < KD
  __device__ static __forceinline__ int a_at(int r, int c) {
    return r * KD + ((((c >> 1) ^ ((r & 3) << 1))) << 1) + (c & 1);
  }
  __device__ static __forceinline__ int b_at(int k, int n) {
    return BS * KD + k * BS + ((((n >> 1) ^ ((k & 3) << 1))) << 1) + (n & 1);
  }
};

// A warp's TS x TS tile of the output at (R0, C0) as MT x NT fragments of
// m16n8: lane 4g + t holds (R0 + 16 mt + g (+8), C0 + 8 nt + 2t (+1)).
template <int BS>
struct DmmaTile {
  using G = DmmaGeo<BS>;
  double acc[G::MT][G::NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < G::MT; ++m)
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0;
  }

  __device__ __forceinline__ void multiply(const double* st, int lane,
                                           int wt) {
    const int R0 = (wt / 2) * 32, C0 = (wt % 2) * 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < G::KD; kk += 8) {
      double a[G::MT][4], b[G::NT][2];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)  // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
          a[mt][i] = st[G::a_at(R0 + 16 * mt + g + 8 * (i & 1),
                                kk + t + 4 * (i >> 1))];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)  // (t, g), (t+4, g)
          b[nt][i] = st[G::b_at(kk + t + 4 * i, C0 + 8 * nt + g)];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt)
          sm90::mma_f64_16808(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // Aligned blocks: each lane's column pair as one 16-byte streaming
  // store; else guarded element stores.
  __device__ __forceinline__ void store(double* dst, int bsz, bool vec,
                                        int lane, int wt) const {
    const int R0 = (wt / 2) * 32, C0 = (wt % 2) * 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = R0 + 16 * mt + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          const int col = C0 + 8 * nt + 2 * t;
          const double x0 = acc[mt][nt][2 * h], x1 = acc[mt][nt][2 * h + 1];
          if (vec) {
            __stcs(reinterpret_cast<double2*>(dst + row * BS + col),
                   make_double2(x0, x1));
          } else if (row < bsz) {
            if (col < bsz) dst[row * bsz + col] = x0;
            if (col + 1 < bsz) dst[row * bsz + col + 1] = x1;
          }
        }
      }
  }
};

// The body kind T runs at BS: its stage geometry G, its tile, the body's
// number (0 the FMA tile, 1 bf16 mma.sync, 2 float64 DMMA) and the
// minimum resident blocks an SM of the kernel's launch bounds (0: none,
// ptxas's own register count).  float64 past BS 8 runs DMMA.  bf16 at BS
// 16 asks for one: left to itself ptxas holds its walk to 64 registers and
// spills 8 bytes a thread; asked for one block, it takes 82 and spills
// none.  Every other kind keeps ptxas's count: a minimum of 1 gave them
// 5-43 registers more (float64's DMMA 211 against 168, 3% slower; bf16 at
// BS 64 146 against 126, 3 blocks an SM instead of 4, 14% slower at bsz
// 40 on an H100; tools/slab_variants.py, PERF.md).
template <typename T, int BS,
          bool D = std::is_same<T, double>::value && BS >= 16>
struct Body {
  using G = Geo<T, BS>;
  using Tile = FmaTile<T, BS>;
  static constexpr int kBody = 0, kMinBlocks = 0;
};
template <int BS>
struct Body<__nv_bfloat16, BS, false> {
  using G = Geo<__nv_bfloat16, BS>;
  using Tile = MmaTile<BS>;
  static constexpr int kBody = 1, kMinBlocks = BS == 16 ? 1 : 0;
};
template <typename T, int BS>
struct Body<T, BS, true> {
  using G = DmmaGeo<BS>;
  using Tile = DmmaTile<BS>;
  static constexpr int kBody = 2, kMinBlocks = 0;
};

// -- copies --------------------------------------------------------------

// Part `part` of one product (A's columns and B's rows KD part .. +KD-1)
// into a stage.  vec (bsz == BS, 16-byte aligned): cp.async, 16 bytes a
// thread; else element copies: of the data region of a whole-product
// stage whose padding the kernel zeroed once, or of the whole slice with
// zeros past bsz (a slice's stage holds other k-ranges in turn).
template <typename T, int BS>
__device__ __forceinline__ void copy_part(T* st, const T* __restrict__ a,
                                          const T* __restrict__ b, int part,
                                          int bsz, bool vec, int tt) {
  using G = typename Body<T, BS>::G;
  constexpr int TT = 32 * G::W, KD = G::KD;
  const int k0 = part * KD;
  if (vec) {
    // 16-byte chunks: N of A's part and N of B's, thread tt copying chunk
    // e = tt + s * TT of each
    constexpr int V = 16 / static_cast<int>(sizeof(T)), N = BS * KD / V;
#pragma unroll
    for (int s = 0; s < (N + TT - 1) / TT; ++s) {
      const int e = tt + s * TT;
      if (N % TT == 0 || e < N) {
        const int r = e / (KD / V), c = (e % (KD / V)) * V;
        const int k = e / (BS / V), n = (e % (BS / V)) * V;
        sm90::cp_async16(st + G::a_at(r, c), a + r * BS + k0 + c, true);
        sm90::cp_async16(st + G::b_at(k, n), b + (k0 + k) * BS + n, true);
      }
    }
  } else if constexpr (G::kParts == 1) {
    for (int e = tt; e < bsz * bsz; e += TT) {
      const int r = e / bsz, c = e - r * bsz;
      st[G::a_at(r, c)] = a[e];
      st[G::b_at(r, c)] = b[e];
    }
  } else {
    for (int e = tt; e < BS * KD; e += TT) {
      const int r = e / KD, c = e % KD;
      st[G::a_at(r, c)] =
          r < bsz && k0 + c < bsz ? a[r * bsz + k0 + c] : T{};
      const int k = e / BS, n = e % BS;
      st[G::b_at(k, n)] =
          k0 + k < bsz && n < bsz ? b[(k0 + k) * bsz + n] : T{};
    }
  }
}

// -- the kernel ----------------------------------------------------------

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads, Body<T, BS>::kMinBlocks)
    slab_kernel(const T* __restrict__ z1, const T* __restrict__ z2,
                const int* __restrict__ prod_ptr,
                const int2* __restrict__ prod_ab, T* __restrict__ out,
                int n_out, int bsz, int vec,
                unsigned long long* __restrict__ issued) {
  using B = Body<T, BS>;
  using G = typename B::G;
  constexpr int S = G::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team = warp / G::W, wt = warp % G::W;
  const int tt = threadIdx.x % (32 * G::W);
  T* ring = reinterpret_cast<T*>(smem) + team * G::kTeamElems;

  // The list is cut into kPieces x (teams) ranges of output blocks,
  // balanced by products plus one per output; team g takes the pieces g,
  // g + teams, ...  in turn, so the teams running at one time work on one
  // stretch of the outputs and share its factor blocks in L2.  Lane
  // l < kPieces finds piece l's first and one-past-last output (p0, p1)
  // and first and one-past-last product (f0, f1).
  const long long nteams = static_cast<long long>(gridDim.x) * G::kTeams;
  const long long g = static_cast<long long>(blockIdx.x) * G::kTeams + team;
  const long long total = static_cast<long long>(__ldg(prod_ptr + n_out)) +
                          n_out;
  const long long npieces = nteams * G::kPieces;
  int p0 = 0, p1 = 0, f0 = 0, f1 = 0;
  if (lane < G::kPieces) {
    const long long piece = g + lane * nteams;
    const int2 o = find_starts(prod_ptr, n_out, total * piece / npieces,
                               total * (piece + 1) / npieces);
    p0 = o.x;
    p1 = o.y;
    f0 = __ldg(prod_ptr + p0);
    f1 = __ldg(prod_ptr + p1);
  }
  if constexpr (G::kParts == 1) {
    if (!vec) {  // element copies fill only the data region: zero the rest
      unsigned* z = reinterpret_cast<unsigned*>(ring);
      for (int e = tt; e < G::kTeamElems * static_cast<int>(sizeof(T)) / 4;
           e += 32 * G::W)
        z[e] = 0u;
      team_sync<G::W>();
    }
  }
  const long long bsz2 = static_cast<long long>(bsz) * bsz;

  // producer: part `part` of product fp into stage ps, one cp.async group
  // a step, across outputs and pieces
  int pp = 0, part = 0;
  int fp = __shfl_sync(kFull, f0, 0), fend = __shfl_sync(kFull, f1, 0);
  int ps = 0;
  Ahead<int2> pairs;
  pairs.init(prod_ab, fend, fp, lane);
  auto produce = [&]() {
    while (fp >= fend && pp + 1 < G::kPieces) {
      ++pp;
      fp = __shfl_sync(kFull, f0, pp);
      fend = __shfl_sync(kFull, f1, pp);
      if (fp < fend) pairs.init(prod_ab, fend, fp, lane);
    }
    if (fp < fend) {
      const int2 ab = pairs.get(fp, lane);
      copy_part<T, BS>(ring + ps * G::kStage, z1 + ab.x * bsz2,
                       z2 + ab.y * bsz2, G::kParts == 1 ? 0 : part, bsz,
                       vec != 0, tt);
    }
    sm90::cp_async_commit();
    if (G::kParts == 1 || ++part == G::kParts) {
      part = 0;
      ++fp;
    }
    ps = ps + 1 == S ? 0 : ps + 1;
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) produce();

  typename B::Tile tile;
  int cs = 0;
  unsigned long long walked = 0;  // products multiplied
  for (int pc = 0; pc < G::kPieces; ++pc) {
    const int o0 = __shfl_sync(kFull, p0, pc), o1 = __shfl_sync(kFull, p1, pc);
    int fc = __shfl_sync(kFull, f0, pc);
    if (o0 >= o1) continue;
    Ahead<int> ends;
    ends.init(prod_ptr, n_out + 1, o0 + 1, lane);
    for (int o = o0; o < o1; ++o) {
      const int fe = ends.get(o + 1, lane);
      tile.zero();
      for (; fc < fe; ++fc) {
#pragma unroll 1
        for (int k = 0; k < G::kParts; ++k) {
          // this stage has landed; every lane of the team is done with
          // the one before, which the copy issued here refills
          sm90::cp_async_wait<S - 2>();
          team_sync<G::W>();
          produce();
          tile.multiply(ring + cs * G::kStage, lane, wt);
          cs = cs + 1 == S ? 0 : cs + 1;
        }
        ++walked;
      }
      tile.store(out + o * bsz2, bsz, vec != 0, lane, wt);
    }
  }
  sm90::cp_async_wait<0>();
  if (issued != nullptr && tt == 0)
    atomicAdd(issued, walked);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Sets the kernel's shared-memory limit and gives its resident thread
// blocks per SM (asked once).
template <typename T, int BS>
cudaError_t blocks_per_sm(int& per_sm_out) {
  using G = typename Body<T, BS>::G;
  if constexpr (G::kBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_kernel<T, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::kBytes);
    if (e != cudaSuccess) return e;
  }
  static int per_sm = 0;
  if (per_sm == 0) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, slab_kernel<T, BS>, kThreads, G::kBytes);
    if (e != cudaSuccess) return e;
    per_sm = n < 1 ? 1 : n;
  }
  per_sm_out = per_sm;
  return cudaSuccess;
}

template <typename T, int BS>
cudaError_t launch_bs(const void* z1, const void* z2, const void* prod_ptr,
                      const void* prod_ab, void* out, int n_out, int bsz,
                      unsigned long long* issued, cudaStream_t stream) {
  using G = typename Body<T, BS>::G;
  int per_sm = 0;
  cudaError_t e = blocks_per_sm<T, BS>(per_sm);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // persistent: no more teams than the card holds at once, or than outputs
  const long long want = (static_cast<long long>(n_out) + G::kTeams - 1) /
                         G::kTeams;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  const bool vec = bsz == BS && aligned16(z1) && aligned16(z2) &&
                   aligned16(out);
  slab_kernel<T, BS><<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(z1), static_cast<const T*>(z2),
      static_cast<const int*>(prod_ptr), static_cast<const int2*>(prod_ab),
      static_cast<T*>(out), n_out, bsz, vec ? 1 : 0, issued);
  return cudaGetLastError();
}

// The launched geometry at BS: out[0..8] = ring stages a team, shared
// bytes a block, resident blocks an SM, registers a thread, local bytes a
// thread, teams a block, body (0 the FMA tile, 1 bf16 mma.sync, 2 float64
// DMMA), k of a stage, output ranges (pieces) a team.
template <typename T, int BS>
cudaError_t geometry_bs(int* out) {
  using B = Body<T, BS>;
  using G = typename B::G;
  int per_sm = 0;
  cudaError_t e = blocks_per_sm<T, BS>(per_sm);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, slab_kernel<T, BS>);
  if (e != cudaSuccess) return e;
  out[0] = G::kStages;
  out[1] = G::kBytes;
  out[2] = per_sm;
  out[3] = at.numRegs;
  out[4] = static_cast<int>(at.localSizeBytes);
  out[5] = G::kTeams;
  out[6] = B::kBody;
  out[7] = G::KD;
  out[8] = G::kPieces;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* z1, const void* z2, const void* prod_ptr,
                   const void* prod_ab, void* out, long long n_out,
                   long long bsz, unsigned long long* issued, void* stream) {
  if (n_out <= 0) return cudaSuccess;
  if (bsz < 1 || bsz > 64 || n_out >= 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_out), b = static_cast<int>(bsz);
  if constexpr (sizeof(T) > 2) {  // bf16's mma tiles start at 16
    if (b <= 8)
      return launch_bs<T, 8>(z1, z2, prod_ptr, prod_ab, out, n, b, issued,
                             st);
  }
  if (b <= 16)
    return launch_bs<T, 16>(z1, z2, prod_ptr, prod_ab, out, n, b, issued,
                            st);
  if (b <= 32)
    return launch_bs<T, 32>(z1, z2, prod_ptr, prod_ab, out, n, b, issued,
                            st);
  return launch_bs<T, 64>(z1, z2, prod_ptr, prod_ab, out, n, b, issued, st);
}

// geometry_bs at the BS launch<T> takes for bsz.
template <typename T>
cudaError_t geometry(long long bsz, int* out) {
  if (bsz < 1 || bsz > 64) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) > 2) {
    if (bsz <= 8) return geometry_bs<T, 8>(out);
  }
  if (bsz <= 16) return geometry_bs<T, 16>(out);
  if (bsz <= 32) return geometry_bs<T, 32>(out);
  return geometry_bs<T, 64>(out);
}

}  // namespace

extern "C" {

// kind: 0 float32, 2 bfloat16 (float32 sums, rounded once), 3 float64, 4
// int32 (sums modulo 2^32).
// z1, z2 (., bsz, bsz) and C (n_out, bsz, bsz) in that type; prod_ptr
// (n_out + 1) and prod_ab (F, 2) int32, the product list.  issued: null,
// or a counter on the card (zeroed by the caller) that gets the products
// multiplied.  Returns cudaGetLastError() after the launch.
int bsr_slab(int kind, const void* z1, const void* z2, const void* prod_ptr,
             const void* prod_ab, void* out, long long n_out, long long bsz,
             void* issued, void* stream) {
  auto* count = static_cast<unsigned long long*>(issued);
  switch (kind) {
    case kF32:
      return launch<float>(z1, z2, prod_ptr, prod_ab, out, n_out, bsz, count,
                           stream);
    case kBF16:
      return launch<__nv_bfloat16>(z1, z2, prod_ptr, prod_ab, out, n_out,
                                   bsz, count, stream);
    case kF64:
      return launch<double>(z1, z2, prod_ptr, prod_ab, out, n_out, bsz,
                            count, stream);
    case kI32:
      return launch<unsigned>(z1, z2, prod_ptr, prod_ab, out, n_out, bsz,
                              count, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The geometry bsr_slab launches for kind and bsz (geometry_bs): out[0..8]
// = ring stages a team, shared bytes a block, resident blocks an SM,
// registers and local bytes a thread, teams a block, body, k of a stage,
// pieces a team.  Returns a cudaError_t.
int bsr_slab_geometry(int kind, long long bsz, int* out) {
  switch (kind) {
    case kF32: return geometry<float>(bsz, out);
    case kBF16: return geometry<__nv_bfloat16>(bsz, out);
    case kF64: return geometry<double>(bsz, out);
    case kI32: return geometry<unsigned>(bsz, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
