// K6's wide-block body (bell_spmm.cu) past bsz 64, for float32, bf16,
// bf16x3 and float64 streams: C[r] (bsz, k) = sum over the slots l of block
// row r of blocks[r, l] (bsz, bsz) @ the operand panel B[cols[r, l]*bsz :
// +bsz] (bsz, k), summed in slot order, as
// sparse_tpu/ops/pallas_bell.py::bell_spmm_pallas (def :58, pallas_call
// :89, kernel :41-55) steps its grid.
//
// Why a body of its own: K3's band body gives a thread block 32 output
// rows, so at bsz 128 four thread blocks of one block row would each copy
// its whole stack of panels, and its bf16 kind writes float32 C for a
// second pass to round.  Here a tile is up to 128 rows of one block row
// (the whole block row at bsz 128; bsz > 128 takes ceil(bsz / 128) row
// tiles) by 128 columns (float64: 64), so each stored block's rows and
// each panel cross into the SM once per row and column tile, and the
// result is written once, in its dtype.
//
// One thread block an SM, persistent: it walks the tiles blockIdx.x, +
// gridDim.x, ... (column tiles fastest, then row tiles, then block rows),
// so the thread blocks running at one time work on neighbouring block rows
// and share their panels in L2.  Nine warps: a producer warp, one lane of
// which keeps a ring of kStages stages full with TMA loads completing on
// an mbarrier each (a stage: kKC contraction indices of the stored block's
// tile rows, A, and the same rows of its panel's tile columns, B), and two
// consumer warpgroups of 64 rows each, which release a stage on a second
// mbarrier once all eight warps have read it.  Nine warps leave 168
// registers a thread (three share one of the SM's four register files).
// The ring runs across slots and tiles, so the next tile's first stages
// load while a tile's sums are stored.  Every array is read through a 3-D tensor map with the 128-byte
// swizzle: A as (nb*Lb, bsz, bsz), B as (nb, bsz, k), so a box that runs
// past bsz rows, bsz indices or k columns reads zero (never the next
// block or panel), and the ragged contraction is zero on both sides.
//
// Skip: each warpgroup votes (a named barrier's OR, bar.red) on each
// 32-index slice of its 64 rows of a stage's A, reading magnitude bits: a
// slice that is zero throughout is not multiplied, so a padding slot's zero
// block never meets its panel (an Inf or NaN there gives the sparse answer)
// and a NaN stored in A propagates; -0 counts as zero.  The panel is
// loaded all the same.  With a counter, each warpgroup adds, for every
// slice it kept, its useful rows x the slice's useful indices x the tile's
// useful columns (once for bf16x3: its three products split the same
// multiply-adds), so a whole non-zero stored block counts bsz * bsz * k.
//
// float32 (A, B and C float32; full float32, fmaf on the CUDA cores, no
// TF32): a stage is 32 indices (A one 16 KB box, B four 4 KB boxes of 32
// columns), six of them.  Consumer thread 32w + l of warpgroup wg (warp w
// of four, lane l: row group g = l % 8, column group h = l / 8) owns an
// 8 x 8 register tile: rows 64wg + g + 8j (j = 0..7) and columns 32w + 4h
// .. +3 and 32w + 16 + 4h .. +3, so warp w reads only B's box w.  What
// sets the pace is shared memory against FFMA issue, so the map is chosen
// for its shared-memory cycles: an LDS.128 is served a quarter warp a
// cycle, or two quarters a cycle where each reads one 16-byte chunk
// (tools/lds_probe.py on an H100).  For 4 indices a thread issues 8
// LDS.128 of A (row 64wg + g + 8j, 16-byte chunk q ^ g, as the swizzle
// XORs the chunk with row % 8 = g: a quarter's eight rows meet eight bank
// groups, 4 cycles) and 8 of B (two a row: chunk h, then h + 4, of a
// 128-byte row, XORed alike: one chunk a quarter, 2 cycles), against 256
// FFMA.  So per index a warp costs 12 cycles for 64 FFMA instructions, 6
// per 32 (K3's band body, each thread 8 x 4 with 32 accumulators: 8, the
// fewest such a map can cost).  A thread's rows are 8 apart: consecutive
// rows would share row % 8 across a quarter's row groups, an 8-way bank
// conflict (32 cycles an A load).  Each output's sum runs in index order,
// one fmaf at a time, slot after slot.
//
// bf16 (A, B and C bf16, sums float32): a stage is 64 indices (one
// swizzle row of A); each warpgroup runs wgmma m64n128k16 on its 64 rows
// from shared-memory descriptors (A K-major, B N-major: the transposed
// operand), four a stage, into 64 float32 registers a thread; the sums are
// rounded to bf16 once and stored as 16-byte runs (a lane quad trades its
// pairs).  bf16x3 (band::Split: float32 A and B, float32 C): a stage is 32
// indices; the two warpgroups split the stage's B once into bf16 planes in
// shared memory (high parts, residuals), each splits its own rows of A in
// registers, and runs hi*hi, hi*lo and lo*hi a 16-index step on wgmma
// m64n128k16 with A from registers, as band_body.cuh's split_chunk orders
// them.  (On mma.sync, each warp 32 x 64 splitting its own fragments, the
// kind took 1.33 ms at the bsz-128 band on an H100, 700 W; this form 0.81.)
// float64 (A, B and C float64): wgmma has no float64, so each warp owns 32
// rows x 32 columns on Hopper's m16n8k8 DMMA (mma.sync), 32 accumulators
// (64 registers) a thread; a tile is 64 columns wide, as a 128-column one
// would need 128 accumulator registers a thread of the 168 (setmaxnreg did
// not lift ptxas's allocation for the consumers: they spilled); a stage
// is 32 indices, 48 KB, four of them.  (On Ampere's m8n8k4 DMMA the kind
// took 2.7-2.8 ms at the bsz-128 band on an H100, 700 W, with 8 or 16
// warps, 64- or 128-column tiles; on m16n8k8 1.8-1.9.)
// The float64 and bf16x3 kinds read their fragments from the stages in an
// order of the contraction that meets every bank once under the 128-byte
// swizzle (pair_at): a 16-index step takes the index pairs (float64:
// indices) 8(t&1) + 2(q^t) + (t>>1) for lane t % 4 and step q, which is a
// permutation of each 128-byte row, applied to A's columns and B's rows
// alike (bf16x3 writes its planes' rows in that order).
//
// Deterministic: no split of the contraction across thread blocks, no
// atomics on C; each output is written once after its tile's fixed-order
// loop.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "band_body.cuh"
#include "sm90_tma.cuh"

namespace wide {

constexpr int kBM = 128;       // output rows of a tile
constexpr int kWarps = 8;      // consumer warps: two warpgroups of 64 rows
constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
constexpr int kRowBytes = 128;  // a row of the 128-byte swizzle
constexpr int kSlice = 32;      // contraction indices a vote

// Per stream kind S (float, __nv_bfloat16, band::Split, double): T, the
// element type in memory and in shared memory; Out, C's; kBN, a tile's
// columns; kKC, a stage's contraction indices; kStages, the ring's depth
// (192 KB).
template <typename S>
struct Cfg;
template <>
struct Cfg<float> {
  using T = float;
  using Out = float;
  using Acc = float[8][8];  // a thread's 8 rows x 8 columns
  static constexpr int kBN = 128, kKC = 32, kStages = 6, kPlanes = 0;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Cfg<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using Out = __nv_bfloat16;
  using Acc = float[64];  // the warpgroup's m64n128 registers
  static constexpr int kBN = 128, kKC = 64, kStages = 6, kPlanes = 0;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Cfg<band::Split> {
  using T = float;
  using Out = float;
  using Acc = float[64];  // the warpgroup's m64n128 registers
  // and two buffers of B's bf16 planes (high parts, residuals: 8 KB each)
  static constexpr int kBN = 128, kKC = 32, kStages = 6, kPlanes = 32768;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Cfg<double> {
  using T = double;
  using Out = double;
  using Acc = double[2][4][4];  // per warp 2 m16 x 4 n8 m16n8k8 tiles
  static constexpr int kBN = 64, kKC = 32, kStages = 4, kPlanes = 0;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
};

// A stage: kABoxes boxes of A (kBM rows x one swizzle row of indices,
// 16 KB each), then kBBoxes boxes of B (kKC rows x one swizzle row of
// columns); every box starts 1024-byte aligned.  bf16x3's B planes follow
// the ring, then the barriers; kBytes adds room to align the dynamic shared
// memory to 1024.
template <typename S>
struct Geo {
  using Cf = Cfg<S>;
  static constexpr int kRow = kRowBytes / sizeof(typename Cf::T);
  static constexpr int kABoxes = Cf::kKC / kRow;
  static constexpr int kBBoxes = Cf::kBN / kRow;
  static constexpr int kABox = kBM * kRowBytes;
  static constexpr int kBBox = Cf::kKC * kRowBytes;
  static constexpr int kABytes = kABoxes * kABox;
  static constexpr int kStage = kABytes + kBBoxes * kBBox;
  static constexpr int kVotes = Cf::kKC / kSlice;
  static constexpr int kRing = Cf::kStages * kStage;
  static constexpr int kBytes = kRing + Cf::kPlanes + 16 * Cf::kStages + 1024;
  static_assert(kABox % 1024 == 0 && kBBox % 1024 == 0, "aligned boxes");
};

// Byte offset of byte `byte` (< 128) of row `row` of a box in the 128-byte
// swizzle: its 16-byte chunk is XORed with row % 8.
__device__ __forceinline__ int sw(int row, int byte) {
  return row * kRowBytes + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// The 8-byte unit (a float pair, a double) of a 128-byte row that lane t
// (of four) reads at 16-unit step q: a permutation of the row's 16 units
// across the four steps, under which a half warp's A reads (rows g =
// 0..3, units of lanes t) and B reads (rows = the units, columns g) meet
// every bank once in the 128-byte swizzle.
__device__ __forceinline__ int pair_at(int q, int t) {
  return 8 * (t & 1) + 2 * (q ^ t) + (t >> 1);
}

// -- the vote -----------------------------------------------------------------

// Whether any element this thread reads of 32-index slice v of warpgroup
// wg's 64 rows of the stage's A is non-zero (NaN is, -0 is not).  The
// slice is 64 x 32 elements; each thread reads sizeof(T) 16-byte chunks.
template <typename S>
__device__ __forceinline__ bool mine_nonzero(const unsigned char* sa, int wg,
                                             int v) {
  using G = Geo<S>;
  constexpr int kSz = sizeof(typename Cfg<S>::T);
  constexpr int kChunks = 2 * kSz;  // 16-byte chunks of a row's slice
  const int tw = threadIdx.x % 128;
  unsigned any = 0;
#pragma unroll
  for (int s = 0; s < kSz; ++s) {
    const int u = tw + 128 * s;
    const int row = 64 * wg + u / kChunks;
    const int byte = kSlice * kSz * v + (u % kChunks) * 16;  // in the stage
    const uint4 w = *reinterpret_cast<const uint4*>(
        sa + (byte / kRowBytes) * G::kABox + sw(row, byte % kRowBytes));
    if constexpr (kSz == 8)
      any |= w.x | w.z | ((w.y | w.w) & 0x7fffffffu);
    else if constexpr (kSz == 4)
      any |= (w.x | w.y | w.z | w.w) & 0x7fffffffu;
    else
      any |= (w.x | w.y | w.z | w.w) & 0x7fff7fffu;
  }
  return any != 0;
}

// -- a stage's products -------------------------------------------------------

__device__ __forceinline__ void zero(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}
__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[j][n] = 0.f;
}
__device__ __forceinline__ void zero(double (&acc)[2][4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0;
}

// bf16: warpgroup wg's 64 rows x 128 columns += the stage's 64 indices,
// four wgmma m64n128k16, the two of each 32-index slice only where its vote
// kept it.  A: K-major, rows 128 bytes, 8-row groups 1024 bytes apart
// (SBO), a 16-index step 32 bytes along the row.  B: N-major, the two
// 64-column boxes 8 KB apart (LBO), 8-row groups 1024 bytes apart (SBO), a
// 16-index step 16 rows down.  Waits for the products before returning, so
// the stage may be released.
template <typename S>
__device__ __forceinline__ void mma_stage(const unsigned char* st,
                                          unsigned votes,
                                          typename Cfg<S>::Acc& acc, int wg,
                                          unsigned char* planes, int buf);

template <>
__device__ __forceinline__ void mma_stage<__nv_bfloat16>(
    const unsigned char* st, unsigned votes, float (&acc)[64], int wg,
    unsigned char*, int) {
  using G = Geo<__nv_bfloat16>;
  const unsigned char* sa = st + wg * 64 * kRowBytes;
  const unsigned char* sb = st + G::kABytes;
  sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((votes >> (j / 2)) & 1u)
      sm90::wgmma_m64n128k16_bf16(
          acc, sm90::sw128_desc(sa + 32 * j, 16, 1024),
          sm90::sw128_desc(sb + 16 * kRowBytes * j, G::kBBox, 1024));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
}

// bf16x3: the stage's float32 B rows become bf16 planes in shared memory,
// high parts and residuals (each 32 rows x 128 columns, N-major in the
// 128-byte swizzle, two 64-column boxes 4 KB apart), written by both
// warpgroups into one of two plane buffers (`buf`, alternating by stage:
// a buffer is rewritten two stages after it was read, once every
// warpgroup has passed the barrier after the stage between); then each
// warpgroup splits its own 64 rows of A in registers (the wgmma A fragment
// of each 16-index step, as mma.sync's: thread 32w + 4g + t holds rows 16w
// + g (+8) and index pairs t (+4)) and, where its vote kept the slice,
// runs per 16-index step hi*hi, hi*lo and lo*hi on wgmma m64n128k16 (A
// from registers) into its float32 registers, the order of band_body.cuh's
// split_chunk for each output.  A's index pair 2t, 2t+1 (+8) of step s is
// unit pair_at(2s + h, t) of the 32-float row; the planes' rows follow the
// same permutation (plane_row), so A and B meet index by index.
__device__ __forceinline__ int plane_row(int k) {
  return 2 * pair_at(2 * (k / 16) + ((k / 8) & 1), (k / 2) & 3) + (k & 1);
}

template <>
__device__ __forceinline__ void mma_stage<band::Split>(
    const unsigned char* st, unsigned votes, float (&acc)[64], int wg,
    unsigned char* planes, int buf) {
  using G = Geo<band::Split>;
  constexpr int kPlane = 8192;  // one plane: 32 rows x 128 bf16 columns
  unsigned char* hi = planes + (buf & 1) * 2 * kPlane;
  // B: each thread splits 2 of the stage's 512 runs of 8 columns
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int item = threadIdx.x % 256 + 256 * i;
    const int k = item / 16, n8 = item % 16;  // plane row, 8-column run
    const int kp = plane_row(k);              // its row in the stage
    const unsigned char* src = st + G::kABytes + (n8 / 4) * G::kBBox +
                               kp * kRowBytes;
    const int c0 = 2 * (n8 % 4);  // its first float32 chunk in the row
    const float4 x = *reinterpret_cast<const float4*>(
        src + (((c0 ^ kp) & 7) << 4));
    const float4 y = *reinterpret_cast<const float4*>(
        src + ((((c0 + 1) ^ kp) & 7) << 4));
    uint4 h, l;
    band::split2(x.x, x.y, h.x, l.x);
    band::split2(x.z, x.w, h.y, l.y);
    band::split2(y.x, y.y, h.z, l.z);
    band::split2(y.z, y.w, h.w, l.w);
    const int dst = (n8 / 8) * 4096 + k * kRowBytes + (((n8 ^ k) & 7) << 4);
    *reinterpret_cast<uint4*>(hi + dst) = h;
    *reinterpret_cast<uint4*>(hi + kPlane + dst) = l;
  }
  // A: warpgroup wg's rows, split in registers
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned ah[2][4], al[2][4];
  if (votes & 1u) {
    const unsigned char* pa = st + (64 * wg + 16 * warp + g) * kRowBytes;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r: row g (+8 for odd r), index pair t (+4 for r >= 2)
        const int p = pair_at(2 * s + (r >> 1), t);
        const float2 x = *reinterpret_cast<const float2*>(
            pa + 8 * (r & 1) * kRowBytes + (((p >> 1) ^ g) << 4) + 8 * (p & 1));
        band::split2(x.x, x.y, ah[s][r], al[s][r]);
      }
  }
  // the planes, written by the generic proxy, to the products' async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  if (!(votes & 1u)) return;
  sm90::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint64_t bh = sm90::sw128_desc(hi + 16 * kRowBytes * s, 4096, 1024);
    const uint64_t bl =
        sm90::sw128_desc(hi + kPlane + 16 * kRowBytes * s, 4096, 1024);
    sm90::wgmma_m64n128k16_bf16_rs(acc, ah[s], bh);
    sm90::wgmma_m64n128k16_bf16_rs(acc, ah[s], bl);
    sm90::wgmma_m64n128k16_bf16_rs(acc, al[s], bh);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
}

// A 16-byte load from shared memory at a 32-bit shared-window address.
// The float32 kind reads its fragments through it: through a generic
// pointer into the realigned dynamic shared memory they compile to generic
// 64-bit loads (LD.E.128) with 64-bit addresses, and the kernel spilled
// and ran slower (PERF.md section 6).
__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// float32: thread 32w + l of warpgroup wg (g = l % 8, h = l / 8) adds the
// stage's 32 indices to its rows 64wg + g + 8j and columns 32w + 4h .. +3,
// 32w + 16 + 4h .. +3 (box w of B), where the vote kept them: for each 4
// indices q, eight A loads (row g + 8j's chunk q ^ g) and, per index kk,
// two B loads (chunks h and h + 4 of row kk, XORed with kk % 8), then 64
// fmaf an index.  Row kk's chunk h ^ (kk % 8) is (h ^ (kk % 4)) + 4 *
// bit 2 of kk, and chunk (h + 4) ^ (kk % 8) the same with bit 2 flipped:
// four base addresses a thread serve every B load, with immediate offsets.
template <>
__device__ __forceinline__ void mma_stage<float>(const unsigned char* st,
                                                 unsigned votes,
                                                 float (&acc)[8][8], int wg,
                                                 unsigned char*, int) {
  using G = Geo<float>;
  if (!(votes & 1u)) return;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane % 8, h = lane / 8;
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(st));
  const unsigned pa = s0 + (64 * wg + g) * kRowBytes;
  unsigned pb[4];  // chunk (h ^ t) of box warp's row 0
#pragma unroll
  for (int t = 0; t < 4; ++t)
    pb[t] = s0 + G::kABytes + warp * G::kBBox + ((h ^ t) << 4);
#pragma unroll
  for (int q = 0; q < Cfg<float>::kKC / 4; ++q) {
    float4 a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      a[j] = lds128(pa + 8 * j * kRowBytes + ((q ^ g) << 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = 4 * q + i;
      const unsigned row = pb[i] + kk * kRowBytes;
      const int hi = (kk & 4) << 4;  // bit 2 of kk, as 64 bytes
      const float4 b0 = lds128(row + hi);
      const float4 b1 = lds128(row + (64 ^ hi));
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = i == 0 ? a[j].x : i == 1 ? a[j].y
                      : i == 2 ? a[j].z : a[j].w;
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[j][n] = fmaf(x, b[n], acc[j][n]);
      }
    }
  }
}

// float64: warp wi of warpgroup wg owns rows 64wg + 32(wi/2) .. +31 and
// columns 32(wi%2) .. +31 of the tile, as 2 m16 x 4 n8 tiles of Hopper's
// m16n8k8 DMMA, and adds the stage's 32 indices (two A boxes of 16, each
// two 8-index steps) where the vote kept them.  Lane t's indices t and t+4
// of step qq of a box are units pair_at(2qq, t) and pair_at(2qq + 1, t)
// of its 16-double row.  Offsets per lane as for bf16x3: B's column chunk
// of an odd n-tile differs from the even one's in bit 6.
template <>
__device__ __forceinline__ void mma_stage<double>(
    const unsigned char* st, unsigned votes, double (&acc)[2][4][4], int wg,
    unsigned char*, int) {
  using G = Geo<double>;
  if (!(votes & 1u)) return;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 32 * (warp / 2), n0 = 32 * (warp % 2);
  const unsigned char* pa = st + (r0 + g) * kRowBytes;
  const unsigned char* pb = st + G::kABytes + (n0 / 16) * G::kBBox + 8 * (g & 1);
#pragma unroll
  for (int j = 0; j < G::kABoxes; ++j)
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      int ca[2], rb[2];  // per half h (index t + 4h): A's byte, B's row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = pair_at(2 * qq + h, t);
        ca[h] = j * G::kABox + (((u >> 1) ^ g) << 4) + 8 * (u & 1);
        rb[h] = (16 * j + u) * kRowBytes + ((((g >> 1) ^ u) & 7) << 4);
      }
      double a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r)  // row g (+8 for odd r), half r / 2
          a[mt][r] = *reinterpret_cast<const double*>(
              pa + (16 * mt + 8 * (r & 1)) * kRowBytes + ca[r >> 1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[nt][h] = *reinterpret_cast<const double*>(
              pb + (nt / 2) * G::kBBox + (rb[h] ^ ((nt & 1) << 6)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sm90::mma_f64_16808(acc[mt][nt], a[mt], b[nt]);
    }
}

// -- stores -------------------------------------------------------------------

// C (rows M, leading dimension N) of one block row; the tile at (m0, n0).

// bf16 from the wgmma layout: thread 32w + 4g + t of warpgroup wg holds
// rows 64wg + 16w + g (+8) and, of n-tile nt (8 columns), columns 2t,
// 2t+1.  For each group of four n-tiles the lanes of a quad trade their
// pairs, so lane q writes n-tile 4G + q's eight columns as one 16-byte
// streaming store.  N is a multiple of 8.
__device__ __forceinline__ void store(const float (&acc)[64],
                                      __nv_bfloat16* c, int M, int N, int m0,
                                      int n0, int wg) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int q = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int G = 0; G < 4; ++G) {
      unsigned w[4], got[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * (4 * G + i) + 2 * h;
        const __nv_bfloat162 p = __floats2bfloat162_rn(acc[j], acc[j + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&p);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // lane q receives from lane (q - s) & 3 that lane's pair of n-tile
        // 4G + q
        const int src = (q - s) & 3;
        const int mine = (q + s) & 3;
        const unsigned send = mine == 0 ? w[0] : mine == 1 ? w[1]
                            : mine == 2 ? w[2] : w[3];
        const unsigned v = __shfl_sync(0xffffffffu, send, quad + src);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (src == e) got[e] = v;
      }
      const int gn = n0 + 8 * (4 * G + q);
      if (gi < M && gn < N)
        __stcs(reinterpret_cast<uint4*>(c + static_cast<long long>(gi) * N +
                                        gn),
               make_uint4(got[0], got[1], got[2], got[3]));
    }
  }
}

// bf16x3's float32 from the wgmma layout (as bf16's): lane 4g + t of warp
// w of warpgroup wg holds rows 64wg + 16w + g (+8), columns 8nt + 2t, +1
// of each n-tile nt, written as 8-byte streaming stores (a lane quad's
// four make one 32-byte run).  N is a multiple of 4.
__device__ __forceinline__ void store(const float (&acc)[64], float* c,
                                      int M, int N, int m0, int n0, int wg) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (gi >= M) continue;
    float* row = c + static_cast<long long>(gi) * N;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int gn = n0 + 8 * nt + 2 * (lane % 4);
      if (gn < N)
        __stcs(reinterpret_cast<float2*>(row + gn),
               make_float2(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]));
    }
  }
}

// float32 from the FFMA tiles: thread 32w + l of warpgroup wg holds rows
// 64wg + l % 8 + 8j and columns 32w + 4(l / 8) .. +3 and 32w + 16 + 4(l /
// 8) .. +3, written as 16-byte streaming stores (a warp's four lanes of
// one row group write 64 contiguous bytes a row).  N is a multiple of 4.
__device__ __forceinline__ void store(const float (&acc)[8][8], float* c,
                                      int M, int N, int m0, int n0, int wg) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gi = m0 + 64 * wg + lane % 8 + 8 * j;
    if (gi >= M) continue;
    float* row = c + static_cast<long long>(gi) * N;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + 32 * warp + 16 * e + 4 * (lane / 8);
      if (gn < N)
        __stcs(reinterpret_cast<float4*>(row + gn),
               make_float4(acc[j][4 * e], acc[j][4 * e + 1],
                           acc[j][4 * e + 2], acc[j][4 * e + 3]));
    }
  }
}

// float64 from the DMMA layout: lane 4g + t of warp wi of warpgroup wg
// holds rows 64wg + 32(wi/2) + 16mt + g (+8), columns 32(wi%2) + 8nt + 2t,
// +1, written as 16-byte streaming stores.  N is even.
__device__ __forceinline__ void store(const double (&acc)[2][4][4],
                                      double* c, int M, int N, int m0,
                                      int n0, int wg) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi =
          m0 + 64 * wg + 32 * (warp / 2) + 16 * mt + 8 * h + lane / 4;
      if (gi >= M) continue;
      double* row = c + static_cast<long long>(gi) * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + 32 * (warp % 2) + 8 * nt + 2 * (lane % 4);
        if (gn < N)
          __stcs(reinterpret_cast<double2*>(row + gn),
                 make_double2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
      }
    }
}

// -- the body -----------------------------------------------------------------

// Where a tile lies: tiles are numbered column tiles fastest, then row
// tiles, then block rows.
struct Tile {
  int r, m0, n0;
  __device__ __forceinline__ Tile(int t, int m_tiles, int n_tiles, int bn) {
    n0 = (t % n_tiles) * bn;
    const int rest = t / n_tiles;
    m0 = (rest % m_tiles) * kBM;
    r = rest / m_tiles;
  }
};

// The persistent body over `tiles` = nb x ceil(bsz / 128) x ceil(k / kBN)
// tiles.  map_a: blocks as (nb*Lb, bsz, bsz), boxes (1, 128, kRow); map_b:
// b as (nb, bsz, k), boxes (1, kKC, kRow); cols (nb, Lb); c (nb*bsz, k) in
// Cfg<S>::Out.  Needs Geo<S>::kBytes of dynamic shared memory and
// kThreads threads.
template <typename S>
__device__ __forceinline__ void run(const CUtensorMap* map_a,
                                    const CUtensorMap* map_b,
                                    const int* __restrict__ cols,
                                    typename Cfg<S>::Out* __restrict__ c,
                                    int Lb, int bsz, int k, int tiles,
                                    unsigned long long* issued) {
  using Cf = Cfg<S>;
  using G = Geo<S>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* planes = smem + G::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + Cf::kPlanes);
  uint64_t* empty = full + Cf::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, kWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int m_tiles = (bsz + kBM - 1) / kBM;
  const int n_tiles = (k + Cf::kBN - 1) / Cf::kBN;
  const int subs = (bsz + Cf::kKC - 1) / Cf::kKC;  // stages a stored block
  if (warp == kWarps) {  // the producer: one lane issues every copy
    if (lane != 0) return;
    sm90::tma_prefetch_map(map_a);
    sm90::tma_prefetch_map(map_b);
    int s = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tile(t, m_tiles, n_tiles, Cf::kBN);
      for (int l = 0; l < Lb; ++l) {
        const int slot = tile.r * Lb + l;
        const int col = __ldg(cols + slot);
        for (int sub = 0; sub < subs; ++sub) {
          sm90::mbar_wait(empty + s, phase ^ 1);
          unsigned char* st = smem + s * G::kStage;
          sm90::mbar_arrive_expect_tx(full + s, G::kStage);
#pragma unroll
          for (int j = 0; j < G::kABoxes; ++j)
            sm90::tma_load_3d(st + j * G::kABox, map_a, full + s,
                              sub * Cf::kKC + j * G::kRow, tile.m0, slot);
#pragma unroll
          for (int h = 0; h < G::kBBoxes; ++h)
            sm90::tma_load_3d(st + G::kABytes + h * G::kBBox, map_b, full + s,
                              tile.n0 + h * G::kRow, sub * Cf::kKC, col);
          if (++s == Cf::kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  // the consumers: warpgroup wg owns the tile's rows 64wg .. 64wg+63
  const int wg = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;
  int s = 0;
  unsigned phase = 0;
  unsigned long long madds = 0;  // multiply-adds the votes kept
  int it = 0;                    // stages consumed
  typename Cf::Acc acc;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tile(t, m_tiles, n_tiles, Cf::kBN);
    const int rows = min(max(bsz - tile.m0 - 64 * wg, 0), 64);
    const int cols_n = min(k - tile.n0, Cf::kBN);
    zero(acc);
    for (int l = 0; l < Lb; ++l)
      for (int sub = 0; sub < subs; ++sub) {
        sm90::mbar_wait(full + s, phase);
        __syncwarp();
        const unsigned char* st = smem + s * G::kStage;
        unsigned votes = 0;
#pragma unroll
        for (int v = 0; v < G::kVotes; ++v)
          votes |= static_cast<unsigned>(sm90::warpgroup_any(
                       mine_nonzero<S>(st, wg, v), 1 + wg))
                   << v;
        mma_stage<S>(st, votes, acc, wg, planes, it++);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + s);
        if (leader)
#pragma unroll
          for (int v = 0; v < G::kVotes; ++v)
            if ((votes >> v) & 1u) {
              const int idx =
                  min(bsz - sub * Cf::kKC - kSlice * v, kSlice);
              madds += static_cast<unsigned long long>(rows) * idx * cols_n;
            }
        if (++s == Cf::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    store(acc, c + static_cast<long long>(tile.r) * bsz * k, bsz, k, tile.m0,
          tile.n0, wg);
  }
  if (issued != nullptr && leader && madds > 0) atomicAdd(issued, madds);
}

}  // namespace wide
