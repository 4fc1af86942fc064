// K1 and K1-r32: segment-tile CSR SpMV on Hopper, over the plan's compact
// stream.
//
// Replaces the TPU kernel sparse_tpu/ops/pallas_csr.py::segtile_apply
// (def :492, pallas_call :618, body kernel_vpu :531), at both tile heights
// of the plan: 8 (K1) and 32 (K1-r32, the loop over 4 row groups at :550).
// It computes the same sum, y[r] = sum of vals[i] * v[cols[i]] over row r's
// stored entries, but not over the TPU's slots: the plan also holds its
// entries as a compact stream (ops/cuda_csr.py), a value and an int32
// column per entry in (row, tile, lane) order, with int32 row offsets.  The
// tile height only changes the order of a row's entries (and with it the
// float rounding); K1-r32 is this kernel on a 32-row plan.
//
// Kinds: float32 and float64 (ScalarEntries, sums in their own type;
// float64 two rows a lane group, kHalfRows);
// int32 (WideEntries<int>: multiply-adds in unsigned, so the sum is the
// reference's int32 result modulo 2^32 in any order, overflow included,
// stored as its bits); bf16 (NarrowBf16: bf16 values and operand widened
// exactly, products and sums in float32 in the float32 kind's order,
// partial float32, y rounded once to bf16 — the reference sums in bf16, so
// this kind is the more accurate of the two — on narrow_rows, below).
//
// What bounds it on this card: the stream, 8 bytes per stored entry in
// float32 (4-byte value + 4-byte column; 12 in float64, 8 in int32, 6 in
// bf16), plus 4 bytes per row offset and the output, against 3.35 TB/s of
// HBM.  The 8x8-row TPU
// tiles at fill 0.066 cost 76 bytes per entry; the stream is read once.
// The operand (2 MB at 500k float32 columns) stays in the 50 MB L2.
//
// What the design does about it:
//  * one pass: a group of G lanes per row (G = the plan's mean row length
//    in 4-entry units, rounded up to a power of two, chosen by the plan
//    builder), each lane taking every G-th aligned 4-entry unit of the row
//    with one 16-byte value load and one 16-byte column load, both
//    evict-first (__ldcs), masking the entries outside the row; the operand
//    is gathered through the read-only path (__ldg); the group's butterfly
//    sum is written once — no partials, no second pass, no atomics;
//  * a group takes 4 rows (2 at G = 16, 1 at G = 32; float64 2 where
//    the others take 4) and issues the first units of all of them before
//    its first gather, so a lane has several stream loads in flight
//    instead of one per round trip;
//  * the gathers, not the stream, would dominate the L2 traffic if each
//    block met its operand window once (a 32-byte sector per 4-byte
//    gather): a block walks consecutive chunks of 128 rows (8 blocks per
//    SM in all), so the window of neighbouring rows stays in its L1;
//  * long rows (more than 8 group passes) would hold their warp: they are
//    cut into 512-entry pieces, one warp each, and a one-thread-per-row
//    pass adds the pieces in order (launched only when long rows exist);
//  * bf16 is held by the latency of its dependent loads (row offsets, then
//    units, then gathers), not by the L1's gathers: it runs narrow_rows,
//    whose 32-bit offsets and two rows a lane group fit 40 registers, so 6
//    blocks of 256 threads are resident an SM (stream_rows: 80 registers,
//    3), on a grid of one wave of them (see NarrowBf16).

#include "segtile_common.cuh"

namespace {

template <typename Tp>
struct ScalarEntries {
  using T = Tp;
  using Out = Tp;
  static constexpr int kUnit = 4;
  static constexpr int kC = 1;
  const T* vals;  // padded to a multiple of 4 entries
  const int* cols;
  const T* v;

  struct Unit {
    T a[4];
    int4 c;
  };

  __device__ __forceinline__ Unit load(long long u) const {
    Unit x;
    load4_stream(vals + 4 * u, x.a);
    x.c = __ldcs(reinterpret_cast<const int4*>(cols) + u);
    return x;
  }

  __device__ __forceinline__ void add(T (&acc)[1], const Unit& x,
                                      long long u, long long s,
                                      long long e) const {
    const int cs[4] = {x.c.x, x.c.y, x.c.z, x.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * u + j;
      if (i >= s && i < e) acc[0] += x.a[j] * __ldg(v + cs[j]);
    }
  }

  __device__ __forceinline__ static long long out_row(long long r) {
    return r;
  }

  __device__ __forceinline__ static void store(T* out, long long i,
                                               const T (&acc)[1]) {
    out[i] = acc[0];
  }
};

// float64: two rows a lane group where the other kinds take four.  Four
// rows of 48-byte units held 108 registers a thread (two 256-thread blocks
// an SM) and took 0.0703 ms on band-10M; every two-row form that
// tools/k1_f64_probe.py tried held 62 registers (four blocks) and took
// 0.0472-0.0481 ms, 32-bit entry offsets or a grid of one wave worth no
// more than 1.5% there (NVIDIA H100 80GB HBM3, 700 W).  Each row's sum
// keeps its order.
template <>
constexpr bool kHalfRows<ScalarEntries<double>> = true;

// The int32 and bf16 kinds: values and operand of type V, products and
// sums in Widen<V>::Acc (unsigned for int32, float32 for bf16) in the float
// kinds' order, y in Widen<V>::Out.
template <typename V>
struct WideEntries {
  using W = Widen<V>;
  using T = typename W::Acc;
  using Out = typename W::Out;
  static constexpr int kUnit = 4;
  static constexpr int kC = 1;
  const V* vals;  // padded to a multiple of 4 entries
  const int* cols;
  const V* v;

  struct Unit {
    V a[4];
    int4 c;
  };

  __device__ __forceinline__ Unit load(long long u) const {
    Unit x;
    load4_stream(vals + 4 * u, x.a);
    x.c = __ldcs(reinterpret_cast<const int4*>(cols) + u);
    return x;
  }

  __device__ __forceinline__ void add(T (&acc)[1], const Unit& x,
                                      long long u, long long s,
                                      long long e) const {
    const int cs[4] = {x.c.x, x.c.y, x.c.z, x.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * u + j;
      if (i >= s && i < e) acc[0] += W::of(x.a[j]) * W::gather(v, cs[j]);
    }
  }

  __device__ __forceinline__ static long long out_row(long long r) {
    return r;
  }

  __device__ __forceinline__ static void store(T* out, long long i,
                                               const T (&acc)[1]) {
    out[i] = acc[0];
  }
  __device__ __forceinline__ static void store(Out* out, long long i,
                                               const T (&acc)[1]) {
    store_out(out + i, acc[0]);
  }
};

// bf16 on narrow_rows (segtile_common.cuh): WideEntries<bf16> with adds
// on 32-bit entry offsets, two rows a lane group where stream_rows takes
// four, at most 40 registers (6 resident blocks an SM), on one wave of
// resident blocks.  On band-10M stream_rows held it to 80 registers with
// 8 bytes spilled, 3 blocks an SM, in 2.5 waves of 8 blocks an SM, and
// took 0.0382-0.0388 ms; this takes 0.0273-0.0281 (tools/k1_bf16_probe.py,
// NVIDIA H100 80GB HBM3, 700 W).  Gathers all on one 128-byte line saved
// 8% of the old kernel; staging each block's operand window in shared
// memory cost 9-19% in every form tried.  Each row keeps its order of
// adds, so the result is the same bits.
struct NarrowBf16 : WideEntries<__nv_bfloat16> {
  using WideEntries<__nv_bfloat16>::add;  // the long rows' pieces

  __device__ __forceinline__ void add(float (&acc)[1], const Unit& x, int u,
                                      int s, int e) const {
    const int cs[4] = {x.c.x, x.c.y, x.c.z, x.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * u + j;
      if (i >= s && i < e) acc[0] += W::of(x.a[j]) * W::gather(v, cs[j]);
    }
  }
};

template <>
constexpr bool kHalfRows<NarrowBf16> = true;

constexpr int kBf16Blocks = 6;  // narrow_rows' resident blocks an SM

// The launched geometry of kernel `fn` (256-thread blocks, no dynamic
// shared memory) on chunks of `chunk_rows` rows, split over `per_sm`
// blocks an SM (0: the resident count): out[0..6] = registers and local
// bytes a thread, static shared bytes a block, resident blocks an SM, rows
// a lane group, then the row blocks and chunks a block of a launch over
// n_rows rows.
template <typename Fn>
cudaError_t geometry_of(Fn fn, int rows, int chunk_rows, int per_sm,
                        long long n_rows, int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  int resident = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn,
                                                      kThreads, 0);
  long long per_block = 0, blocks = 0;
  if (e == cudaSuccess)
    e = split_chunks((n_rows + chunk_rows - 1) / chunk_rows, per_block,
                     blocks, per_sm ? per_sm : resident);
  if (e != cudaSuccess) return e;
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  out[3] = resident;
  out[4] = rows;
  out[5] = static_cast<int>(blocks);
  out[6] = static_cast<int>(per_block);
  return cudaSuccess;
}

template <int G>
cudaError_t geometry_g(int kind, long long n_rows, int* out) {
  using D = ScalarEntries<double>;
  using F = ScalarEntries<float>;
  switch (kind) {
    case 0:
      return geometry_of(stream_rows<F, G>, group_rows<F, G>,
                         kChunkRowsOf<F, G>, kBlocksPerSm, n_rows, out);
    case 1:
      return geometry_of(stream_rows<D, G>, group_rows<D, G>,
                         kChunkRowsOf<D, G>, kBlocksPerSm, n_rows, out);
    case 2:
      return geometry_of(narrow_rows<NarrowBf16, G, kBf16Blocks>,
                         group_rows<NarrowBf16, G>,
                         kChunkRowsOf<NarrowBf16, G>, 0, n_rows, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// a: the stream's fixed arguments (segtile_common.cuh; cols padded to a
// multiple of 4 entries, 16-byte aligned; no output map); vals (cols'
// length and alignment), v (m), partial scratch (n_pieces), y (n_rows) and
// the CUDA stream.  Returns cudaGetLastError().
int segtile_csr_f32(const StreamArgs* a, const void* vals, const void* v,
                    void* partial, void* y, void* stream) {
  return launch_entries<ScalarEntries<float>, float>(a, vals, v, partial, y,
                                                     stream);
}

int segtile_csr_f64(const StreamArgs* a, const void* vals, const void* v,
                    void* partial, void* y, void* stream) {
  return launch_entries<ScalarEntries<double>, double>(a, vals, v, partial,
                                                       y, stream);
}

// int32: vals, v and y int32, partial int32 scratch (the sums' bits).
int segtile_csr_i32(const StreamArgs* a, const void* vals, const void* v,
                    void* partial, void* y, void* stream) {
  return launch_entries<WideEntries<int>, int>(a, vals, v, partial, y,
                                               stream);
}

// bf16: vals, v and y bf16, partial float32 scratch; narrow_rows.
int segtile_csr_bf16(const StreamArgs* a, const void* vals, const void* v,
                     void* partial, void* y, void* stream) {
  const NarrowBf16 ent{{static_cast<const __nv_bfloat16*>(vals), a->cols,
                         static_cast<const __nv_bfloat16*>(v)}};
  return static_cast<int>(with_group(a->group, [&](auto g) {
    return launch_narrow_rows<NarrowBf16, decltype(g)::value, kBf16Blocks>(
        ent, rows_of(*a), a->n_long, static_cast<float*>(partial),
        static_cast<__nv_bfloat16*>(y), static_cast<cudaStream_t>(stream));
  }));
}

// The geometry of K1's row kernel at lane group `group` (1, 2, ..., 32)
// for kind 0 (float32), 1 (float64) or 2 (bf16, narrow_rows): out[0..6] =
// registers and local bytes a thread, static shared bytes, resident
// 256-thread blocks an SM, rows a lane group, and the row blocks and
// chunks a block of a launch over n_rows rows on the current card.
// Returns a cudaError_t.
int segtile_csr_geometry(int kind, int group, long long n_rows, int* out) {
  return static_cast<int>(with_group(group, [&](auto g) {
    return geometry_g<decltype(g)::value>(kind, n_rows, out);
  }));
}

}  // extern "C"
