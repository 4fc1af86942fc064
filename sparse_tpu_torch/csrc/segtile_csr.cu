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
// stored as its bits); bf16 (WideEntries<__nv_bfloat16>: bf16 values and
// operand widened exactly, products and sums in float32 in the float32
// kind's order, partial float32, y rounded once to bf16 — the reference
// sums in bf16, so this kind is the more accurate of the two).
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
//    pass adds the pieces in order (launched only when long rows exist).

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

// The launched geometry of kernel `fn` (256-thread blocks, no dynamic
// shared memory): out[0..4] = registers and local bytes a thread, static
// shared bytes a block, resident blocks an SM, rows a lane group.
template <typename Fn>
cudaError_t geometry_of(Fn fn, int rows, int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0);
  if (e != cudaSuccess) return e;
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  out[3] = per_sm;
  out[4] = rows;
  return cudaSuccess;
}

template <int G>
cudaError_t geometry_g(bool f64, int* out) {
  using D = ScalarEntries<double>;
  using F = ScalarEntries<float>;
  return f64 ? geometry_of(stream_rows<D, G>, group_rows<D, G>, out)
             : geometry_of(stream_rows<F, G>, group_rows<F, G>, out);
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

// bf16: vals, v and y bf16, partial float32 scratch.
int segtile_csr_bf16(const StreamArgs* a, const void* vals, const void* v,
                     void* partial, void* y, void* stream) {
  return launch_entries<WideEntries<__nv_bfloat16>, __nv_bfloat16>(
      a, vals, v, partial, y, stream);
}

// The geometry of K1's row kernel at lane group `group` (1, 2, ..., 32)
// for float64 (f64 != 0) or float32: out[0..4] = registers and local bytes
// a thread, static shared bytes, resident 256-thread blocks an SM, rows a
// lane group.  Returns a cudaError_t.
int segtile_csr_geometry(int f64, int group, int* out) {
  switch (group) {
    case 1: return geometry_g<1>(f64 != 0, out);
    case 2: return geometry_g<2>(f64 != 0, out);
    case 4: return geometry_g<4>(f64 != 0, out);
    case 8: return geometry_g<8>(f64 != 0, out);
    case 16: return geometry_g<16>(f64 != 0, out);
    case 32: return geometry_g<32>(f64 != 0, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
