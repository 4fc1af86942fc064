// K2: block-granule (2x2 BSR) segment-tile SpMV on Hopper, over the plan's
// compact stream.
//
// Replaces the TPU kernel
// sparse_tpu/ops/pallas_csr_block.py::bsr_smvm_segtile_block (def :229,
// pallas_call :309, kernel :259).  The TPU plan puts a whole 2x2 block in
// one slot (four value planes sharing one int8 window pointer); the plan
// here also holds its stored blocks as a compact stream (ops/cuda_csr.py):
// per block one 16-byte record of its four values (a00, a01, a10, a11; 32
// bytes in float64) and one int32 block column, in (block row, tile, lane)
// order, with int32 block-row offsets.  For block row r:
//   y[2r]     = sum over its blocks of a00 * v[2c] + a01 * v[2c+1]
//   y[2r + 1] = sum over its blocks of a10 * v[2c] + a11 * v[2c+1]
//
// What bounds it on this card: the stream, 20 bytes per stored block in
// float32 (5 per scalar entry; 36 per block in float64), plus the block-row
// offsets and the output, against 3.35 TB/s of HBM.  The TPU's slots cost
// 17 bytes each at any fill.  The operand (1.6 MB for 400k float32 rows
// after the block RCM) stays in the 50 MB L2.
//
// What the design does about it: one pass, a group of G lanes for 4
// consecutive block rows (G from the plan's mean blocks per row; 2 rows at
// G = 16, 1 at 32), each lane taking every G-th block of each row, the
// first block of all its rows loaded before the first gather: one 16-byte evict-first record load, one 4-byte column load and
// one 8-byte gather of the operand pair (float2 / double2 through __ldg);
// two sums per row, reduced by the group's butterfly and written once; a
// block walks consecutive chunks of block rows so the operand window stays
// in its L1.
// Long block rows are cut into pieces of 128 blocks, summed in order, as
// in segtile_common.cuh.
//
// The folded view (a plan composed with a block permutation P, the block
// RCM of ops/dispatch.py): the stream's block columns are given in the
// caller's numbering (P[c]) and out_rows maps stream block row r to the
// caller's block row P[r] (out_long likewise for the long rows), so
// y[2*P[r] + i] is written straight from the stream with no gather of v
// before the kernel and none of y after it.  The stream and each row's
// order of summation are the unfolded plan's, so the folded result has the
// bits of the unfolded one gathered back through P.  A null out_rows is
// the identity (the unfolded stream).  What it costs: where the caller's
// numbering scatters neighbouring block rows (a node-scrambled mesh), the
// operand's window no longer stays in L1 and each pair gather reads its
// own L2 sector; the operand (1.6 MB at 400k float32 rows) still stays in
// the 50 MB L2, and the two gathers and their launches around the
// unfolded kernel are gone.
//
// Kinds: float32 and float64 (BlockEntries); int32 (WideBlockEntries<int>:
// 16-byte records, multiply-adds in unsigned — the reference's wrapping
// int32 result in any order — stored as int32 bits); bf16
// (WideBlockEntries<__nv_bfloat16>: 8-byte records, values and operand
// widened exactly to float32, sums in float32 in the float32 kind's order,
// y rounded once to bf16).

#include "segtile_common.cuh"

namespace {

__device__ __forceinline__ void load_pair(const float* v, int c, float& x0,
                                          float& x1) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(v) + c);
  x0 = t.x;
  x1 = t.y;
}

__device__ __forceinline__ void load_pair(const double* v, int c, double& x0,
                                          double& x1) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(v) + c);
  x0 = t.x;
  x1 = t.y;
}

template <typename Tp>
struct BlockEntries {
  using T = Tp;
  using Out = Tp;
  static constexpr int kUnit = 1;
  static constexpr int kC = 2;
  const T* vals;  // (nbz, 4), 16-byte aligned
  const int* cols;
  const T* v;          // (2 * nb), aligned to two elements
  const int* out_rows;  // stream block row -> y's block row, or null

  struct Unit {
    T a[4];
    int c;
  };

  __device__ __forceinline__ Unit load(long long u) const {
    Unit x;
    load4_stream(vals + 4 * u, x.a);
    x.c = __ldcs(cols + u);
    return x;
  }

  __device__ __forceinline__ void add(T (&acc)[2], const Unit& x,
                                      long long, long long, long long) const {
    T x0, x1;
    load_pair(v, x.c, x0, x1);
    acc[0] += x.a[0] * x0 + x.a[1] * x1;
    acc[1] += x.a[2] * x0 + x.a[3] * x1;
  }

  __device__ __forceinline__ long long out_row(long long r) const {
    return out_rows ? __ldg(out_rows + r) : r;
  }

  __device__ __forceinline__ static void store(T* out, long long i,
                                               const T (&acc)[2]) {
    out[2 * i] = acc[0];
    out[2 * i + 1] = acc[1];
  }
};

// The operand pair (v[2c], v[2c+1]) widened: int32 as unsigned (one 8-byte
// load), bf16 to float32 exactly (one 4-byte load, element 2c in the low
// half).
__device__ __forceinline__ void load_pair(const int* v, int c, unsigned& x0,
                                          unsigned& x1) {
  const int2 t = __ldg(reinterpret_cast<const int2*>(v) + c);
  x0 = static_cast<unsigned>(t.x);
  x1 = static_cast<unsigned>(t.y);
}

__device__ __forceinline__ void load_pair(const __nv_bfloat16* v, int c,
                                          float& x0, float& x1) {
  const unsigned t = __ldg(reinterpret_cast<const unsigned*>(v) + c);
  x0 = __uint_as_float(t << 16);
  x1 = __uint_as_float(t & 0xffff0000u);
}

// The int32 and bf16 kinds: records and operand of type V, products and
// sums in Widen<V>::Acc in the float kinds' order, y in Widen<V>::Out.
template <typename V>
struct WideBlockEntries {
  using W = Widen<V>;
  using T = typename W::Acc;
  using Out = typename W::Out;
  static constexpr int kUnit = 1;
  static constexpr int kC = 2;
  const V* vals;  // (nbz, 4), 16-byte aligned
  const int* cols;
  const V* v;          // (2 * nb), aligned to two elements
  const int* out_rows;  // stream block row -> y's block row, or null

  struct Unit {
    V a[4];
    int c;
  };

  __device__ __forceinline__ Unit load(long long u) const {
    Unit x;
    load4_stream(vals + 4 * u, x.a);
    x.c = __ldcs(cols + u);
    return x;
  }

  __device__ __forceinline__ void add(T (&acc)[2], const Unit& x,
                                      long long, long long, long long) const {
    T x0, x1;
    load_pair(v, x.c, x0, x1);
    acc[0] += W::of(x.a[0]) * x0 + W::of(x.a[1]) * x1;
    acc[1] += W::of(x.a[2]) * x0 + W::of(x.a[3]) * x1;
  }

  __device__ __forceinline__ long long out_row(long long r) const {
    return out_rows ? __ldg(out_rows + r) : r;
  }

  __device__ __forceinline__ static void store(T* out, long long i,
                                               const T (&acc)[2]) {
    out[2 * i] = acc[0];
    out[2 * i + 1] = acc[1];
  }
  __device__ __forceinline__ static void store(Out* out, long long i,
                                               const T (&acc)[2]) {
    store_out(out + 2 * i, acc[0]);
    store_out(out + 2 * i + 1, acc[1]);
  }
};

// A C entry of block kind E (records and operand of type V).
template <class E, typename V>
int launch_block(const StreamArgs* a, const void* vals, const void* v,
                 void* partial, void* y, void* stream) {
  const E ent{static_cast<const V*>(vals), a->cols, static_cast<const V*>(v),
              a->out_rows};
  return static_cast<int>(launch_stream_rows_any(
      ent, rows_of(*a), a->n_long, a->group,
      static_cast<typename E::T*>(partial), static_cast<typename E::Out*>(y),
      static_cast<cudaStream_t>(stream), a->out_long));
}

}  // namespace

extern "C" {

// a: the stream's fixed arguments (segtile_common.cuh: block columns, row
// offsets over block rows, long rows, lane group, and for the folded view
// out_rows / out_long, else both null); vals (nbz, 4) block records, v
// (2 * nb), partial scratch (2 * n_pieces), y (2 * n_rows) with
// y[2*out_row + i], and the CUDA stream.  Returns cudaGetLastError().
int segtile_block_f32(const StreamArgs* a, const void* vals, const void* v,
                      void* partial, void* y, void* stream) {
  return launch_block<BlockEntries<float>, float>(a, vals, v, partial, y,
                                                  stream);
}

int segtile_block_f64(const StreamArgs* a, const void* vals, const void* v,
                      void* partial, void* y, void* stream) {
  return launch_block<BlockEntries<double>, double>(a, vals, v, partial, y,
                                                    stream);
}

// int32: records, v and y int32, partial int32 scratch (the sums' bits).
int segtile_block_i32(const StreamArgs* a, const void* vals, const void* v,
                      void* partial, void* y, void* stream) {
  return launch_block<WideBlockEntries<int>, int>(a, vals, v, partial, y,
                                                  stream);
}

// bf16: records, v and y bf16 (8-byte records), partial float32 scratch.
int segtile_block_bf16(const StreamArgs* a, const void* vals, const void* v,
                       void* partial, void* y, void* stream) {
  return launch_block<WideBlockEntries<__nv_bfloat16>, __nv_bfloat16>(
      a, vals, v, partial, y, stream);
}

}  // extern "C"
