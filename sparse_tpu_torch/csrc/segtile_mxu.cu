// K1-mxu: segment-tile CSR SpMV with the row sums on the tensor cores, over
// the plan's compact stream.
//
// Replaces the TPU kernel sparse_tpu/ops/pallas_csr.py::segtile_apply with
// reduce="mxu" (body kernel_mxu :565-595, pallas_call :618), at tile heights
// 8 and 32.  The TPU kernel wrote each grid step's products to a VMEM
// scratch and reduced every tile row's 128 lanes with one matrix-unit
// product against an all-ones (128, 8) matrix at Precision.HIGHEST.  The sum
// is K1's, y[r] = sum of vals[i] * v[cols[i]] over row r's stored entries,
// read from the same compact stream (segtile_csr.cu).
//
// What bounds it on this card: the stream, as K1 (8 bytes per stored entry
// in float32, 12 in float64, 6 in bf16, against 3.35 TB/s); the reduction
// moves no device memory.  What it pays beyond K1 is issue: the tensor core
// sums 8 entries of each of 16 rows a step, so a strip pays for its
// longest row, and the A fragment's layout decides which lane holds which
// product.
//
// What the design does:
//  * one warp per strip of 16 consecutive rows (the m16 of the product), so
//    the strip's loads cover one contiguous segment of the stream; a block
//    walks consecutive chunks of 8 strips (8 blocks per SM in all), so the
//    operand's window of neighbouring rows stays in its L1, as in K1.  Lane
//    4g + t holds strip rows g and g + 8.  The four lanes of a row read it
//    as K1 does, in aligned 4-entry units (one 16-byte evict-first load of
//    values and one of columns a unit, entries outside the row masked to
//    zero), four consecutive units a pass; each lane gathers the operand
//    (__ldg) and puts its products straight into its registers of the A
//    fragment of mma.sync m16n8k8 — A's (g, t), (g + 8, t), (g, t + 4),
//    (g + 8, t + 4) — against an all-ones B held in registers: a pass is
//    two steps, unit entries 0 and 1 in the first, 2 and 3 in the second.
//    Nothing is staged in shared memory.  A strip takes as many passes as
//    its longest row has 16-entry passes (a 20-entry row: 5 or 6 units, two
//    passes); the masked slots cost tensor-core steps, not memory traffic,
//    since their bytes are the neighbouring rows' and are read anyway;
//  * float32: each product split into hi = tf32(p) and lo = tf32(p - hi),
//    both multiplied into one float32 accumulator (ones are exact in TF32),
//    so the sum keeps float32 accuracy.  bf16: values and operand widened
//    exactly to float32, whose product is exact, then the float32 kind's
//    sum, y rounded once to bf16.  float64: Hopper's m16n8k8 DMMA
//    (sm90_tma.cuh's mma_f64_16808).  int32 runs K1's kernel
//    (segtile_csr.cu): sm_90's tensor cores take no 32-bit integer
//    operands, and a sum modulo 2^32 is one result whichever unit adds it;
//  * every column of the 16 x 8 accumulator holds the row sums: lane 4g
//    writes rows g and g + 8 (columns 0), once each — one pass, no
//    partials, no atomics;
//  * long rows: the pieces of segtile_common.cuh, each a strip of 16
//    sub-rows of piece / 16 entries summed the same way, its 16 sums added
//    in order by lane 0; the pieces' sums are added in order per row.

#include "segtile_common.cuh"
#include "sm90_tma.cuh"

namespace {

constexpr int kStrip = 16;  // rows of a strip: the product's m
constexpr int kStep = 8;    // entries of a strip row a step: the product's k

// tf32(x), rounded to nearest (the bits of a float32 whose low 13 mantissa
// bits are zero).
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (16x8, float32) += a (16x8, row, TF32) @ b (8x8, col, TF32), the
// fragment layout of mma_f64_16808.
__device__ __forceinline__ void mma_tf32_16808(float (&d)[4],
                                               const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A strip's row sums: add(p) adds one step's A fragment of products; d[0]
// is then row g's sum and d[2] row g + 8's in lane 4g + t.
template <typename T>
struct LaneSum;

template <>
struct LaneSum<float> {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  __device__ __forceinline__ void add(const float (&p)[4]) {
    constexpr unsigned kOne = 0x3f800000u;  // 1.0f, exact in TF32
    const unsigned ones[2] = {kOne, kOne};
    unsigned hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = to_tf32(p[e]);
      lo[e] = to_tf32(p[e] - __uint_as_float(hi[e]));
    }
    mma_tf32_16808(d, hi, ones);
    mma_tf32_16808(d, lo, ones);
  }
};

template <>
struct LaneSum<double> {
  double d[4] = {0.0, 0.0, 0.0, 0.0};

  __device__ __forceinline__ void add(const double (&p)[4]) {
    const double ones[2] = {1.0, 1.0};
    sm90::mma_f64_16808(d, p, ones);
  }
};

// Per value type V: T, the type of the products and the sums (partial
// too); Out, y's; of(x), a value widened exactly; gather(v, c), operand
// element c.  float32 and float64 in their own type; bf16 widened exactly
// to float32, where a product of two bf16 values is exact, so the float32
// kind's TF32 hi + lo sum applies unchanged, then y is rounded once.
template <typename V>
struct Val {
  using T = V;
  using Out = V;
  __device__ static __forceinline__ T of(V x) { return x; }
  __device__ static __forceinline__ T gather(const V* v, int c) {
    return __ldg(v + c);
  }
};
template <>
struct Val<__nv_bfloat16> {
  using T = float;
  using Out = __nv_bfloat16;
  __device__ static __forceinline__ float of(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __forceinline__ float gather(const __nv_bfloat16* v,
                                                 int c) {
    return Widen<__nv_bfloat16>::gather(v, c);
  }
};

// The products of aligned 4-entry unit u of the stream that lie in
// [s, e), zeros elsewhere: one 16-byte evict-first load of the columns,
// one of the values (8 bytes in bf16, 32 in float64), the gathers.
template <typename V, typename T = typename Val<V>::T>
__device__ __forceinline__ void unit_products(const V* __restrict__ vals,
                                              const int* __restrict__ cols,
                                              const V* __restrict__ v,
                                              long long u, long long s,
                                              long long e, T (&p)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) p[q] = T(0);
  if (4 * u >= e) return;
  V a[4];
  load4_stream(vals + 4 * u, a);
  const int4 c4 = __ldcs(reinterpret_cast<const int4*>(cols) + u);
  const int c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long i = 4 * u + q;
    if (i >= s && i < e) p[q] = Val<V>::of(a[q]) * Val<V>::gather(v, c[q]);
  }
}

// The sums of a strip: lane 4g + t holds strip row g's entry range
// [s0, e0) and row g + 8's [s1, e1) (every lane of the warp takes part).
// A row is read in aligned 4-entry units, the four lanes of its group
// taking four consecutive units a pass (16 entries, 64 bytes of values in
// float32); a pass is two steps of the product: lane t's unit entries 0
// and 1 are A's (row, t) and (row, t + 4) in the first, entries 2 and 3 in
// the second.  The passes and steps are added in order.
template <typename V, typename T = typename Val<V>::T>
__device__ __forceinline__ void strip_sums(const V* __restrict__ vals,
                                           const int* __restrict__ cols,
                                           const V* __restrict__ v,
                                           long long s0, long long e0,
                                           long long s1, long long e1,
                                           LaneSum<T>& sum) {
  const int t = threadIdx.x % 4;
  const long long u0 = s0 / 4, u1 = s1 / 4;
  const long long n0 = e0 > s0 ? (e0 + 3) / 4 - u0 : 0;
  const long long n1 = e1 > s1 ? (e1 + 3) / 4 - u1 : 0;
  const int passes = __reduce_max_sync(
      0xffffffffu, static_cast<unsigned>((max(n0, n1) + 3) / 4));
#pragma unroll 1
  for (int j = 0; j < passes; ++j) {
    T p0[4], p1[4];
    unit_products(vals, cols, v, u0 + 4 * j + t, s0, e0, p0);
    unit_products(vals, cols, v, u1 + 4 * j + t, s1, e1, p1);
    const T a[4] = {p0[0], p1[0], p0[1], p1[1]};
    const T b[4] = {p0[2], p1[2], p0[3], p1[3]};
    sum.add(a);
    sum.add(b);
  }
}

// Short row r's entry range (empty past the last row and for a long row,
// whose pieces sum it); returns whether this strip writes it.
__device__ __forceinline__ bool short_row(const Rows& rows, long long r,
                                          long long& s, long long& e) {
  s = e = 0;
  if (r >= rows.n_rows) return false;
  s = __ldg(rows.row_ptr + r);
  e = __ldg(rows.row_ptr + r + 1);
  if (e - s <= rows.long_min) return true;
  e = s;
  return false;
}

// Blocks [0, n_strip_blocks) take the short rows, each `per_block`
// consecutive chunks of kWarps strips in turn (one strip a warp), so the
// operand's window of neighbouring rows stays in the SM's L1 from one
// chunk to the next, as in stream_rows; the blocks after them take the
// pieces, one a warp.
template <typename V, typename T = typename Val<V>::T,
          typename Out = typename Val<V>::Out>
__global__ void __launch_bounds__(kThreads)
    segtile_mxu_rows(const V* __restrict__ vals, const int* __restrict__ cols,
                     const V* __restrict__ v, Rows rows,
                     long long n_strip_blocks, long long per_block,
                     T* __restrict__ partial, Out* __restrict__ y) {
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;
  long long s0, e0, s1, e1;
  if (blockIdx.x < n_strip_blocks) {
    constexpr int kChunkRows = kWarps * kStrip;
    const long long n_chunks = (rows.n_rows + kChunkRows - 1) / kChunkRows;
    const long long c1 = min((blockIdx.x + 1) * per_block, n_chunks);
    for (long long c = blockIdx.x * per_block; c < c1; ++c) {
      const long long r0 = (c * kWarps + w) * kStrip + g;
      const bool mine0 = short_row(rows, r0, s0, e0);
      const bool mine1 = short_row(rows, r0 + 8, s1, e1);
      LaneSum<T> sum;
      strip_sums(vals, cols, v, s0, e0, s1, e1, sum);
      if (lane % 4 == 0) {
        if (mine0) store_out(y + r0, sum.d[0]);
        if (mine1) store_out(y + r0 + 8, sum.d[2]);
      }
    }
  } else {
    const long long pc =
        (static_cast<long long>(blockIdx.x) - n_strip_blocks) * kWarps + w;
    long long ps, pe;
    piece_range(rows, pc, ps, pe);
    const long long width = rows.piece / kStrip;
    s0 = min(ps + g * width, pe);
    e0 = min(s0 + width, pe);
    s1 = min(ps + (g + 8) * width, pe);
    e1 = min(s1 + width, pe);
    LaneSum<T> sum;
    strip_sums(vals, cols, v, s0, e0, s1, e1, sum);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < kStrip; ++i)  // sub-row i's sum, in order
      acc += __shfl_sync(0xffffffffu, i < 8 ? sum.d[0] : sum.d[2],
                         (i % 8) * 4);
    if (lane == 0 && pc < rows.n_pieces) partial[pc] = acc;
  }
}

template <typename V>
int segtile_mxu_any(const StreamArgs* a, const void* vals, const void* v,
                    void* partial, void* y, void* stream) {
  using T = typename Val<V>::T;
  using Out = typename Val<V>::Out;
  if (a->piece % (kStrip * kStep) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows = rows_of(*a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kChunkRows = kWarps * kStrip;
  long long per_block, strip_blocks;
  cudaError_t err = split_chunks((a->n_rows + kChunkRows - 1) / kChunkRows,
                                 per_block, strip_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = strip_blocks + (a->n_pieces + kWarps - 1) / kWarps;
  if (grid > 0) {
    segtile_mxu_rows<V><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const V*>(vals), a->cols, static_cast<const V*>(v), rows,
        strip_blocks, per_block, static_cast<T*>(partial),
        static_cast<Out*>(y));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_long_row_sum<T, 1, Out>(
      static_cast<const T*>(partial), rows, a->n_long, static_cast<Out*>(y),
      s));
}

}  // namespace

extern "C" {

// segtile_csr_f32/_f64's arguments (segtile_csr.cu; the lane group is not
// read); piece must be a multiple of 128 entries.  Returns
// cudaGetLastError().
int segtile_mxu_f32(const StreamArgs* a, const void* vals, const void* v,
                    void* partial, void* y, void* stream) {
  return segtile_mxu_any<float>(a, vals, v, partial, y, stream);
}

int segtile_mxu_f64(const StreamArgs* a, const void* vals, const void* v,
                    void* partial, void* y, void* stream) {
  return segtile_mxu_any<double>(a, vals, v, partial, y, stream);
}

// bf16: vals, v and y bf16, partial float32 scratch.  (int32 has no kind
// here: the tensor cores take no 32-bit integer operands, and the wrapper
// launches segtile_csr_i32 instead.)
int segtile_mxu_bf16(const StreamArgs* a, const void* vals, const void* v,
                     void* partial, void* y, void* stream) {
  return segtile_mxu_any<__nv_bfloat16>(a, vals, v, partial, y, stream);
}

}  // extern "C"
