// Shared pieces of the compact-stream SpMV kernels (segtile_csr.cu,
// segtile_mxu.cu, segtile_block.cu): the row classes of a plan's compact
// stream, streamed loads, the lane-group sum, the one-pass row kernel (and
// narrow_rows, its form on 32-bit entry offsets on one wave of resident
// blocks) and the fixed-order sum of a long row's pieces.
//
// The stream (built once per plan by ops/cuda_csr.py) holds a plan's stored
// entries in (output row, tile, lane) order, so each output row is one
// contiguous segment [row_ptr[r], row_ptr[r+1]).  A row is short when it has
// at most `long_min` entries: a lane group sums it and writes y[r] once.  A
// longer row is cut into pieces of `piece` entries; one warp sums each piece
// into partial[p], and long_row_sum adds a row's pieces in piece order.  No
// float atomics anywhere, so every result is bitwise repeatable.  An entry
// kind may write stream row r to another output row (E::out_row: K2's
// folded view writes in the caller's numbering); the long rows' sum then
// takes their output rows as a list of its own (out_long).
//
// Value kinds: float32 and float64 sum in their own type; int32 multiplies
// and adds in unsigned (a sum modulo 2^32, the reference's wrapping int32
// result in any order) and stores the bits as int32; bf16 widens values and
// operand exactly to float32, sums in float32 (partial too) and rounds once
// to bf16 as y is stored (Widen<V>, store_out).
//
// Everything but StreamArgs (the C entries' fixed arguments, one layout for
// the whole library) lives in an anonymous namespace so each translation
// unit keeps its own copy of the templates (all are linked into one
// library).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // threads of a block
constexpr int kWarps = kThreads / kWarp;
constexpr int kBlocksPerSm = 8;  // short-row blocks launched per SM

// Row classes of a compact stream.  long_rows lists the long rows; the
// pieces of long row j are piece_ptr[j] .. piece_ptr[j+1) and piece_row[p]
// is the j of piece p.
struct Rows {
  const int* row_ptr;    // (n_rows + 1) entry offsets
  const int* long_rows;  // (n_long)
  const int* piece_ptr;  // (n_long + 1)
  const int* piece_row;  // (n_pieces)
  long long n_rows;
  long long n_pieces;
  int long_min;  // entries: a row with more is long
  int piece;     // entries of one piece
};

// Entry range [s, e) of piece pc (an empty range past the last piece).
__device__ __forceinline__ void piece_range(const Rows& rows, long long pc,
                                            long long& s, long long& e) {
  s = e = 0;
  if (pc < rows.n_pieces) {
    const int j = __ldg(rows.piece_row + pc);
    const int r = __ldg(rows.long_rows + j);
    const long long k = pc - __ldg(rows.piece_ptr + j);
    s = __ldg(rows.row_ptr + r) + k * rows.piece;
    e = min(s + rows.piece, static_cast<long long>(__ldg(rows.row_ptr + r + 1)));
  }
}

// Four consecutive stream values.  The stream is read exactly once per
// SpMV, so it is loaded evict-first (__ldcs) to leave the L2 to the operand
// vector.  16-byte loads: the wrapper checks the alignment.
__device__ __forceinline__ void load4_stream(const float* p, float (&a)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  a[0] = t.x;
  a[1] = t.y;
  a[2] = t.z;
  a[3] = t.w;
}

__device__ __forceinline__ void load4_stream(const double* p,
                                             double (&a)[4]) {
  const double2 t0 = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 t1 = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  a[0] = t0.x;
  a[1] = t0.y;
  a[2] = t1.x;
  a[3] = t1.y;
}

__device__ __forceinline__ void load4_stream(const int* p, int (&a)[4]) {
  const int4 t = __ldcs(reinterpret_cast<const int4*>(p));
  a[0] = t.x;
  a[1] = t.y;
  a[2] = t.z;
  a[3] = t.w;
}

// Four bf16 values: one 8-byte load (the wrapper checks 16-byte alignment
// of the stream, whose units are 4 entries).
__device__ __forceinline__ void load4_stream(const __nv_bfloat16* p,
                                             __nv_bfloat16 (&a)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  a[0] = lo.x;
  a[1] = lo.y;
  a[2] = hi.x;
  a[3] = hi.y;
}

// The sums of the int32 and bf16 kinds: Acc, the type products and sums
// are taken in (partial too); Out, y's; of(x), a value widened exactly;
// gather(v, c), operand element c through the read-only path.
template <typename V>
struct Widen;
template <>
struct Widen<int> {
  using Acc = unsigned;
  using Out = int;
  __device__ static __forceinline__ unsigned of(int x) {
    return static_cast<unsigned>(x);
  }
  __device__ static __forceinline__ unsigned gather(const int* v, int c) {
    return static_cast<unsigned>(__ldg(v + c));
  }
};
template <>
struct Widen<__nv_bfloat16> {
  using Acc = float;
  using Out = __nv_bfloat16;
  __device__ static __forceinline__ float of(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // a bf16 is the high half of the float32 it widens to
  __device__ static __forceinline__ float gather(const __nv_bfloat16* v,
                                                 int c) {
    return __uint_as_float(
        static_cast<unsigned>(
            __ldg(reinterpret_cast<const unsigned short*>(v) + c))
        << 16);
  }
};

// *p = x, in y's type: the float kinds store their sum as it is, int32 its
// bits, bf16 rounds once to nearest even.
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(double* p, double x) { *p = x; }
__device__ __forceinline__ void store_out(int* p, unsigned x) {
  *p = static_cast<int>(x);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Butterfly sum over the G lanes of an aligned lane group (G a power of two
// up to 32): a fixed order, so the result is bitwise repeatable.  Every lane
// of the warp takes part.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows a lane group takes at once: their first load units are all in
// flight before the first gather (a row of the band is one unit a lane).
template <int G>
__host__ __device__ constexpr int rows_per_group() {
  return G <= 8 ? 4 : (G == 16 ? 2 : 1);
}

// Rows a lane group of entry kind E takes at once: rows_per_group, but
// two where that is four for a kind that sets kHalfRows<E> (float64, whose
// units hold twice the registers: see segtile_csr.cu).
template <class E>
constexpr bool kHalfRows = false;
template <class E, int G>
constexpr int group_rows =
    kHalfRows<E> && rows_per_group<G>() == 4 ? 2 : rows_per_group<G>();

// Chunk c of the short rows (see stream_rows).
template <class E, int G>
__device__ __forceinline__ void chunk_rows(const E& ent, const Rows& rows,
                                           long long c, typename E::Out* y) {
  using T = typename E::T;
  constexpr int K = group_rows<E, G>;
  constexpr int kGroups = kWarp / G;  // lane groups of a warp
  const long long r0 =
      (c * kWarps + threadIdx.x / kWarp) * kGroups * K +
      (threadIdx.x % kWarp) / G;
  const int g = threadIdx.x % G;
  long long s[K], e[K];
  bool mine[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long r = r0 + k * kGroups;
    s[k] = e[k] = 0;
    mine[k] = false;
    if (r < rows.n_rows) {
      s[k] = __ldg(rows.row_ptr + r);
      e[k] = __ldg(rows.row_ptr + r + 1);
      mine[k] = e[k] - s[k] <= rows.long_min;
      if (!mine[k]) e[k] = s[k];  // a long row: its pieces sum it
    }
  }
  T acc[K][E::kC];
  typename E::Unit x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[k][c] = T(0);
    const long long u = s[k] / E::kUnit + g;
    if (u * E::kUnit < e[k]) x[k] = ent.load(u);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long u = s[k] / E::kUnit + g;
    if (u * E::kUnit < e[k]) ent.add(acc[k], x[k], u, s[k], e[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {  // the rest of each row
    for (long long u = s[k] / E::kUnit + g + G; u * E::kUnit < e[k];
         u += G)
      ent.add(acc[k], ent.load(u), u, s[k], e[k]);
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[k][c] = group_sum<G>(acc[k][c]);
    if (mine[k] && g == 0)
      E::store(y, ent.out_row(r0 + k * kGroups), acc[k]);
  }
}

// The one-pass row kernel, for an entry kind E:
//   E::T (the sums' type, and partial's), E::Out (y's), E::kUnit (entries per load unit), E::kC (output components per
//   row), E::Unit and E::load(u) (load unit u's stream words),
//   E::add(acc, x, u, s, e) (adds the entries of loaded unit x = u that lie
//   in [s, e)), E::out_row(r) (the output row of stream row r) and
//   E::store(out, i, acc) (writes out[i*kC .. i*kC + kC)).
// Blocks [0, n_row_blocks) take the short rows, each `per_block`
// consecutive chunks of kThreads / G * K rows in turn, so the operand's
// window of neighbouring rows stays in the SM's L1 from one chunk to the
// next.  In a chunk, a warp takes 32 / G * K consecutive rows, its group j
// (of G lanes) rows j, j + 32 / G, ... so that at each step the groups
// read neighbouring rows.  The blocks after them take the long rows'
// pieces, one warp per piece, written to partial[p*kC ..].  E::store takes
// either (partial's T, or y's Out).
template <class E, int G>
__global__ void __launch_bounds__(kThreads)
    stream_rows(E ent, Rows rows, long long n_row_blocks, long long per_block,
                typename E::T* __restrict__ partial,
                typename E::Out* __restrict__ y) {
  if (blockIdx.x < n_row_blocks) {
    constexpr int kChunkRows = kThreads / G * group_rows<E, G>;
    const long long n_chunks = (rows.n_rows + kChunkRows - 1) / kChunkRows;
    const long long c1 = min((blockIdx.x + 1) * per_block, n_chunks);
    for (long long c = blockIdx.x * per_block; c < c1; ++c)
      chunk_rows<E, G>(ent, rows, c, y);
  } else {
    using T = typename E::T;
    T acc[E::kC];
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[c] = T(0);
    const long long pc =
        (static_cast<long long>(blockIdx.x) - n_row_blocks) * kWarps +
        threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    long long s, e;
    piece_range(rows, pc, s, e);
    for (long long u = s / E::kUnit + lane; u * E::kUnit < e; u += kWarp)
      ent.add(acc, ent.load(u), u, s, e);
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[c] = group_sum<kWarp>(acc[c]);
    if (pc < rows.n_pieces && lane == 0) E::store(partial, pc, acc);
  }
}

// Chunk c of the short rows on 32-bit entry offsets (a stream's row
// offsets are int32): chunk_rows with int where it holds long long, for
// narrow_rows.  E::add takes int offsets.
template <class E, int G>
__device__ __forceinline__ void narrow_chunk(const E& ent, const Rows& rows,
                                             int c, typename E::Out* y) {
  using T = typename E::T;
  constexpr int K = group_rows<E, G>;
  constexpr int kGroups = kWarp / G;  // lane groups of a warp
  const int r0 = (c * kWarps + static_cast<int>(threadIdx.x / kWarp)) *
                     kGroups * K +
                 static_cast<int>((threadIdx.x % kWarp) / G);
  const int g = threadIdx.x % G;
  int s[K], e[K];
  bool mine[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = r0 + k * kGroups;
    s[k] = e[k] = 0;
    mine[k] = false;
    if (r < rows.n_rows) {
      s[k] = __ldg(rows.row_ptr + r);
      e[k] = __ldg(rows.row_ptr + r + 1);
      mine[k] = e[k] - s[k] <= rows.long_min;
      if (!mine[k]) e[k] = s[k];  // a long row: its pieces sum it
    }
  }
  T acc[K][E::kC];
  typename E::Unit x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[k][c] = T(0);
    const int u = s[k] / E::kUnit + g;
    if (u * E::kUnit < e[k]) x[k] = ent.load(u);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = s[k] / E::kUnit + g;
    if (u * E::kUnit < e[k]) ent.add(acc[k], x[k], u, s[k], e[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {  // the rest of each row
    for (int u = s[k] / E::kUnit + g + G; u * E::kUnit < e[k]; u += G)
      ent.add(acc[k], ent.load(u), u, s[k], e[k]);
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[k][c] = group_sum<G>(acc[k][c]);
    if (mine[k] && g == 0)
      E::store(y, ent.out_row(r0 + k * kGroups), acc[k]);
  }
}

// stream_rows on 32-bit entry offsets (narrow_chunk), held to MINB
// resident blocks an SM by __launch_bounds__ and launched on one wave of
// resident blocks (launch_narrow_rows), each walking the chunks that wave
// leaves it; the long rows' pieces as in stream_rows.
template <class E, int G, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    narrow_rows(E ent, Rows rows, int n_row_blocks, int per_block,
                typename E::T* __restrict__ partial,
                typename E::Out* __restrict__ y) {
  if (static_cast<int>(blockIdx.x) < n_row_blocks) {
    constexpr int kChunkRows = kThreads / G * group_rows<E, G>;
    const int n_chunks =
        static_cast<int>((rows.n_rows + kChunkRows - 1) / kChunkRows);
    const int c0 = static_cast<int>(blockIdx.x) * per_block;
    const int c1 = min(c0 + per_block, n_chunks);
    for (int c = c0; c < c1; ++c) narrow_chunk<E, G>(ent, rows, c, y);
  } else {
    using T = typename E::T;
    T acc[E::kC];
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[c] = T(0);
    const long long pc =
        (static_cast<long long>(blockIdx.x) - n_row_blocks) * kWarps +
        threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    long long s, e;
    piece_range(rows, pc, s, e);
    for (long long u = s / E::kUnit + lane; u * E::kUnit < e; u += kWarp)
      ent.add(acc, ent.load(u), u, s, e);
#pragma unroll
    for (int c = 0; c < E::kC; ++c) acc[c] = group_sum<kWarp>(acc[c]);
    if (pc < rows.n_pieces && lane == 0) E::store(partial, pc, acc);
  }
}

// y[long_rows[j]] = the sum of row j's piece partials in piece order, one
// thread per long row (C components each), stored in y's type Out.
template <typename T, int C, typename Out = T>
__global__ void long_row_sum(const T* __restrict__ partial,
                             const int* __restrict__ long_rows,
                             const int* __restrict__ piece_ptr,
                             long long n_long, Out* __restrict__ y) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n_long) return;
  const int p0 = piece_ptr[j], p1 = piece_ptr[j + 1];
  const long long r = long_rows[j];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T acc = T(0);
    for (int p = p0; p < p1; ++p) acc += partial[static_cast<long long>(p) * C + c];
    store_out(y + r * C + c, acc);
  }
}

// out_long: each long row's output row (null: its stream row).
template <typename T, int C, typename Out = T>
cudaError_t launch_long_row_sum(const T* partial, const Rows& rows,
                                long long n_long, Out* y, cudaStream_t s,
                                const int* out_long = nullptr) {
  if (n_long > 0) {
    const long long blocks = (n_long + kThreads - 1) / kThreads;
    long_row_sum<T, C, Out><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        partial, out_long ? out_long : rows.long_rows, rows.piece_ptr, n_long,
        y);
  }
  return cudaGetLastError();
}

// `chunks` consecutive row chunks over `per_sm` blocks per SM of the
// current device: `per_block` chunks a block, `blocks` blocks.
inline cudaError_t split_chunks(long long chunks, long long& per_block,
                                long long& blocks,
                                int per_sm = kBlocksPerSm) {
  int dev = 0, sms = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = static_cast<long long>(sms) * per_sm;
  per_block = chunks > want ? (chunks + want - 1) / want : 1;
  blocks = (chunks + per_block - 1) / per_block;
  return err;
}

// Rows a chunk of the row kernel holds at lane group G for entry kind E.
template <class E, int G>
constexpr int kChunkRowsOf = kThreads / G * group_rows<E, G>;

// Launch stream_rows at lane-group size G, then the long rows' sum.
template <class E, int G>
cudaError_t launch_stream_rows(const E& ent, const Rows& rows,
                               long long n_long, typename E::T* partial,
                               typename E::Out* y, cudaStream_t s,
                               const int* out_long) {
  constexpr int kChunkRows = kChunkRowsOf<E, G>;
  long long per_block, row_blocks;
  cudaError_t err = split_chunks((rows.n_rows + kChunkRows - 1) / kChunkRows,
                                 per_block, row_blocks);
  if (err != cudaSuccess) return err;
  const long long grid = row_blocks + (rows.n_pieces + kWarps - 1) / kWarps;
  if (grid > 0) {
    stream_rows<E, G><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        ent, rows, row_blocks, per_block, partial, y);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_long_row_sum<typename E::T, E::kC, typename E::Out>(
      partial, rows, n_long, y, s, out_long);
}

// Launch narrow_rows<E, G, MINB> on one wave of resident blocks (their
// count read from the runtime at the first launch), then the long rows'
// sum.
template <class E, int G, int MINB>
cudaError_t launch_narrow_rows(const E& ent, const Rows& rows,
                               long long n_long, typename E::T* partial,
                               typename E::Out* y, cudaStream_t s) {
  constexpr int kChunkRows = kChunkRowsOf<E, G>;
  static int resident = 0;
  cudaError_t err = cudaSuccess;
  if (resident == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, narrow_rows<E, G, MINB>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (resident == 0) return cudaErrorInvalidConfiguration;
  long long per_block, row_blocks;
  err = split_chunks((rows.n_rows + kChunkRows - 1) / kChunkRows, per_block,
                     row_blocks, resident);
  if (err != cudaSuccess) return err;
  const long long grid = row_blocks + (rows.n_pieces + kWarps - 1) / kWarps;
  if (grid > 0) {
    narrow_rows<E, G, MINB><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        ent, rows, static_cast<int>(row_blocks), static_cast<int>(per_block),
        partial, y);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_long_row_sum<typename E::T, E::kC, typename E::Out>(
      partial, rows, n_long, y, s, nullptr);
}

// f(std::integral_constant<int, G>{}) at the lane-group size `group` (1,
// 2, 4, ..., 32); cudaErrorInvalidValue for any other.
template <class F>
cudaError_t with_group(int group, F&& f) {
  switch (group) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

// Dispatch the lane-group size (1, 2, 4, ..., 32) to its instantiation;
// out_long as in launch_long_row_sum.
template <class E>
cudaError_t launch_stream_rows_any(const E& ent, const Rows& rows,
                                   long long n_long, int group,
                                   typename E::T* partial,
                                   typename E::Out* y, cudaStream_t s,
                                   const int* out_long = nullptr) {
  return with_group(group, [&](auto g) {
    return launch_stream_rows<E, decltype(g)::value>(ent, rows, n_long,
                                                     partial, y, s, out_long);
  });
}

}  // namespace

// The arguments of a compact-stream kernel that stay the same from call to
// call, built once per stream by its wrapper (ops/cuda_csr.py, whose
// ctypes copy is _kernels.StreamArgs) and passed by address.
struct StreamArgs {
  const int* cols;       // int32 columns, 16-byte aligned
  const int* row_ptr;    // (n_rows + 1) entry offsets
  const int* long_rows;  // (n_long)
  const int* piece_ptr;  // (n_long + 1)
  const int* piece_row;  // (n_pieces)
  long long n_rows;
  long long n_long;
  long long n_pieces;
  int long_min;
  int piece;
  int group;             // K1's and K2's lane group: 1, 2, 4, ..., 32
  const int* out_rows;   // K2's folded view: (n_rows) output rows, or null
  const int* out_long;   // (n_long) the long rows' output rows, or null
};

namespace {

// The row classes of a stream's fixed arguments.
inline Rows rows_of(const StreamArgs& a) {
  return Rows{a.row_ptr, a.long_rows, a.piece_ptr, a.piece_row,
              a.n_rows,  a.n_pieces,  a.long_min,  a.piece};
}

// A C entry of an entries kind E (values and operand of type V, int32
// columns): the stream's fixed arguments, then the values, the operand,
// the scratch, y and the CUDA stream; returns cudaGetLastError().
template <class E, typename V>
int launch_entries(const StreamArgs* a, const void* vals, const void* v,
                   void* partial, void* y, void* stream) {
  const E ent{static_cast<const V*>(vals), a->cols, static_cast<const V*>(v)};
  return static_cast<int>(launch_stream_rows_any(
      ent, rows_of(*a), a->n_long, a->group,
      static_cast<typename E::T*>(partial), static_cast<typename E::Out*>(y),
      static_cast<cudaStream_t>(stream)));
}

}  // namespace
