// K7: block-SpGEMM slab apply on Hopper, C[o] = sum over the schedule's
// slots aimed at output block o of Z1[a] @ Z2[b], in slot order.
//
// Replaces the TPU kernel in sparse_tpu/ops/pallas_bsr.py::run_slabs_arrays
// (def :467, pallas_call :562, kernel :486), both table layouts:
//   unpaired  slot i of step t reads Z1[a_idx[t*g + i]] and Z2[b_idx[t*g+i]]
//             and adds into row oloc[t*g + i] of its slab;
//   paired    a_idx holds (S*g/2) two-block windows: slot i reads
//             Z1[2*a_idx[(t*g + i)/2] + (oloc & 1)], its row is oloc >> 1.
// Slab s (p output blocks, global ids s*p .. s*p+p-1) owns the steps
// [slab_start[s], slab_start[s+1]).  Pad slots read zero blocks and add
// exact zeros.  Z1, Z2 (., bsz, bsz) and C (nbz_out, bsz, bsz) row-major.
//
// What bounds it on this card: a product is 2*bsz^3 flops against two
// bsz^2 blocks, and every output block is written once; at bsz 32 in float32
// that is 64 KFLOP per 8 KB of operands, which mostly come from the 50 MB
// L2 (each stored block feeds ~10 products on a banded pattern), so the
// inner product runs on the CUDA cores at the rate shared memory feeds them
// (full float32 is the contract: no TF32, no tensor cores), and the C write
// (bsz^2 per output block) is the one stream that must reach device memory.
//
// What the design does about it: the TPU kernel zeroed a 128-block slab in
// VMEM and read-modify-wrote it once per product, in a grid that runs in
// order.  Here one thread block owns ONE output block: it scans its slab's
// slots in order (a block-wide ballot keeps the ones aimed at its row, in
// slot order), stages each product's A and B blocks in shared memory with
// coalesced 16-byte loads, and keeps its bsz^2 sums in registers across all
// its products.  It writes its block once, through shared memory so the
// store is coalesced; a block with no product writes zeros (the TPU's
// `first` zeroing, so C needs no memset).  No atomics, no second pass: the
// result is bitwise repeatable.  Register tile: lane = output row (lane +
// 32*rm), warp = 8 output columns; per contraction step a thread reads its
// A element (rows padded to an odd stride: no bank conflict) and 8 B values
// as broadcast 16-byte loads, for 8 FMAs per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Element types of the C entry point.
enum Kind { kF32 = 0, kBF16 = 2, kF64 = 3 };

constexpr int kMaxBsz = 64;
constexpr int kCols = 8;  // output columns per warp

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double widen(double x) { return x; }

__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void narrow(double x, double* p) { *p = x; }

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}

// 8 consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void lds8(const float* p, float (&r)[kCols]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  r[0] = u.x; r[1] = u.y; r[2] = u.z; r[3] = u.w;
  r[4] = v.x; r[5] = v.y; r[6] = v.z; r[7] = v.w;
}
__device__ __forceinline__ void lds8(const double* p, double (&r)[kCols]) {
#pragma unroll
  for (int q = 0; q < kCols / 2; ++q) {
    const double2 u = reinterpret_cast<const double2*>(p)[q];
    r[2 * q] = u.x;
    r[2 * q + 1] = u.y;
  }
}

// Layout of one thread block's dynamic shared memory, in elements of S:
// As (bsz x lda) | Bs (bsz x ldb) | slot list (blockDim ints).
struct Smem {
  int lda, ldb, b_off, list_off_bytes;
};

template <typename S>
__host__ __device__ __forceinline__ Smem smem_layout(int bsz) {
  Smem m;
  m.lda = bsz | 1;                 // odd stride: column reads conflict-free
  m.ldb = (bsz + kCols - 1) / kCols * kCols;  // rows of 16-byte groups
  m.b_off = (bsz * m.lda + 3) / 4 * 4;        // Bs 16-byte aligned
  m.list_off_bytes = (m.b_off + bsz * m.ldb) * static_cast<int>(sizeof(S));
  return m;
}

template <typename S>
inline size_t smem_bytes(int bsz, int threads) {
  const Smem m = smem_layout<S>(bsz);
  return static_cast<size_t>(m.list_off_bytes) + threads * sizeof(int);
}

// Copy one bsz x bsz block from global memory into shared memory (row
// stride ld), widened to S.  VEC: 16-byte loads (bsz a multiple of the
// vector width and aligned bases, checked by the caller).
template <typename T, typename S, bool VEC>
__device__ __forceinline__ void stage(const T* __restrict__ src, S* dst,
                                      int ld, int bsz) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const int per_row = bsz / V;
  const int rstep = blockDim.x / per_row;
  const int r0 = threadIdx.x / per_row;
  const int c = (threadIdx.x - r0 * per_row) * V;
  if (r0 >= rstep) return;
  for (int r = r0; r < bsz; r += rstep) {
    if constexpr (VEC) {
      union {
        uint4 u;
        T t[V];
      } x;
      x.u = __ldg(reinterpret_cast<const uint4*>(src + r * bsz + c));
#pragma unroll
      for (int e = 0; e < V; ++e) dst[r * ld + c + e] = widen(x.t[e]);
    } else {
      dst[r * ld + c] = widen(src[r * bsz + c]);
    }
  }
}

template <typename T, int RM, bool VEC>
__global__ void __launch_bounds__(256)
    bsr_slab_kernel(const T* __restrict__ z1, const T* __restrict__ z2,
                    const int* __restrict__ a_idx,
                    const int* __restrict__ b_idx,
                    const int* __restrict__ oloc,
                    const int* __restrict__ slab_start, T* __restrict__ out,
                    int bsz, int g, int p, int paired) {
  using S = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_hits[256 / 32];
  const Smem L = smem_layout<S>(bsz);
  S* As = reinterpret_cast<S*>(smem_raw);
  S* Bs = As + L.b_off;
  int* list = reinterpret_cast<int*>(smem_raw + L.list_off_bytes);

  const long long o = blockIdx.x;
  const int s = static_cast<int>(o / p);
  const int row = static_cast<int>(o - static_cast<long long>(s) * p);
  const long long lo = static_cast<long long>(slab_start[s]) * g;
  const long long hi = static_cast<long long>(slab_start[s + 1]) * g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long bsz2 = static_cast<long long>(bsz) * bsz;

  S acc[RM][kCols];
#pragma unroll
  for (int rm = 0; rm < RM; ++rm)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[rm][j] = S(0);

  for (long long base = lo; base < hi; base += blockDim.x) {
    // keep this chunk's slots aimed at `row`, in slot order
    const long long slot = base + tid;
    const bool hit = slot < hi && (__ldg(oloc + slot) >> paired) == row;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int cnt = warp_hits[w];
      off += w < warp ? cnt : 0;
      total += cnt;
    }
    if (hit) list[off + __popc(mask & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    for (int q = 0; q < total; ++q) {
      const long long sl = base + list[q];
      const long long ai =
          paired ? 2LL * __ldg(a_idx + (sl >> 1)) + (__ldg(oloc + sl) & 1)
                 : static_cast<long long>(__ldg(a_idx + sl));
      const long long bi = __ldg(b_idx + sl);
      __syncthreads();  // the previous product is done with As / Bs
      stage<T, S, VEC>(z1 + ai * bsz2, As, L.lda, bsz);
      stage<T, S, VEC>(z2 + bi * bsz2, Bs, L.ldb, bsz);
      __syncthreads();
      const int c0 = warp * kCols;
#pragma unroll 4
      for (int k = 0; k < bsz; ++k) {
        S b[kCols];
        lds8(Bs + k * L.ldb + c0, b);
#pragma unroll
        for (int rm = 0; rm < RM; ++rm) {
          const int i = lane + 32 * rm;
          if (i < bsz) {
            const S a = As[i * L.lda + k];
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[rm][j] = mad(a, b[j], acc[rm][j]);
          }
        }
      }
    }
    __syncthreads();  // every warp has read warp_hits and list
  }

  // write C[o] once, through shared memory (As) so the store is coalesced
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
    const int i = lane + 32 * rm;
    if (i < bsz) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = warp * kCols + j;
        if (c < bsz) As[i * L.lda + c] = acc[rm][j];
      }
    }
  }
  __syncthreads();
  T* dst = out + o * bsz2;
  for (int e = tid; e < bsz2; e += blockDim.x) {
    const int i = e / bsz;
    narrow(As[i * L.lda + (e - i * bsz)], dst + e);
  }
}

template <typename T, int RM, bool VEC>
cudaError_t launch_one(const void* z1, const void* z2, const void* a_idx,
                       const void* b_idx, const void* oloc,
                       const void* slab_start, void* out, long long nbz_out,
                       int bsz, int g, int p, int paired,
                       cudaStream_t stream) {
  using S = typename AccOf<T>::type;
  const int warps = (bsz + kCols - 1) / kCols;
  const int threads = 32 * warps;
  const size_t bytes = smem_bytes<S>(bsz, threads);
  auto kernel = bsr_slab_kernel<T, RM, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(nbz_out), threads, bytes, stream>>>(
      static_cast<const T*>(z1), static_cast<const T*>(z2),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(oloc), static_cast<const int*>(slab_start),
      static_cast<T*>(out), bsz, g, p, paired);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* z1, const void* z2, const void* a_idx,
                   const void* b_idx, const void* oloc,
                   const void* slab_start, void* out, long long nbz_out,
                   long long bsz, long long g, long long p, int paired,
                   int vec, void* stream) {
  if (nbz_out <= 0) return cudaSuccess;
  if (bsz < 1 || bsz > kMaxBsz || g < 1 || p < 1 ||
      nbz_out > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(bsz), gi = static_cast<int>(g),
            pi = static_cast<int>(p);
  if (bsz > 32) {
    return vec ? launch_one<T, 2, true>(z1, z2, a_idx, b_idx, oloc,
                                        slab_start, out, nbz_out, b, gi, pi,
                                        paired, st)
               : launch_one<T, 2, false>(z1, z2, a_idx, b_idx, oloc,
                                         slab_start, out, nbz_out, b, gi, pi,
                                         paired, st);
  }
  return vec ? launch_one<T, 1, true>(z1, z2, a_idx, b_idx, oloc, slab_start,
                                      out, nbz_out, b, gi, pi, paired, st)
             : launch_one<T, 1, false>(z1, z2, a_idx, b_idx, oloc,
                                       slab_start, out, nbz_out, b, gi, pi,
                                       paired, st);
}

}  // namespace

extern "C" {

// kind: 0 float32, 2 bfloat16 (float32 sums, rounded once), 3 float64.
// z1, z2 (., bsz, bsz) and C (nbz_out, bsz, bsz) in that type; a_idx (S*g,
// or S*g/2 windows when paired), b_idx and oloc (S*g) and slab_start
// (ceil(nbz_out/p) + 1) int32.  vec: 16-byte loads are allowed (bsz a
// multiple of the vector width, z1 and z2 16-byte aligned).  Returns
// cudaGetLastError() after the launch.
int bsr_slab(int kind, const void* z1, const void* z2, const void* a_idx,
             const void* b_idx, const void* oloc, const void* slab_start,
             void* out, long long nbz_out, long long bsz, long long g,
             long long p, int paired, int vec, void* stream) {
  switch (kind) {
    case kF32:
      return launch<float>(z1, z2, a_idx, b_idx, oloc, slab_start, out,
                           nbz_out, bsz, g, p, paired, vec, stream);
    case kBF16:
      return launch<__nv_bfloat16>(z1, z2, a_idx, b_idx, oloc, slab_start,
                                   out, nbz_out, bsz, g, p, paired, vec,
                                   stream);
    case kF64:
      return launch<double>(z1, z2, a_idx, b_idx, oloc, slab_start, out,
                            nbz_out, bsz, g, p, paired, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
