// The stream kinds of the blocked-ELL C entry points (bell_spmm.cu,
// bell_banded.cu), the `kind` argument ops/cuda_bell.py passes: float32,
// float32 with the bf16x3 split, bf16 (float32 sums), float64 and int32
// (sums modulo 2^32).  A header of its own, so it outlives any one body.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace band {
struct Split;  // band_body.cuh: the bf16x3 stream kind
}  // namespace band

namespace bell {

enum Kind { kF32 = 0, kF32Split = 1, kBF16 = 2, kF64 = 3, kI32 = 4 };

// A stream kind S as a value: f(As<S>()) names S as decltype(s)::type.
template <typename S>
struct As {
  using type = S;
};

// f(As<S>()) for the stream kind S of `kind`: float, band::Split,
// __nv_bfloat16, double or int; cudaErrorInvalidValue for any other kind.
template <class F>
cudaError_t with_kind(int kind, F f) {
  switch (kind) {
    case kF32:
      return f(As<float>());
    case kF32Split:
      return f(As<band::Split>());
    case kBF16:
      return f(As<__nv_bfloat16>());
    case kF64:
      return f(As<double>());
    case kI32:
      return f(As<int>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bell
