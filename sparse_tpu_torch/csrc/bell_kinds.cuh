// The stream kinds of the blocked-ELL C entry points (bell_spmm.cu,
// bell_banded.cu), the `kind` argument ops/cuda_bell.py passes: float32,
// float32 with the bf16x3 split, bf16 (float32 sums), float64 and int32
// (sums modulo 2^32).  A header of its own, so it outlives any one body.

#pragma once

namespace bell {

enum Kind { kF32 = 0, kF32Split = 1, kBF16 = 2, kF64 = 3, kI32 = 4 };

}  // namespace bell
