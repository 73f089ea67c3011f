// The bit extraction shared by the delta-decode CUDA kernels.
//
// A page of ids is `first` followed by `first + inclusive_scan(delta)`, all
// in int32 with wraparound.  miniblock.cuh reads the raw miniblock arrays
// of PackedPages 8 deltas a thread (kernels 2 and 8-10 in per_dispatch.cu,
// kernel 12 in single_range.cu), and bitmap_scatter.cu (kernels 1 and 4)
// decodes the resident unpack plan with a kernel of its own; both cut a
// delta's bits out of its word with extract_bits.
#pragma once

#include <cuda_runtime.h>

namespace rt {

// The low `bw` bits of `word >> shift` (bw >= 32: all 32 bits).
__device__ __forceinline__ unsigned extract_bits(unsigned word, unsigned shift,
                                                 unsigned bw) {
  const unsigned mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
  return (word >> shift) & mask;
}

}  // namespace rt
