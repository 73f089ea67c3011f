// Shared declarations of the pac_decode CUDA kernels.
#pragma once

#include <cuda_runtime.h>

// Decode the resident unpack-plan rows named by idx[0 .. n_rows) into
// out[n_rows, d + 1] (int32, row-major).  Each idx entry is clamped to
// [0, n_pages - 1].  Defined in gather_decode.cu.
void launch_gather_decode(const int* first, const int* pos, const int* mind,
                          const unsigned* packed, int n_pages, int d,
                          int max_words, const int* idx, int n_rows, int* out,
                          cudaStream_t stream);
