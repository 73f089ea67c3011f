// rle_to_bitmap: one RLE label column -> the bitmap of the rows where the
// label equals `want` (paper §5.1).
//
// Replaces the TPU kernel rle_to_bitmap_pallas
// (src/repro/kernels/rle_filter/kernel.py:40, pallas_call at :47, body
// _rle_kernel at :22).  Inputs: positions int32[n_pos], the column's
// interval position list padded with the row count (sorted); meta int32[3]
// = (first_value, want, count).  Bit lane l lies in run
// upper_bound(positions, l) - 1 (searchsorted side="right"; -1 before
// positions[0] flips the first value), its value is first_value ^ (run & 1),
// and the bit is (value == want) && l < count.
//
// Bound on the H100: the bytes are few (4 * n_pos read, 4 * n_words
// written); the work, as the TPU kernel states it, is a binary search over
// n_pos positions for each of the 32 * n_words lanes, counted as 32-bit
// operations at the card's 67 T/s non-tensor 32-bit rate.
//
// Design: one thread per output word, through cond.cuh's rt::rle_word: one
// binary search for the run of the word's first lane, then a walk forward
// over the run boundaries that fall inside the word's 32 lanes, so the
// search is paid once per word instead of once per lane; the word is
// written once, with no atomics.
#include <cuda_runtime.h>

#include "cond.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rle_to_bitmap_kernel(const int* __restrict__ pos, int n_pos,
                     const int* __restrict__ meta,
                     unsigned* __restrict__ words, int n_words) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_words) return;
  words[w] = rt::rle_word(pos, n_pos, meta[0], meta[2], meta[1], w);
}

}  // namespace

extern "C" int rt_rle_to_bitmap(const int* pos, int n_pos, const int* meta,
                                int* words, int n_words, void* stream) {
  if (n_words > 0) {
    const int blocks = (n_words + kThreads - 1) / kThreads;
    rle_to_bitmap_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pos, n_pos, meta, reinterpret_cast<unsigned*>(words), n_words);
  }
  return static_cast<int>(cudaGetLastError());
}
