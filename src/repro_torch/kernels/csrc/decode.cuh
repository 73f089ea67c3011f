// Shared pieces of the delta-decode CUDA kernels.
//
// A page of ids is `first` followed by `first + inclusive_scan(delta)`, all
// in int32 with wraparound.  Both decode layouts -- the resident unpack
// plan (gather_decode.cu) and the raw miniblock arrays of PackedPages
// (single_range.cu) -- produce one delta per lane and hand the row to
// decode_row, which scans it with one block.  per_dispatch.cu (the raw
// arrays) and bitmap_scatter.cu (the plan) decode with kernels of their
// own (extract_bits only).
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeItems = 8;
constexpr int kDecodeTile = kDecodeThreads * kDecodeItems;
constexpr int kDecodeWarps = kDecodeThreads / 32;

// Exclusive scan of one value per thread across a kDecodeThreads block;
// *total gets the block's sum.  Every thread of the block must call it.
// Unsigned arithmetic, so int32 wraparound is defined.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* warp_sums,
                                                         unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kDecodeWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < kDecodeWarps; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kDecodeWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kDecodeWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0u) + x - v;
}

// Decode one row with the calling kDecodeThreads block: orow[0] = first and
// orow[j + 1] = first + delta(0) + ... + delta(j) for j < d.
//
// A pass covers kDecodeTile deltas: threads compute them striped
// (neighbouring threads on neighbouring deltas, so the loads behind
// delta() coalesce) into shared memory, each thread sums kDecodeItems
// consecutive deltas, the block scan gives each thread its offset, and the
// scanned row is stored striped again.  Longer rows carry the running sum.
template <class Delta>
__device__ __forceinline__ void decode_row(const Delta& delta, unsigned first,
                                           int d, int* __restrict__ orow) {
  __shared__ unsigned tile[kDecodeTile];
  __shared__ unsigned warp_sums[kDecodeWarps];
  unsigned carry = first;
  if (threadIdx.x == 0) orow[0] = static_cast<int>(carry);
  for (int base = 0; base < d; base += kDecodeTile) {
#pragma unroll
    for (int i = 0; i < kDecodeItems; ++i) {
      const int j = i * kDecodeThreads + threadIdx.x;
      tile[j] = base + j < d ? delta(base + j) : 0u;
    }
    __syncthreads();
    unsigned* mine = tile + threadIdx.x * kDecodeItems;
    unsigned local = 0;
#pragma unroll
    for (int i = 0; i < kDecodeItems; ++i) local += mine[i];
    unsigned total;
    unsigned acc = carry + block_exclusive_scan(local, warp_sums, &total);
#pragma unroll
    for (int i = 0; i < kDecodeItems; ++i) {
      acc += mine[i];
      mine[i] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kDecodeItems; ++i) {
      const int j = i * kDecodeThreads + threadIdx.x;
      if (base + j < d) orow[base + j + 1] = static_cast<int>(tile[j]);
    }
    carry += total;
    __syncthreads();
  }
}

// The low `bw` bits of `word >> shift` (bw >= 32: all 32 bits).
__device__ __forceinline__ unsigned extract_bits(unsigned word, unsigned shift,
                                                 unsigned bw) {
  const unsigned mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
  return (word >> shift) & mask;
}

// Delta j of one page shipped as raw miniblock arrays (per_dispatch.cu,
// single_range.cu): delta j lives in miniblock m = j / 32 at bit
// (j % 32) * bw of the miniblock's word region, plus the miniblock's min
// delta; deltas at or past count - 1 are 0.  Word and miniblock indices
// are clamped: the clamp only moves reads of deltas that the count zeroes.
struct MiniblockDelta {
  const int* mind;
  const int* bw;
  const int* woff;
  const unsigned* words;
  int n_mini;
  int max_words;
  int last;  // count - 1: deltas at or past it are 0

  __device__ __forceinline__ unsigned operator()(int j) const {
    if (j >= last) return 0u;
    const int m = min(j >> 5, n_mini - 1);
    const int w = bw[m];
    const int bit = (j & 31) * w;
    const int widx = min(max(woff[m] + (bit >> 5), 0), max_words - 1);
    return extract_bits(words[widx], bit & 31, w) +
           static_cast<unsigned>(mind[m]);
  }
};

}  // namespace rt
