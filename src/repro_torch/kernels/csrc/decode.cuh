// Shared pieces of the delta-decode CUDA kernels.
//
// A page of ids is `first` followed by `first + inclusive_scan(delta)`, all
// in int32 with wraparound.  decode_row scans one row of deltas with one
// block; gather_decode.cu feeds it the resident unpack plan, one delta per
// lane.  The raw miniblock arrays of PackedPages are read 8 deltas a
// thread by miniblock.cuh (per_dispatch.cu, single_range.cu), and
// bitmap_scatter.cu decodes the plan with a kernel of its own; both use
// extract_bits only.
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

}  // namespace rt
