// gather_decode: decode resident delta pages named by a page-index vector.
//
// Replaces the TPU kernel gather_decode_pallas
// (src/repro/kernels/pac_decode/kernel.py:437, body _decode_plan_rows at
// :381).  The column lives on the card as its per-delta unpack plan
// (PackedPages.unpack_plan): first int32[P,1], pos int32[P,d],
// mind int32[P,d], packed uint32[P,max_words], with d = page_size - 1.
// For every delta j of a gathered page:
//   word  = packed[min(pos >> 11, max_words - 1)]
//   resid = (word >> ((pos >> 6) & 31)) & mask(bw = pos & 63)   (bw >= 32: all ones)
//   delta = resid + mind
// and the page's ids are first followed by first + inclusive_scan(delta),
// all in int32 with wraparound.  Positions past a page's count hold the
// running last id (their plan entries decode to 0).
//
// Bound on the H100 (3.35 TB/s): the kernel must read one plan row per
// gathered page -- 4 + 4d + 4d + 4*page_size bytes, 24,572 B at page size
// 2048 -- and write 4*page_size = 8,192 B of ids: 32.8 KB, about 9.8 ns
// per page.  It does no arithmetic worth counting against that.
//
// Design: one block of 256 threads per gathered row.  A pass decodes 2048
// deltas: threads load the plan striped (neighbouring threads on
// neighbouring words, so every load is coalesced) into shared memory, each
// thread then sums 8 consecutive deltas, a warp-shuffle scan over the 256
// partial sums gives each thread its offset, and the scanned row is stored
// striped again.  Rows longer than one pass carry the running sum.  Many
// rows are in flight per SM, which is what hides the gather's latency.
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned decode_delta(const int* prow,
                                                 const int* mrow,
                                                 const unsigned* wrow, int j,
                                                 int max_words) {
  const int p = prow[j];
  const int widx = min(p >> 11, max_words - 1);
  const unsigned shift = (p >> 6) & 31;
  const unsigned bw = p & 63;
  const unsigned mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << bw) - 1u);
  return ((wrow[widx] >> shift) & mask) + static_cast<unsigned>(mrow[j]);
}

// Exclusive scan of one value per thread across the block; *total gets the
// block's sum.  Every thread of the block must call it.
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
    unsigned w = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0u) + x - v;
}

__global__ void __launch_bounds__(kThreads)
gather_decode_kernel(const int* __restrict__ first, const int* __restrict__ pos,
                     const int* __restrict__ mind,
                     const unsigned* __restrict__ packed, int n_pages, int d,
                     int max_words, const int* __restrict__ idx,
                     int* __restrict__ out) {
  __shared__ unsigned tile[kTile];
  __shared__ unsigned warp_sums[kWarps];
  const int row = blockIdx.x;
  const int page = min(max(idx[row], 0), n_pages - 1);
  const int* prow = pos + static_cast<size_t>(page) * d;
  const int* mrow = mind + static_cast<size_t>(page) * d;
  const unsigned* wrow = packed + static_cast<size_t>(page) * max_words;
  int* orow = out + static_cast<size_t>(row) * (d + 1);
  unsigned carry = static_cast<unsigned>(first[page]);
  if (threadIdx.x == 0) orow[0] = static_cast<int>(carry);
  for (int base = 0; base < d; base += kTile) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + threadIdx.x;
      tile[j] = base + j < d ? decode_delta(prow, mrow, wrow, base + j,
                                            max_words)
                             : 0u;
    }
    __syncthreads();
    unsigned* mine = tile + threadIdx.x * kItems;
    unsigned local = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) local += mine[i];
    unsigned total;
    unsigned acc = carry + block_exclusive_scan(local, warp_sums, &total);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      acc += mine[i];
      mine[i] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + threadIdx.x;
      if (base + j < d) orow[base + j + 1] = static_cast<int>(tile[j]);
    }
    carry += total;
    __syncthreads();
  }
}

}  // namespace

void launch_gather_decode(const int* first, const int* pos, const int* mind,
                          const unsigned* packed, int n_pages, int d,
                          int max_words, const int* idx, int n_rows, int* out,
                          cudaStream_t stream) {
  if (n_rows <= 0) return;
  gather_decode_kernel<<<n_rows, kThreads, 0, stream>>>(
      first, pos, mind, packed, n_pages, d, max_words, idx, out);
}

extern "C" int rt_gather_decode(const int* first, const int* pos,
                                const int* mind, const int* packed,
                                int n_pages, int d, int max_words,
                                const int* idx, int n_rows, int* out,
                                void* stream) {
  launch_gather_decode(first, pos, mind,
                       reinterpret_cast<const unsigned*>(packed), n_pages, d,
                       max_words, idx, n_rows, out,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
