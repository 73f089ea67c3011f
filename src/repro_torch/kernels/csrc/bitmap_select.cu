// bitmap_select: selection pushdown of property values by a PAC bitmap
// (paper §4.3, [45]).
//
// Replaces the TPU kernel bitmap_select_pallas
// (src/repro/kernels/bitmap_select/kernel.py:36, pallas_call at :44, body
// _select_kernel at :19).  Inputs: vals f32[n, page_size] (as raw 32-bit
// patterns), words uint32[n, page_size / 32], the page's bitmap (bit l of
// word l / 32 selects lane l).  Per page the selected values are written,
// in lane order, to the front of out[p] (slots [0, count)), slots
// [count, page_size) are zeroed, and counts[p] = count.  Values are copied
// as bits, so NaN payloads, -0.0 and denormals come through unchanged.
//
// Bound on the H100 (3.35 TB/s), for each input read once and each output
// written once: page_size / 8 bytes of words and 4 bytes for each selected
// lane's value in (an unselected value is never read), 4 * page_size bytes
// of values and 4 of count out, per page.
//
// Design: one block of 256 threads per page.  A popcount per word and the
// block scan of decode.cuh (rt::block_exclusive_scan) give each word's
// first output slot, kept in shared memory (page_size / 32 entries of
// dynamic shared memory); then each thread takes lanes striped across the
// page (coalesced reads) and writes a selected lane's value to its word's
// slot plus the popcount of the lower bits of its word.
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

__global__ void __launch_bounds__(rt::kDecodeThreads)
bitmap_select_kernel(const int* __restrict__ vals,
                     const unsigned* __restrict__ words, int page_size,
                     int* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ unsigned first_slot[];
  __shared__ unsigned warp_sums[rt::kDecodeWarps];
  const size_t p = blockIdx.x;
  const int wpp = page_size >> 5;
  const unsigned* w = words + p * wpp;
  unsigned carry = 0u;
  for (int base = 0; base < wpp; base += rt::kDecodeThreads) {
    const int i = base + threadIdx.x;
    const unsigned c = i < wpp ? __popc(w[i]) : 0u;
    unsigned total;
    const unsigned before = rt::block_exclusive_scan(c, warp_sums, &total);
    if (i < wpp) first_slot[i] = carry + before;
    carry += total;
    __syncthreads();  // warp_sums is reused by the next pass
  }
  const int count = static_cast<int>(carry);
  const int* v = vals + p * page_size;
  int* o = out + p * page_size;
  for (int lane = threadIdx.x; lane < page_size; lane += blockDim.x) {
    const unsigned word = w[lane >> 5];
    const unsigned bit = lane & 31;
    if ((word >> bit) & 1u) {
      o[first_slot[lane >> 5] + __popc(word & ((1u << bit) - 1u))] = v[lane];
    }
  }
  for (int s = count + threadIdx.x; s < page_size; s += blockDim.x) o[s] = 0;
  if (threadIdx.x == 0) counts[p] = count;
}

}  // namespace

extern "C" int rt_bitmap_select(const int* vals, const int* words, int n,
                                int page_size, int* out, int* counts,
                                void* stream) {
  if (n > 0) {
    const size_t smem = sizeof(unsigned) * static_cast<size_t>(page_size / 32);
    bitmap_select_kernel<<<n, rt::kDecodeThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        vals, reinterpret_cast<const unsigned*>(words), page_size, out,
        counts);
  }
  return static_cast<int>(cudaGetLastError());
}
