// The single-range bitmap entries: ids -> bitmap, and one page-aligned row
// range of a delta column -> bitmap with the ids kept on chip.
//
// Replaces two TPU kernels:
//   bitmap_pallas
//     (src/repro/kernels/pac_decode/kernel.py:170, pallas_call at :180,
//     bodies _bitmap_kernel at :149 and _bitmap_tile at :135);
//   fused_decode_bitmap
//     (src/repro/kernels/pac_decode/kernel.py:562, pallas_call at :570,
//     body _fused_kernel at :198 over _unpack_and_scan at :57).
//
// Both produce uint32[n_words] over [base, base + 32 * n_words) with a
// 32-aligned base: bit j of word w is set iff some valid id equals
// base + 32 * w + j.  ids_bitmap's valid ids are ids[0 .. count);
// fused_decode_bitmap's are rows [0, counts[p]) of each page p, decoded as
// in per_dispatch.cu's delta_decode (rt::MiniblockDelta, the same clamps).
//
// The TPU kernels build each word as a *sum* of 1 << bit over the valid
// ids, dropping an id equal to its predecessor; that is an OR only when
// equal ids are adjacent.  Here every valid in-range id ORs its bit
// (atomicOr), so the words are the set of ids under any order and
// multiplicity.  Where the TPU kernels' contract holds (sorted ids, or
// duplicates adjacent within a page) the words are the same.  An id equal
// to its predecessor is skipped all the same: on sorted input it saves the
// atomic.
//
// Bound on the H100 (3.35 TB/s), for each input read once and each output
// written once: ids_bitmap 4 * count bytes in and 4 * n_words out;
// fused_decode_bitmap, per page, 4 * (2 + 3 * n_mini) bytes of header
// arrays and 4 * sum(bit_widths) bytes of packed words in (a miniblock of
// width bw packs its 32 deltas into bw words), and 4 * n_words out.  The
// arithmetic is a shift, a mask and a scan step per delta.
//
// Design: the words are zeroed with cudaMemsetAsync.  ids_bitmap is one
// thread per id.  fused_decode_bitmap is one block of 256 threads per page:
// rt::decode_row scans the page into shared memory (page_size ints of
// dynamic shared memory), then the block ORs one bit per remaining row;
// the decoded ids never reach device memory.
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

constexpr int kIdThreads = 256;

// OR the bit of id into words when id - base lies in [0, span).
__device__ __forceinline__ void set_bit(unsigned* __restrict__ words,
                                        int id, int base, long long span) {
  const long long rel = static_cast<long long>(id) - base;
  if (rel < 0 || rel >= span) return;
  atomicOr(words + (rel >> 5), 1u << (rel & 31));
}

__global__ void __launch_bounds__(kIdThreads)
ids_bitmap_kernel(const int* __restrict__ ids, int count, int base,
                  unsigned* __restrict__ words, int n_words) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int id = ids[i];
  if (i > 0 && ids[i - 1] == id) return;
  set_bit(words, id, base, 32LL * n_words);
}

__global__ void __launch_bounds__(rt::kDecodeThreads)
fused_decode_bitmap_kernel(const int* __restrict__ first,
                           const int* __restrict__ mind,
                           const int* __restrict__ bw,
                           const int* __restrict__ woff,
                           const unsigned* __restrict__ packed,
                           const int* __restrict__ counts, int n_mini,
                           int max_words, int page_size, int base,
                           unsigned* __restrict__ words, int n_words) {
  extern __shared__ int row[];
  const size_t p = blockIdx.x;
  const rt::MiniblockDelta delta{mind + p * n_mini, bw + p * n_mini,
                                 woff + p * n_mini, packed + p * max_words,
                                 n_mini, max_words, counts[p] - 1};
  rt::decode_row(delta, static_cast<unsigned>(first[p]), page_size - 1, row);
  __syncthreads();
  const int count = min(counts[p], page_size);
  const long long span = 32LL * n_words;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int id = row[j];
    if (j > 0 && row[j - 1] == id) continue;
    set_bit(words, id, base, span);
  }
}

}  // namespace

extern "C" int rt_ids_bitmap(const int* ids, int count, int base, int* words,
                             int n_words, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = static_cast<int>(
      cudaMemsetAsync(words, 0, sizeof(unsigned) * n_words, stream));
  if (err != 0) return err;
  if (count > 0 && n_words > 0) {
    const int blocks = static_cast<int>(
        (static_cast<long long>(count) + kIdThreads - 1) / kIdThreads);
    ids_bitmap_kernel<<<blocks, kIdThreads, 0, stream>>>(
        ids, count, base, reinterpret_cast<unsigned*>(words), n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_fused_decode_bitmap(const int* first, const int* mind,
                                      const int* bw, const int* woff,
                                      const int* packed, const int* counts,
                                      int n, int n_mini, int max_words,
                                      int page_size, int base, int* words,
                                      int n_words, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = static_cast<int>(
      cudaMemsetAsync(words, 0, sizeof(unsigned) * n_words, stream));
  if (err != 0) return err;
  if (n > 0 && n_words > 0) {
    const size_t smem = sizeof(int) * static_cast<size_t>(page_size);
    if (smem > 32 * 1024) {
      err = static_cast<int>(cudaFuncSetAttribute(
          fused_decode_bitmap_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
      if (err != 0) return err;
    }
    fused_decode_bitmap_kernel<<<n, rt::kDecodeThreads, smem, stream>>>(
        first, mind, bw, woff, reinterpret_cast<const unsigned*>(packed),
        counts, n_mini, max_words, page_size, base,
        reinterpret_cast<unsigned*>(words), n_words);
  }
  return static_cast<int>(cudaGetLastError());
}
