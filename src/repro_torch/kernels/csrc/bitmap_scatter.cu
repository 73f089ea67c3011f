// Fused resident retrieval: page indices -> decoded pages -> target bitmap,
// with and without a label predicate.
//
// Replaces two TPU kernels:
//   fused_gather_decode_bitmap_batch
//     (src/repro/kernels/pac_decode/kernel.py:491, pallas_call at :540);
//   fused_gather_decode_filter_bitmap_batch
//     (src/repro/kernels/label_filter/kernel.py:195, pallas_call at :231).
// Input is one staged int32 vector [idx (p_pad) | gidx (t) | total (1)].
// The rows named by idx are decoded as in gather_decode.cu; then, for every
// k < total, id = ids_flat[clamp(gidx[k], 0, p_pad * page_size - 1)] sets bit
// id of the uint32[n_words] target bitmap when 0 <= id < 32 * n_words (and,
// for the filtered entry, when bit id of the predicate words fwords is set).
// The TPU kernel sorts the requested ids, drops duplicates and adds distinct
// powers of two (kernel.py:405-428); an atomic OR gives the same words with
// no sort, whatever the order and multiplicity of the ids.
//
// Bound on the H100 (3.35 TB/s): one plan row per gathered page, 24,572 B
// at page size 2048, plus 8,192 B per page of ids when they are written
// (want_ids), plus the staged vector and 4 * n_words bytes of words (and as
// many of fwords).  The atomics touch at most `total` words.
//
// Design: the decode writes the page matrix (the ids output, or a scratch
// matrix the wrapper allocates when want_ids is false) and a second
// kernel, one thread per requested row, scatters with atomicOr into the
// words buffer after a cudaMemsetAsync.  The matrix round trip through
// device memory is the price of keeping the two steps simple: a later
// version can scatter straight from shared memory and skip it.
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

constexpr int kScatterThreads = 256;

template <bool kFilter>
__global__ void __launch_bounds__(kScatterThreads)
bitmap_scatter_kernel(const int* __restrict__ ids, int n_ids,
                      const int* __restrict__ gidx,
                      const int* __restrict__ total, int t,
                      unsigned* __restrict__ words, int n_words,
                      const unsigned* __restrict__ fwords) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= t || k >= *total) return;
  const int g = min(max(gidx[k], 0), n_ids - 1);
  const int id = ids[g];
  if (id < 0 || static_cast<long long>(id) >= 32LL * n_words) return;
  const unsigned bit = 1u << (id & 31);
  if (kFilter && !(fwords[id >> 5] & bit)) return;
  atomicOr(words + (id >> 5), bit);
}

template <bool kFilter>
int fused_gather_decode_bitmap(const int* first, const int* pos,
                               const int* mind, const int* packed,
                               int n_pages, int d, int max_words,
                               const int* staged, int p_pad, int t, int* ids,
                               int* words, int n_words, const int* fwords,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  launch_gather_decode(first, pos, mind,
                       reinterpret_cast<const unsigned*>(packed), n_pages, d,
                       max_words, staged, p_pad, ids, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(words, 0, sizeof(unsigned) * n_words, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t > 0) {
    const int blocks = (t + kScatterThreads - 1) / kScatterThreads;
    bitmap_scatter_kernel<kFilter><<<blocks, kScatterThreads, 0, stream>>>(
        ids, p_pad * (d + 1), staged + p_pad, staged + p_pad + t, t,
        reinterpret_cast<unsigned*>(words), n_words,
        reinterpret_cast<const unsigned*>(fwords));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_fused_gather_decode_bitmap(
    const int* first, const int* pos, const int* mind, const int* packed,
    int n_pages, int d, int max_words, const int* staged, int p_pad, int t,
    int* ids, int* words, int n_words, void* stream) {
  return fused_gather_decode_bitmap<false>(first, pos, mind, packed, n_pages,
                                           d, max_words, staged, p_pad, t, ids,
                                           words, n_words, nullptr, stream);
}

extern "C" int rt_fused_gather_decode_filter_bitmap(
    const int* first, const int* pos, const int* mind, const int* packed,
    int n_pages, int d, int max_words, const int* staged, int p_pad, int t,
    int* ids, int* words, int n_words, const int* fwords, void* stream) {
  return fused_gather_decode_bitmap<true>(first, pos, mind, packed, n_pages,
                                          d, max_words, staged, p_pad, t, ids,
                                          words, n_words, fwords, stream);
}
