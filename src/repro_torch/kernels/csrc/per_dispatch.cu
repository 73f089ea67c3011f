// The per-dispatch pack route (REPRO_DEVICE_RESIDENT=0): packed pages are
// shipped with every dispatch as raw miniblock arrays and decoded here.
//
// Replaces three TPU kernels:
//   delta_decode_pallas
//     (src/repro/kernels/pac_decode/kernel.py:98, pallas_call at :110,
//     body _unpack_and_scan at :57);
//   fused_decode_bitmap_batch
//     (src/repro/kernels/pac_decode/kernel.py:295, pallas_call at :321,
//     bodies _unpack_and_scan_batch at :224 and _bitmap_from_gather at :256);
//   fused_decode_filter_bitmap_batch
//     (src/repro/kernels/label_filter/kernel.py:123, pallas_call at :147).
//
// Inputs of a batch of n pages: first/counts int32[n,1], min_deltas,
// bit_widths and word_offsets int32[n,n_mini], packed uint32[n,max_words].
// Delta j (j < page_size - 1) of a page lives in miniblock m = j / 32 at bit
// (j % 32) * bw of the miniblock's word region:
//   word  = packed[clamp(word_offsets[m] + bit / 32, 0, max_words - 1)]
//   delta = ((word >> bit % 32) & mask(bw)) + min_deltas[m]  if j < count - 1
//           0                                                 otherwise
// and the page decodes to first, first + inclusive_scan(delta) (int32 with
// wraparound).  The clamp only ever moves reads of deltas that the count
// zeroes: the TPU kernels index with jnp.take's fill and clip modes there.
//
// The fused entries then build the target bitmap uint32[n_words] from the
// gcount requested rows: row k reads flat position clamp(gidx[k]) of the
// matrix [ids (m rows) | cached (c rows)] -- cached holds the LRU-hit
// pages' rows, decoded on the host -- and sets bit id when
// 0 <= id < 32 * n_words (the filtered entry: and when the label predicate
// holds at id).  The TPU kernel sorts the requested ids and looks every
// target up by rank (kernel.py:256-277); an atomic OR per requested row
// gives the same words with no sort, exact under any order and multiplicity.
// The predicate is evaluated per requested row, not per bit of the target
// space as on the TPU: the words are the same, because a bit survives the
// AND exactly when some requested row holds that id and the predicate
// holds there, and the work follows the rows requested (at most a few
// hundred thousand) instead of the 32 * n_words lanes (millions).
//
// Bound on the H100 (3.35 TB/s), for each input read once and each output
// written once: per decoded page 4 * (2 + 3 * n_mini) bytes of header
// arrays and 4 * sum(bit_widths) bytes of packed words in (a miniblock of
// width bw packs its 32 deltas into bw words; the zero words past them up
// to max_words are never read), and 4 * page_size out; plus
// 4 * page_size per cached row, 4 per requested row and 4 * n_words for
// the words.  The arithmetic is a shift, a mask and a scan step per delta.
//
// Design: the decode is one block of 256 threads per page (rt::decode_row,
// shared with gather_decode.cu); the words are zeroed with
// cudaMemsetAsync; the scatter is one thread per requested row.  The ids
// output is written whether or not the caller keeps it, as the TPU kernel
// returns it.
#include <cuda_runtime.h>

#include "cond.cuh"
#include "decode.cuh"

namespace {

constexpr int kScatterThreads = 256;

__global__ void __launch_bounds__(rt::kDecodeThreads)
delta_decode_kernel(const int* __restrict__ first,
                    const int* __restrict__ mind, const int* __restrict__ bw,
                    const int* __restrict__ woff,
                    const unsigned* __restrict__ packed,
                    const int* __restrict__ counts, int n_mini,
                    int max_words, int page_size, int* __restrict__ out) {
  const size_t row = blockIdx.x;
  const rt::MiniblockDelta delta{mind + row * n_mini, bw + row * n_mini,
                             woff + row * n_mini, packed + row * max_words,
                             n_mini, max_words, counts[row] - 1};
  rt::decode_row(delta, static_cast<unsigned>(first[row]), page_size - 1,
                 out + row * page_size);
}

template <bool kFilter>
__global__ void __launch_bounds__(kScatterThreads)
rows_to_bitmap_kernel(const int* __restrict__ ids, long long n_ids,
                      const int* __restrict__ cached, long long n_cached,
                      const int* __restrict__ gidx,
                      const int* __restrict__ gcount, int t,
                      unsigned* __restrict__ words, int n_words,
                      const int* __restrict__ fpos,
                      const int* __restrict__ fmeta, int n_pos,
                      const int* __restrict__ ops, int n_ops) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= t || k >= *gcount) return;
  const long long g =
      min(max(static_cast<long long>(gidx[k]), 0LL), n_ids + n_cached - 1);
  const int id = g < n_ids ? ids[g] : cached[g - n_ids];
  if (id < 0 || static_cast<long long>(id) >= 32LL * n_words) return;
  if (kFilter && !rt::eval_cond(fpos, fmeta, n_pos, ops, n_ops, id)) return;
  atomicOr(words + (id >> 5), 1u << (id & 31));
}

int launch_delta_decode(const int* first, const int* mind, const int* bw,
                        const int* woff, const int* packed, const int* counts,
                        int n, int n_mini, int max_words, int page_size,
                        int* out, cudaStream_t stream) {
  if (n > 0) {
    delta_decode_kernel<<<n, rt::kDecodeThreads, 0, stream>>>(
        first, mind, bw, woff, reinterpret_cast<const unsigned*>(packed),
        counts, n_mini, max_words, page_size, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kFilter>
int fused_decode_bitmap_batch(const int* first, const int* mind,
                              const int* bw, const int* woff,
                              const int* packed, const int* counts, int m,
                              int n_mini, int max_words, int page_size,
                              const int* cached, int c, const int* gidx,
                              int t, const int* gcount, int* ids, int* words,
                              int n_words, const int* fpos, const int* fmeta,
                              int n_pos, const int* ops, int n_ops,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = launch_delta_decode(first, mind, bw, woff, packed, counts, m,
                                n_mini, max_words, page_size, ids, stream);
  if (err != 0) return err;
  err = static_cast<int>(
      cudaMemsetAsync(words, 0, sizeof(unsigned) * n_words, stream));
  if (err != 0) return err;
  if (t > 0) {
    const int blocks = (t + kScatterThreads - 1) / kScatterThreads;
    rows_to_bitmap_kernel<kFilter><<<blocks, kScatterThreads, 0, stream>>>(
        ids, static_cast<long long>(m) * page_size, cached,
        static_cast<long long>(c) * page_size, gidx, gcount, t,
        reinterpret_cast<unsigned*>(words), n_words, fpos, fmeta, n_pos, ops,
        n_ops);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_delta_decode(const int* first, const int* mind,
                               const int* bw, const int* woff,
                               const int* packed, const int* counts, int n,
                               int n_mini, int max_words, int page_size,
                               int* out, void* stream) {
  return launch_delta_decode(first, mind, bw, woff, packed, counts, n, n_mini,
                             max_words, page_size, out,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int rt_fused_decode_bitmap_batch(
    const int* first, const int* mind, const int* bw, const int* woff,
    const int* packed, const int* counts, int m, int n_mini, int max_words,
    int page_size, const int* cached, int c, const int* gidx, int t,
    const int* gcount, int* ids, int* words, int n_words, void* stream) {
  return fused_decode_bitmap_batch<false>(
      first, mind, bw, woff, packed, counts, m, n_mini, max_words, page_size,
      cached, c, gidx, t, gcount, ids, words, n_words, nullptr, nullptr, 0,
      nullptr, 0, stream);
}

extern "C" int rt_fused_decode_filter_bitmap_batch(
    const int* first, const int* mind, const int* bw, const int* woff,
    const int* packed, const int* counts, int m, int n_mini, int max_words,
    int page_size, const int* cached, int c, const int* gidx, int t,
    const int* gcount, int* ids, int* words, int n_words, const int* fpos,
    const int* fmeta, int n_pos, const int* ops, int n_ops, void* stream) {
  return fused_decode_bitmap_batch<true>(
      first, mind, bw, woff, packed, counts, m, n_mini, max_words, page_size,
      cached, c, gidx, t, gcount, ids, words, n_words, fpos, fmeta, n_pos,
      ops, n_ops, stream);
}
