// Decode of the raw miniblock arrays of pages (PackedPages): the resident
// column's pages gathered by a row-index vector (kernel 2), and the
// per-dispatch pack route's (REPRO_DEVICE_RESIDENT=0) pages shipped with
// every dispatch (kernels 8-10).
//
// Replaces four TPU kernels:
//   gather_decode_pallas
//     (src/repro/kernels/pac_decode/kernel.py:437, pallas_call at :453,
//     body _decode_plan_rows at :381);
//   delta_decode_pallas
//     (src/repro/kernels/pac_decode/kernel.py:98, pallas_call at :110,
//     body _unpack_and_scan at :57);
//   fused_decode_bitmap_batch
//     (src/repro/kernels/pac_decode/kernel.py:295, pallas_call at :321,
//     bodies _unpack_and_scan_batch at :224 and _bitmap_from_gather at :256);
//   fused_decode_filter_bitmap_batch
//     (src/repro/kernels/label_filter/kernel.py:123, pallas_call at :147).
//
// The TPU's gather_decode reads the column's per-delta unpack plan
// (PackedPages.unpack_plan: pos and mind int32[P, page_size - 1], the
// miniblock metadata expanded to every delta, which suits its vector
// unit).  Kernel 2 here computes the same ids from the resident column's
// miniblock arrays instead: row r of the output decodes page
// clamp(idx[r], 0, n_pages - 1), read through the same decode as
// kernel 10.  At page size 2048 that is about 776 bytes of miniblock
// headers a page against the plan's 16,380.
//
// Inputs of a batch of n pages: first/counts int32[n,1], min_deltas,
// bit_widths and word_offsets int32[n,n_mini], packed uint32[n,max_words].
// Delta j (j < page_size - 1) of a page lives in miniblock
// m = min(j / 32, n_mini - 1) at bit (j % 32) * bw of the miniblock's word
// region:
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
// to max_words are never read), and 4 * page_size out; kernel 2 reads each
// distinct gathered page once and 4 bytes of idx a row; the fused entries
// add 4 * page_size per cached row, 4 per requested row and 4 * n_words
// for the words.  The arithmetic is a shift, a mask and a scan step per
// delta.
//
// Design of the decode (page_decode_kernel; PERF.md has the layouts it
// was timed against): thread s of a page owns the 8 output positions and
// the 8 deltas [8s, 8s + 8), so that
//   out[8s + i] = first + (deltas before 8s) + delta(8s) + ... +
//                 delta(8s + i - 1).
// rt::thread_deltas (miniblock.cuh, shared with kernel 12) gives the
// thread those deltas: the miniblock's header loaded once, beside the
// page's count, then 16-byte loads of the words that hold them and the
// bits cut out with the width known at compile time; a thread whose deltas
// all lie at or past count - 1 (the padding pages) reads no word.  The
// scan is warp shuffles and one exchange of warp totals in shared memory.
// The outputs then pass through shared memory, so that each warp's stores
// are 512 contiguous bytes: stored straight from the thread that owns
// them (32 bytes each, a warp's 16-byte stores each half of 32 sectors),
// the same kernel took 2.6x as long.  A block of 256 threads decodes a
// page of 2048 in one pass; pages of 256 positions or fewer share a
// block, a warp or more each, and longer pages loop with a carry.  The
// same launch zeroes the fused entries' target words.  Kernel 2 is the
// same kernel given idx: each page group's threads read their row's page
// number once and decode that page's arrays; many pages are in flight
// per SM, which hides the gather's latency.
//
// The scatter is one thread per requested row with an atomic OR.  The
// filtered one runs the program per row; each leaf's search first finds
// the row's stretch of the position list in a sample of every stride-th
// position staged in shared memory, so it ends with a search of one
// stretch.  The ids output is written whether or not the caller keeps
// it, as the TPU kernel returns it.
#include <cuda_runtime.h>

#include <cstdint>

#include "cond.cuh"
#include "decode.cuh"
#include "miniblock.cuh"

namespace {

constexpr int kThreads = 256;           // a decode block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = rt::kItems;      // positions (and deltas) a thread
constexpr int kScatterThreads = 256;
constexpr int kFilterThreads = 512;     // a filtered scatter block
constexpr int kSamples = 512;           // sampled positions a leaf

using rt::Pages;
using rt::thread_deltas;

// Decode the rows of every page group g of this block, rows
// [g * ppb, (g + 1) * ppb) with ppb = kThreads >> tpp_log2 and 2^tpp_log2
// threads a row (a row is the page p.idx names, or page r without it);
// zero[0, n_zero) is set to 0 on the way.  A pass covers
// kItems << tpp_log2 positions of each of the group's pages.
__global__ void __launch_bounds__(kThreads)
page_decode_kernel(Pages p, int tpp_log2, int* __restrict__ out,
                   unsigned* __restrict__ zero, int n_zero) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_zero;
       i += gridDim.x * kThreads) {
    zero[i] = 0u;
  }
  __shared__ unsigned warp_sums[kWarps];
  __shared__ uint4 stage[kThreads * kItems / 4];  // the pass's outputs
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tpp = 1 << tpp_log2;
  const int slot = threadIdx.x & (tpp - 1);
  const int group0 = (threadIdx.x >> tpp_log2) << (tpp_log2 - 5);
  const int ppb = kThreads >> tpp_log2;
  const int span = kItems << tpp_log2;
  const bool vec = (p.page_size & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (long long g = blockIdx.x; g * ppb < p.n; g += gridDim.x) {
    const long long row = g * ppb + (threadIdx.x >> tpp_log2);
    const bool live = row < p.n;
    // the page this row decodes
    long long src = live ? row : 0;
    if (live && p.idx != nullptr) {
      src = min(max(__ldg(p.idx + row), 0), p.n_src - 1);
    }
    unsigned carry = live ? static_cast<unsigned>(__ldg(p.first + src)) : 0u;
    const int last =
        live ? min(__ldg(p.counts + src) - 1, p.page_size - 1) : 0;
    for (int base = 0; base < p.page_size; base += span) {
      const int j0 = base + kItems * slot;
      unsigned d[kItems];
      thread_deltas(p, src, j0, last, d);
      unsigned tot = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) tot += d[i];
      unsigned x = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x += y;
      }
      __syncthreads();  // the last pass's readers of warp_sums and stage
      if (lane == 31) warp_sums[warp] = x;
      __syncthreads();
      unsigned acc = carry + x - tot;
      for (int w = group0; w < group0 + (tpp >> 5); ++w) {
        const unsigned t = warp_sums[w];
        if (w < warp) acc += t;
        carry += t;
      }
      unsigned v[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        v[i] = acc;
        acc += d[i];
      }
      stage[2 * threadIdx.x] = make_uint4(v[0], v[1], v[2], v[3]);
      stage[2 * threadIdx.x + 1] = make_uint4(v[4], v[5], v[6], v[7]);
      __syncthreads();
      // the block's outputs leave in order: a warp's stores are contiguous
      // (page k of the group holds stage[k * span / 4 ..][0 .. span / 4))
      if (vec) {
        for (int u = threadIdx.x; u < kThreads * kItems / 4; u += kThreads) {
          const long long r = g * ppb + u / (span >> 2);
          const int pos = base + 4 * (u % (span >> 2));
          if (r < p.n && pos < p.page_size) {
            *reinterpret_cast<uint4*>(out + r * p.page_size + pos) = stage[u];
          }
        }
      } else {
        const unsigned* st = reinterpret_cast<const unsigned*>(stage);
        for (int q = threadIdx.x; q < kThreads * kItems; q += kThreads) {
          const long long r = g * ppb + q / span;
          const int pos = base + q % span;
          if (r < p.n && pos < p.page_size) {
            out[r * p.page_size + pos] = static_cast<int>(st[q]);
          }
        }
      }
    }
  }
}

// log2 of the threads a page takes: 8 positions a thread, at least a warp,
// at most the block (longer pages loop).
int page_threads_log2(int page_size) {
  int lg = 5;
  while (lg < 8 && (kItems << lg) < page_size) ++lg;
  return lg;
}

// Decode p into out, zeroing zero[0, n_zero) in the same launch.
int launch_page_decode(const Pages& p, int* out, int* zero, int n_zero,
                       cudaStream_t stream) {
  const int lg = page_threads_log2(p.page_size);
  const int ppb = kThreads >> lg;
  long long blocks = (static_cast<long long>(p.n) + ppb - 1) / ppb;
  if (blocks == 0) blocks = min((n_zero + kThreads - 1) / kThreads, 1024);
  if (blocks > 0) {
    page_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(p, lg, out,
                                   reinterpret_cast<unsigned*>(zero), n_zero);
  }
  return static_cast<int>(cudaGetLastError());
}

// The row's id, or -1 where the row is past gcount or its id lies outside
// the target space.
__device__ __forceinline__ int requested_id(const int* __restrict__ ids,
                                            long long n_ids,
                                            const int* __restrict__ cached,
                                            long long n_cached,
                                            const int* __restrict__ gidx,
                                            const int* __restrict__ gcount,
                                            int t, int n_words, int k) {
  if (k >= t || k >= *gcount) return -1;
  const long long g =
      min(max(static_cast<long long>(gidx[k]), 0LL), n_ids + n_cached - 1);
  const int id = g < n_ids ? ids[g] : cached[g - n_ids];
  return id >= 0 && static_cast<long long>(id) < 32LL * n_words ? id : -1;
}

__global__ void __launch_bounds__(kScatterThreads)
rows_to_bitmap_kernel(const int* __restrict__ ids, long long n_ids,
                      const int* __restrict__ cached, long long n_cached,
                      const int* __restrict__ gidx,
                      const int* __restrict__ gcount, int t,
                      unsigned* __restrict__ words, int n_words) {
  const int id = requested_id(ids, n_ids, cached, n_cached, gidx, gcount, t,
                              n_words, blockIdx.x * blockDim.x + threadIdx.x);
  if (id >= 0) atomicOr(words + (id >> 5), 1u << (id & 31));
}

// The filtered scatter: the program runs per requested row
// (rt::run_program).  Leaf `op`'s search: the block stages
// every stride-th position of the leaf's list (ns <= kSamples of them),
// the row finds the count c of samples <= id in shared memory, and the
// answer upper_bound(row, n_pos, id) lies in ((c - 1) * stride,
// min(c * stride, n_pos)]: one search of at most stride entries.
__global__ void __launch_bounds__(kFilterThreads)
filter_rows_kernel(const int* __restrict__ ids, long long n_ids,
                   const int* __restrict__ cached, long long n_cached,
                   const int* __restrict__ gidx,
                   const int* __restrict__ gcount, int t,
                   unsigned* __restrict__ words, int n_words,
                   const int* __restrict__ fpos,
                   const int* __restrict__ fmeta, int n_pos,
                   const int* __restrict__ ops, int n_ops) {
  __shared__ int sample[kSamples];
  int id = requested_id(ids, n_ids, cached, n_cached, gidx, gcount, t,
                        n_words, blockIdx.x * blockDim.x + threadIdx.x);
  if (id >= fmeta[1]) id = -1;  // lanes at or past the count are false
  const int stride = max(1, (n_pos + kSamples - 1) / kSamples);
  const int ns = (n_pos + stride - 1) / stride;
  // every thread runs the same opcodes, so each leaf's staging is
  // block-wide
  const bool hit = rt::run_program(ops, n_ops, [&](int op) {
    const int* row = fpos + static_cast<size_t>(op) * n_pos;
    __syncthreads();  // the last leaf's readers are done
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      sample[i] = row[static_cast<size_t>(i) * stride];
    }
    __syncthreads();
    int ub = 0;  // upper_bound(row, n_pos, id)
    if (id >= 0) {
      const int c = rt::upper_bound(sample, ns, id);
      if (c > 0) {
        const int lo = (c - 1) * stride + 1;
        const int hi = min(c * stride, n_pos);
        ub = lo + rt::upper_bound(row + lo, hi - lo, id);
      }
    }
    return (fmeta[2 * op] ^ ((ub - 1) & 1)) == 1;
  });
  if (id >= 0 && hit) atomicOr(words + (id >> 5), 1u << (id & 31));
}

template <bool kFilter>
int fused_decode_bitmap_batch(const Pages& p, const int* cached, int c,
                              const int* gidx, int t, const int* gcount,
                              int* ids, int* words, int n_words,
                              const int* fpos, const int* fmeta, int n_pos,
                              const int* ops, int n_ops,
                              cudaStream_t stream) {
  const int err = launch_page_decode(p, ids, words, n_words, stream);
  if (err != 0 || t <= 0) return err;
  const long long n_ids = static_cast<long long>(p.n) * p.page_size;
  const long long n_cached = static_cast<long long>(c) * p.page_size;
  unsigned* w = reinterpret_cast<unsigned*>(words);
  if (kFilter) {
    filter_rows_kernel<<<(t + kFilterThreads - 1) / kFilterThreads,
                         kFilterThreads, 0, stream>>>(
        ids, n_ids, cached, n_cached, gidx, gcount, t, w, n_words, fpos,
        fmeta, n_pos, ops, n_ops);
  } else {
    rows_to_bitmap_kernel<<<(t + kScatterThreads - 1) / kScatterThreads,
                            kScatterThreads, 0, stream>>>(
        ids, n_ids, cached, n_cached, gidx, gcount, t, w, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

Pages pages_of(const int* first, const int* mind, const int* bw,
               const int* woff, const int* packed, const int* counts, int n,
               int n_mini, int max_words, int page_size) {
  return Pages{first, mind, bw, woff,
               reinterpret_cast<const unsigned*>(packed), counts, n, n_mini,
               max_words, page_size};
}

}  // namespace

// Kernel 2: the resident pages named by idx[0 .. n_rows), each clamped to
// [0, n_pages - 1], into out[n_rows, page_size].
extern "C" int rt_gather_decode(const int* first, const int* mind,
                                const int* bw, const int* woff,
                                const int* packed, const int* counts,
                                int n_pages, int n_mini, int max_words,
                                int page_size, const int* idx, int n_rows,
                                int* out, void* stream) {
  Pages p = pages_of(first, mind, bw, woff, packed, counts, n_rows, n_mini,
                     max_words, page_size);
  p.idx = idx;
  p.n_src = n_pages;
  return launch_page_decode(p, out, nullptr, 0,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int rt_delta_decode(const int* first, const int* mind,
                               const int* bw, const int* woff,
                               const int* packed, const int* counts, int n,
                               int n_mini, int max_words, int page_size,
                               int* out, void* stream) {
  return launch_page_decode(
      pages_of(first, mind, bw, woff, packed, counts, n, n_mini, max_words,
               page_size),
      out, nullptr, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int rt_fused_decode_bitmap_batch(
    const int* first, const int* mind, const int* bw, const int* woff,
    const int* packed, const int* counts, int m, int n_mini, int max_words,
    int page_size, const int* cached, int c, const int* gidx, int t,
    const int* gcount, int* ids, int* words, int n_words, void* stream) {
  return fused_decode_bitmap_batch<false>(
      pages_of(first, mind, bw, woff, packed, counts, m, n_mini, max_words,
               page_size),
      cached, c, gidx, t, gcount, ids, words, n_words, nullptr, nullptr, 0,
      nullptr, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int rt_fused_decode_filter_bitmap_batch(
    const int* first, const int* mind, const int* bw, const int* woff,
    const int* packed, const int* counts, int m, int n_mini, int max_words,
    int page_size, const int* cached, int c, const int* gidx, int t,
    const int* gcount, int* ids, int* words, int n_words, const int* fpos,
    const int* fmeta, int n_pos, const int* ops, int n_ops, void* stream) {
  return fused_decode_bitmap_batch<true>(
      pages_of(first, mind, bw, woff, packed, counts, m, n_mini, max_words,
               page_size),
      cached, c, gidx, t, gcount, ids, words, n_words, fpos, fmeta, n_pos,
      ops, n_ops, static_cast<cudaStream_t>(stream));
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
