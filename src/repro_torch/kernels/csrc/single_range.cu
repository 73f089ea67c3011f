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
// base + 32 * w + j (id - base reckoned in 64 bits).  ids_bitmap's valid
// ids are ids[0 .. count); fused_decode_bitmap's are rows
// [0, min(counts[p], page_size)) of each page p, decoded as per_dispatch.cu's
// delta_decode decodes them (miniblock.cuh: the same clamps, int32
// wraparound).
//
// The TPU kernels build each word as a *sum* of 1 << bit over the valid
// ids, dropping an id equal to its predecessor; that is an OR only when
// equal ids are adjacent.  Here every valid in-range id ORs its bit, so
// the words are the set of ids under any order and multiplicity.  Where
// the TPU kernels' contract holds (sorted ids, or duplicates adjacent
// within a page) the words are the same.  An id equal to the one before
// it is skipped all the same: on sorted input it saves the OR.
//
// Bound on the H100 (3.35 TB/s), for each input read once and each output
// written once: ids_bitmap 4 * count bytes in and 4 * n_words out;
// fused_decode_bitmap, per page, 4 * (2 + 3 * n_mini) bytes of header
// arrays and 4 * sum(bit_widths) bytes of packed words in (a miniblock of
// width bw packs its 32 deltas into bw words), and 4 * n_words out.  The
// arithmetic is a shift, a mask and a scan step per delta and an OR per
// id.
//
// What costs: a main-path call ORs 69.0M ids into a window of 606 KB
// (LiveJournal's 4,847,571 vertices).  An atomicOr in device memory for
// each word a lane's ids touch (after merging them in registers) took
// 0.44 ms on the unsorted <dst> column, the L2's atomics; the window in a
// thread block cluster's shared memory, ORed through distributed shared
// memory, took 0.55-1.10 ms, and the same ORs grouped over the warp with
// __match_any_sync 0.76 (PERF.md; tools/single_range_forms.cu holds those
// forms).  But a graph's neighbour lists lie near their source (the
// locality GraphAr's layout exploits), and a sorted column's ids near each
// other, so the ids a warp handles in a row mostly fall in a few words.
//
// Design: each warp keeps a window of kWindow words (4,096 ids) in shared
// memory.  Before each pass of 256 ids the warp looks at the pass's first
// id; when it lies outside the window, the warp ORs the window's nonzero
// words into the output words, zeroes it and moves it to start kWindow / 4
// words below that id.  A lane's ids inside the window OR into it with
// shared-memory atomics, the rest with atomicOr in device memory; the warp
// ORs its window out at the end.  The output words are zeroed by
// cudaMemsetAsync before the launch, so no block of the launch zeroes a
// word that another may have ORed into.  The grid is persistent: as many
// blocks as the card holds at once, each warp walking pages (or groups of
// 256 ids) warp0, warp0 + n_warps, ...
//   - fused_decode_bitmap decodes a page a warp: 8 positions a lane
//     through miniblock.cuh's thread_deltas (the header once, 16-byte word
//     loads, the width known at compile time), a warp-shuffle scan and a
//     carry across passes of 256 positions; the ids stay in registers.
//   - ids_bitmap reads 8 ids a lane, with two 16-byte loads where `ids` is
//     16-byte aligned and scalar loads otherwise (an offset view is
//     contiguous but not aligned) and past the last whole group; the id
//     before a lane's first comes by one shuffle (lane 0 loads it).
//   - A lane merges its 8 ids' bits word by word in registers and drops an
//     id equal to the one before it, so each OR it issues carries every
//     bit of its run that lands in that word.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "miniblock.cuh"

namespace {

constexpr int kItems = rt::kItems;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPass = 32 * kItems;  // ids a warp handles at once
constexpr int kWindow = 128;        // words of a warp's window

// A warp's window, words [wb, wb + kWindow) of the output in shared
// memory, in front of the output words.
struct Window {
  unsigned* words;
  unsigned* win;  // this warp's kWindow words of shared memory
  int n_words;
  int wb;

  // OR bits into word w (in [0, n_words)); any lane.
  __device__ __forceinline__ void put(int w, unsigned bits) const {
    if (static_cast<unsigned>(w - wb) < static_cast<unsigned>(kWindow)) {
      atomicOr(win + (w - wb), bits);
    } else {
      atomicOr(words + w, bits);
    }
  }

  // OR the window's nonzero words out and zero them; the whole warp.
  __device__ __forceinline__ void flush() {
    __syncwarp();
    for (int k = threadIdx.x & 31; k < kWindow; k += 32) {
      const unsigned b = win[k];
      if (b) {
        win[k] = 0u;
        atomicOr(words + wb + k, b);
      }
    }
    __syncwarp();
  }

  // Before a pass whose first id lies `rel` past base; the whole warp.
  __device__ __forceinline__ void begin(long long rel) {
    if (rel < 0 || rel >= 32LL * n_words) return;
    const int w = static_cast<int>(rel >> 5);
    if (static_cast<unsigned>(w - wb) < static_cast<unsigned>(kWindow)) {
      return;
    }
    flush();
    wb = w - kWindow / 4;
  }
};

// A lane's 8 ids v (valid where bit i of `valid` is set; `prev` the id
// before v[0], compared where has_prev) into the target.
__device__ __forceinline__ void scatter8(const Window& t,
                                         const unsigned (&v)[kItems],
                                         unsigned valid, unsigned prev,
                                         bool has_prev, int base) {
  const long long span = 32LL * t.n_words;
  int cur = -1;
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned before = i ? v[i - 1] : prev;
    const bool dup = (i || has_prev) && v[i] == before;
    const long long rel =
        static_cast<long long>(static_cast<int>(v[i])) - base;
    if (((valid >> i) & 1u) && !dup && rel >= 0 && rel < span) {
      const int w = static_cast<int>(rel >> 5);
      if (w != cur) {
        if (cur >= 0) t.put(cur, bits);
        cur = w;
        bits = 0;
      }
      bits |= 1u << (rel & 31);
    }
  }
  if (cur >= 0) t.put(cur, bits);
}

// fused_decode_bitmap's walk: warp `warp0` of `n_warps` decodes pages
// warp0, warp0 + n_warps, ... and scatters rows [0, min(count, page_size)).
__device__ __forceinline__ void walk_pages(const rt::Pages& p, long long warp0,
                                           long long n_warps, Window& t,
                                           int base) {
  const int lane = threadIdx.x & 31;
  for (long long row = warp0; row < p.n; row += n_warps) {
    unsigned carry = static_cast<unsigned>(__ldg(p.first + row));
    const int c = __ldg(p.counts + row);
    const int count = min(c, p.page_size);
    const int last = min(c - 1, p.page_size - 1);
    unsigned prev = 0;
    for (int b = 0; b < count; b += kPass) {
      const int j0 = b + kItems * lane;
      unsigned d[kItems];
      rt::thread_deltas(p, row, j0, last, d);
      unsigned tot = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) tot += d[i];
      unsigned x = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      unsigned v[kItems];
      unsigned acc = carry + x - tot;
      unsigned valid = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        v[i] = acc;
        acc += d[i];
        if (j0 + i < count) valid |= 1u << i;
      }
      // carry is the pass's first id, position b
      t.begin(static_cast<long long>(static_cast<int>(carry)) - base);
      const unsigned up = __shfl_up_sync(kFull, v[kItems - 1], 1);
      scatter8(t, v, valid, lane ? up : prev, j0 > 0, base);
      carry += __shfl_sync(kFull, x, 31);
      prev = __shfl_sync(kFull, v[kItems - 1], 31);
    }
  }
}

// ids_bitmap's walk: warp `warp0` of `n_warps` takes ids [256 g, 256 g +
// 256) for g = warp0, warp0 + n_warps, ...; 8 a lane.
__device__ __forceinline__ void walk_ids(const int* __restrict__ ids,
                                         int count, long long warp0,
                                         long long n_warps, Window& t,
                                         int base) {
  const int lane = threadIdx.x & 31;
  const bool vec = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  for (long long g = warp0; g * kPass < count; g += n_warps) {
    const long long i0 = g * kPass + kItems * lane;
    unsigned v[kItems];
    unsigned valid = 0;
    if (vec && i0 + kItems <= count) {
      const uint4* q = reinterpret_cast<const uint4*>(ids + i0);
      const uint4 a = __ldg(q);
      const uint4 b = __ldg(q + 1);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
      v[4] = b.x;
      v[5] = b.y;
      v[6] = b.z;
      v[7] = b.w;
      valid = 0xFFu;
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const bool in = i0 + i < count;
        v[i] = in ? static_cast<unsigned>(__ldg(ids + i0 + i)) : 0u;
        if (in) valid |= 1u << i;
      }
    }
    // lane 0's first id, position 256 g, is the pass's first
    t.begin(static_cast<long long>(
                static_cast<int>(__shfl_sync(kFull, v[0], 0))) - base);
    unsigned prev = __shfl_up_sync(kFull, v[kItems - 1], 1);
    if (lane == 0 && i0 > 0) prev = static_cast<unsigned>(__ldg(ids + i0 - 1));
    scatter8(t, v, valid, prev, i0 > 0, base);
  }
}

// What a launch reads: pages (fused_decode_bitmap) or ids (ids_bitmap).
struct Source {
  rt::Pages p;
  const int* ids;
  int count;
  bool pages;
};

__global__ void __launch_bounds__(kThreads)
single_range_kernel(Source s, int base, unsigned* __restrict__ words,
                    int n_words) {
  __shared__ unsigned win[kWarps][kWindow];
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x & 31; k < kWindow; k += 32) win[warp][k] = 0u;
  // wb far below any word: the first pass moves the window
  Window t{words, win[warp], n_words, -2 * kWindow};
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long warp0 = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s.pages) {
    walk_pages(s.p, warp0, n_warps, t, base);
  } else {
    walk_ids(s.ids, s.count, warp0, n_warps, t, base);
  }
  t.flush();
}

// The persistent grid: as many blocks as the card's SMs hold at once.  The
// occupancy query is host work, so its answer is kept per device, not
// asked every launch.
constexpr int kMaxDevices = 64;

int persistent_blocks() {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) {
    const int c = cache[dev].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, single_range_kernel,
                                                kThreads, 0);
  const int blocks = std::max(1, sms * per_sm);
  if (cached) cache[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

// Zero the words, then OR in the source's ids: `units` pages or groups of
// kPass ids, a warp each at a time.
int launch(const Source& s, long long units, int base, int* words,
           int n_words, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = static_cast<int>(
      cudaMemsetAsync(words, 0, sizeof(unsigned) * n_words, stream));
  if (err != 0 || n_words <= 0 || units <= 0) return err;
  const long long blocks = std::min<long long>(
      persistent_blocks(), (units + kWarps - 1) / kWarps);
  single_range_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(s, base, reinterpret_cast<unsigned*>(words),
                                  n_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_ids_bitmap(const int* ids, int count, int base, int* words,
                             int n_words, void* stream) {
  Source s{};
  s.ids = ids;
  s.count = count;
  s.pages = false;
  return launch(s, (static_cast<long long>(count) + kPass - 1) / kPass, base,
                words, n_words, stream);
}

extern "C" int rt_fused_decode_bitmap(const int* first, const int* mind,
                                      const int* bw, const int* woff,
                                      const int* packed, const int* counts,
                                      int n, int n_mini, int max_words,
                                      int page_size, int base, int* words,
                                      int n_words, void* stream) {
  Source s{};
  s.p = rt::Pages{first, mind, bw, woff,
                  reinterpret_cast<const unsigned*>(packed), counts, n,
                  n_mini, max_words, page_size};
  s.pages = true;
  return launch(s, n, base, words, n_words, stream);
}
