// Four forms of the scatter behind kernels 11 (ids -> bitmap) and 12 (a
// range of shipped pages -> bitmap), on one decode, and the fourth with its
// loads a pass ahead, for timing side by side with
// tools/single_range_forms.py.  The port's own kernels are in
// src/repro_torch/kernels/csrc/single_range.cu, which keeps the form that
// these timings chose.
//
//   kGlobal  (A) an atomicOr in device memory for each word a thread's 8
//                ids touch (ids merged in registers first);
//   kWarp    (B) (A) aggregated over the warp: for each of the 8 slots the
//                lanes group by target word (__match_any_sync), OR their
//                bits (__reduce_or_sync), and the group's lowest lane does
//                the atomic;
//   kCluster (C) a private copy of the window in the shared memory of a
//                thread block cluster of `param` blocks, each block owning
//                a slice; ids OR into the owner's slice through distributed
//                shared memory; each block ORs its slice's nonzero words
//                into the words once; windows wider than a cluster holds
//                take passes;
//   kWindow  (D) a window of `param` words in each warp's shared memory:
//                at each pass the warp moves it when the pass's first id
//                lies outside (ORing its nonzero words into the words and
//                zeroing it), ids inside OR into it with shared-memory
//                atomics and the rest as (A); the warp ORs it out at the
//                end.  Where a warp's ids lie near each other (sorted ids,
//                the neighbour lists of a graph with locality) most ORs
//                stay on the SM;
//   kWindowAhead (D+) D with each warp's next pass (group of ids) loaded
//                before the current one is scanned and ORed.
//
// Kernel 12 decodes a page a warp, 8 positions a lane (miniblock.cuh's
// thread_deltas), a warp-shuffle scan and a carry across passes of 256
// positions; kernel 11 reads 8 ids a lane, with 16-byte loads where the ids
// are aligned.  Both drop an id equal to the one before it.  The words are
// zeroed by cudaMemsetAsync first.  Grids are persistent: as many blocks
// (clusters) as the card holds at once.
//
// Build (the script does): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas=-v
//   -I src/repro_torch/kernels/csrc tools/single_range_forms.cu -o lib.so
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "miniblock.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kItems = rt::kItems;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kGlobal = 0, kWarp = 1, kCluster = 2, kWindow = 3,
              kWindowAhead = 4;
// shared memory a block of the cluster form holds at most
constexpr int kMaxSliceBytes = 200 * 1024;

// Targets: put(w, bits) ORs bits into word w of the window; begin(rel) is
// called by the whole warp before each pass with the pass's first id
// (relative to base); finish() by the whole warp after its last pass.
struct GlobalTarget {
  unsigned* words;
  __device__ __forceinline__ void put(int w, unsigned bits) const {
    atomicOr(words + w, bits);
  }
  __device__ __forceinline__ void begin(long long) {}
  __device__ __forceinline__ void finish() {}
};

struct ClusterTarget {
  unsigned* smem;
  int w0;
  int slice;
  __device__ __forceinline__ void put(int w, unsigned bits) const {
    const unsigned rel = static_cast<unsigned>(w - w0);
    const unsigned r = rel / static_cast<unsigned>(slice);
    unsigned* dst = cg::this_cluster().map_shared_rank(smem, r);
    atomicOr(dst + (rel - r * slice), bits);
  }
  __device__ __forceinline__ void begin(long long) {}
  __device__ __forceinline__ void finish() {}
};

struct WindowTarget {
  unsigned* words;
  unsigned* win;  // this warp's `size` words of shared memory
  int size;
  int n_words;
  int wb;         // the window's first word

  __device__ __forceinline__ void put(int w, unsigned bits) const {
    if (static_cast<unsigned>(w - wb) < static_cast<unsigned>(size)) {
      atomicOr(win + (w - wb), bits);
    } else {
      atomicOr(words + w, bits);
    }
  }
  __device__ __forceinline__ void flush() {
    __syncwarp();
    for (int k = threadIdx.x & 31; k < size; k += 32) {
      const unsigned b = win[k];
      if (b) {
        win[k] = 0u;
        atomicOr(words + wb + k, b);
      }
    }
    __syncwarp();
  }
  __device__ __forceinline__ void begin(long long rel) {
    if (rel < 0 || rel >= 32LL * n_words) return;
    const int w = static_cast<int>(rel >> 5);
    if (static_cast<unsigned>(w - wb) < static_cast<unsigned>(size)) return;
    flush();
    wb = w - size / 4;
  }
  __device__ __forceinline__ void finish() { flush(); }
};

// A thread's 8 ids v (valid where bit i of `valid` is set; `prev` the id
// before v[0], compared where has_prev) into the window bits [lo, hi)
// relative to base.
template <int kForm, class T>
__device__ __forceinline__ void scatter8(const T& t,
                                         const unsigned (&v)[kItems],
                                         unsigned valid, unsigned prev,
                                         bool has_prev, int base, long long lo,
                                         long long hi) {
  if constexpr (kForm == kWarp) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned before = i ? v[i - 1] : prev;
      const bool dup = (i || has_prev) && v[i] == before;
      const long long rel =
          static_cast<long long>(static_cast<int>(v[i])) - base;
      const bool in = ((valid >> i) & 1u) && !dup && rel >= lo && rel < hi;
      const int key = in ? static_cast<int>(rel >> 5) : -1;
      const unsigned bit = in ? 1u << (rel & 31) : 0u;
      const unsigned peers = __match_any_sync(kFull, key);
      const unsigned bits = __reduce_or_sync(peers, bit);
      if (in && lane == __ffs(peers) - 1) t.put(key, bits);
    }
  } else {
    int cur = -1;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned before = i ? v[i - 1] : prev;
      const bool dup = (i || has_prev) && v[i] == before;
      const long long rel =
          static_cast<long long>(static_cast<int>(v[i])) - base;
      if (((valid >> i) & 1u) && !dup && rel >= lo && rel < hi) {
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
}

// Kernel 12's walk: warp `warp0` of `n_warps` decodes pages warp0,
// warp0 + n_warps, ... and scatters rows [0, min(count, page_size)).
template <int kForm, bool kAhead, class T>
__device__ __forceinline__ void walk_pages(const rt::Pages& p, long long warp0,
                                           long long n_warps, T& t,
                                           int base, long long lo,
                                           long long hi) {
  const int lane = threadIdx.x & 31;
  for (long long row = warp0; row < p.n; row += n_warps) {
    unsigned carry = static_cast<unsigned>(__ldg(p.first + row));
    const int c = __ldg(p.counts + row);
    const int count = min(c, p.page_size);
    const int last = min(c - 1, p.page_size - 1);
    unsigned prev = 0;
    unsigned d[kItems];
    if (kAhead && count > 0) rt::thread_deltas(p, row, kItems * lane, last, d);
    for (int b = 0; b < count; b += 32 * kItems) {
      const int j0 = b + kItems * lane;
      unsigned dn[kItems] = {};  // kAhead: the next pass's deltas
      if constexpr (kAhead) {
        if (b + 32 * kItems < count) {
          rt::thread_deltas(p, row, j0 + 32 * kItems, last, dn);
        }
      } else {
        rt::thread_deltas(p, row, j0, last, d);
      }
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
      t.begin(static_cast<long long>(static_cast<int>(carry)) - base);
      const unsigned up = __shfl_up_sync(kFull, v[kItems - 1], 1);
      scatter8<kForm>(t, v, valid, lane ? up : prev, j0 > 0, base, lo, hi);
      carry += __shfl_sync(kFull, x, 31);
      prev = __shfl_sync(kFull, v[kItems - 1], 31);
      if constexpr (kAhead) {
#pragma unroll
        for (int i = 0; i < kItems; ++i) d[i] = dn[i];
      }
    }
  }
  t.finish();
}

// Ids i0 .. i0 + 7 (valid below count), by two 16-byte loads where vec
// and the group is whole.
__device__ __forceinline__ void load8(const int* __restrict__ ids, int count,
                                      long long i0, bool vec,
                                      unsigned (&v)[kItems],
                                      unsigned& valid) {
  valid = 0;
  if (vec && i0 + kItems <= count) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(ids + i0));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(ids + i0) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    valid = 0xFFu;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool in = i0 + i < count;
      v[i] = in ? static_cast<unsigned>(__ldg(ids + i0 + i)) : 0u;
      if (in) valid |= 1u << i;
    }
  }
}

// Kernel 11's walk: warp `warp0` of `n_warps` takes ids [256 g, 256 g + 256)
// for g = warp0, warp0 + n_warps, ...; 8 a lane (kAhead: the next group's
// loads issued before this group's ORs).
template <int kForm, bool kAhead, class T>
__device__ __forceinline__ void walk_ids(const int* __restrict__ ids,
                                         int count, long long warp0,
                                         long long n_warps,
                                         T& t, int base, long long lo,
                                         long long hi) {
  const int lane = threadIdx.x & 31;
  const bool vec = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  unsigned v[kItems];
  unsigned valid = 0;
  if (kAhead && warp0 * 32 * kItems < count) {
    load8(ids, count, warp0 * 32 * kItems + kItems * lane, vec, v, valid);
  }
  for (long long g = warp0; g * 32 * kItems < count; g += n_warps) {
    const long long i0 = g * 32 * kItems + kItems * lane;
    unsigned vn[kItems] = {};
    unsigned valid_n = 0;
    if constexpr (kAhead) {
      if ((g + n_warps) * 32 * kItems < count) {
        load8(ids, count, i0 + n_warps * 32 * kItems, vec, vn, valid_n);
      }
    } else {
      load8(ids, count, i0, vec, v, valid);
    }
    t.begin(static_cast<long long>(static_cast<int>(
                __shfl_sync(kFull, v[0], 0))) - base);
    unsigned prev = __shfl_up_sync(kFull, v[kItems - 1], 1);
    if (lane == 0 && i0 > 0) prev = static_cast<unsigned>(__ldg(ids + i0 - 1));
    scatter8<kForm>(t, v, valid, prev, i0 > 0, base, lo, hi);
    if constexpr (kAhead) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) v[i] = vn[i];
      valid = valid_n;
    }
  }
  t.finish();
}

// The arguments of either kernel: ids (kernel 11) or pages (kernel 12).
struct Source {
  rt::Pages p;
  const int* ids;
  int count;
  bool pages;
};

template <int kForm, bool kAhead = false, class T>
__device__ __forceinline__ void walk(const Source& s, T& t, int base,
                                     long long lo, long long hi) {
  const long long n_warps = static_cast<long long>(gridDim.x) *
                            (blockDim.x >> 5);
  const long long warp0 = static_cast<long long>(blockIdx.x) *
                              (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s.pages) {
    walk_pages<kForm, kAhead>(s.p, warp0, n_warps, t, base, lo, hi);
  } else {
    walk_ids<kForm, kAhead>(s.ids, s.count, warp0, n_warps, t, base, lo, hi);
  }
}

template <int kForm, int kThreads>
__global__ void __launch_bounds__(kThreads)
global_kernel(Source s, int base, unsigned* __restrict__ words, int n_words) {
  GlobalTarget t{words};
  walk<kForm>(s, t, base, 0, 32LL * n_words);
}

template <int kThreads, bool kAhead>
__global__ void __launch_bounds__(kThreads)
window_kernel(Source s, int base, unsigned* __restrict__ words, int n_words,
              int size) {
  extern __shared__ unsigned smem[];
  unsigned* win = smem + (threadIdx.x >> 5) * size;
  for (int k = threadIdx.x & 31; k < size; k += 32) win[k] = 0u;
  WindowTarget t{words, win, size, n_words, -2 * size};
  walk<kWindow, kAhead>(s, t, base, 0, 32LL * n_words);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
cluster_kernel(Source s, int base, unsigned* __restrict__ words, int n_words,
               int slice) {
  extern __shared__ unsigned smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int span = slice * static_cast<int>(cluster.num_blocks());
  for (int w0 = 0; w0 < n_words; w0 += span) {
    for (int k = threadIdx.x; k < slice; k += kThreads) smem[k] = 0u;
    cluster.sync();
    ClusterTarget t{smem, w0, slice};
    walk<kCluster>(s, t, base, 32LL * w0,
                   32LL * min(static_cast<long long>(w0) + span,
                              static_cast<long long>(n_words)));
    cluster.sync();  // every block's ORs into this slice are done
    const int own = w0 + rank * slice;
    for (int k = threadIdx.x; k < slice && own + k < n_words; k += kThreads) {
      const unsigned b = smem[k];
      if (b) atomicOr(words + own + k, b);
    }
    __syncthreads();  // the slice is read before the next pass zeroes it
  }
}

template <class Kernel>
int max_blocks(Kernel kernel, int threads, size_t dyn) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                dyn);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <int kThreads>
int launch_cluster(const Source& s, int base, unsigned* words, int n_words,
                   int cs, cudaStream_t stream) {
  const long long cap = kMaxSliceBytes / sizeof(unsigned);
  const int slice = static_cast<int>(
      (std::min(static_cast<long long>(n_words), cap * cs) + cs - 1) / cs);
  const size_t dyn = sizeof(unsigned) * slice;
  auto kernel = cluster_kernel<kThreads>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSliceBytes));
  if (err) return err;
  if (cs > 8) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (err) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg));
  if (err) return err;
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(clusters * cs);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, s, base, words, n_words, slice));
}

template <int kThreads, bool kAhead>
int launch_window(const Source& s, int base, unsigned* words, int n_words,
                  int size, cudaStream_t stream) {
  const size_t dyn = sizeof(unsigned) * size * (kThreads / 32);
  auto kernel = window_kernel<kThreads, kAhead>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn)));
  if (err) return err;
  window_kernel<kThreads, kAhead>
      <<<max_blocks(kernel, kThreads, dyn), kThreads, dyn, stream>>>(
          s, base, words, n_words, size);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm, int kThreads>
int launch_global(const Source& s, int base, unsigned* words, int n_words,
                  cudaStream_t stream) {
  auto kernel = global_kernel<kForm, kThreads>;
  global_kernel<kForm, kThreads>
      <<<max_blocks(kernel, kThreads, 0), kThreads, 0, stream>>>(
          s, base, words, n_words);
  return static_cast<int>(cudaGetLastError());
}

int launch(int form, int threads, int param, const Source& s, int base,
           int* words_i, int n_words, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned* words = reinterpret_cast<unsigned*>(words_i);
  int err = static_cast<int>(
      cudaMemsetAsync(words, 0, sizeof(unsigned) * n_words, stream));
  if (err != 0 || n_words <= 0) return err;
  if (s.pages ? s.p.n <= 0 : s.count <= 0) return 0;
#define RT_FORMS(T)                                                      \
  if (threads == T) {                                                    \
    if (form == kGlobal)                                                 \
      return launch_global<kGlobal, T>(s, base, words, n_words, stream); \
    if (form == kWarp)                                                   \
      return launch_global<kWarp, T>(s, base, words, n_words, stream);   \
    if (form == kWindow)                                                 \
      return launch_window<T, false>(s, base, words, n_words, param,     \
                                     stream);                            \
    if (form == kWindowAhead)                                            \
      return launch_window<T, true>(s, base, words, n_words, param,      \
                                    stream);                             \
    return launch_cluster<T>(s, base, words, n_words, param, stream);    \
  }
  RT_FORMS(256)
  RT_FORMS(512)
  RT_FORMS(1024)
#undef RT_FORMS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Kernel 11 in form `form` at `threads` a block (`param`: the cluster's
// blocks, or the warp's window words).
extern "C" int forms_ids_bitmap(int form, int threads, int param,
                                const int* ids, int count, int base,
                                int* words, int n_words, void* stream) {
  Source s{};
  s.ids = ids;
  s.count = count;
  s.pages = false;
  return launch(form, threads, param, s, base, words, n_words, stream);
}

// Kernel 12 in form `form` at `threads` a block (`param` as above).
extern "C" int forms_fused_decode_bitmap(
    int form, int threads, int param, const int* first, const int* mind,
    const int* bw, const int* woff, const int* packed, const int* counts,
    int n, int n_mini, int max_words, int page_size, int base, int* words,
    int n_words, void* stream) {
  Source s{};
  s.p = rt::Pages{first, mind, bw, woff,
                  reinterpret_cast<const unsigned*>(packed), counts, n,
                  n_mini, max_words, page_size};
  s.pages = true;
  return launch(form, threads, param, s, base, words, n_words, stream);
}

extern "C" const char* forms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
