// traversal: the fused traversal plane -- one hop of the k-hop scan,
// IC-8's two-hop chain and BI-2's counting expansion.
//
// Replaces the TPU kernels of src/repro/kernels/traversal/kernel.py, all
// three built on the body traversal/ref.py:61 expand_counts:
//   #5 khop_scan_pallas :50 (hop body _hop_kernel :28, pallas_call :42),
//   #6 two_hop_pallas   :83 (_expand_kernel :67, pallas_call :74),
//   #7 count_hop_pallas :107 (_count_kernel :97, pallas_call :113).
//
// The resident expansion plan: key_sorted int32[rows_pad] holds the CSR
// key of every edge row, rows grouped by value id (padding keys >= the
// key-space size select nothing); voff int32[n + 1] gives value v's rows
// [voff[v], voff[v+1]).  Frontiers are int32 0/1 planes over the key
// space; bitmap words are uint32.  The Pallas body packs the gathered row
// bits into words and reads each segment's count as a popcount rank
// difference, because a TPU has no cheap scattered gather.  A card does
// not need the trick: each value id's count is a plain segmented sum
//   count[v] = sum over r in [voff[v], voff[v+1]) of
//              (key_sorted[r] < n_key) * frontier[key_sorted[r]],
// and one __device__ routine, segment_count, computes it for all three.
//
// Design of segment_count: a thread per value id, and a warp for the long
// segments.  In-degree on a power-law graph is skewed: most segments are
// a few rows (14 on average at soc-LiveJournal1 scale), a few are
// thousands.  A lane walks a segment of at most kShort rows by itself, so
// short segments cost no warp-wide step; a ballot then names the warp's
// long segments, and the 32 lanes take them one at a time, striding over
// the rows with coalesced loads and summing with __reduce_add_sync.  A
// long segment thus costs length / 32 steps, and no lane waits on one
// vertex's thousands of rows while its warp idles.  Where only count > 0
// matters (#5, #6) a lane stops at its first selected row, and a warp at
// the first stride that holds one (__any_sync).
//
// Bound on the H100 (3.35 TB/s): bytes, for all three.  A kernel must read
// the key_sorted rows it needs (4 B a row: 276 MB for the whole plan at
// soc-LiveJournal1 scale) and voff, read its input planes and write its
// outputs once; per row it does a compare and an add, nothing worth
// counting against the bytes.  The frontier gathers are random, but the
// plane (19 MB at that scale) stays in the 50 MB L2, so they cost L2
// bandwidth, not device-memory bandwidth.  What the design does about
// the bound: key_sorted is read in row order (a warp's long-segment loads
// are coalesced; a lane's short segment spans one or two 128-byte
// lines), neighbouring threads read neighbouring voff and plane entries,
// and #5 and #6 read no further into a segment than its first selected
// row.  Notes on each kernel stand beside it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// segments up to this many rows stay with one lane
constexpr int kShort = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int selected(const int* __restrict__ ks,
                                        const int* __restrict__ frontier,
                                        int nk, int r) {
  const int k = ks[r];
  return static_cast<unsigned>(k) < static_cast<unsigned>(nk) &&
         frontier[k] != 0;
}

// Count of frontier-selected rows in value v's segment, for each lane
// whose v is `active` (an inactive lane reads nothing and gets 0).  With
// kAny only count > 0 matters, and the result is 0 or 1.  Every lane of
// the warp must call it.
template <bool kAny>
__device__ __forceinline__ int segment_count(const int* __restrict__ ks,
                                             const int* __restrict__ voff,
                                             const int* __restrict__ frontier,
                                             int nk, int v, bool active) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = 0;
  if (active) {
    lo = voff[v];
    hi = voff[v + 1];
  }
  const bool is_long = hi - lo > kShort;
  int mine = 0;
  if (!is_long) {
    for (int r = lo; r < hi; ++r) {
      if (selected(ks, frontier, nk, r)) {
        ++mine;
        if (kAny) break;
      }
    }
  }
  unsigned longs = __ballot_sync(kFull, is_long);
  while (longs) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1;
    const int l = __shfl_sync(kFull, lo, src);
    const int h = __shfl_sync(kFull, hi, src);
    int acc = 0;
    for (int base = l; base < h; base += 32) {
      const int r = base + lane;
      const int s = r < h ? selected(ks, frontier, nk, r) : 0;
      if (kAny) {
        if (__any_sync(kFull, s)) {
          acc = 1;
          break;
        }
      } else {
        acc += s;
      }
    }
    if (!kAny) acc = __reduce_add_sync(kFull, acc);
    if (lane == src) mine = acc;
  }
  return mine;
}

// #5, one hop.  For each v: nxt = (count > 0) & filter bit & !visited.
// A vertex that is visited or filtered out gets 0 without reading its
// segment (exact: the product is 0 either way), and the scan stops at the
// first selected row.  nxt goes to this hop's plane, visited[v] is set in
// place (each v touches only its own slot; the frontier is the previous
// plane, another buffer), and each block adds its sum into *size with one
// atomicAdd.  Bytes it must move: voff, visited (read, and written where
// nxt is set), the filter words and the frontier once, the plane written
// once, and the key_sorted rows of the active vertices up to their first
// selected row.
__global__ void __launch_bounds__(kThreads)
khop_hop_kernel(const int* __restrict__ ks, const int* __restrict__ voff,
                int n, const int* __restrict__ frontier,
                int* __restrict__ visited, const unsigned* __restrict__ fw,
                int* __restrict__ plane, int* __restrict__ size) {
  __shared__ int warp_sums[kWarps];
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool in = v < n;
  bool active = false;
  if (in) active = visited[v] == 0 && ((fw[v >> 5] >> (v & 31)) & 1u);
  const int nxt =
      segment_count<true>(ks, voff, frontier, n, v, active) > 0 ? 1 : 0;
  if (in) {
    plane[v] = nxt;
    if (nxt) visited[v] = 1;
  }
  const int wsum = __reduce_add_sync(kFull, nxt);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = wsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    if (total) atomicAdd(size, total);
  }
}

// #6, first pass: mid[v] = count > 0 through adjacency A.
__global__ void __launch_bounds__(kThreads)
expand_plane_kernel(const int* __restrict__ ks, const int* __restrict__ voff,
                    int nk, const int* __restrict__ frontier,
                    int* __restrict__ out, int n) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool in = v < n;
  const int c = segment_count<true>(ks, voff, frontier, nk, v, in);
  if (in) out[v] = c > 0 ? 1 : 0;
}

// #6, second pass: the expansion through adjacency B packed straight to
// words.  One thread per bit lane, one warp per word: __ballot_sync over
// 32 consecutive value ids gives the word, ANDed with the filter word.
// Lanes at or past n are 0, so the bits past n_out in the last word are
// zero, as _pack_words leaves them.  Bytes of the chain: both plans'
// voff and the key_sorted rows up to each segment's first selected row,
// the seed plane read once, mid written and read once, the filter words
// read and the output words written once.
__global__ void __launch_bounds__(kThreads)
expand_words_kernel(const int* __restrict__ ks, const int* __restrict__ voff,
                    int nk, const int* __restrict__ frontier, int n,
                    const unsigned* __restrict__ fw,
                    unsigned* __restrict__ words, int n_words) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int word = v >> 5;
  if (word >= n_words) return;  // whole warps leave together
  const int c = segment_count<true>(ks, voff, frontier, nk, v, v < n);
  const unsigned w = __ballot_sync(kFull, c > 0);
  if ((threadIdx.x & 31) == 0) words[word] = w & fw[word];
}

// Number of entries of sorted a[0, len) that are <= k.
__device__ __forceinline__ int upper_bound(const int* __restrict__ a,
                                          int len, int k) {
  int lo = 0;
  int hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// #7, first pass: the interval frontier as a plane.  The Pallas body
// scatters +1 at each start and -1 at each end, then takes a cumsum; the
// cumsum at k is exactly #{starts <= k} - #{ends <= k}, so two binary
// searches over the starts and ends (sorted once by the wrapper, a few
// thousand entries that stay in L1) give it with no scan.  This holds for
// overlapping intervals too, and a sentinel above n_key - 1 is never
// <= k, so it drops.
__global__ void __launch_bounds__(kThreads)
interval_plane_kernel(const int* __restrict__ starts, int n_starts,
                      const int* __restrict__ ends, int n_ends,
                      int* __restrict__ plane, int n_key) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_key) return;
  plane[k] = upper_bound(starts, n_starts, k) - upper_bound(ends, n_ends, k)
                     > 0
                 ? 1
                 : 0;
}

// #7, second pass: the full segmented count through the interval plane,
// with no early exit (multiplicity is the result).  Bytes: all of
// key_sorted and voff, the starts and ends, the counts written once.
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ ks, const int* __restrict__ voff,
             int nk, const int* __restrict__ frontier,
             int* __restrict__ counts, int n) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool in = v < n;
  const int c = segment_count<false>(ks, voff, frontier, nk, v, in);
  if (in) counts[v] = c;
}

int blocks_for(long long items) {
  return static_cast<int>((items + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int rt_khop_hop(const int* ks, const int* voff, int n,
                           const int* frontier, int* visited, const int* fw,
                           int* plane, int* size, void* stream) {
  if (n > 0) {
    khop_hop_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        ks, voff, n, frontier, visited, reinterpret_cast<const unsigned*>(fw),
        plane, size);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_two_hop(const int* ks_a, const int* voff_a, int n_key,
                          const int* seeds_plane, int* mid, int n_mid,
                          const int* ks_b, const int* voff_b, int n_out,
                          const int* fw, int* words, int n_words,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_mid > 0) {
    expand_plane_kernel<<<blocks_for(n_mid), kThreads, 0, s>>>(
        ks_a, voff_a, n_key, seeds_plane, mid, n_mid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_words > 0) {
    expand_words_kernel<<<blocks_for(32LL * n_words), kThreads, 0, s>>>(
        ks_b, voff_b, n_mid, mid, n_out,
        reinterpret_cast<const unsigned*>(fw),
        reinterpret_cast<unsigned*>(words), n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_count_hop(const int* ks, const int* voff, int n_key,
                            const int* starts, int n_starts, const int* ends,
                            int n_ends, int* plane, int* counts, int n_out,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_key > 0) {
    interval_plane_kernel<<<blocks_for(n_key), kThreads, 0, s>>>(
        starts, n_starts, ends, n_ends, plane, n_key);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_out > 0) {
    count_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(ks, voff, n_key, plane,
                                                        counts, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}
