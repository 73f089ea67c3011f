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
// [voff[v], voff[v+1]).  The frontiers of #6 and #7 are int32 0/1 planes
// over the key space, #5's are bit words; bitmap words are uint32.  The
// Pallas body packs the gathered row bits into words and reads each
// segment's count as a popcount rank difference, because a TPU has no
// cheap scattered gather.  A card does not need the trick: each value
// id's count is a plain segmented sum
//   count[v] = sum over r in [voff[v], voff[v+1]) of
//              (key_sorted[r] < n_key) * frontier[key_sorted[r]],
// and one __device__ routine, segment_count, computes it for #6 and #7.
// #5 walks a word's 32 segments with one warp (scan_word, its design
// beside it).
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
// matters (#6) a lane stops at its first selected row, and a warp at the
// first stride that holds one (__any_sync).
//
// Bound on the H100 (3.35 TB/s): bytes, for all three.  A kernel must read
// the key_sorted rows it needs (4 B a row: 276 MB for the whole plan at
// soc-LiveJournal1 scale) and voff, read its input planes and write its
// outputs once; per row it does a compare and an add, nothing worth
// counting against the bytes.  The frontier gathers are random, but the
// plane (19 MB at that scale; #5's words 606 KB) stays in the 50 MB L2,
// so they cost L2 bandwidth, not device-memory bandwidth.  What the
// design does about the bound: key_sorted is read in row order (#5's
// and a warp's long-segment loads are coalesced; a lane's short segment
// spans one or two 128-byte lines), neighbouring threads read
// neighbouring voff and plane entries, and #5 and #6 read no further
// into a segment than its first selected row.  Notes on each kernel
// stand beside it.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

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

// #5's seeds, the one launch of a khop_scan call before its hops: the
// visited plane and the words (zeroed by the wrapper) get each seed, and
// the hop sizes are zeroed.  A seed id below 0 counts from the end once
// (as jnp normalises a negative index) and anything outside [0, n) after
// that drops, as the plain version's mode="drop" scatter drops it;
// duplicates set the same bit twice.
__global__ void __launch_bounds__(kThreads)
khop_seed_kernel(const int* __restrict__ seeds, int n_seeds, int n,
                 int* __restrict__ visited, unsigned* __restrict__ words,
                 unsigned* __restrict__ vis_words, unsigned* __restrict__ sum,
                 int g, int* __restrict__ sizes, int hops) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < hops) sizes[i] = 0;
  if (i >= n_seeds) return;
  long long s = seeds[i];
  if (s < 0) s += n;
  if (s < 0 || s >= n) return;
  const int w = static_cast<int>(s >> 5);
  const unsigned bit = 1u << (s & 31);
  visited[s] = 1;
  atomicOr(words + w, bit);
  atomicOr(vis_words + w, bit);
  atomicOr(sum + ((w >> g) >> 5), 1u << ((w >> g) & 31));
}

// #5, one hop: nxt[v] = (count > 0) & filter bit & !visited, one warp for
// the 32 value ids v0 .. v0 + 31 of one output word.
//
// Rows are grouped by value id in order, so the rows of those 32 segments
// are one contiguous range of key_sorted, [voff[v0], voff[v0 + 32]).  The
// warp walks it in windows of kLoads * 128 rows with coalesced 16-byte
// loads (lane l takes rows 4l .. 4l + 3 of each 128 rows), never a
// segment by one lane.  Each lane holds one segment's bounds.  A row's
// selection bit goes into one of 4 * kLoads ballots, and a segment hits
// when a ballot has a bit in its range (a range mask per ballot, no search
// per row).  Only the segments that are active (filter bit set, not
// visited, at least one row) and have no hit yet are pending.  A window
// starts at the first row of the lowest pending segment, or where the
// last one ended, and reads nothing past the end of the last pending
// segment.  So a warp whose word has no active id reads no row, and the
// warp leaves a segment as soon as it hits: the early exit of a thread per
// id, kept at 16-byte granularity.  Segments of thousands of rows go
// through the same loop.
//
// The frontier arrives as bit words (n / 32 words, 606 KB at
// soc-LiveJournal1 scale, where an int32 plane takes 19 MB) and a summary
// of them, one bit for each 2^g words that holds a set bit (g = 0 up to
// 6.3M ids: 19 KB at that scale).  Each block keeps the summary in shared
// memory, so a row whose key's word is empty (nearly every row while the
// frontier is small) costs a shared-memory load and no gather; the other
// keys gather their word, from a table that stays in L2.  Each hop writes
// its words and their summary for the next hop to read, zeroes the
// summary buffer the hop after it will write (three buffers in turn), and
// updates the visited words.  The int32 plane and visited outputs keep
// their contract: the warp stores its 32 plane entries coalesced, sets
// visited[v] where nxt is set, and adds its popcount into a per-block
// sum, one atomicAdd a block.
//
// The grid is persistent: as many blocks as the SMs hold at once, each
// warp looping over words and loading the next word's filter, visited and
// voff entries before it scans this one.  A window's loads go straight to
// registers, all issued before any is used.
constexpr int kQuarter = 128;  // rows of one coalesced 16-byte load
constexpr int kLoads = 4;      // 16-byte loads a lane per window
constexpr int kWin = kQuarter * kLoads;  // rows of one window

// bits [0, k) for any k (all of them from 32 up)
__device__ __forceinline__ unsigned bits_below(int k) {
  return k >= 32 ? kFull : (k <= 0 ? 0u : (1u << k) - 1u);
}

// A hop's frontier: its bit words and, in shared memory, their summary.
struct Frontier {
  const unsigned* __restrict__ words;
  const unsigned* sum;
  int n;
  int shift;  // 5 + g: key k's summary bit is k >> shift
};

// 1 when row key k is on the frontier (keys outside [0, n) select
// nothing); the word is read only when the summary says it may be set
__device__ __forceinline__ unsigned on_frontier(const Frontier& fr, int k) {
  if (static_cast<unsigned>(k) >= static_cast<unsigned>(fr.n)) return 0u;
  const int wi = k >> fr.shift;
  if (!((fr.sum[wi >> 5] >> (wi & 31)) & 1u)) return 0u;
  return (__ldg(fr.words + (k >> 5)) >> (k & 31)) & 1u;
}

// Whether a window row in [a, b) is selected; sel[4q + u] has bit l set
// when row kQuarter * q + 4l + u of the window is.
__device__ __forceinline__ bool range_hit(const unsigned (&sel)[4 * kLoads],
                                          int a, int b) {
  unsigned any = 0;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // the lanes l with a <= kQuarter * q + 4l + u < b
      const int x = a - kQuarter * q - u;
      const int y = b - kQuarter * q - u;
      const int lmin = x <= 0 ? 0 : (x + 3) >> 2;
      const int lmax = y <= 0 ? 0 : (y + 3) >> 2;
      any |= sel[4 * q + u] & bits_below(lmax) & ~bits_below(lmin);
    }
  }
  return any != 0;
}

// The hits among the pending segments of one word.  Lane l holds segment
// l's rows [lo, hi); every lane of the warp calls it.
__device__ __forceinline__ unsigned scan_word(const int* __restrict__ ks,
                                              const Frontier& fr, int lo,
                                              int hi, unsigned pending) {
  const int lane = threadIdx.x & 31;
  const int n = fr.n;
  unsigned found = 0;
  int cur = 0;
  while (pending) {
    cur = max(cur, __shfl_sync(kFull, lo, __ffs(pending) - 1));
    const int end = __shfl_sync(kFull, hi, 31 - __clz(pending));
    const int c = cur & ~3;  // 16-byte aligned: rows_pad % 32 == 0
    const int r0 = c + 4 * lane;
    int4 q[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) q[i] = make_int4(n, n, n, n);  // none
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if (r0 + kQuarter * i < end) {
        q[i] = __ldcs(reinterpret_cast<const int4*>(ks + r0 + kQuarter * i));
      }
    }
    unsigned f = 0u;  // bit 4i + e: element e of load i selects
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      f |= (on_frontier(fr, q[i].x) | on_frontier(fr, q[i].y) << 1 |
            on_frontier(fr, q[i].z) << 2 | on_frontier(fr, q[i].w) << 3)
           << (4 * i);
    }
    // most windows select no row while the frontier is small: then no
    // segment hits, and the ballots and range masks are skipped
    unsigned hits = 0u;
    if (__any_sync(kFull, f)) {
      unsigned sel[4 * kLoads];
#pragma unroll
      for (int u = 0; u < 4 * kLoads; ++u) {
        sel[u] = __ballot_sync(kFull, (f >> u) & 1u);
      }
      const bool mine = (pending >> lane) & 1u;
      hits = __ballot_sync(
          kFull, mine && range_hit(sel, min(max(lo - c, 0), kWin),
                                   min(max(hi - c, 0), kWin)));
    }
    const unsigned done = __ballot_sync(kFull, hi <= c + kWin);
    found |= hits;
    pending &= ~(hits | done);
    cur = c + kWin;
  }
  return found;
}

// What a warp reads of word w before it scans: the filter and visited
// words, and its lane's segment bounds.
struct WordHead {
  unsigned filt;
  unsigned vis;
  int lo;
  int hi;
};

__device__ __forceinline__ WordHead word_head(const int* __restrict__ voff,
                                              const unsigned* __restrict__ fw,
                                              const unsigned* vis_words,
                                              int n, int w) {
  const int v = (w << 5) + (threadIdx.x & 31);
  return {fw[w], vis_words[w], voff[min(v, n)], voff[min(v + 1, n)]};
}

// Bytes the hop must move: voff, the filter and visited words and the
// frontier words once, the plane written once, visited written where nxt
// is set, and the key_sorted rows of the active vertices up to their
// first selected row.  A window reads more: the rows of other segments
// that lie between pending ones inside it, and up to 3 rows on each side
// for its 16-byte alignment.  Blocks are 1024 threads; a block's summary
// is n_sum words of dynamic shared memory.
constexpr int kHopThreads = 1024;

__global__ void __launch_bounds__(kHopThreads)
khop_hop_kernel(const int* __restrict__ ks, const int* __restrict__ voff,
                int n, const unsigned* __restrict__ frontier,
                const unsigned* __restrict__ sum_in,
                unsigned* __restrict__ sum_out,
                unsigned* __restrict__ sum_clear, int n_sum, int g,
                unsigned* __restrict__ vis_words,
                int* __restrict__ visited, const unsigned* __restrict__ fw,
                unsigned* __restrict__ out_words, int* __restrict__ plane,
                int* __restrict__ size) {
  constexpr int kT = kHopThreads;
  constexpr int kW = kT / 32;
  extern __shared__ unsigned s_sum[];
  __shared__ int warp_sums[kW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < n_sum; i += kT) s_sum[i] = sum_in[i];
  for (int i = blockIdx.x * kT + threadIdx.x; i < n_sum; i += gridDim.x * kT) {
    sum_clear[i] = 0u;
  }
  const Frontier fr{frontier, s_sum, n, 5 + g};
  __syncthreads();
  const int n_words = (n + 31) >> 5;
  const int stride = gridDim.x * kW;
  int mine = 0;
  int w = blockIdx.x * kW + warp;
  WordHead head{};
  if (w < n_words) head = word_head(voff, fw, vis_words, n, w);
  while (w < n_words) {
    const int next = w + stride;
    WordHead ahead{};
    if (next < n_words) ahead = word_head(voff, fw, vis_words, n, next);
    const int v0 = w << 5;
    const int v = v0 + lane;
    unsigned pending = head.filt & ~head.vis & bits_below(n - v0);
    unsigned found = 0;
    if (pending) {  // uniform: every lane read the same words
      pending &= __ballot_sync(kFull, head.hi > head.lo);
      found = scan_word(ks, fr, head.lo, head.hi, pending);
    }
    const unsigned bit = (found >> lane) & 1u;
    if (v < n) plane[v] = static_cast<int>(bit);
    if (bit) visited[v] = 1;
    if (lane == 0) {
      out_words[w] = found;
      if (found) {
        vis_words[w] = head.vis | found;
        atomicOr(sum_out + ((w >> g) >> 5), 1u << ((w >> g) & 31));
      }
      mine += __popc(found);
    }
    head = ahead;
    w = next;
  }
  if (lane == 0) warp_sums[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kW; ++i) total += warp_sums[i];
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

// The persistent grid's size: as many blocks of the hop kernel as the
// card's SMs hold at once.  The occupancy query is host work, so its
// answer is kept per device and dynamic shared size, not asked every hop.
constexpr int kMaxDevices = 64;

int persistent_blocks(size_t dyn) {
  static std::atomic<unsigned long long> cache[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  // an entry is (dyn + 1) << 32 | blocks; 0 is no entry yet
  const unsigned long long tag = static_cast<unsigned long long>(dyn) + 1;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) {
    const unsigned long long c = cache[dev].load(std::memory_order_relaxed);
    if ((c >> 32) == tag) return static_cast<int>(c & 0xFFFFFFFFu);
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, khop_hop_kernel,
                                                kHopThreads, dyn);
  const int blocks = std::max(1, sms * per_sm);
  if (cached) {
    cache[dev].store(tag << 32 | static_cast<unsigned>(blocks),
                     std::memory_order_relaxed);
  }
  return blocks;
}

}  // namespace

// g: the summary's bit (w >> g) covers frontier words w
extern "C" int rt_khop_seed(const int* seeds, int n_seeds, int n,
                            int* visited, int* words, int* vis_words,
                            int* sum, int g, int* sizes, int hops,
                            void* stream) {
  const int items = std::max(n_seeds, hops);
  if (items > 0) {
    khop_seed_kernel<<<blocks_for(items), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        seeds, n_seeds, n, visited, reinterpret_cast<unsigned*>(words),
        reinterpret_cast<unsigned*>(vis_words),
        reinterpret_cast<unsigned*>(sum), g, sizes, hops);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_khop_hop(const int* ks, const int* voff, int n,
                           const int* frontier, const int* sum_in,
                           int* sum_out, int* sum_clear, int n_sum, int g,
                           int* vis_words, int* visited, const int* fw,
                           int* out_words, int* plane, int* size,
                           void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int n_words = (n + 31) / 32;
  const size_t dyn = sizeof(unsigned) * static_cast<size_t>(n_sum);
  const int blocks = std::min((n_words + kHopThreads / 32 - 1) /
                                  (kHopThreads / 32),
                              persistent_blocks(dyn));
  khop_hop_kernel<<<blocks, kHopThreads, dyn,
                    static_cast<cudaStream_t>(stream)>>>(
      ks, voff, n, reinterpret_cast<const unsigned*>(frontier),
      reinterpret_cast<const unsigned*>(sum_in),
      reinterpret_cast<unsigned*>(sum_out),
      reinterpret_cast<unsigned*>(sum_clear), n_sum, g,
      reinterpret_cast<unsigned*>(vis_words), visited,
      reinterpret_cast<const unsigned*>(fw),
      reinterpret_cast<unsigned*>(out_words), plane, size);
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
