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
// [voff[v], voff[v+1]).  Every frontier is bit words over the key space
// (uint32, held in int32 tensors).  The Pallas body packs the gathered row
// bits into words and reads each segment's count as a popcount rank
// difference, because a TPU has no cheap scattered gather.  On the card
// each value id's count is a segmented sum
//   count[v] = sum over r in [voff[v], voff[v+1]) of
//              (key_sorted[r] < n_key) * frontier bit of key_sorted[r],
// computed by one of two designs:
//
// * #5 and #6 need only count > 0.  A warp per output word walks the
//   contiguous rows of its 32 segments with 16-byte loads and leaves a
//   segment at its first selected row (hop_kernel, scan_word; the design
//   beside them).  #5 runs it once a hop; #6 once through adjacency A
//   (seed words -> mid) and once through B (mid words -> output words), a
//   seed launch before both (seed_kernel, shared with #5).
// * #7 needs every row (multiplicity is its result), and its targets range
//   from 64 segments of 100k rows (BI-2's tags) to 4.8M segments of 14
//   rows (soc-LiveJournal1): a grid over values starves at the first.  So
//   its grid is balanced over rows: fixed tiles of kTile rows, each block
//   counting the segments of its tile by rank differences over the tile's
//   bits in shared memory, with atomics only for the two segments that may
//   cross into a neighbouring tile (count_tiles_kernel, after
//   interval_words_kernel builds the frontier words).
//
// A key's frontier word is read only when a summary in shared memory says
// it must be: for #5 and #6 (on_frontier) one bit for each 2^g words that
// hold a set bit; for #7 (dense_test) two bits, so that a key in a group of
// empty or of full words needs no gather either.  The words (n / 32: 606
// KB at soc-LiveJournal1 scale) stay in the 50 MB L2.
//
// Bound on the H100 (3.35 TB/s): bytes, for all three.  A kernel must read
// the key_sorted rows it needs (4 B a row: 276 MB for the whole plan at
// soc-LiveJournal1 scale) and voff, read its input words or intervals and
// write its outputs once; per row it does a compare and an add, nothing
// worth counting against the bytes.  #5 and #6 need each active segment's
// rows up to its first selected one, #7 every row.  What the designs do
// about it: key_sorted is read in row order with coalesced 16-byte loads,
// once (#7) or only as far as the early exit (#5, #6); the frontier's
// empty (and for #7 full) words cost a shared-memory load and no gather.
// Notes on each kernel stand beside it.  The partition plane's sharded
// k-hop adds rt_merge_hop (merge_hop_kernel), beside #6's expansion.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The seed launch of #5 and #6, one a call before the hops: the frontier
// words and their summary (zeroed by the wrapper) get each seed's bit; for
// #5 the visited plane and words get it too, and the hop sizes are
// zeroed (#6 passes no visited plane, visited words or sizes).  A seed id
// below 0 counts from the end once (as jnp normalises a negative index)
// and anything outside [0, n) after that drops, as the plain version's
// mode="drop" scatter drops it; duplicates set the same bit twice.
__global__ void __launch_bounds__(kThreads)
seed_kernel(const int* __restrict__ seeds, int n_seeds, int n,
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
  atomicOr(words + w, bit);
  atomicOr(sum + ((w >> g) >> 5), 1u << ((w >> g) & 31));
  if (visited != nullptr) {
    visited[s] = 1;
    atomicOr(vis_words + w, bit);
  }
}

// bits [0, k) for any k (all of them from 32 up)
__device__ __forceinline__ unsigned bits_below(int k) {
  return k >= 32 ? kFull : (k <= 0 ? 0u : (1u << k) - 1u);
}

// A frontier: its bit words over the key space [0, n) and, in shared
// memory, their summary, one bit for each 2^g words that holds a set bit
// (g = 0 up to 6.3M ids: 19 KB at soc-LiveJournal1 scale).
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

// bit e: element e of the 4 keys in q is on the frontier
__device__ __forceinline__ unsigned on_frontier4(const Frontier& fr,
                                                 int4 q) {
  return on_frontier(fr, q.x) | on_frontier(fr, q.y) << 1 |
         on_frontier(fr, q.z) << 2 | on_frontier(fr, q.w) << 3;
}

// #7's frontier summary: two bits for each 2^g words, kSomeSet |
// kNotAllSet, so a key in an empty or a full group needs no gather.
constexpr unsigned kSomeSet = 1u;
constexpr unsigned kNotAllSet = 2u;

// bits 2b -> bits b of a word's even bits
__device__ __forceinline__ unsigned even_bits(unsigned x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// #7's test of the 4 * kL keys of a thread's loads against the frontier
// (words over [0, n), tbl its two-bit summary in shared memory, 2^(shift
// - 5) words an entry): bit 4i + e is set when element e of load i is on
// it.  No branch a key: the summary loads issue together, the states pack
// two bits a key, and only keys in groups neither empty nor full gather
// their word.
template <int kL>
__device__ __forceinline__ unsigned dense_test(
    const unsigned* tbl, const unsigned* __restrict__ words, int n,
    int shift, const int4 (&q)[kL]) {
  static_assert(kL <= 4, "two bits a key in one word");
  unsigned spread = 0u;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const int k4[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = static_cast<unsigned>(k4[e]) <
                      static_cast<unsigned>(n);
      const int wi = (in ? k4[e] : 0) >> shift;
      const unsigned st = (tbl[wi >> 4] >> ((wi & 15) << 1)) & 3u;
      spread |= (in ? st : 0u) << (2 * (4 * i + e));
    }
  }
  const unsigned some = spread & 0x55555555u;
  const unsigned open = (spread >> 1) & some;  // gather these
  unsigned sure = some & ~open;                // in full groups
  if (open) {
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int k4[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 2 * (4 * i + e);
        if ((open >> b) & 1u) {
          const int k = k4[e];
          sure |= ((__ldg(words + (k >> 5)) >> (k & 31)) & 1u) << b;
        }
      }
    }
  }
  return even_bits(sure);
}

// #5 and #6, one expansion: found[v] = count > 0 for the pending value ids
// v0 .. v0 + 31 of one output word, one warp a word.
//
// Rows are grouped by value id in order, so the rows of those 32 segments
// are one contiguous range of key_sorted, [voff[v0], voff[v0 + 32]).  The
// warp walks it in windows of kLoads * 128 rows with coalesced 16-byte
// loads (lane l takes rows 4l .. 4l + 3 of each 128 rows), never a
// segment by one lane.  Each lane holds one segment's bounds.  A row's
// selection bit goes into one of 4 * kLoads ballots, and a segment hits
// when a ballot has a bit in its range (a range mask per ballot, no search
// per row).  Only the segments that are active (filter bit set, for #5 not
// visited, at least one row) and have no hit yet are pending.  A window
// starts at the first row of the lowest pending segment, or where the
// last one ended, and reads nothing past the end of the last pending
// segment.  So a warp whose word has no active id reads no row, and the
// warp leaves a segment as soon as it hits: the early exit of a thread per
// id, kept at 16-byte granularity.  Segments of thousands of rows go
// through the same loop.  A row whose key's frontier word is empty (nearly
// every row while the frontier is small) stops at the summary.
constexpr int kQuarter = 128;  // rows of one coalesced 16-byte load
constexpr int kLoads = 4;      // 16-byte loads a lane per window
constexpr int kWin = kQuarter * kLoads;  // rows of one window

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
    for (int i = 0; i < kLoads; ++i) f |= on_frontier4(fr, q[i]) << (4 * i);
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

// What a warp reads of word w before it scans: the filter word (all set
// where there is none), for #5 the visited word, and its lane's segment
// bounds.
struct WordHead {
  unsigned filt;
  unsigned vis;
  int lo;
  int hi;
};

// What an expansion writes and reads besides its output words: #5's hop
// (filter and visited words in, the int32 plane, visited plane and words,
// summary and hop size out), #6's expansion A (no filter; the int32 mid
// plane and the summary out) and #6's expansion B (filter words in).
enum Mode { kKhopHop, kChainMid, kChainOut };

template <Mode kMode>
__device__ __forceinline__ WordHead word_head(const int* __restrict__ voff,
                                              const unsigned* __restrict__ fw,
                                              const unsigned* vis_words,
                                              int n, int w) {
  const int v = (w << 5) + (threadIdx.x & 31);
  return {kMode == kChainMid ? kFull : fw[w],
          kMode == kKhopHop ? vis_words[w] : 0u, voff[min(v, n)],
          voff[min(v + 1, n)]};
}

// One expansion over n value ids into n_words output words.  #5's hop:
// nxt = found & filter & !visited; it also writes the int32 plane and the
// words' summary for the next hop, zeroes the summary buffer the hop after
// it will write (three buffers in turn), updates the visited plane and
// words, and adds its popcount into the hop size, one atomicAdd a block.
// #6: no visited plane, no size; expansion A writes the mid plane, words
// and summary (over its value space, 2^g_out words a bit) for expansion B,
// which writes the output words ANDed with the filter words.  Output bits
// past n stay zero.
//
// Bytes an expansion must move: voff, the filter (and visited) words and
// the frontier words once, its outputs written once, and the key_sorted
// rows of the active vertices up to their first selected row.  A window
// reads more: the rows of other segments that lie between pending ones
// inside it, and up to 3 rows on each side for its 16-byte alignment.
//
// The grid is persistent: as many 1024-thread blocks as the SMs hold at
// once, each loading the summary into shared memory (n_sum_in words) once
// and each warp looping over words, loading the next word's filter,
// visited and voff entries before it scans this one.  A window's loads go
// straight to registers, all issued before any is used.
constexpr int kHopThreads = 1024;

template <Mode kMode>
__global__ void __launch_bounds__(kHopThreads)
hop_kernel(const int* __restrict__ ks, const int* __restrict__ voff, int n,
           int n_words, const unsigned* __restrict__ frontier,
           const unsigned* __restrict__ sum_in, int n_key, int n_sum_in,
           int g_in, unsigned* __restrict__ sum_out, int g_out,
           unsigned* __restrict__ sum_clear, unsigned* __restrict__ vis_words,
           int* __restrict__ visited, const unsigned* __restrict__ fw,
           unsigned* __restrict__ out_words, int* __restrict__ plane,
           int* __restrict__ size) {
  constexpr int kT = kHopThreads;
  constexpr int kW = kT / 32;
  constexpr bool kKhop = kMode == kKhopHop;
  constexpr bool kOut = kMode == kChainOut;  // no plane, no summary out
  extern __shared__ unsigned s_sum[];
  __shared__ int warp_sums[kW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < n_sum_in; i += kT) s_sum[i] = sum_in[i];
  if constexpr (kKhop) {
    for (int i = blockIdx.x * kT + threadIdx.x; i < n_sum_in;
         i += gridDim.x * kT) {
      sum_clear[i] = 0u;
    }
  }
  const Frontier fr{frontier, s_sum, n_key, 5 + g_in};
  __syncthreads();
  const int stride = gridDim.x * kW;
  int mine = 0;
  int w = blockIdx.x * kW + warp;
  WordHead head{};
  if (w < n_words) head = word_head<kMode>(voff, fw, vis_words, n, w);
  while (w < n_words) {
    const int next = w + stride;
    WordHead ahead{};
    if (next < n_words) {
      ahead = word_head<kMode>(voff, fw, vis_words, n, next);
    }
    const int v0 = w << 5;
    const int v = v0 + lane;
    unsigned pending = head.filt & ~head.vis & bits_below(n - v0);
    unsigned found = 0;
    if (pending) {  // uniform: every lane read the same words
      pending &= __ballot_sync(kFull, head.hi > head.lo);
      found = scan_word(ks, fr, head.lo, head.hi, pending);
    }
    const unsigned bit = (found >> lane) & 1u;
    if (!kOut && v < n) plane[v] = static_cast<int>(bit);
    if constexpr (kKhop) {
      if (bit) visited[v] = 1;
    }
    if (lane == 0) {
      out_words[w] = found;
      if (found) {
        if constexpr (kKhop) vis_words[w] = head.vis | found;
        if constexpr (!kOut) {
          atomicOr(sum_out + ((w >> g_out) >> 5), 1u << ((w >> g_out) & 31));
        }
      }
      if constexpr (kKhop) mine += __popc(found);
    }
    head = ahead;
    w = next;
  }
  if constexpr (kKhop) {
    if (lane == 0) warp_sums[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int i = 0; i < kW; ++i) total += warp_sums[i];
      if (total) atomicAdd(size, total);
    }
  }
}

// For each x[j], the number of entries of sorted a[0, len) that are
// <= x[j]: binary searches by powers of two, all kN in one loop so their
// loads overlap.
template <int kN>
__device__ __forceinline__ void upper_bounds(const int* __restrict__ a,
                                             int len, const int (&x)[kN],
                                             int (&pos)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) pos[j] = 0;
  for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int q = pos[j] + step;
      if (q <= len && a[q - 1] <= x[j]) pos[j] = q;
    }
  }
}

// The number of entries of sorted a[0, len) that are <= x, searched by
// the whole warp, 32 probes a step (every lane calls it and gets it).
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ a,
                                                int len, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = len;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, p < hi && a[p] <= x));
    if (c == 0) return lo;
    hi = min(lo + c * step, hi);
    lo += (c - 1) * step + 1;
  }
  return lo;
}

// #7's tiles: kCountThreads threads, each with kCountLoads 16-byte loads,
// take kTile rows.
constexpr int kCountThreads = 512;
constexpr int kCountLoads = 4;
constexpr int kTile = 4 * kCountLoads * kCountThreads;  // 8192 rows
constexpr int kTileWords = kTile / 32;

// One sorted array of raw interval bounds read as the plain version's
// mode="drop" scatter into size = n_key + 1 slots reads it: a bound b in
// [-size, 0) counts at b + size, one in [0, size) at b, the rest nowhere.
// Those are two sorted runs of the array, [q0, p0) shifted by size and
// [p0, len) as it is (its bounds from size up lie past every key).  For
// one word [k0, k0 + 32) it keeps a cursor in each run and the bit
// position of each run's next bound (32: none in the word).
struct BoundRuns {
  const int* __restrict__ a;
  int len;
  int size;
  int p0, q0;   // entries < 0, entries < -size
  int cp, cn;   // cursors: the next bound in each run
  int np, nn;   // their bit positions
  int before;   // bounds that count before k0
  int base;     // k0

  __device__ __forceinline__ void start(const int* __restrict__ bounds,
                                        int n_bounds, int n_key, int k0) {
    a = bounds;
    len = n_bounds;
    size = n_key + 1;
    const int x[4] = {k0 - 1, k0 - 1 - size, -1, -size - 1};
    int ub[4];
    upper_bounds<4>(a, len, x, ub);
    cp = ub[0];
    cn = ub[1];
    p0 = ub[2];
    q0 = ub[3];
    before = (cp - p0) + (cn - q0);
    np = cp < len ? min(a[cp] - k0, 32) : 32;
    nn = cn < p0 ? min(a[cn] + size - k0, 32) : 32;
    base = k0;
  }
  __device__ __forceinline__ int next() const { return min(np, nn); }
  // the number of bounds at bit position `bit`, the cursors moved past them
  __device__ __forceinline__ int take(int bit) {
    int c = 0;
    while (np == bit) {
      ++c;
      ++cp;
      np = cp < len ? min(a[cp] - base, 32) : 32;
    }
    while (nn == bit) {
      ++c;
      ++cn;
      nn = cn < p0 ? min(a[cn] + size - base, 32) : 32;
    }
    return c;
  }
};

// #7, first launch: the interval frontier as bit words, a thread per word,
// with their two-bit summary (kSomeSet | kNotAllSet for each 2^g words,
// ORed into a table the wrapper zeroed); and, a warp per tile t in
// [0, n_tiles], the segment that holds the tile's first row (the last
// v < n with voff[v] <= t * kTile, by 32-way searches; 0 for tile 0),
// whose count it zeroes: the only segments the second launch adds into
// are those that cross a tile's first row, and it stores every other.
// The Pallas body scatters +1 at each start and -1 at each end
// (mode="drop"), then takes a cumsum; the cumsum at k is exactly
// #{starts at or before k} - #{ends at or before k}, so a thread searches
// the sorted starts and ends once for its word's first id and then walks
// the bounds that fall inside the word, as kernel 3 walks its run
// boundaries (BI-2's intervals number hundreds of thousands, too many for
// a search a key).  This holds for overlapping intervals, negative bounds
// (counted from the end once) and any bound past n_key - 1, which sets no
// bit.  Bytes: the words written (n_key / 8), the starts and ends read
// once.
__global__ void __launch_bounds__(kThreads)
interval_words_kernel(const int* __restrict__ starts, int n_starts,
                      const int* __restrict__ ends, int n_ends, int n_key,
                      unsigned* __restrict__ words, unsigned* __restrict__ sum,
                      int g, const int* __restrict__ voff, int n,
                      int* __restrict__ tile_seg, int n_tiles,
                      int* __restrict__ counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if ((i >> 5) <= n_tiles && n > 0) {  // uniform in the warp
    const int t = i >> 5;
    const long long r = static_cast<long long>(t) * kTile;
    const int first = warp_upper_bound(
        voff, n + 1, r < 0x7FFFFFFF ? static_cast<int>(r) : 0x7FFFFFFF);
    if ((threadIdx.x & 31) == 0) {
      const int v = t == 0 ? 0 : min(max(first - 1, 0), n - 1);
      tile_seg[t] = v;
      counts[v] = 0;
    }
  }
  const int n_words = (n_key + 31) >> 5;
  const bool valid = i < n_words;
  unsigned word = 0u;
  if (valid) {
    const int k0 = i << 5;
    BoundRuns s;
    BoundRuns e;
    s.start(starts, n_starts, n_key, k0);
    e.start(ends, n_ends, n_key, k0);
    int c = s.before - e.before;  // the cumsum just before k0
    int bit = 0;
    while (bit < 32) {
      const int next = min(s.next(), e.next());
      if (c > 0) word |= bits_below(next) & ~bits_below(bit);
      bit = next;
      if (bit < 32) c += s.take(bit) - e.take(bit);
    }
    word &= bits_below(n_key - k0);
    words[i] = word;
  }
  // the warp's 32 words -> its groups' summary entries (a word past the
  // last counts as full: a group is full when the words it has are)
  const unsigned set = __ballot_sync(kFull, word != 0u);
  const unsigned full = __ballot_sync(kFull, word == kFull || !valid);
  if ((threadIdx.x & 31) == 0 && i < n_words) {
    const int gb = min(g, 5);  // a group is 2^gb of the warp's words
    const unsigned m = gb == 5 ? kFull : (1u << (1 << gb)) - 1u;
    unsigned long long entries = 0ull;  // two bits a group
    for (int j = 0; j < (32 >> gb); ++j) {
      const unsigned e = (((set >> (j << gb)) & m) ? kSomeSet : 0u) |
                         (((~full >> (j << gb)) & m) ? kNotAllSet : 0u);
      entries |= static_cast<unsigned long long>(e) << (2 * j);
    }
    const int g0 = i >> g;  // the warp's first group
    const int sh = (g0 & 15) << 1;
    const unsigned lo = static_cast<unsigned>(entries << sh);
    if (lo) atomicOr(sum + (g0 >> 4), lo);
    const unsigned hi = static_cast<unsigned>((entries << sh) >> 32);
    if (hi) atomicOr(sum + (g0 >> 4) + 1, hi);
  }
}

// Selected rows of the tile before tile row i, from its bits and their
// exclusive prefix popcount (entry kTileWords: the whole tile).
__device__ __forceinline__ int tile_rank(const unsigned* bits, const int* pre,
                                         int i) {
  return pre[i >> 5] + __popc(bits[i >> 5] & bits_below(i & 31));
}

// #7, second launch: every row's frontier bit, counted per segment, on a
// grid balanced over rows.  A tile is kTile rows of key_sorted, whatever
// the segments: thread t loads rows 4t .. 4t + 3 of each 2048 with one
// coalesced 16-byte load, tests the 4 keys against the frontier (the
// two-bit summary in shared memory, one load a key, and a gather only for
// a key in a group that is neither empty nor full), and the tile's bits
// go to shared memory as words (8 lanes' nibbles ORed by shuffles), with
// their prefix popcount.  Each segment that overlaps the tile (from
// tile_seg, the first launch's searches) then takes its count as a rank
// difference at its clipped bounds: a segment wholly inside the tile
// (an empty one at its edges too) is stored, and only the first and last,
// which may cross into a neighbour, are atomicAdded into the counts the
// first launch zeroed (integer adds are exact in any order).  64 segments
// of 100k rows and 4.8M of 14 rows fill the card alike: 782 tiles at
// BI-2's shape, 8,420 at soc-LiveJournal1's.
//
// Bytes: all of key_sorted and voff read once, the frontier words and
// summary, the counts written once.  The grid is persistent, two blocks an
// SM (the summary, 2 * n_sum words of dynamic shared memory, loads once a
// block); the next tile's keys, its segment range and its first segment's
// bounds are loaded a tile ahead, into registers; the bits and prefix are
// double-buffered, two barriers a tile.
struct TileKeys {
  int4 q[kCountLoads];

  // tile t's rows below end as this thread loads them (rows past end, and
  // a tile past n_tiles, hold the key n_key, which selects nothing)
  __device__ __forceinline__ void load(const int* __restrict__ ks, int t,
                                       int n_tiles, int end, int n_key) {
    const long long t0 = static_cast<long long>(t) * kTile;
#pragma unroll
    for (int i = 0; i < kCountLoads; ++i) {
      q[i] = make_int4(n_key, n_key, n_key, n_key);
      const long long r = t0 + 4 * (i * kCountThreads + threadIdx.x);
      if (t < n_tiles && r < end) {
        q[i] = __ldcs(reinterpret_cast<const int4*>(ks + r));
      }
    }
  }
};

__global__ void __launch_bounds__(kCountThreads, 2)
count_tiles_kernel(const int* __restrict__ ks, const int* __restrict__ voff,
                   int n, const int* __restrict__ tile_seg, int n_tiles,
                   const unsigned* __restrict__ words,
                   const unsigned* __restrict__ sum_in, int n_sum, int g,
                   int n_key, int* __restrict__ counts) {
  extern __shared__ unsigned s_sum[];
  __shared__ unsigned s_bits[2][kTileWords + 1];
  __shared__ int s_pre[2][kTileWords + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int end = voff[n];
  int t = blockIdx.x;
  TileKeys keys;
  keys.load(ks, t, n_tiles, end, n_key);
  int first = 0;  // the tile's segment range [first, last]
  int last = -1;
  int a0 = 0;     // the bounds of this thread's first segment in it
  int b0 = 0;
  if (t < n_tiles) {
    first = tile_seg[t];
    last = tile_seg[t + 1];
    if (first + tid <= last) {
      a0 = voff[first + tid];
      b0 = voff[first + tid + 1];
    }
  }
  for (int i = tid; i < 2 * n_sum; i += kCountThreads) s_sum[i] = sum_in[i];
  if (tid < 2) s_bits[tid][kTileWords] = 0u;
  __syncthreads();
  // tile 0 runs even with no row, to store its empty segments
  for (int buf = 0; t < n_tiles && (t == 0 || t * kTile < end);
       t += gridDim.x, buf ^= 1) {
    const int t0 = t * kTile;
    const int t1 = end - t0 < kTile ? end : t0 + kTile;
    unsigned* bits = s_bits[buf];
    int* pre = s_pre[buf];
    const unsigned f =
        dense_test<kCountLoads>(s_sum, words, n_key, 5 + g, keys.q);
    // the next tile's keys, range and first bounds, while this one counts
    const int tn = t + gridDim.x;
    keys.load(ks, tn, n_tiles, end, n_key);
    int first_n = 0;
    int last_n = -1;
    if (tn < n_tiles) {
      first_n = tile_seg[tn];
      last_n = tile_seg[tn + 1];
    }
#pragma unroll
    for (int i = 0; i < kCountLoads; ++i) {
      unsigned x = ((f >> (4 * i)) & 15u) << (4 * (lane & 7));
      x |= __shfl_xor_sync(kFull, x, 1);
      x |= __shfl_xor_sync(kFull, x, 2);
      x |= __shfl_xor_sync(kFull, x, 4);
      if ((lane & 7) == 0) bits[(i * kCountThreads + tid) >> 3] = x;
    }
    __syncthreads();
    if (tid < 32) {  // the exclusive prefix popcount, one warp
      constexpr int kPer = kTileWords / 32;
      int c[kPer];
      int s = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        c[j] = __popc(bits[lane * kPer + j]);
        s += c[j];
      }
      int incl = s;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      int run = incl - s;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        pre[lane * kPer + j] = run;
        run += c[j];
      }
      if (lane == 31) pre[kTileWords] = incl;
    }
    __syncthreads();
    for (int v = first + tid; v <= last; v += kCountThreads) {
      const int a = v == first + tid ? a0 : voff[v];
      const int b = v == first + tid ? b0 : voff[v + 1];
      const int lo = max(a, t0) - t0;
      const int hi = min(b, t1) - t0;
      if (a >= t0 && b <= t1) {
        counts[v] = lo < hi ? tile_rank(bits, pre, hi) -
                                  tile_rank(bits, pre, lo)
                            : 0;
      } else if (lo < hi) {
        const int c = tile_rank(bits, pre, hi) - tile_rank(bits, pre, lo);
        if (c) atomicAdd(counts + v, c);
      }
    }
    first = first_n;
    last = last_n;
    if (first + tid <= last) {
      a0 = voff[first + tid];
      b0 = voff[first + tid + 1];
    }
  }
}

// The partition plane's sharded k-hop merge, one launch a hop on the
// mesh's first device (no TPU kernel of its own: the JAX package's
// shard_map body merges with a pmax collective, then ANDs and ANDNOTs in
// jnp).  Each mesh entry's expansion (rt_expand_words) wrote its partial
// words over the value space into row p of partial [n_parts][n_words];
// the hop's frontier is
//   nxt[w] = (OR over p of partial[p][w]) & fw[w] & ~vis_words[w],
// written with its summary (the bit (w >> g) of sum set when word w is
// not 0, every summary word written, so no buffer needs zeroing), its
// int32 plane, the visited words and plane updated, and its popcount
// added into *size (zeroed by the seed launch).
//
// A warp per summary word s: its words are [32 s << g, 32 (s + 1) << g),
// taken 32 at a time (lane l reads word 32 j + l of them: coalesced loads
// of every partial row, fw and the visited words), so the warp's 32
// summary bits come from one OR across it.  The 32 words of a step then
// write their 1024 plane entries a word at a time, the word broadcast by
// a shuffle and lane l writing entry l (128-byte stores).  Bound: bytes
// -- n_parts + 2 words read and 2 written a frontier word, 4 bytes
// written a plane entry; a simple kernel, not tuned.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
merge_hop_kernel(const unsigned* __restrict__ partial, int n_parts,
                 int n_words, int n, const unsigned* __restrict__ fw,
                 unsigned* __restrict__ vis_words, int* __restrict__ visited,
                 unsigned* __restrict__ out_words, unsigned* __restrict__ sum,
                 int n_sum, int g, int* __restrict__ plane,
                 int* __restrict__ size) {
  const int s = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= n_sum) return;  // the whole warp
  const long long base = static_cast<long long>(s) << (5 + g);
  unsigned groups = 0u;  // bit b: a word of group 32 s + b is not 0
  int count = 0;
  for (int j = 0; j < (1 << g); ++j) {
    const long long w0 = base + 32LL * j;
    if (w0 >= n_words) break;  // the whole warp
    const long long w = w0 + lane;
    unsigned nxt = 0u;
    if (w < n_words) {
      unsigned x = 0u;
      for (int p = 0; p < n_parts; ++p) {
        x |= __ldg(partial + static_cast<size_t>(p) * n_words + w);
      }
      const unsigned vis = vis_words[w];
      nxt = x & __ldg(fw + w) & ~vis;
      out_words[w] = nxt;
      if (nxt) {
        vis_words[w] = vis | nxt;
        groups |= 1u << ((32 * j + lane) >> g);
        count += __popc(nxt);
      }
    }
    for (int b = 0; b < 32; ++b) {
      const unsigned word = __shfl_sync(kFull, nxt, b);
      const long long v = ((w0 + b) << 5) + lane;
      if (v < n) {
        const int bit = static_cast<int>((word >> lane) & 1u);
        plane[v] = bit;
        if (bit) visited[v] = 1;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    groups |= __shfl_xor_sync(kFull, groups, o);
    count += __shfl_xor_sync(kFull, count, o);
  }
  if (lane == 0) {
    sum[s] = groups;
    if (count) atomicAdd(size, count);
  }
}

int blocks_for(long long items) {
  return static_cast<int>((items + kThreads - 1) / kThreads);
}

// The persistent grids' size: as many blocks of a kernel as the card's
// SMs hold at once.  The occupancy query is host work, so its answer is
// kept per kernel (kId), device and dynamic shared size, in a few slots,
// not asked every launch.
constexpr int kMaxDevices = 64;
constexpr int kSlots = 4;

template <int kId, typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t dyn) {
  static std::atomic<unsigned long long> cache[kMaxDevices][kSlots];
  int dev = 0;
  cudaGetDevice(&dev);
  // an entry is (dyn + 1) << 32 | blocks; 0 is no entry yet
  const unsigned long long tag = static_cast<unsigned long long>(dyn) + 1;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) {
    for (const auto& slot : cache[dev]) {
      const unsigned long long c = slot.load(std::memory_order_relaxed);
      if ((c >> 32) == tag) return static_cast<int>(c & 0xFFFFFFFFu);
    }
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                dyn);
  const int blocks = std::max(1, sms * per_sm);
  if (cached) {
    cache[dev][(dyn / sizeof(unsigned)) % kSlots].store(
        tag << 32 | static_cast<unsigned>(blocks), std::memory_order_relaxed);
  }
  return blocks;
}

template <Mode kMode>
int launch_hop(const int* ks, const int* voff, int n, int n_words,
               const int* frontier, const int* sum_in, int n_key,
               int n_sum_in, int g_in, int* sum_out, int g_out,
               int* sum_clear, int* vis_words, int* visited, const int* fw,
               int* out_words, int* plane, int* size, void* stream) {
  const size_t dyn = sizeof(unsigned) * static_cast<size_t>(n_sum_in);
  const int blocks = std::min(
      (n_words + kHopThreads / 32 - 1) / (kHopThreads / 32),
      persistent_blocks<kMode>(hop_kernel<kMode>, kHopThreads, dyn));
  hop_kernel<kMode><<<blocks, kHopThreads, dyn,
                      static_cast<cudaStream_t>(stream)>>>(
      ks, voff, n, n_words, reinterpret_cast<const unsigned*>(frontier),
      reinterpret_cast<const unsigned*>(sum_in), n_key, n_sum_in, g_in,
      reinterpret_cast<unsigned*>(sum_out), g_out,
      reinterpret_cast<unsigned*>(sum_clear),
      reinterpret_cast<unsigned*>(vis_words), visited,
      reinterpret_cast<const unsigned*>(fw),
      reinterpret_cast<unsigned*>(out_words), plane, size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// #5's and #6's seeds.  g: the summary's bit (w >> g) covers frontier
// words w; visited, vis_words and sizes may be null (then hops is 0).
extern "C" int rt_seed_words(const int* seeds, int n_seeds, int n,
                             int* visited, int* words, int* vis_words,
                             int* sum, int g, int* sizes, int hops,
                             void* stream) {
  const int items = std::max(n_seeds, hops);
  if (items > 0) {
    seed_kernel<<<blocks_for(items), kThreads, 0,
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
  return launch_hop<kKhopHop>(ks, voff, n, (n + 31) / 32, frontier, sum_in,
                              n, n_sum, g, sum_out, g, sum_clear, vis_words,
                              visited, fw, out_words, plane, size, stream);
}

// #6, one expansion of the chain: the frontier's words and summary over
// the key space [0, n_key) (n_sum words, 2^g_in words a bit) ->
// out_words [n_words] over the value space [0, n).  Expansion A passes
// plane (int32[n]) and sum_out (2^g_out words a bit, zeroed by the
// caller) and no fw; expansion B passes fw, whose words AND the output,
// and neither plane nor sum_out.
extern "C" int rt_expand_words(const int* ks, const int* voff, int n,
                               int n_words, const int* frontier,
                               const int* sum_in, int n_key, int n_sum,
                               int g_in, int* sum_out, int g_out,
                               const int* fw, int* out_words, int* plane,
                               void* stream) {
  if (n_words <= 0) return static_cast<int>(cudaGetLastError());
  if (plane != nullptr) {
    return launch_hop<kChainMid>(ks, voff, n, n_words, frontier, sum_in,
                                 n_key, n_sum, g_in, sum_out, g_out, nullptr,
                                 nullptr, nullptr, nullptr, out_words, plane,
                                 nullptr, stream);
  }
  return launch_hop<kChainOut>(ks, voff, n, n_words, frontier, sum_in, n_key,
                               n_sum, g_in, nullptr, 0, nullptr, nullptr,
                               nullptr, fw, out_words, nullptr, nullptr,
                               stream);
}

// The sharded k-hop's merge of one hop (merge_hop_kernel): partial
// [n_parts][n_words], fw and vis_words [n_words], visited and plane [n],
// out_words [n_words], sum [n_sum] (2^g words a bit), size [1].
extern "C" int rt_merge_hop(const int* partial, int n_parts, int n_words,
                            int n, const int* fw, int* vis_words,
                            int* visited, int* out_words, int* sum,
                            int n_sum, int g, int* plane, int* size,
                            void* stream) {
  if (n_words <= 0 || n_sum <= 0) return static_cast<int>(cudaGetLastError());
  const long long threads = 32LL * n_sum;
  merge_hop_kernel<<<static_cast<int>((threads + kMergeThreads - 1) /
                                      kMergeThreads),
                     kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const unsigned*>(partial), n_parts, n_words, n,
      reinterpret_cast<const unsigned*>(fw),
      reinterpret_cast<unsigned*>(vis_words), visited,
      reinterpret_cast<unsigned*>(out_words),
      reinterpret_cast<unsigned*>(sum), n_sum, g, plane, size);
  return static_cast<int>(cudaGetLastError());
}

// #7's first launch: words [ceil(n_key / 32)] written, the summary table
// (2 * n_sum words, 2^g words an entry) ORed into (zeroed by the caller),
// tile_seg [n_tiles + 1] written and the counts of its segments zeroed.
// starts and ends are sorted, as they came (the kernel normalises them).
extern "C" int rt_interval_words(const int* starts, int n_starts,
                                 const int* ends, int n_ends, int n_key,
                                 int* words, int* sum, int g,
                                 const int* voff, int n, int* tile_seg,
                                 int n_tiles, int* counts, void* stream) {
  const long long items = std::max(static_cast<long long>(n_key + 31) / 32,
                                   32 * (static_cast<long long>(n_tiles) + 1));
  interval_words_kernel<<<blocks_for(items), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      starts, n_starts, ends, n_ends, n_key,
      reinterpret_cast<unsigned*>(words), reinterpret_cast<unsigned*>(sum),
      g, voff, n, tile_seg, n_tiles, counts);
  return static_cast<int>(cudaGetLastError());
}

// #7's second launch over n_tiles >= 1 tiles of `tile` rows (which must be
// the kernel's kTile).
extern "C" int rt_count_tiles(const int* ks, const int* voff, int n,
                              const int* tile_seg, int n_tiles, int tile,
                              const int* words, const int* sum, int n_sum,
                              int g, int n_key, int* counts, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t dyn = 2 * sizeof(unsigned) * static_cast<size_t>(n_sum);
  const int blocks = std::min(
      n_tiles, persistent_blocks<3>(count_tiles_kernel, kCountThreads, dyn));
  count_tiles_kernel<<<blocks, kCountThreads, dyn,
                       static_cast<cudaStream_t>(stream)>>>(
      ks, voff, n, tile_seg, n_tiles, reinterpret_cast<const unsigned*>(words),
      reinterpret_cast<const unsigned*>(sum), n_sum, g, n_key, counts);
  return static_cast<int>(cudaGetLastError());
}
