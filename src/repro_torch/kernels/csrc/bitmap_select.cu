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
// lane's value in (an unselected value need not be read), 4 * page_size
// bytes of values and 4 of count out, per page.  The output, mostly zeros
// where few lanes are selected, is nearly all of it.
//
// Design: a block of 64 threads walks a page in tiles of 1024 lanes, a
// thread owning 16 consecutive lanes.  It reads their 16 bits once and
// each 16-byte group of 4 values only where one of its 4 bits is set.
// Five ballots of its count's bits give its slot inside the warp, and the
// warps' totals in shared memory (one barrier) the rest.  The selected
// values are compacted into a stage in shared memory behind the 0-3 values
// of the last partial 16-byte group of the tile before, and every full
// group goes out as a coalesced 16-byte store; after the page's last tile
// the partial group, zero-padded, and the zeros to the row's end go out
// the same way.  A page larger than a tile takes several tiles with that
// carry, so any page size runs in the same kernel and the same 4 KB of
// shared memory.  The grid is persistent (as many blocks as the SMs hold
// at once, pages strided over them: 2,367 pages of 2048 all at once on an
// H100), and each block keeps its next tile's value loads and the tile
// after's word loads in flight while it compacts the current tile.  (The
// block sizes and lanes a thread this was chosen from run side by side in
// tools/rle_select_forms.py.)
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

template <bool kVec>
__device__ __forceinline__ int4 load_quad(const int* __restrict__ v) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const int4*>(v));
  } else {
    return make_int4(__ldg(v), __ldg(v + 1), __ldg(v + 2), __ldg(v + 3));
  }
}

// The bits of thread `mine`'s 4 * kQuads consecutive lanes of tile t0 of
// page p (none past the batch or the page).
template <int kQuads>
__device__ __forceinline__ unsigned load_bits(
    const unsigned* __restrict__ words, int n, int page_size, int p, int t0,
    int mine) {
  static_assert(kQuads == 1 || kQuads == 2 || kQuads == 4,
                "a thread's lanes lie in one word");
  const int l = t0 + mine;
  if (p >= n || l >= page_size) return 0u;
  const unsigned w =
      __ldg(words + static_cast<size_t>(p) * (page_size >> 5) + (l >> 5));
  return (w >> (l & 31)) & ((1u << (4 * kQuads)) - 1u);
}

// Their values: for each group of 4 lanes with a bit set, the 4 values.
template <int kQuads, bool kVec>
struct Lanes {
  unsigned bits;
  int4 v[kQuads];

  __device__ __forceinline__ void load(const int* __restrict__ vals,
                                       int page_size, int p, int t0,
                                       int mine, unsigned b) {
    bits = b;
    const int* at = vals + static_cast<size_t>(p) * page_size + t0 + mine;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      v[q] = (b >> (4 * q)) & 0xFu ? load_quad<kVec>(at + 4 * q)
                                   : make_int4(0, 0, 0, 0);
    }
  }
};

template <int kThreads, int kQuads, bool kVec>
__global__ void __launch_bounds__(kThreads)
bitmap_select_kernel(const int* __restrict__ vals,
                     const unsigned* __restrict__ words, int n, int page_size,
                     int* __restrict__ out, int* __restrict__ counts) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kLanes = 4 * kQuads;        // lanes of one thread
  constexpr int kTile = kLanes * kThreads;  // lanes of one tile
  __shared__ __align__(16) int stage[kTile + 4];
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int mine = kLanes * threadIdx.x;  // the thread's first lane

  // the block's tiles in order: page blockIdx.x + k * gridDim.x, tile by
  // tile.  While a tile is compacted, the next tile's values and the bits
  // of the one after are in flight.
  auto advance = [&](int& p, int& t0) {
    t0 += kTile;
    if (t0 >= page_size) {
      t0 = 0;
      p += gridDim.x;
    }
  };
  int p = blockIdx.x, t0 = 0;
  Lanes<kQuads, kVec> cur;
  cur.load(vals, page_size, p, t0, mine,
           load_bits<kQuads>(words, n, page_size, p, t0, mine));
  int q = p, s0 = t0;
  advance(q, s0);
  unsigned bits_q = load_bits<kQuads>(words, n, page_size, q, s0, mine);
  int c = 0;                   // values of the page before this tile
  int h0 = 0, h1 = 0, h2 = 0;  // out[c & ~3, c), not stored yet
  while (p < n) {
    int r = q, r0 = s0;
    advance(r, r0);
    Lanes<kQuads, kVec> nxt;
    nxt.load(vals, page_size, q, s0, mine, bits_q);
    const unsigned bits_r = load_bits<kQuads>(words, n, page_size, r, r0,
                                              mine);
    // the thread's slot: ballots of its count's bits, then the warps'
    // totals
    const int k = __popc(cur.bits);
    int slot = 0;
#pragma unroll
    for (int b = 0; (1 << b) <= kLanes; ++b) {
      slot += __popc(__ballot_sync(kFull, (k >> b) & 1) & below) << b;
    }
    if (lane == 31) warp_total[warp] = slot + k;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int s = warp_total[i];
      slot += i < warp ? s : 0;
      total += s;
    }
    const int head = c & 3;
    if (threadIdx.x < head) {
      stage[threadIdx.x] =
          threadIdx.x == 0 ? h0 : (threadIdx.x == 1 ? h1 : h2);
    }
    slot += head;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const unsigned nib = cur.bits >> (4 * i);
      if (nib & 1u) stage[slot++] = cur.v[i].x;
      if (nib & 2u) stage[slot++] = cur.v[i].y;
      if (nib & 4u) stage[slot++] = cur.v[i].z;
      if (nib & 8u) stage[slot++] = cur.v[i].w;
    }
    __syncthreads();
    // the stage's full groups are out[(c & ~3) + 4 g, ...]
    const int full = (head + total) >> 2;
    int4* row = reinterpret_cast<int4*>(out + static_cast<size_t>(p) *
                                                  page_size);
    const int4* staged = reinterpret_cast<const int4*>(stage);
    for (int g = threadIdx.x; g < full; g += kThreads) {
      row[(c >> 2) + g] = staged[g];
    }
    h0 = stage[4 * full];
    h1 = stage[4 * full + 1];
    h2 = stage[4 * full + 2];
    c += total;
    if (s0 == 0) {
      // the page's last tile: the partial group zero-padded, then zeros
      const int g0 = c >> 2;
      const int tail = c & 3;
      for (int g = g0 + threadIdx.x; g < (page_size >> 2); g += kThreads) {
        int4 z = make_int4(0, 0, 0, 0);
        if (g == g0) {
          z.x = tail > 0 ? h0 : 0;
          z.y = tail > 1 ? h1 : 0;
          z.z = tail > 2 ? h2 : 0;
        }
        row[g] = z;
      }
      if (threadIdx.x == 0) counts[p] = c;
      c = 0;
    }
    p = q;
    t0 = s0;
    cur = nxt;
    q = r;
    s0 = r0;
    bits_q = bits_r;
  }
}

// The persistent grid: as many blocks as the card's SMs hold at once.  The
// occupancy query is host work, so its answer is kept per kernel and
// device, not asked every launch.
constexpr int kMaxDevices = 64;

template <int kThreads, int kQuads, bool kVec>
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
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bitmap_select_kernel<kThreads, kQuads, kVec>, kThreads, 0);
  const int blocks = std::max(1, sms * per_sm);
  if (cached) cache[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

// vals at any 4-byte offset (16-byte loads where it is aligned); out, which
// the wrapper allocates, 16-byte aligned.
template <int kThreads, int kQuads>
int select_launch(const int* vals, const int* words, int n, int page_size,
                  int* out, int* counts, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned* w = reinterpret_cast<const unsigned*>(words);
  if (reinterpret_cast<uintptr_t>(vals) % 16 == 0) {
    const int blocks =
        std::min(n, persistent_blocks<kThreads, kQuads, true>());
    bitmap_select_kernel<kThreads, kQuads, true>
        <<<blocks, kThreads, 0, stream>>>(vals, w, n, page_size, out, counts);
  } else {
    const int blocks =
        std::min(n, persistent_blocks<kThreads, kQuads, false>());
    bitmap_select_kernel<kThreads, kQuads, false>
        <<<blocks, kThreads, 0, stream>>>(vals, w, n, page_size, out, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_bitmap_select(const int* vals, const int* words, int n,
                                int page_size, int* out, int* counts,
                                void* stream) {
  return select_launch<64, 4>(vals, words, n, page_size, out, counts,
                              static_cast<cudaStream_t>(stream));
}
