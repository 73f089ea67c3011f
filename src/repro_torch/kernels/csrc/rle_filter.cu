// rle_to_bitmap: one RLE label column -> the bitmap of the rows where the
// label equals `want` (paper §5.1).
//
// Replaces the TPU kernel rle_to_bitmap_pallas
// (src/repro/kernels/rle_filter/kernel.py:40, pallas_call at :47, body
// _rle_kernel at :22).  Inputs: positions int32[n_pos], the column's
// interval position list padded with the row count (sorted); meta int32[3]
// = (first_value, want, count).  Bit lane l lies in run
// upper_bound(positions, l) - 1 (searchsorted side="right"; -1 before
// positions[0] flips the first value), its value is first_value ^ (run & 1),
// and the bit is (value == want) && l < count.  Words past the count are
// 0; a position at or past 32 * n_words touches no word.
//
// Bound on the H100: bytes.  The kernel must read the 4 * n_pos bytes of
// positions and the meta once and write 4 * n_words bytes of words, over
// 3.35 TB/s; the work, one toggle per position and a few word operations
// per output word, is far below that at the card's 67 T/s non-tensor
// 32-bit rate.  On a sparse list (a clustered label) the words alone are
// the bytes, and the kernel's time is its launch.
//
// Design: toggle and scan, a block per range of 32 * kThreads lanes (a word
// a thread, 256 threads).  Warps 0 and 1 find the block's slice of the list
// with two warp-wide 32-ary searches at once (cond.cuh's
// rt::warp_upper_bound, shared with kernel 3); the count before the slice
// gives the parity at its first lane.  Each thread then takes 16
// consecutive positions of the slice (four 16-byte loads, issued together)
// and XORs each position's lane bit into a 128-lane window of registers
// that starts at its first position's word; the window's words go to a
// word array in shared memory by atomicXor, where the threads that share a
// word meet.  Equal positions (the padding copies of the count) cancel by
// parity on their own.  A thread whose positions reach past its window or
// the slice's ends takes them one by one.  Each thread then turns its word
// of toggles into parities with a five-step shift-XOR prefix, and a ballot
// over the words' parities plus one exchange of warp parities carries the
// parity across the block.  The positions are read once, coalesced, and
// the words written once, with no atomics in device memory.  What is left
// is the search's round trips before the slice's loads, and the
// shared-memory atomics (tools/rle_select_forms.py times the forms this was
// chosen from, and stamps each block's phases).
#include <cuda_runtime.h>

#include <cstdint>

#include "cond.cuh"

namespace {

using rt::kAllLanes;
constexpr int kPer = 16;  // consecutive positions a thread takes a pass

// Entries [g, g + 4) of pos[0, n), n >= 1, read with no branch, so that a
// thread's loads all issue before any returns: one 16-byte load when kVec
// (pos 16-byte aligned and n a multiple of 4; g a multiple of 4), else four
// 4-byte loads; an entry past n reads pos[n - 1] (or the last 4) in its
// place, which the callers never use.
template <bool kVec>
__device__ __forceinline__ int4 load_four(const int* __restrict__ pos,
                                          int n, int g) {
  if (kVec) return __ldg(reinterpret_cast<const int4*>(pos + min(g, n - 4)));
  return make_int4(__ldg(pos + min(g, n - 1)), __ldg(pos + min(g + 1, n - 1)),
                   __ldg(pos + min(g + 2, n - 1)),
                   __ldg(pos + min(g + 3, n - 1)));
}

// Thread `threadIdx.x`'s kPer consecutive positions from base that lie in
// the slice [lo, hi) toggle their lanes' bits in `toggles` (word
// (p - first_lane) >> 5; every position of the slice lies in the block's
// lanes).  A thread whose kPer positions all lie in the slice and in 4
// words XORs them into a window of 4 words (128 lanes in two 64-bit
// registers) from the word of its first one, then XORs the window's words
// into `toggles`; the threads at the slice's ends, and those whose
// positions spread wider, take them one by one.  Neighbouring threads meet
// in a word, so the XORs into `toggles` are atomicXor.  Returns true if
// the thread's positions reach hi.
template <bool kVec>
__device__ __forceinline__ bool toggle_pass(const int* __restrict__ pos,
                                           int n_pos, int base, int lo,
                                           int hi, int first_lane,
                                           unsigned* toggles) {
  const int g0 = base + kPer * threadIdx.x;
  if (g0 >= hi || g0 + kPer <= lo) return g0 + kPer >= hi;
  int v[kPer];
#pragma unroll
  for (int u = 0; u < kPer / 4; ++u) {
    const int4 q = load_four<kVec>(pos, n_pos, g0 + 4 * u);
    v[4 * u] = q.x - first_lane;
    v[4 * u + 1] = q.y - first_lane;
    v[4 * u + 2] = q.z - first_lane;
    v[4 * u + 3] = q.w - first_lane;
  }
  const int w0 = v[0] >> 5;
  if (g0 >= lo && g0 + kPer <= hi && v[kPer - 1] - 32 * w0 < 128) {
    unsigned long long low = 0ull, high = 0ull;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = v[e] - 32 * w0;
      const unsigned long long bit = 1ull << (idx & 63);
      low ^= idx < 64 ? bit : 0ull;
      high ^= idx < 64 ? 0ull : bit;
    }
    const unsigned part[4] = {static_cast<unsigned>(low),
                              static_cast<unsigned>(low >> 32),
                              static_cast<unsigned>(high),
                              static_cast<unsigned>(high >> 32)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (part[k]) atomicXor(&toggles[w0 + k], part[k]);
    }
    return g0 + kPer >= hi;
  }
  // one by one: the positions of a word XORed first
  int word = 0;
  unsigned acc = 0u;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = g0 + e;
    if (i >= lo && i < hi) {
      if ((v[e] >> 5) != word) {
        if (acc) atomicXor(&toggles[word], acc);
        word = v[e] >> 5;
        acc = 0u;
      }
      acc ^= 1u << (v[e] & 31);
    }
  }
  if (acc) atomicXor(&toggles[word], acc);
  return g0 + kPer >= hi;
}

template <int kThreads, bool kVec>
__global__ void __launch_bounds__(kThreads)
rle_to_bitmap_kernel(const int* __restrict__ pos, int n_pos,
                     const int* __restrict__ meta,
                     unsigned* __restrict__ words, int n_words) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kLanes = 32 * kThreads;  // bit lanes of one block
  __shared__ unsigned toggles[kThreads];
  __shared__ int bounds[2];
  __shared__ unsigned warp_odd[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first_value = meta[0];
  const int want = meta[1];
  const int count = meta[2];
  const int first_lane = blockIdx.x * kLanes;
  const int end_lane = static_cast<int>(
      min(static_cast<long long>(first_lane) + kLanes, 32LL * n_words));
  toggles[threadIdx.x] = 0u;
  // the positions before the slice's first lane (warp 0) and before its
  // end (warp 1)
  if (warp < 2) {
    const int ub = rt::warp_upper_bound(
        pos, n_pos, (warp == 0 ? first_lane : end_lane) - 1);
    if (lane == 0) bounds[warp] = ub;
  }
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];
  if (lo < hi) {
    for (int base = lo & ~3;; base += kPer * kThreads) {
      const bool last = toggle_pass<kVec>(pos, n_pos, base, lo, hi,
                                          first_lane, toggles);
      if (__syncthreads_or(last)) break;
    }
  }
  const unsigned raw = toggles[threadIdx.x];
  unsigned x = raw;  // bit b: parity of the word's toggles at bits <= b
  x ^= x << 1;
  x ^= x << 2;
  x ^= x << 4;
  x ^= x << 8;
  x ^= x << 16;
  const unsigned odd_words = __ballot_sync(kAllLanes, __popc(raw) & 1u);
  if (lane == 0) warp_odd[warp] = __popc(odd_words) & 1u;
  __syncthreads();
  // the parity of the positions before the word's first lane
  unsigned carry = (lo & 1) ^ (__popc(odd_words & ((1u << lane) - 1u)) & 1u);
#pragma unroll
  for (int k = 0; k < kWarps; ++k) carry ^= k < warp ? warp_odd[k] : 0u;
  // bit b of `run_odd`: run & 1 at the lane, with run the count - 1
  const unsigned run_odd = ~((carry ? kAllLanes : 0u) ^ x);
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w < n_words) {
    words[w] = rt::leaf_word(run_odd, first_value, want) &
               rt::lanes_below(w << 5, count);
  }
}

template <int kThreads>
int rle_launch(const int* pos, int n_pos, const int* meta, int* words,
               int n_words, cudaStream_t stream) {
  if (n_words > 0) {
    const int blocks = (n_words + kThreads - 1) / kThreads;
    unsigned* out = reinterpret_cast<unsigned*>(words);
    if (reinterpret_cast<uintptr_t>(pos) % 16 == 0 && n_pos % 4 == 0) {
      rle_to_bitmap_kernel<kThreads, true><<<blocks, kThreads, 0, stream>>>(
          pos, n_pos, meta, out, n_words);
    } else {
      rle_to_bitmap_kernel<kThreads, false><<<blocks, kThreads, 0, stream>>>(
          pos, n_pos, meta, out, n_words);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_rle_to_bitmap(const int* pos, int n_pos, const int* meta,
                                int* words, int n_words, void* stream) {
  return rle_launch<256>(pos, n_pos, meta, words, n_words,
                         static_cast<cudaStream_t>(stream));
}
