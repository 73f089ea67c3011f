// The forms of kernel 13 (rle_to_bitmap) and the block sizes of kernel 14
// (bitmap_select), for timing side by side with tools/rle_select_forms.py.
// The port's own kernels are in src/repro_torch/kernels/csrc/rle_filter.cu
// and bitmap_select.cu, which keep the forms that these timings chose; this
// file includes both, so forms C and S below are their code at other block
// sizes.
//
// Kernel 13:
//   form 0 (A)   a thread per output word: a binary search in device memory
//                for the run of the word's first lane, then a walk over the
//                run boundaries inside the word (the port's kernel 13 before
//                its redesign);
//   form 1 (B)   kernel 3's block slice with one leaf: two warp-wide 32-ary
//                searches for the block's slice, the slice staged into
//                shared memory in chunks of 2048 positions, a binary search
//                there for each word's first boundary, a flip per boundary
//                (odd ^= ~0u << (p - lane0)) and `want` applied to the leaf;
//   form 4 (B2)  B with the slice staged in one round of 16-byte loads, each
//                word's first boundary found by a binary search there and a
//                flip per position; form 5 (B2~) B2 with C1~'s search;
//   form 2 (C1)  toggle and scan: the block's slice found by two warp-wide
//                searches, each thread's 16 consecutive positions XORed into
//                a word array in shared memory one by one (a position's
//                word compared with the last, an atomicXor when it
//                changes), then a shift-XOR prefix in each word and a block
//                scan of the words' parities;
//   form 3 (C1~) C1 with each search's first step probing a bracket around
//                the index that the positions' spread predicts;
//   form 6 (C1') C1 with one search, for the slice's start: the passes stop
//                at the first position past the slice's end;
//   form 8 (D)   blocks by position index, no search: each block stages its
//                positions and writes the words whose count falls in its
//                range, a binary search and a walk in shared memory a word;
//   form 9 (C)   rle_filter.cu's kernel: C1 with a thread's 16 positions
//                XORed into a 128-lane window of registers, written by up
//                to 4 atomicXors a thread;
//   form 11 (Cp) C with two word arrays by the lane's parity, so that most
//                of a window's words are plain stores.
// `threads` is the block size (a word a thread in B2, C1 and C).
// Kernel 14: bitmap_select.cu's kernel with blocks of `threads` threads,
// each owning 4 * `quads` lanes of a tile.
// forms_rle_stamped runs B and C with each block's timing stamps (the
// global timer at its start and end, the SM's clock at its phases).
//
// Build (the script does): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas=-v
//   -I src/repro_torch/kernels/csrc tools/rle_select_forms.cu -o lib.so
#include "bitmap_select.cu"
#include "rle_filter.cu"

namespace forms {

// ---- form C: toggle and scan (with its searches: kTwoSearches, kGuessed,
// kOneSearch) ----
constexpr int kTwoSearches = 0, kGuessed = 1, kOneSearch = 2;

constexpr int kSpan = 4096;  // half the guessed bracket, in entries

// The number of entries of the sorted pos[0, n) that are <= x, found by a
// warp: the first step probes 32 entries spread over a bracket of
// 2 * kSpan entries around n * x / lanes (the list's positions spread over
// [0, lanes)), which shrinks the range to the bracket's 1/31 where the
// guess holds, and to one side of it where it does not; rt::warp_upper_bound's
// steps go on from there.
__device__ __forceinline__ int guessed_upper_bound(const int* __restrict__ pos,
                                                   int n, int x,
                                                   long long lanes) {
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(n) * max(x, 0) / lanes;
  const int a = static_cast<int>(min(max(g - kSpan, 0LL),
                                     static_cast<long long>(n)));
  const int b = static_cast<int>(min(g + kSpan, static_cast<long long>(n)));
  const int idx = a - 1 + (lane * (b - a)) / 31;  // a - 1 ... b - 1
  const bool le = idx < 0 || pos[idx] <= x;
  const int t = __popc(__ballot_sync(kAllLanes, le));
  const int below = __shfl_sync(kAllLanes, idx, t > 0 ? t - 1 : 0);
  const int above = __shfl_sync(kAllLanes, idx, t < 32 ? t : 31);
  // rt::warp_upper_bound's steps from the bracket [lo, hi]
  int lo = t > 0 ? below + 1 : 0;
  int hi = t < 32 ? above : n;
  while (lo < hi) {
    const long long m = hi - lo;
    const int i = lo + static_cast<int>((m * (lane + 1)) >> 5) - 1;
    const int s = __popc(__ballot_sync(kAllLanes, i < lo || pos[i] <= x));
    const int sb = __shfl_sync(kAllLanes, i, s > 0 ? s - 1 : 0);
    const int sa = __shfl_sync(kAllLanes, i, s < 32 ? s : 31);
    lo = s > 0 ? sb + 1 : lo;
    hi = s < 32 ? sa : hi;
  }
  return lo;
}

// Thread `threadIdx.x`'s kPer consecutive positions from base (four
// 16-byte loads, all issued before any is used) that lie in [lo, hi) and
// below end_lane toggle their lanes' bits in `toggles` (word
// (p - first_lane) >> 5): the positions that share a word are XORed in a
// register, then one shared-memory atomicXor a word.  Returns true if one
// of the thread's positions lies at or past end_lane, or past hi.
template <int kThreads, bool kVec>
__device__ __forceinline__ bool toggle_pass(const int* __restrict__ pos,
                                           int n_pos, int base, int lo,
                                           int hi, int first_lane,
                                           int end_lane, unsigned* toggles) {
  const int g0 = base + kPer * threadIdx.x;
  int v[kPer];
#pragma unroll
  for (int u = 0; u < kPer / 4; ++u) {
    const int4 q = load_four<kVec>(pos, n_pos, g0 + 4 * u);
    v[4 * u] = q.x;
    v[4 * u + 1] = q.y;
    v[4 * u + 2] = q.z;
    v[4 * u + 3] = q.w;
  }
  bool past = g0 + kPer > hi;
  int word = 0;
  unsigned acc = 0u;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = g0 + e;
    if (i >= lo && i < hi) {
      if (v[e] >= end_lane) {
        past = true;
        continue;
      }
      const int r = v[e] - first_lane;  // in [0, kLanes)
      if ((r >> 5) != word) {
        if (acc) atomicXor(&toggles[word], acc);
        word = r >> 5;
        acc = 0u;
      }
      acc ^= 1u << (r & 31);
    }
  }
  if (acc) atomicXor(&toggles[word], acc);
  return past;
}

template <int kThreads, int kSearch, bool kVec>
__global__ void __launch_bounds__(kThreads)
toggle_kernel(const int* __restrict__ pos, int n_pos,
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
  // end (warp 1; kOneSearch: the passes stop at the first position past
  // the end instead)
  if (warp < (kSearch == kOneSearch ? 1 : 2)) {
    const int x = (warp == 0 ? first_lane : end_lane) - 1;
    const int ub = kSearch == kGuessed
                       ? guessed_upper_bound(pos, n_pos, x, 32LL * n_words)
                       : rt::warp_upper_bound(pos, n_pos, x);
    if (lane == 0) bounds[warp] = ub;
  }
  __syncthreads();
  const int lo = bounds[0];
  const int hi = kSearch == kOneSearch ? n_pos : bounds[1];
  if (lo < hi) {
    for (int base = lo & ~3;; base += kPer * kThreads) {
      const bool past = toggle_pass<kThreads, kVec>(
          pos, n_pos, base, lo, hi, first_lane, end_lane, toggles);
      if (__syncthreads_or(past)) break;
    }
  }
  __syncthreads();
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

template <int kThreads, int kSearch>
int toggle_launch(const int* pos, int n_pos, const int* meta, int* words,
               int n_words, cudaStream_t stream) {
  if (n_words > 0) {
    const int blocks = (n_words + kThreads - 1) / kThreads;
    unsigned* out = reinterpret_cast<unsigned*>(words);
    if (reinterpret_cast<uintptr_t>(pos) % 16 == 0 && n_pos % 4 == 0) {
      toggle_kernel<kThreads, kSearch, true>
          <<<blocks, kThreads, 0, stream>>>(pos, n_pos, meta, out, n_words);
    } else {
      toggle_kernel<kThreads, kSearch, false>
          <<<blocks, kThreads, 0, stream>>>(pos, n_pos, meta, out, n_words);
    }
  }
  return static_cast<int>(cudaGetLastError());
}



constexpr int kThreads = 256;
constexpr int kLanes = 32 * kThreads;
constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kThreads)
thread_word_kernel(const int* __restrict__ pos, int n_pos,
                   const int* __restrict__ meta, unsigned* __restrict__ words,
                   int n_words) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_words) return;
  const int first_value = meta[0], want = meta[1], count = meta[2];
  const int lane0 = w << 5;
  int lo = rt::upper_bound(pos, n_pos, lane0);  // run = lo - 1
  unsigned out = 0u;
  for (int b = 0; b < 32; ++b) {
    const int lane = lane0 + b;
    if (lane >= count) break;
    while (lo < n_pos && pos[lo] <= lane) ++lo;
    if ((first_value ^ ((lo - 1) & 1)) == want) out |= 1u << b;
  }
  words[w] = out;
}

__global__ void __launch_bounds__(kThreads)
block_slice_kernel(const int* __restrict__ pos, int n_pos,
                   const int* __restrict__ meta, unsigned* __restrict__ words,
                   int n_words) {
  __shared__ int bounds[2];
  __shared__ int chunk[kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first_lane = blockIdx.x * kLanes;
  const int last_lane = static_cast<int>(
      min(static_cast<long long>(first_lane) + kLanes, 32LL * n_words) - 1);
  if (warp < 2) {
    const int ub = rt::warp_upper_bound(pos, n_pos,
                                        warp ? last_lane : first_lane);
    if (lane == 0) bounds[warp] = ub;
  }
  __syncthreads();
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const bool in = w < n_words;
  const int lane0 = in ? w << 5 : 0;
  const int lo = bounds[0];
  const int hi = bounds[1];
  int cnt = lo;  // positions <= lane0
  unsigned flips = 0u;
  for (int c = lo; c < hi; c += kChunk) {
    const int m = min(kChunk, hi - c);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) chunk[i] = pos[c + i];
    __syncthreads();
    if (in) {
      int j = rt::upper_bound(chunk, m, lane0);
      cnt += j;
      while (j < m && chunk[j] <= lane0 + 31) {
        const int p = chunk[j];
        int e = j + 1;
        if (e < m && chunk[e] == p) {
          e = j + rt::upper_bound(chunk + j, m - j, p);
        }
        if ((e - j) & 1) flips ^= rt::kAllLanes << (p - lane0);
        j = e;
      }
    }
  }
  const unsigned odd = (((cnt - 1) & 1) ? rt::kAllLanes : 0u) ^ flips;
  if (in) {
    words[w] = rt::leaf_word(odd, meta[0], meta[1]) &
               rt::lanes_below(lane0, meta[2]);
  }
}

// ---- form Cp: C with two word arrays by the lane's parity, plain stores
// where no thread of the same parity can share the word ----

// The word array's word w ^= x, by atomicXor where another thread may
// write the same word of the same array in the same pass.
__device__ __forceinline__ void put(unsigned* toggles, int w, unsigned x,
                                    bool shared) {
  if (x == 0u) return;
  if (shared) {
    atomicXor(&toggles[w], x);
  } else {
    toggles[w] ^= x;
  }
}

// Thread `threadIdx.x`'s kPer consecutive positions from base that lie in
// the slice [lo, hi) toggle their lanes' bits in the word arrays
// toggles[0] and toggles[1] (word (p - first_lane) >> 5 of their XOR;
// every position of the slice lies in the block's lanes).  A thread whose
// kPer positions all lie in the slice and in 4 words XORs them into a
// window of 4 words (128 lanes in two 64-bit registers) from the word of
// its first one, and writes the window to the array of its lane's parity.
// Two threads beside each other meet in one word at most, and there they
// use different arrays; two threads of one parity meet only through a
// thread between them whose positions lie in one word.  So those words are
// plain stores, except a thread's first word when the thread before it may
// have one word (or is in another warp), its last word when the thread
// after it may, and all of them when it has one word itself: those are
// atomicXor.  The threads at the slice's ends, and those whose positions
// spread wider, take them one by one, by atomicXor.  Returns true if the
// thread's positions reach hi.
template <int kThreads, bool kVec>
__device__ __forceinline__ bool parity_pass(const int* __restrict__ pos,
                                           int n_pos, int base, int lo,
                                           int hi, int first_lane,
                                           unsigned (*toggles)[kThreads]) {
  const int lane = threadIdx.x & 31;
  const int g0 = base + kPer * threadIdx.x;
  const bool active = g0 < hi && g0 + kPer > lo;
  int head = 0;  // the words of the thread's first and last positions
  int tail = -1;
  unsigned part[4] = {0u, 0u, 0u, 0u};  // the window, word head + k
  if (g0 >= lo && g0 + kPer <= hi) {
    int v[kPer];
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
      const int4 q = load_four<kVec>(pos, n_pos, g0 + 4 * u);
      v[4 * u] = q.x - first_lane;
      v[4 * u + 1] = q.y - first_lane;
      v[4 * u + 2] = q.z - first_lane;
      v[4 * u + 3] = q.w - first_lane;
    }
    head = v[0] >> 5;
    tail = v[kPer - 1] >> 5;
    if (tail - head < 4) {
      unsigned long long low = 0ull, high = 0ull;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int idx = v[e] - 32 * head;
        const unsigned long long bit = 1ull << (idx & 63);
        low ^= idx < 64 ? bit : 0ull;
        high ^= idx < 64 ? 0ull : bit;
      }
      part[0] = static_cast<unsigned>(low);
      part[1] = static_cast<unsigned>(low >> 32);
      part[2] = static_cast<unsigned>(high);
      part[3] = static_cast<unsigned>(high >> 32);
    }
  }
  const bool window = tail - head >= 0 && tail - head < 4;
  // a thread that may have one word: one by one, or a window of one word
  const bool narrow = active && (!window || tail == head);
  const bool narrow_before = __shfl_up_sync(kAllLanes, narrow, 1);
  const bool narrow_after = __shfl_down_sync(kAllLanes, narrow, 1);
  unsigned* mine = toggles[lane & 1];
  if (window) {
    const bool first_shared = narrow || lane == 0 || narrow_before;
    const bool last_shared = narrow || lane == 31 || narrow_after;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k <= tail - head) {
        put(mine, head + k, part[k],
            (k == 0 && first_shared) || (k == tail - head && last_shared));
      }
    }
  } else if (active) {
    // one by one: the positions of a word XORed first
    int word = 0;
    unsigned acc = 0u;
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
      const int4 q = load_four<kVec>(pos, n_pos, g0 + 4 * u);
      const int r[4] = {q.x - first_lane, q.y - first_lane,
                        q.z - first_lane, q.w - first_lane};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g0 + 4 * u + e;
        if (i >= lo && i < hi) {
          if ((r[e] >> 5) != word) {
            put(mine, word, acc, true);
            word = r[e] >> 5;
            acc = 0u;
          }
          acc ^= 1u << (r[e] & 31);
        }
      }
    }
    put(mine, word, acc, true);
  }
  return g0 + kPer >= hi;
}

template <int kThreads, bool kVec>
__global__ void __launch_bounds__(kThreads, 1280 / kThreads)
parity_kernel(const int* __restrict__ pos, int n_pos,
                     const int* __restrict__ meta,
                     unsigned* __restrict__ words, int n_words) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kLanes = 32 * kThreads;  // bit lanes of one block
  __shared__ unsigned toggles[2][kThreads];  // by the lane's parity
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
  toggles[0][threadIdx.x] = 0u;
  toggles[1][threadIdx.x] = 0u;
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
      const bool last = parity_pass<kThreads, kVec>(pos, n_pos, base, lo,
                                                    hi, first_lane, toggles);
      if (__syncthreads_or(last)) break;
    }
  }
  const unsigned raw = toggles[0][threadIdx.x] ^ toggles[1][threadIdx.x];
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

// ---- form D: blocks by position index, no search ----

// The words a block writes: those whose first lane's count of positions,
// # positions < 32 w, lies in its index range [i0, i1).  They run from the
// word after the one of pos[i0 - 1] (0 for the first block) to the one of
// pos[i1 - 1] (n_words for the last block), clamped to [0, n_words].
__device__ __forceinline__ int word_after(int p, int n_words) {
  return min(max(p >> 5, -1), n_words - 1) + 1;
}

// The first index in [j, m) of the sorted staged[0, m) whose entry is >= x,
// given that every entry before j is below x.
__device__ __forceinline__ int first_at_least(const int* staged, int j, int m,
                                              long long x) {
  if (j >= m || staged[j] >= x) return j;
  return j + rt::upper_bound(staged + j, m - j,
                             static_cast<int>(min(x, 1LL << 31) - 1));
}

// Word w's bits, with j the first staged index whose position is >= 32 w:
// # positions < 32 w is s0 + j, and each position inside the word below
// the count flips the parity of its lane and the lanes after it (equal
// positions by the parity of their number).  A word whose positions run
// past the staged entries reads the rest from pos.
__device__ __forceinline__ unsigned word_bits(
    const int* __restrict__ pos, int n_pos, const int* staged, int s0, int m,
    int j, int w, int first_value, int want, int count) {
  const int lane0 = w << 5;
  const int limit = static_cast<int>(min(static_cast<long long>(lane0) + 32,
                                         static_cast<long long>(count)));
  unsigned flips = 0u;
  int k = j;
  while (k < m && staged[k] < limit) {
    const int p = staged[k];
    int e = k + 1;
    if (e < m && staged[e] == p) e = k + rt::upper_bound(staged + k, m - k, p);
    if ((e - k) & 1) flips ^= kAllLanes << (p - lane0);
    k = e;
  }
  for (int g = s0 + k; k == m && g < n_pos && pos[g] < limit; ++g) {
    flips ^= kAllLanes << (pos[g] - lane0);
  }
  const unsigned run_odd = ~((((s0 + j) & 1) ? kAllLanes : 0u) ^ flips);
  return rt::leaf_word(run_odd, first_value, want) &
         rt::lanes_below(lane0, count);
}

template <int kThreads, bool kVec>
__global__ void __launch_bounds__(kThreads)
index_kernel(const int* __restrict__ pos, int n_pos,
                     const int* __restrict__ meta,
                     unsigned* __restrict__ words, int n_words,
                     int per_block) {
  constexpr int kStage = kPer * kThreads;
  __shared__ __align__(16) int staged[kStage];
  const int i0 = blockIdx.x * per_block;  // a multiple of 4
  const int i1 = min(i0 + per_block, n_pos);
  const int s0 = max(i0 - 4, 0);
  const int m = min(kStage, n_pos - s0);
  // stage pos[s0, s0 + m): the block's positions, the 4 before them and
  // up to 60 after them, one round of 16-byte loads
  int4 q[kPer / 4] = {};
#pragma unroll
  for (int u = 0; u < kPer / 4; ++u) {
    if (n_pos > 0) {
      q[u] = load_four<kVec>(pos, n_pos, s0 + kPer * threadIdx.x + 4 * u);
    }
  }
#pragma unroll
  for (int u = 0; u < kPer / 4; ++u) {
    reinterpret_cast<int4*>(staged)[(kPer / 4) * threadIdx.x + u] = q[u];
  }
  const int first_value = meta[0];
  const int want = meta[1];
  const int count = meta[2];
  __syncthreads();
  const int wa = i0 == 0 ? 0 : word_after(staged[i0 - 1 - s0], n_words);
  const int wb = i1 == n_pos ? n_words
                             : word_after(staged[i1 - 1 - s0], n_words);
  int j = 0;  // every staged entry before j lies below the thread's lanes
  if (wb - wa <= 4 * kThreads) {
    for (int w = wa + threadIdx.x; w < wb; w += kThreads) {
      j = first_at_least(staged, j, m, static_cast<long long>(w) << 5);
      words[w] = word_bits(pos, n_pos, staged, s0, m, j, w, first_value,
                           want, count);
    }
    return;
  }
  // a long range (few positions over many words): 4 words a thread, and
  // one 16-byte store where no position falls in them
  for (int w0 = (wa & ~3) + 4 * threadIdx.x; w0 < wb; w0 += 4 * kThreads) {
    const long long lane0 = static_cast<long long>(w0) << 5;
    j = first_at_least(staged, j, m, lane0);
    if (w0 >= wa && w0 + 4 <= wb && lane0 + 128 <= count &&
        (j == m || staged[j] >= lane0 + 128)) {
      const unsigned x = rt::leaf_word(((s0 + j) & 1) ? 0u : kAllLanes,
                                       first_value, want);
      reinterpret_cast<uint4*>(words)[w0 >> 2] = make_uint4(x, x, x, x);
      continue;
    }
    for (int w = max(w0, wa); w < min(w0 + 4, wb); ++w) {
      const int jw = first_at_least(staged, j, m, static_cast<long long>(w)
                                                      << 5);
      words[w] = word_bits(pos, n_pos, staged, s0, m, jw, w, first_value,
                           want, count);
    }
  }
}

template <int kThreads>
int index_launch(const int* pos, int n_pos, const int* meta, int* words,
               int n_words, cudaStream_t stream) {
  if (n_words <= 0) return static_cast<int>(cudaGetLastError());
  // positions a block: as many as spread the words over blocks of
  // kThreads words, a multiple of 4, at least 4 and at most the stage
  // less the 64 entries around them
  constexpr int kMax = kPer * kThreads - 64;
  const long long even = (static_cast<long long>(n_pos) * kThreads +
                          4LL * n_words - 1) / (4LL * n_words) * 4;
  const int per_block = static_cast<int>(std::min<long long>(
      std::max<long long>(even, 4), kMax));
  const int blocks = std::max(1, (n_pos + per_block - 1) / per_block);
  unsigned* out = reinterpret_cast<unsigned*>(words);
  if (reinterpret_cast<uintptr_t>(pos) % 16 == 0 && n_pos % 4 == 0) {
    index_kernel<kThreads, true><<<blocks, kThreads, 0, stream>>>(
        pos, n_pos, meta, out, n_words, per_block);
  } else {
    index_kernel<kThreads, false><<<blocks, kThreads, 0, stream>>>(
        pos, n_pos, meta, out, n_words, per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

// form 4 (B2): B with the slice staged in one round (16 consecutive
// positions a thread by 16-byte loads) and no search of the duplicates:
// each thread finds its word's first boundary by a binary search in the
// staged slice and flips once per position, so equal positions cancel.
template <int kT, bool kGuess, bool kVec>
__global__ void __launch_bounds__(kT)
staged_words_kernel(const int* __restrict__ pos, int n_pos,
                    const int* __restrict__ meta,
                    unsigned* __restrict__ words, int n_words) {
  constexpr int kChunkB = kPer * kT;
  __shared__ __align__(16) int chunk[kChunkB];
  __shared__ int bounds[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first_value = meta[0];
  const int want = meta[1];
  const int count = meta[2];
  const int first_lane = blockIdx.x * 32 * kT;
  const int end_lane = static_cast<int>(
      min(static_cast<long long>(first_lane) + 32 * kT, 32LL * n_words));
  if (warp < 2) {
    const int x = (warp == 0 ? first_lane : end_lane) - 1;
    const int ub = kGuess ? guessed_upper_bound(pos, n_pos, x, 32LL * n_words)
                          : rt::warp_upper_bound(pos, n_pos, x);
    if (lane == 0) bounds[warp] = ub;
  }
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];
  const int w = blockIdx.x * kT + threadIdx.x;
  const int lane0 = w << 5;
  int cnt = lo;  // positions <= lane0
  unsigned flips = 0u;
  for (int c = lo; c < hi;) {
    const int a = c & ~3;
    const int m = min(kChunkB - (c - a), hi - c);
    int4 q[kPer / 4];
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
      q[u] = load_four<kVec>(pos, n_pos, a + kPer * threadIdx.x + 4 * u);
    }
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
      reinterpret_cast<int4*>(chunk)[(kPer / 4) * threadIdx.x + u] = q[u];
    }
    __syncthreads();
    const int* row = chunk + (c - a);
    int j = rt::upper_bound(row, m, lane0);
    cnt += j;
    for (; j < m && row[j] <= lane0 + 31; ++j) {
      flips ^= rt::kAllLanes << (row[j] - lane0);
    }
    c += m;
    __syncthreads();
  }
  if (w < n_words) {
    const unsigned odd = (((cnt - 1) & 1) ? rt::kAllLanes : 0u) ^ flips;
    words[w] = rt::leaf_word(odd, first_value, want) &
               rt::lanes_below(lane0, count);
  }
}

// Timing stamps of one block, written by thread 0: the global timer at
// the start and the end (ns), and the SM's clock at the start, after the
// search, after the slice (toggled, or staged and walked) and at the end.
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Form C1 (two warp searches), stamped.
template <int kT, bool kVec>
__global__ void __launch_bounds__(kT)
stamped_toggle_kernel(const int* __restrict__ pos, int n_pos,
                      const int* __restrict__ meta,
                      unsigned* __restrict__ words, int n_words,
                      long long* __restrict__ stamps) {
  const long long g0 = global_ns();
  const long long c0 = clock64();
  constexpr int kWarps = kT / 32;
  __shared__ unsigned toggles[kT];
  __shared__ int bounds[2];
  __shared__ unsigned warp_odd[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first_value = meta[0];
  const int want = meta[1];
  const int count = meta[2];
  const int first_lane = blockIdx.x * 32 * kT;
  const int end_lane = static_cast<int>(
      min(static_cast<long long>(first_lane) + 32 * kT, 32LL * n_words));
  toggles[threadIdx.x] = 0u;
  if (warp < 2) {
    const int ub = rt::warp_upper_bound(
        pos, n_pos, (warp == 0 ? first_lane : end_lane) - 1);
    if (lane == 0) bounds[warp] = ub;
  }
  __syncthreads();
  const long long c1 = clock64();
  const int lo = bounds[0];
  const int hi = bounds[1];
  if (lo < hi) {
    for (int base = lo & ~3;; base += kPer * kT) {
      const bool past = toggle_pass<kT, kVec>(pos, n_pos, base, lo, hi,
                                              first_lane, end_lane, toggles);
      if (__syncthreads_or(past)) break;
    }
  }
  __syncthreads();
  const long long c2 = clock64();
  const unsigned raw = toggles[threadIdx.x];
  unsigned x = raw;
  x ^= x << 1;
  x ^= x << 2;
  x ^= x << 4;
  x ^= x << 8;
  x ^= x << 16;
  const unsigned odd_words = __ballot_sync(rt::kAllLanes, __popc(raw) & 1u);
  if (lane == 0) warp_odd[warp] = __popc(odd_words) & 1u;
  __syncthreads();
  unsigned carry = (lo & 1) ^ (__popc(odd_words & ((1u << lane) - 1u)) & 1u);
  for (int k = 0; k < kWarps; ++k) carry ^= k < warp ? warp_odd[k] : 0u;
  const unsigned run_odd = ~((carry ? rt::kAllLanes : 0u) ^ x);
  const int w = blockIdx.x * kT + threadIdx.x;
  if (w < n_words) {
    words[w] = rt::leaf_word(run_odd, first_value, want) &
               rt::lanes_below(w << 5, count);
  }
  if (threadIdx.x == 0) {
    long long* st = stamps + 6 * blockIdx.x;
    st[0] = g0;
    st[1] = global_ns();
    st[2] = c0;
    st[3] = c1;
    st[4] = c2;
    st[5] = clock64();
  }
}

// Form B (kernel 3's block slice, one leaf), stamped.
__global__ void __launch_bounds__(kThreads)
stamped_slice_kernel(const int* __restrict__ pos, int n_pos,
                     const int* __restrict__ meta,
                     unsigned* __restrict__ words, int n_words,
                     long long* __restrict__ stamps) {
  const long long g0 = global_ns();
  const long long c0 = clock64();
  __shared__ int bounds[2];
  __shared__ int chunk[kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first_lane = blockIdx.x * kLanes;
  const int last_lane = static_cast<int>(
      min(static_cast<long long>(first_lane) + kLanes, 32LL * n_words) - 1);
  if (warp < 2) {
    const int ub = rt::warp_upper_bound(pos, n_pos,
                                        warp ? last_lane : first_lane);
    if (lane == 0) bounds[warp] = ub;
  }
  __syncthreads();
  const long long c1 = clock64();
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const bool in = w < n_words;
  const int lane0 = in ? w << 5 : 0;
  const int lo = bounds[0];
  const int hi = bounds[1];
  int cnt = lo;
  unsigned flips = 0u;
  for (int c = lo; c < hi; c += kChunk) {
    const int m = min(kChunk, hi - c);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) chunk[i] = pos[c + i];
    __syncthreads();
    if (in) {
      int j = rt::upper_bound(chunk, m, lane0);
      cnt += j;
      while (j < m && chunk[j] <= lane0 + 31) {
        const int p = chunk[j];
        int e = j + 1;
        if (e < m && chunk[e] == p) {
          e = j + rt::upper_bound(chunk + j, m - j, p);
        }
        if ((e - j) & 1) flips ^= rt::kAllLanes << (p - lane0);
        j = e;
      }
    }
  }
  __syncthreads();
  const long long c2 = clock64();
  const unsigned odd = (((cnt - 1) & 1) ? rt::kAllLanes : 0u) ^ flips;
  if (in) {
    words[w] = rt::leaf_word(odd, meta[0], meta[1]) &
               rt::lanes_below(lane0, meta[2]);
  }
  if (threadIdx.x == 0) {
    long long* st = stamps + 6 * blockIdx.x;
    st[0] = g0;
    st[1] = global_ns();
    st[2] = c0;
    st[3] = c1;
    st[4] = c2;
    st[5] = clock64();
  }
}

// Form D at 128 threads, stamped: the SM's
// clock at the start, once staged (the "search" slot) and after the
// words, every thread done (the "slice" slot).
__global__ void __launch_bounds__(128)
stamped_index_kernel(const int* __restrict__ pos, int n_pos,
                     const int* __restrict__ meta,
                     unsigned* __restrict__ words, int n_words, int per_block,
                     long long* __restrict__ stamps) {
  constexpr int kT = 128;
  constexpr int kStage = kPer * kT;
  const long long g0 = global_ns();
  const long long c0 = clock64();
  __shared__ __align__(16) int staged[kStage];
  const int i0 = blockIdx.x * per_block;
  const int i1 = min(i0 + per_block, n_pos);
  const int s0 = max(i0 - 4, 0);
  const int m = min(kStage, n_pos - s0);
  int4 q[kPer / 4];
#pragma unroll
  for (int u = 0; u < kPer / 4; ++u) {
    q[u] = load_four<true>(pos, n_pos, s0 + kPer * threadIdx.x + 4 * u);
  }
#pragma unroll
  for (int u = 0; u < kPer / 4; ++u) {
    reinterpret_cast<int4*>(staged)[(kPer / 4) * threadIdx.x + u] = q[u];
  }
  const int first_value = meta[0];
  const int want = meta[1];
  const int count = meta[2];
  __syncthreads();
  const long long c1 = clock64();
  const int wa = i0 == 0 ? 0 : word_after(staged[i0 - 1 - s0], n_words);
  const int wb = i1 == n_pos ? n_words
                             : word_after(staged[i1 - 1 - s0], n_words);
  int j = 0;
  for (int w = wa + threadIdx.x; w < wb; w += kT) {
    j = first_at_least(staged, j, m, static_cast<long long>(w) << 5);
    words[w] = word_bits(pos, n_pos, staged, s0, m, j, w, first_value, want,
                         count);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long* st = stamps + 6 * blockIdx.x;
    st[0] = g0;
    st[1] = global_ns();
    st[2] = c0;
    st[3] = c1;
    st[4] = clock64();
    st[5] = st[4];
  }
}

// Form C (rle_filter.cu's kernel at 128 threads), stamped.  With kPlain,
// a yardstick and not a form: its window's words are stored with no
// atomic, so a word two threads share keeps one of their parts.
template <bool kPlain>
__global__ void __launch_bounds__(128)
stamped_window_kernel(const int* __restrict__ pos, int n_pos,
                      const int* __restrict__ meta,
                      unsigned* __restrict__ words, int n_words,
                      long long* __restrict__ stamps) {
  constexpr int kT = 128;
  const long long g0 = global_ns();
  const long long c0 = clock64();
  __shared__ unsigned toggles[kT];
  __shared__ int bounds[2];
  __shared__ unsigned warp_odd[kT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first_value = meta[0];
  const int want = meta[1];
  const int count = meta[2];
  const int first_lane = blockIdx.x * 32 * kT;
  const int end_lane = static_cast<int>(
      min(static_cast<long long>(first_lane) + 32 * kT, 32LL * n_words));
  toggles[threadIdx.x] = 0u;
  if (warp < 2) {
    const int ub = rt::warp_upper_bound(
        pos, n_pos, (warp == 0 ? first_lane : end_lane) - 1);
    if (lane == 0) bounds[warp] = ub;
  }
  __syncthreads();
  const long long c1 = clock64();
  const int lo = bounds[0];
  const int hi = bounds[1];
  if (lo < hi) {
    for (int base = lo & ~3;; base += kPer * kT) {
      bool last;
      if (kPlain) {
        const int gs = base + kPer * threadIdx.x;
        last = gs + kPer >= hi;
        if (gs < hi && gs + kPer > lo) {
          int v[kPer];
#pragma unroll
          for (int u = 0; u < kPer / 4; ++u) {
            const int4 q = load_four<true>(pos, n_pos, gs + 4 * u);
            v[4 * u] = q.x - first_lane;
            v[4 * u + 1] = q.y - first_lane;
            v[4 * u + 2] = q.z - first_lane;
            v[4 * u + 3] = q.w - first_lane;
          }
          const int w0 = max(v[0] >> 5, 0);
          unsigned long long low = 0ull, high = 0ull;
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const int idx = (v[e] - 32 * w0) & 127;
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
            if (part[k] && w0 + k < kT) toggles[w0 + k] = part[k];
          }
        }
      } else {
        last = ::toggle_pass<true>(pos, n_pos, base, lo, hi, first_lane,
                                   toggles);
      }
      if (__syncthreads_or(last)) break;
    }
  }
  const long long c2 = clock64();
  const unsigned raw = toggles[threadIdx.x];
  unsigned x = raw;
  x ^= x << 1;
  x ^= x << 2;
  x ^= x << 4;
  x ^= x << 8;
  x ^= x << 16;
  const unsigned odd_words = __ballot_sync(rt::kAllLanes, __popc(raw) & 1u);
  if (lane == 0) warp_odd[warp] = __popc(odd_words) & 1u;
  __syncthreads();
  unsigned carry = (lo & 1) ^ (__popc(odd_words & ((1u << lane) - 1u)) & 1u);
  for (int k = 0; k < kT / 32; ++k) carry ^= k < warp ? warp_odd[k] : 0u;
  const unsigned run_odd = ~((carry ? rt::kAllLanes : 0u) ^ x);
  const int w = blockIdx.x * kT + threadIdx.x;
  if (w < n_words) {
    words[w] = rt::leaf_word(run_odd, first_value, want) &
               rt::lanes_below(w << 5, count);
  }
  if (threadIdx.x == 0) {
    long long* st = stamps + 6 * blockIdx.x;
    st[0] = g0;
    st[1] = global_ns();
    st[2] = c0;
    st[3] = c1;
    st[4] = c2;
    st[5] = clock64();
  }
}

// A yardstick, not a form: each block reads its share of the positions as
// form D does (kPer consecutive entries a thread, 16-byte loads, no
// search) and writes one word a thread; the time of reading the list.
template <int kT>
__global__ void __launch_bounds__(kT)
read_only_kernel(const int* __restrict__ pos, int n_pos,
                 unsigned* __restrict__ words, int n_words,
                 long long* __restrict__ stamps) {
  const long long g0 = global_ns();
  const long long c0 = clock64();
  const int g = (blockIdx.x * kT + threadIdx.x) * kPer;
  unsigned acc = 0u;
#pragma unroll
  for (int u = 0; u < kPer / 4; ++u) {
    const int4 q = load_four<true>(pos, n_pos, g + 4 * u);
    acc ^= q.x ^ q.y ^ q.z ^ q.w;
  }
  __syncthreads();
  const long long c1 = clock64();
  const int w = blockIdx.x * kT + threadIdx.x;
  if (w < n_words) words[w] = acc;
  if (threadIdx.x == 0) {
    long long* st = stamps + 6 * blockIdx.x;
    st[0] = g0;
    st[1] = global_ns();
    st[2] = c0;
    st[3] = c1;
    st[4] = c1;
    st[5] = clock64();
  }
}

}  // namespace forms

extern "C" int forms_rle_to_bitmap(int form, int threads, const int* pos,
                                   int n_pos, const int* meta, int* words,
                                   int n_words, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* out = reinterpret_cast<unsigned*>(words);
  const int blocks = (n_words + forms::kThreads - 1) / forms::kThreads;
  if (n_words <= 0) return static_cast<int>(cudaGetLastError());
  if (form == 0) {
    forms::thread_word_kernel<<<blocks, forms::kThreads, 0, s>>>(
        pos, n_pos, meta, out, n_words);
    return static_cast<int>(cudaGetLastError());
  }
  if (form == 1) {
    forms::block_slice_kernel<<<blocks, forms::kThreads, 0, s>>>(
        pos, n_pos, meta, out, n_words);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = reinterpret_cast<uintptr_t>(pos) % 16 == 0 &&
                   n_pos % 4 == 0;
#define FORMS_RLE(T)                                                          \
  if (threads == T && (form == 4 || form == 5)) {                             \
    const int nb = (n_words + T - 1) / T;                                     \
    if (form == 5 && vec) {                                                   \
      forms::staged_words_kernel<T, true, true><<<nb, T, 0, s>>>(             \
          pos, n_pos, meta, out, n_words);                                    \
    } else if (form == 5) {                                                   \
      forms::staged_words_kernel<T, true, false><<<nb, T, 0, s>>>(            \
          pos, n_pos, meta, out, n_words);                                    \
    } else if (vec) {                                                         \
      forms::staged_words_kernel<T, false, true><<<nb, T, 0, s>>>(            \
          pos, n_pos, meta, out, n_words);                                    \
    } else {                                                                  \
      forms::staged_words_kernel<T, false, false><<<nb, T, 0, s>>>(           \
          pos, n_pos, meta, out, n_words);                                    \
    }                                                                         \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  if (threads == T && form == 2) {                                            \
    return forms::toggle_launch<T, forms::kTwoSearches>(pos, n_pos, meta,     \
                                                        words, n_words, s);   \
  }                                                                           \
  if (threads == T && form == 3) {                                            \
    return forms::toggle_launch<T, forms::kGuessed>(pos, n_pos, meta, words,  \
                                                    n_words, s);              \
  }                                                                           \
  if (threads == T && form == 6) {                                            \
    return forms::toggle_launch<T, forms::kOneSearch>(pos, n_pos, meta,       \
                                                      words, n_words, s);     \
  }                                                                           \
  if (threads == T && form == 8) {                                            \
    return forms::index_launch<T>(pos, n_pos, meta, words, n_words, s);       \
  }                                                                           \
  if (threads == T && form == 11) {                                           \
    const int nb = (n_words + T - 1) / T;                                     \
    if (vec) {                                                                \
      forms::parity_kernel<T, true><<<nb, T, 0, s>>>(pos, n_pos, meta, out,   \
                                                     n_words);                \
    } else {                                                                  \
      forms::parity_kernel<T, false><<<nb, T, 0, s>>>(pos, n_pos, meta, out,  \
                                                      n_words);               \
    }                                                                         \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  if (threads == T && form == 9) {                                            \
    return rle_launch<T>(pos, n_pos, meta, words, n_words, s);                \
  }
  FORMS_RLE(64)
  FORMS_RLE(128)
  FORMS_RLE(256)
#undef FORMS_RLE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int forms_bitmap_select(int threads, int quads, const int* vals,
                                   const int* words, int n, int page_size,
                                   int* out, int* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FORMS_SELECT(T, Q)                                             \
  if (threads == T && quads == Q) {                                    \
    return select_launch<T, Q>(vals, words, n, page_size, out, counts, \
                               s);                                     \
  }
  FORMS_SELECT(32, 4)
  FORMS_SELECT(64, 1)
  FORMS_SELECT(64, 2)
  FORMS_SELECT(64, 4)
  FORMS_SELECT(128, 2)
  FORMS_SELECT(128, 4)
  FORMS_SELECT(256, 1)
#undef FORMS_SELECT
  return static_cast<int>(cudaErrorInvalidValue);
}

// form 0 stamps form B; 2 form C1 at 128 threads, 3 at 256, 4 at 128 with
// 4-byte loads; 8 form D at 128; 9 form C at 128; 7 and 10 the yardsticks
// (reading alone, and C with plain stores; their words are no bitmap).
// The stamps hold 6 values a block.
extern "C" int forms_rle_stamped(int form, const int* pos, int n_pos,
                                 const int* meta, int* words, int n_words,
                                 long long* stamps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* out = reinterpret_cast<unsigned*>(words);
  if (form == 0) {
    forms::stamped_slice_kernel<<<(n_words + 255) / 256, 256, 0, s>>>(
        pos, n_pos, meta, out, n_words, stamps);
  } else if (form == 2) {
    forms::stamped_toggle_kernel<128, true>
        <<<(n_words + 127) / 128, 128, 0, s>>>(pos, n_pos, meta, out,
                                              n_words, stamps);
  } else if (form == 3) {
    forms::stamped_toggle_kernel<256, true>
        <<<(n_words + 255) / 256, 256, 0, s>>>(pos, n_pos, meta, out,
                                              n_words, stamps);
  } else if (form == 4) {
    forms::stamped_toggle_kernel<128, false>
        <<<(n_words + 127) / 128, 128, 0, s>>>(pos, n_pos, meta, out,
                                              n_words, stamps);
  } else if (form == 9 || form == 10) {
    const int blocks = (n_words + 127) / 128;
    if (form == 9) {
      forms::stamped_window_kernel<false><<<blocks, 128, 0, s>>>(
          pos, n_pos, meta, out, n_words, stamps);
    } else {
      forms::stamped_window_kernel<true><<<blocks, 128, 0, s>>>(
          pos, n_pos, meta, out, n_words, stamps);
    }
  } else if (form == 8) {
    const int per_block = static_cast<int>(std::min<long long>(
        std::max<long long>((static_cast<long long>(n_pos) * 128 +
                             4LL * n_words - 1) / (4LL * n_words) * 4, 4),
        kPer * 128 - 64));
    forms::stamped_index_kernel<<<(n_pos + per_block - 1) / per_block, 128,
                                  0, s>>>(pos, n_pos, meta, out, n_words,
                                          per_block, stamps);
  } else {
    const int blocks = (n_pos + 128 * kPer - 1) / (128 * kPer);
    forms::read_only_kernel<128><<<blocks, 128, 0, s>>>(pos, n_pos, out,
                                                        n_words, stamps);
  }
  return static_cast<int>(cudaGetLastError());
}
