// cond_bitmap: a compiled label predicate over RLE label columns -> bitmap.
//
// Replaces the TPU kernel cond_bitmap_pallas
// (src/repro/kernels/label_filter/kernel.py:79, pallas_call at :88, with
// eval_cond_bits at :44 and pack_bits at :64).  Inputs: pos int32[k, n_pos],
// each label's interval position list padded with the row count; meta
// int32[k, 2] = (first_value, count); ops, the postfix program as int32
// opcodes (i >= 0: push leaf i, -1: NOT, -2: AND, -3: OR).  For every bit
// lane, leaf i is first_value ^ (run & 1) with run = upper_bound(pos[i], lane)
// - 1 (searchsorted side="right"); the program combines the leaves, lanes
// at or past meta[0][1] are 0, and the bits pack into uint32 words.
//
// Bound on the H100: bytes.  The kernel must read pos, meta and the
// opcodes once and write 4 * n_words bytes; the work is one flip per run
// boundary and n_ops word operations per output word, 32-bit operations
// at the card's 67 T/s non-tensor rate, far below the bytes.  Writing the
// words alone (606 KB at soc-LiveJournal1 scale) takes 0.18 us, well
// under a launch, so the kernel's aim is to add little to its launch.  The
// predicate plane is built once per (filter, n_words) and reused by every
// filtered dispatch.
//
// Design: a thread per output word and a block per range of kThreads
// words.  A leaf's word needs only the parity of its run at the word's
// first lane and the run boundaries that fall inside its 32 lanes: each
// boundary p flips the parity of the lanes from p on,
// odd ^= ~0u << (p - lane0), so the word costs one flip per boundary and
// no search per lane.  The block first finds, for every label row, the
// slice of pos that falls in its lanes, two warp-wide 32-ary searches
// (cond.cuh's rt::warp_upper_bound, which kernel 13 shares; all rows at
// once, spread over the warps); for each leaf of the program
// it then stages that slice into shared memory with coalesced loads, in
// chunks of kChunk positions, so a dense list (a boundary every lane, as a
// numeric predicate over a scattered column can give) streams through the
// same loop, and each thread finds its first boundary with a binary search
// in shared memory.  The program then runs on whole words (NOT, AND, OR of
// 32 lanes at once) over a stack of words: in registers up to 8 deep, in
// local memory up to 64 (the wrapper passes the program's depth).
#include <cuda_runtime.h>

#include "cond.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32 * kThreads;  // bit lanes of one block
constexpr int kChunk = 2048;           // positions staged at a time
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int kDepth>
__global__ void __launch_bounds__(kThreads)
cond_words_kernel(const int* __restrict__ pos, const int* __restrict__ meta,
                  int k, int n_pos, const int* __restrict__ ops, int n_ops,
                  unsigned* __restrict__ words, int n_words) {
  extern __shared__ int bounds[];  // [2 r], [2 r + 1]: row r's slice
  __shared__ int chunk[kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first_lane = blockIdx.x * kLanes;
  const int last_lane = static_cast<int>(
      min(static_cast<long long>(first_lane) + kLanes, 32LL * n_words) - 1);
  for (int q = warp; q < 2 * k; q += kWarps) {
    const int ub = rt::warp_upper_bound(
        pos + static_cast<size_t>(q >> 1) * n_pos, n_pos,
        q & 1 ? last_lane : first_lane);
    if (lane == 0) bounds[q] = ub;
  }
  __syncthreads();
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const bool in = w < n_words;
  const int lane0 = in ? w << 5 : 0;
  rt::WordStack<kDepth> st;
  for (int o = 0; o < n_ops; ++o) {
    const int op = ops[o];  // the same for every thread
    if (op < 0) {
      rt::apply_word_op(st, op);
      continue;
    }
    // leaf `op`: its positions in (first_lane, last_lane] are row[lo, hi)
    const int* row = pos + static_cast<size_t>(op) * n_pos;
    const int lo = bounds[2 * op];
    const int hi = bounds[2 * op + 1];
    int cnt = lo;  // positions <= lane0
    unsigned flips = 0u;
    for (int c = lo; c < hi; c += kChunk) {
      const int m = min(kChunk, hi - c);
      __syncthreads();  // the last chunk's readers are done
      for (int i = threadIdx.x; i < m; i += kThreads) chunk[i] = row[c + i];
      __syncthreads();
      if (in) {
        int j = rt::upper_bound(chunk, m, lane0);
        cnt += j;
        while (j < m && chunk[j] <= lane0 + 31) {
          // a run of equal positions flips by its count's parity (the
          // list's padding repeats the row count many times)
          const int p = chunk[j];
          int e = j + 1;
          if (e < m && chunk[e] == p) {
            e = j + rt::upper_bound(chunk + j, m - j, p);
          }
          if ((e - j) & 1) flips ^= kFull << (p - lane0);
          j = e;
        }
      }
    }
    // run = cnt - 1 at lane0; each boundary inside the word flips the rest
    const unsigned odd = (((cnt - 1) & 1) ? kFull : 0u) ^ flips;
    st.push(rt::leaf_word(odd, meta[2 * op]));
  }
  const unsigned out = st.pop();
  if (in) words[w] = out & rt::lanes_below(lane0, meta[1]);
}

template <int kDepth>
int cond_words_launch(const int* pos, const int* meta, int k, int n_pos,
                      const int* ops, int n_ops, int* words, int n_words,
                      cudaStream_t stream) {
  const size_t dyn = 2 * sizeof(int) * static_cast<size_t>(k);
  if (dyn > 32 * 1024) {  // past the default 48 KB with the chunk
    const cudaError_t err = cudaFuncSetAttribute(
        cond_words_kernel<kDepth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_words + kThreads - 1) / kThreads;
  cond_words_kernel<kDepth><<<blocks, kThreads, dyn, stream>>>(
      pos, meta, k, n_pos, ops, n_ops, reinterpret_cast<unsigned*>(words),
      n_words);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// depth: the program's deepest stack (at most 64, as the wrapper checks)
extern "C" int rt_cond_bitmap(const int* pos, const int* meta, int k,
                              int n_pos, const int* ops, int n_ops, int depth,
                              int* words, int n_words, void* stream) {
  if (n_words <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return depth <= 8 ? cond_words_launch<8>(pos, meta, k, n_pos, ops, n_ops,
                                           words, n_words, s)
                    : cond_words_launch<64>(pos, meta, k, n_pos, ops, n_ops,
                                            words, n_words, s);
}

// One launch of an empty kernel: the floor under every kernel's time.
extern "C" int rt_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
