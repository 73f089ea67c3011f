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
// Bound on the H100: the bytes are few (k * n_pos * 4 read, 4 * n_words
// written); the work is n_words * 32 lanes x (one step per level of each
// leaf's binary search over n_pos positions + one per program op), counted
// as 32-bit operations at the card's 67 T/s non-tensor 32-bit rate (the
// data sheet's float32 figure).  The predicate plane is built once per
// (filter, n_words) and reused by every filtered dispatch.
//
// Design: one thread per bit lane and one warp per output word, so the 32
// lanes of a word pack with a single __ballot_sync.  The program is data,
// not generated source: each thread walks the opcode array with its stack
// held as the bits of one 64-bit register (the wrapper refuses programs
// deeper than 64).  Neighbouring lanes search the same run boundaries, so
// the binary searches hit the same cache lines.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNot = -1;
constexpr int kAnd = -2;

__global__ void __launch_bounds__(kThreads)
cond_bitmap_kernel(const int* __restrict__ pos, const int* __restrict__ meta,
                   int n_pos, const int* __restrict__ ops, int n_ops,
                   unsigned* __restrict__ words, int n_words) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int word = lane >> 5;
  if (word >= n_words) return;  // whole warps leave together
  unsigned long long stack = 0;
  for (int o = 0; o < n_ops; ++o) {
    const int op = ops[o];
    if (op >= 0) {
      const int* row = pos + static_cast<size_t>(op) * n_pos;
      int lo = 0;
      int hi = n_pos;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] <= lane) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int run = lo - 1;
      const unsigned long long leaf = (meta[2 * op] ^ (run & 1)) == 1;
      stack = (stack << 1) | leaf;
    } else if (op == kNot) {
      stack ^= 1ull;
    } else {
      const unsigned long long b = stack & 1ull;
      const unsigned long long a = (stack >> 1) & 1ull;
      stack = ((stack >> 2) << 1) | (op == kAnd ? (a & b) : (a | b));
    }
  }
  const bool bit = (stack & 1ull) && lane < meta[1];
  const unsigned w = __ballot_sync(0xFFFFFFFFu, bit);
  if ((threadIdx.x & 31) == 0) words[word] = w;
}

}  // namespace

extern "C" int rt_cond_bitmap(const int* pos, const int* meta, int n_pos,
                              const int* ops, int n_ops, int* words,
                              int n_words, void* stream) {
  if (n_words > 0) {
    const long long lanes = 32LL * n_words;
    const int blocks = static_cast<int>((lanes + kThreads - 1) / kThreads);
    cond_bitmap_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pos, meta, n_pos, ops, n_ops, reinterpret_cast<unsigned*>(words),
        n_words);
  }
  return static_cast<int>(cudaGetLastError());
}
