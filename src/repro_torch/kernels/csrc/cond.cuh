// The label-predicate interpreter of the filtered per-dispatch retrieval
// (run_program, for per_dispatch.cu), the searches over a sorted position
// list (upper_bound, one thread; warp_upper_bound, a warp together), and
// the word-wide pieces (leaf_word, lanes_below, WordStack, apply_word_op)
// that run a program on whole 32-lane words (cond_bitmap.cu) or turn one
// RLE leaf's run parities into its bits (rle_filter.cu).
//
// pos int32[k, n_pos] holds each label's RLE interval position list,
// padded with the row count; meta int32[k, 2] = (first_value, count); ops
// is the postfix program as int32 opcodes (i >= 0: push leaf i, -1: NOT,
// -2: AND, -3: OR).  Leaf i at bit position `lane` is
// first_value ^ (run & 1) with run = upper_bound(pos[i], lane) - 1
// (searchsorted side="right"); lanes at or past meta[0][1] are false.  The
// stack is held as the bits of one 64-bit register (the wrappers refuse
// programs deeper than 64).
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kOpNot = -1;
constexpr int kOpAnd = -2;

// The number of entries of the sorted row[0, n) that are <= x
// (searchsorted side="right").
__device__ __forceinline__ int upper_bound(const int* __restrict__ row,
                                          int n, int x) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// The number of entries of the sorted row[0, n) that are <= x, found by
// the 32 lanes of a warp together: each step probes the last entry of
// each of 32 near-equal parts of [lo, hi), so the range shrinks 32-fold.
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ row,
                                                int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long m = hi - lo;
    const int idx = lo + static_cast<int>((m * (lane + 1)) >> 5) - 1;
    const bool le = idx < lo || row[idx] <= x;
    // sorted entries: the lanes that hold are a prefix
    const int t = __popc(__ballot_sync(kAllLanes, le));
    const int below = __shfl_sync(kAllLanes, idx, t > 0 ? t - 1 : 0);
    const int above = __shfl_sync(kAllLanes, idx, t < 32 ? t : 31);
    lo = t > 0 ? below + 1 : lo;
    hi = t < 32 ? above : hi;
  }
  return lo;
}

// Run the postfix program `ops` at one lane: leaf(i) gives leaf i's bit
// there (first_value ^ (run & 1) == 1), NOT, AND and OR combine the stack
// (any opcode but NOT and AND is OR), and the top of the stack is the
// result.  A thread calls leaf once for each leaf opcode, in order.
template <class Leaf>
__device__ __forceinline__ bool run_program(const int* __restrict__ ops,
                                            int n_ops, Leaf&& leaf) {
  unsigned long long stack = 0;
  for (int o = 0; o < n_ops; ++o) {
    const int op = ops[o];
    if (op >= 0) {
      stack = (stack << 1) | (leaf(op) ? 1ull : 0ull);
    } else if (op == kOpNot) {
      stack ^= 1ull;
    } else {
      const unsigned long long b = stack & 1ull;
      const unsigned long long a = (stack >> 1) & 1ull;
      stack = ((stack >> 2) << 1) | (op == kOpAnd ? (a & b) : (a | b));
    }
  }
  return stack & 1ull;
}

// A leaf's 32 bits from the parity of its lanes' runs (bit b of `odd`:
// run & 1 at lane b): first_value ^ (run & 1) == want, for any first_value
// and want (eval_cond reads a leaf with want = 1).
__device__ __forceinline__ unsigned leaf_word(unsigned odd, int first_value,
                                              int want = 1) {
  const unsigned if_even = first_value == want ? kAllLanes : 0u;
  const unsigned if_odd = (first_value ^ 1) == want ? kAllLanes : 0u;
  return (odd & if_odd) | (~odd & if_even);
}

// The lanes of the word starting at lane0 that are below count.
__device__ __forceinline__ unsigned lanes_below(int lane0, int count) {
  const long long k = static_cast<long long>(count) - lane0;
  return k >= 32 ? kAllLanes : (k <= 0 ? 0u : (1u << k) - 1u);
}

// The program's stack of predicate words.  Up to 8 deep it is a shift
// register (slot 0 the top, every index fixed at compile time, so it
// stays in registers); deeper programs index a local array.
template <int kDepth>
struct WordStack {
  unsigned slot[kDepth];
  int top = 0;

  __device__ __forceinline__ void push(unsigned x) {
    if (kDepth <= 8) {
#pragma unroll
      for (int i = kDepth - 1; i > 0; --i) slot[i] = slot[i - 1];
      slot[0] = x;
    } else {
      slot[top++] = x;
    }
  }

  __device__ __forceinline__ unsigned pop() {
    if (kDepth > 8) return slot[--top];
    const unsigned x = slot[0];
#pragma unroll
    for (int i = 0; i < kDepth - 1; ++i) slot[i] = slot[i + 1];
    return x;
  }
};

// One NOT, AND or OR of the program on whole words (op < 0; any opcode
// but NOT and AND is OR, as in eval_cond).
template <int kDepth>
__device__ __forceinline__ void apply_word_op(WordStack<kDepth>& st, int op) {
  if (op == kOpNot) {
    st.push(~st.pop());
  } else {
    const unsigned b = st.pop();
    const unsigned a = st.pop();
    st.push(op == kOpAnd ? (a & b) : (a | b));
  }
}

}  // namespace rt
