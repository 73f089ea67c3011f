// The label-predicate interpreter of the filtered per-dispatch retrieval
// (run_program, for per_dispatch.cu), and the RLE leaf evaluated a word at
// a time (rle_word, for rle_filter.cu).  The word-wide pieces at the end
// (leaf_word, lanes_below, WordStack, apply_word_op) run the same program
// on whole 32-lane words (cond_bitmap.cu).
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

// Word w of an RLE leaf's bitmap: bit b is set when lane 32 * w + b is
// below count and its value, first_value ^ (run & 1), equals want.  One
// search finds the run of the word's first lane; the walk then crosses the
// run boundaries that fall inside the word's 32 lanes.
__device__ __forceinline__ unsigned rle_word(const int* __restrict__ pos,
                                             int n_pos, int first_value,
                                             int count, int want, int w) {
  const int lane0 = w << 5;
  int lo = upper_bound(pos, n_pos, lane0);  // run = lo - 1
  unsigned out = 0u;
  for (int b = 0; b < 32; ++b) {
    const int lane = lane0 + b;
    if (lane >= count) break;
    while (lo < n_pos && pos[lo] <= lane) ++lo;
    if ((first_value ^ ((lo - 1) & 1)) == want) out |= 1u << b;
  }
  return out;
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


constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// A leaf's 32 bits from the parity of its lanes' runs (bit b of `odd`:
// run & 1 at lane b): first_value ^ (run & 1) == 1, as eval_cond reads
// it, for any first_value.
__device__ __forceinline__ unsigned leaf_word(unsigned odd, int first_value) {
  const unsigned if_even = first_value == 1 ? kAllLanes : 0u;
  const unsigned if_odd = first_value == 0 ? kAllLanes : 0u;
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
