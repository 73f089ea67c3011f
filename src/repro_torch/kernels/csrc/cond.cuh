// The label-predicate interpreter shared by cond_bitmap.cu and the
// filtered per-dispatch retrieval (per_dispatch.cu), and the RLE leaf
// evaluated a word at a time (rle_word, for rle_filter.cu).
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

__device__ __forceinline__ bool eval_cond(const int* __restrict__ pos,
                                          const int* __restrict__ meta,
                                          int n_pos,
                                          const int* __restrict__ ops,
                                          int n_ops, int lane) {
  unsigned long long stack = 0;
  for (int o = 0; o < n_ops; ++o) {
    const int op = ops[o];
    if (op >= 0) {
      const int* row = pos + static_cast<size_t>(op) * n_pos;
      const int run = upper_bound(row, n_pos, lane) - 1;
      const unsigned long long leaf = (meta[2 * op] ^ (run & 1)) == 1;
      stack = (stack << 1) | leaf;
    } else if (op == kOpNot) {
      stack ^= 1ull;
    } else {
      const unsigned long long b = stack & 1ull;
      const unsigned long long a = (stack >> 1) & 1ull;
      stack = ((stack >> 2) << 1) | (op == kOpAnd ? (a & b) : (a | b));
    }
  }
  return (stack & 1ull) && lane < meta[1];
}

}  // namespace rt
