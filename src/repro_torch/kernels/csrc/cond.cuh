// The label-predicate interpreter shared by cond_bitmap.cu and the
// filtered per-dispatch retrieval (per_dispatch.cu).
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
