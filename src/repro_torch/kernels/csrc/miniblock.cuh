// The raw miniblock arrays of pages (PackedPages), read 8 deltas a thread:
// the decode of kernels 2 and 8-10 (per_dispatch.cu: the resident column's
// pages gathered by a row-index vector, and pages shipped with a dispatch)
// and of kernel 12 (single_range.cu).
//
// Delta j (j < page_size - 1) of a page lives in miniblock
// m = min(j / 32, n_mini - 1) at bit (j % 32) * bw of the miniblock's word
// region:
//   word  = packed[clamp(word_offsets[m] + bit / 32, 0, max_words - 1)]
//   delta = ((word >> bit % 32) & mask(bw)) + min_deltas[m]  if j < count - 1
//           0                                                 otherwise
// and the page decodes to first, first + inclusive_scan(delta) (int32 with
// wraparound).  The clamp only ever moves reads of deltas that the count
// zeroes.
//
// A thread owns the 8 deltas [8s, 8s + 8): they lie in one miniblock (8
// divides 32), so it loads the miniblock's header once and then the words
// that hold them, bw / 4 whole words for a width of 4 or more (16-byte
// loads where aligned) or one word for widths 1 and 2.  The bits are cut
// out with the width known at compile time (a switch over the packer's
// widths 0, 1, 2, 4, 8, 16 and 32), so every index is a register.  Any
// other width, or a word outside the row, reads each delta's word on its
// own, clamped, as the plain version does; a thread whose deltas all lie
// at or past count - 1 reads no word.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "decode.cuh"

namespace rt {

constexpr int kItems = 8;  // positions (and deltas) a thread

// A batch of pages (the C entries' arrays and sizes).  Without idx, row r
// of a batch of n is page r of the arrays; with it, row r is page
// clamp(idx[r], 0, n_src - 1) of arrays of n_src pages.
struct Pages {
  const int* first;
  const int* mind;
  const int* bw;
  const int* woff;
  const unsigned* packed;
  const int* counts;
  int n;
  int n_mini;
  int max_words;
  int page_size;
  const int* idx = nullptr;
  int n_src = 0;
};

// Deltas 8s .. 8s + 7 of a thread of width W (compile time, a power of
// two up to 32, as the packer writes them: no delta straddles a word), plus
// md.  W >= 4: they fill the W / 4 words from `words` (bit offset 0);
// W <= 2: they lie in words[0] from bit `shift`.
template <int W>
__device__ __forceinline__ void unpack8(const unsigned* __restrict__ words,
                                        int shift, unsigned md,
                                        unsigned (&d)[kItems]) {
  if constexpr (W == 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) d[i] = md;
  } else {
    constexpr int kN = W >= 4 ? W / 4 : 1;
    unsigned r[kN];
    if constexpr (kN >= 4) {
      if ((reinterpret_cast<uintptr_t>(words) & 15) == 0) {
#pragma unroll
        for (int c = 0; c < kN / 4; ++c) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(words) + c);
          r[4 * c] = v.x;
          r[4 * c + 1] = v.y;
          r[4 * c + 2] = v.z;
          r[4 * c + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kN; ++k) r[k] = __ldg(words + k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) r[k] = __ldg(words + k);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      unsigned v;
      if constexpr (W >= 4) {
        v = r[(i * W) >> 5] >> ((i * W) & 31);
      } else {
        v = r[0] >> (shift + i * W);
      }
      if constexpr (W < 32) v &= (1u << W) - 1u;
      d[i] = v + md;
    }
  }
}

#define RT_WIDTHS(X) X(0) X(1) X(2) X(4) X(8) X(16) X(32)

// The thread's 8 deltas j0 .. j0 + 7 of page `row` (0 at or past `last` =
// count - 1).  The miniblock's header is loaded once; a width of the
// packer's with its words inside the row takes unpack8, anything else
// reads each delta's word on its own, clamped, as the plain version does.
__device__ __forceinline__ void thread_deltas(const Pages& p, size_t row,
                                              int j0, int last,
                                              unsigned (&d)[kItems]) {
  const size_t h = row * p.n_mini + min(j0 >> 5, p.n_mini - 1);
  const int w = __ldg(p.bw + h);
  const int wo = __ldg(p.woff + h);
  const unsigned md = static_cast<unsigned>(__ldg(p.mind + h));
  if (j0 >= last) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) d[i] = 0u;
    return;
  }
  const unsigned* rw = p.packed + row * p.max_words;
  const int b0 = (j0 & 31) * w;
  const int nw = w >= 4 ? w / 4 : (w > 0 ? 1 : 0);
  const long long lo = static_cast<long long>(wo) + (b0 >> 5);
  if (w >= 0 && w <= 32 && (w & (w - 1)) == 0 && lo >= 0 &&
      lo + nw <= p.max_words) {
    switch (w) {
#define RT_CASE(W)                           \
  case W:                                    \
    unpack8<W>(rw + lo, b0 & 31, md, d);     \
    break;
      RT_WIDTHS(RT_CASE)
#undef RT_CASE
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int bit = ((j0 + i) & 31) * w;
      const long long widx =
          min(max(wo + static_cast<long long>(bit >> 5), 0LL),
              static_cast<long long>(p.max_words) - 1);
      d[i] = extract_bits(__ldg(rw + widx), bit & 31, w) + md;
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (j0 + i >= last) d[i] = 0u;
  }
}

}  // namespace rt
