// Fused resident retrieval: page indices -> decoded pages -> target bitmap,
// with and without a label predicate.
//
// Replaces two TPU kernels:
//   fused_gather_decode_bitmap_batch
//     (src/repro/kernels/pac_decode/kernel.py:491, pallas_call at :540);
//   fused_gather_decode_filter_bitmap_batch
//     (src/repro/kernels/label_filter/kernel.py:195, pallas_call at :231).
// Input is one staged int32 vector [idx (p_pad) | gidx (t) | total (1)] and
// the column's resident unpack plan (PackedPages.unpack_plan in
// core/encoding.py has its layout: first, pos, mind, packed).  Row
// r of the p_pad x page_size matrix decodes page clamp(idx[r]); for every
// k < total, id = matrix.flat[clamp(gidx[k], 0, p_pad * page_size - 1)]
// sets bit id of the uint32[n_words] target bitmap when
// 0 <= id < 32 * n_words (and, for the filtered entry, when bit id of the
// predicate words fwords is set).  Under want_ids the matrix itself is an
// output, padding rows included.  The TPU kernel sorts the requested ids,
// drops duplicates and adds distinct powers of two (kernel.py:405-428); an
// atomic OR gives the same words with no sort, whatever the order and
// multiplicity of the ids.
//
// Bound on the H100 (3.35 TB/s), for what these inputs need: position j of
// a row depends on the row's first id and its deltas 0 .. j - 1 alone, so
// without want_ids a row is read only up to its last requested position
// (`need`): first, pos and mind of deltas < need - 1 and the distinct
// packed words those deltas name; plus the staged vector, 4 * n_words
// bytes of words written and, for the filtered entry, the predicate words
// the requested ids name.  Rows no request lands in (the padding rows)
// cost nothing.  Under want_ids every row is read whole and
// 4 * p_pad * page_size bytes of ids are written.
//
// Design, two launches and no memset:
//   mark_kernel, a thread per requested row: zeroes the target words, and
//     for each k < total sets bit f = clamp(gidx[k]) in a request mask
//     (ceil(page_size / 32) words a row) and raises need[f / page_size] to
//     f % page_size + 1.  Requests arrive as runs of consecutive
//     positions, so a warp ORs its bits per mask word and takes its
//     maximum per row first, and one lane of each group does the atomic.
//     The wrapper hands it the mask and need zeroed (one torch.zeros).
//   decode_or_kernel, a warp per gathered row: lane l owns the 8 output
//     positions and the 8 deltas [base + 8l, base + 8l + 8) of a pass of
//     256 positions; it loads its 8 pos and 8 mind entries with 16-byte
//     loads of the aligned chunks that hold them, then its 8 packed words
//     (clamped word index) at once, so 8 loads are in flight and not 1.
//     The scan is warp shuffles, and longer rows loop with a carry, so no
//     barrier is needed and each warp ends with its own row: a row with
//     need == 0 returns at once, and the others stop after need positions
//     (want_ids: after page_size).  Each requested position then ORs its
//     id's bit into the words straight from registers (kernel 4 tests the
//     id's bit in fwords first).  Under want_ids a warp stages its 256
//     outputs in its own 1 KB of shared memory and stores them as 512
//     contiguous bytes per instruction: stored straight from the threads
//     (32 bytes each) the same decode took 2.6x as long (per_dispatch.cu).
//     Timed against it on the card (PERF.md): 4 or 8 rows a block, 3% and
//     20% slower than 2 (a block lasts as long as its longest row); held to
//     40 registers, it spills and is 25% slower; lanes striped over the
//     pass (position base + 32 i + l), 9% faster without want_ids but 1.5x
//     slower with it.
#include <cuda_runtime.h>

#include <cstdint>

#include "decode.cuh"

namespace {

constexpr int kItems = 8;                 // positions (and deltas) a lane
constexpr int kSpan = 32 * kItems;        // positions a warp's pass
constexpr int kRowsPerBlock = 2;          // warps (rows) a decode block
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMarkThreads = 256;
constexpr int kMarkBlocksMax = 4096;

// A column's resident unpack plan.
struct Plan {
  const int* first;
  const int* pos;
  const int* mind;
  const unsigned* packed;
  int n_pages;
  int d;  // page_size - 1
  int max_words;
};

__global__ void __launch_bounds__(kMarkThreads)
mark_kernel(const int* __restrict__ gidx, const int* __restrict__ total,
            int t, int page_size, int n_ids, int mask_stride,
            unsigned* __restrict__ mask, unsigned* __restrict__ need,
            unsigned* __restrict__ words, int n_words) {
  const int n = max(t, n_words);
  const int live_rows = min(t, *total);
  const int lane = threadIdx.x & 31;
  // the loop bound is block-uniform, so every lane reaches the warp
  // intrinsics below
  for (int base = blockIdx.x * kMarkThreads; base < n;
       base += gridDim.x * kMarkThreads) {
    const int k = base + threadIdx.x;
    if (k < n_words) words[k] = 0u;
    const bool live = k < live_rows;
    const int f = live ? min(max(gidx[k], 0), n_ids - 1) : 0;
    const int row = f / page_size;
    const int j = f - row * page_size;
    const unsigned wkey =
        live ? static_cast<unsigned>(row * mask_stride + (j >> 5)) : ~0u;
    const unsigned wpeers = __match_any_sync(0xFFFFFFFFu, wkey);
    const unsigned bits = __reduce_or_sync(wpeers, live ? 1u << (j & 31) : 0u);
    if (live && lane == __ffs(wpeers) - 1) atomicOr(mask + wkey, bits);
    const unsigned rkey = live ? static_cast<unsigned>(row) : ~0u;
    const unsigned rpeers = __match_any_sync(0xFFFFFFFFu, rkey);
    const unsigned top =
        __reduce_max_sync(rpeers, live ? static_cast<unsigned>(j + 1) : 0u);
    if (live && lane == __ffs(rpeers) - 1) atomicMax(need + row, top);
  }
}

// v[i] = a[i] for i < n (n <= kItems), 0 past it, from 16-byte loads of
// only the aligned chunks that hold a[0 .. n): a chunk holding one wanted
// element lies inside the array, so no load leaves it.  O is a's offset in
// its chunk, in elements.
template <int O>
__device__ __forceinline__ void pick8(const int* __restrict__ a, int n,
                                      unsigned (&v)[kItems]) {
  const int4* c = reinterpret_cast<const int4*>(a - O);
  int e[12];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int4 x = make_int4(0, 0, 0, 0);
    if (n > 0 && 4 * q < O + n) x = __ldg(c + q);
    e[4 * q] = x.x;
    e[4 * q + 1] = x.y;
    e[4 * q + 2] = x.z;
    e[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = i < n ? static_cast<unsigned>(e[O + i]) : 0u;
  }
}

__device__ __forceinline__ void load8(const int* __restrict__ a, int n,
                                      unsigned (&v)[kItems]) {
  switch ((reinterpret_cast<uintptr_t>(a) >> 2) & 3) {
    case 0: pick8<0>(a, n, v); break;
    case 1: pick8<1>(a, n, v); break;
    case 2: pick8<2>(a, n, v); break;
    default: pick8<3>(a, n, v); break;
  }
}

template <bool kFilter, bool kIds>
__global__ void __launch_bounds__(kThreads)
decode_or_kernel(Plan p, const int* __restrict__ idx, int p_pad,
                 const unsigned* __restrict__ mask, int mask_stride,
                 const unsigned* __restrict__ need,
                 unsigned* __restrict__ words, int n_words,
                 const unsigned* __restrict__ fwords, int* __restrict__ out) {
  __shared__ uint4 stage[kIds ? kRowsPerBlock : 1][kSpan / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                        warp;
  if (row >= p_pad) return;  // the whole warp
  const int page_size = p.d + 1;
  const int lim = kIds ? page_size
                       : min(static_cast<int>(__ldg(need + row)), page_size);
  if (lim <= 0) return;      // no position of this row is requested
  const int page = min(max(__ldg(idx + row), 0), p.n_pages - 1);
  const int* prow = p.pos + static_cast<size_t>(page) * p.d;
  const int* mrow = p.mind + static_cast<size_t>(page) * p.d;
  const unsigned* wrow = p.packed + static_cast<size_t>(page) * p.max_words;
  const unsigned* qrow = mask + row * mask_stride;
  const long long n_ids = 32LL * n_words;
  const bool vec = (page_size & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  unsigned carry = static_cast<unsigned>(__ldg(p.first + page));
  for (int base = 0; base < lim; base += kSpan) {
    const int j0 = base + kItems * lane;
    // deltas j0 .. j0 + n - 1: those before the pass's last wanted position
    const int n = min(max(lim - 1 - j0, 0), kItems);
    unsigned req = 0u;
    if (j0 < lim) req = (__ldg(qrow + (j0 >> 5)) >> (j0 & 24)) & 0xFFu;
    unsigned ps[kItems], md[kItems];
    load8(prow + j0, n, ps);
    load8(mrow + j0, n, md);
    unsigned w[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int q = static_cast<int>(ps[i]);
      w[i] = i < n && (q & 63) != 0
                 ? __ldg(wrow + min(max(q >> 11, 0), p.max_words - 1))
                 : 0u;
    }
    unsigned d[kItems];
    unsigned tot = 0u;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      d[i] = rt::extract_bits(w[i], (ps[i] >> 6) & 31, ps[i] & 63) + md[i];
      tot += d[i];
    }
    unsigned x = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    unsigned acc = carry + x - tot;
    carry += __shfl_sync(0xFFFFFFFFu, x, 31);
    unsigned v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      v[i] = acc;
      acc += d[i];
    }
    // the requested positions' bits, straight from registers
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int id = static_cast<int>(v[i]);
      bool set = ((req >> i) & 1u) != 0 && id >= 0 && id < n_ids;
      if constexpr (kFilter) {
        if (set) set = (__ldg(fwords + (id >> 5)) >> (id & 31)) & 1u;
      }
      if (set) atomicOr(words + (id >> 5), 1u << (id & 31));
    }
    if constexpr (kIds) {
      // the warp's outputs leave in order: 512 contiguous bytes a store
      stage[warp][2 * lane] = make_uint4(v[0], v[1], v[2], v[3]);
      stage[warp][2 * lane + 1] = make_uint4(v[4], v[5], v[6], v[7]);
      __syncwarp();
      int* orow = out + row * page_size;
      if (vec) {
#pragma unroll
        for (int u = lane; u < kSpan / 4; u += 32) {
          const int at = base + 4 * u;
          if (at < page_size) {
            *reinterpret_cast<uint4*>(orow + at) = stage[warp][u];
          }
        }
      } else {
        const unsigned* st = reinterpret_cast<const unsigned*>(stage[warp]);
#pragma unroll
        for (int q = lane; q < kSpan; q += 32) {
          if (base + q < page_size) orow[base + q] = static_cast<int>(st[q]);
        }
      }
      __syncwarp();  // the stores read stage before the next pass writes it
    }
  }
}

template <bool kFilter>
int fused_gather_decode_bitmap(const Plan& p, const int* staged, int p_pad,
                               int t, int* ids, int* work, int* words,
                               int n_words, const int* fwords,
                               cudaStream_t stream) {
  const int page_size = p.d + 1;
  const int mask_stride = (page_size + 31) / 32;
  unsigned* need = reinterpret_cast<unsigned*>(work);
  unsigned* mask = need + p_pad;
  unsigned* w = reinterpret_cast<unsigned*>(words);
  const int n = max(t, n_words);
  if (n > 0) {
    const int blocks = min((n + kMarkThreads - 1) / kMarkThreads,
                           kMarkBlocksMax);
    mark_kernel<<<blocks, kMarkThreads, 0, stream>>>(
        staged + p_pad, staged + p_pad + t, t, page_size, p_pad * page_size,
        mask_stride, mask, need, w, n_words);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p_pad + kRowsPerBlock - 1) / kRowsPerBlock;
  const unsigned* fw = reinterpret_cast<const unsigned*>(fwords);
  if (ids != nullptr) {
    decode_or_kernel<kFilter, true><<<blocks, kThreads, 0, stream>>>(
        p, staged, p_pad, mask, mask_stride, need, w, n_words, fw, ids);
  } else {
    decode_or_kernel<kFilter, false><<<blocks, kThreads, 0, stream>>>(
        p, staged, p_pad, mask, mask_stride, need, w, n_words, fw, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

Plan plan_of(const int* first, const int* pos, const int* mind,
             const int* packed, int n_pages, int d, int max_words) {
  return Plan{first, pos, mind, reinterpret_cast<const unsigned*>(packed),
              n_pages, d, max_words};
}

}  // namespace

// ids: int32[p_pad, page_size] or null (want_ids false); work: int32
// [p_pad * (1 + ceil(page_size / 32))] zeroed, need then the request mask.
extern "C" int rt_fused_gather_decode_bitmap(
    const int* first, const int* pos, const int* mind, const int* packed,
    int n_pages, int d, int max_words, const int* staged, int p_pad, int t,
    int* ids, int* work, int* words, int n_words, void* stream) {
  return fused_gather_decode_bitmap<false>(
      plan_of(first, pos, mind, packed, n_pages, d, max_words), staged,
      p_pad, t, ids, work, words, n_words, nullptr,
      static_cast<cudaStream_t>(stream));
}

extern "C" int rt_fused_gather_decode_filter_bitmap(
    const int* first, const int* pos, const int* mind, const int* packed,
    int n_pages, int d, int max_words, const int* staged, int p_pad, int t,
    int* ids, int* work, int* words, int n_words, const int* fwords,
    void* stream) {
  return fused_gather_decode_bitmap<true>(
      plan_of(first, pos, mind, packed, n_pages, d, max_words), staged,
      p_pad, t, ids, work, words, n_words, fwords,
      static_cast<cudaStream_t>(stream));
}
