// gather_decode: decode resident delta pages named by a page-index vector.
//
// Replaces the TPU kernel gather_decode_pallas
// (src/repro/kernels/pac_decode/kernel.py:437, body _decode_plan_rows at
// :381).  The column lives on the card as its per-delta unpack plan
// (PackedPages.unpack_plan): first int32[P,1], pos int32[P,d],
// mind int32[P,d], packed uint32[P,max_words], with d = page_size - 1.
// For every delta j of a gathered page:
//   word  = packed[min(pos >> 11, max_words - 1)]
//   resid = (word >> ((pos >> 6) & 31)) & mask(bw = pos & 63)   (bw >= 32: all ones)
//   delta = resid + mind
// and the page's ids are first followed by first + inclusive_scan(delta),
// all in int32 with wraparound.  Positions past a page's count hold the
// running last id (their plan entries decode to 0).
//
// Bound on the H100 (3.35 TB/s): the kernel must read one plan row per
// gathered page -- first, pos and mind whole (4 + 4d + 4d bytes, 16,380 B
// at page size 2048) and of the packed words only the page's
// sum(bit_widths) (a miniblock of width bw packs its 32 deltas into bw
// words; the zero words past them are never read) -- and write
// 4*page_size = 8,192 B of ids.  It does no arithmetic worth counting
// against that.
//
// Design: one block of 256 threads per gathered row, scanned by
// rt::decode_row (decode.cuh): a pass decodes 2048 deltas with the plan
// loaded striped (coalesced) into shared memory, a warp-shuffle block scan
// of per-thread partial sums, and a striped store.  Many rows are in flight
// per SM, which is what hides the gather's latency.
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

// Delta j of one resident plan row (see the header comment).
struct PlanDelta {
  const int* prow;
  const int* mrow;
  const unsigned* wrow;
  int max_words;

  __device__ __forceinline__ unsigned operator()(int j) const {
    const int p = prow[j];
    const int widx = min(p >> 11, max_words - 1);
    return rt::extract_bits(wrow[widx], (p >> 6) & 31, p & 63) +
           static_cast<unsigned>(mrow[j]);
  }
};

__global__ void __launch_bounds__(rt::kDecodeThreads)
gather_decode_kernel(const int* __restrict__ first, const int* __restrict__ pos,
                     const int* __restrict__ mind,
                     const unsigned* __restrict__ packed, int n_pages, int d,
                     int max_words, const int* __restrict__ idx,
                     int* __restrict__ out) {
  const int row = blockIdx.x;
  const int page = min(max(idx[row], 0), n_pages - 1);
  const PlanDelta delta{pos + static_cast<size_t>(page) * d,
                        mind + static_cast<size_t>(page) * d,
                        packed + static_cast<size_t>(page) * max_words,
                        max_words};
  rt::decode_row(delta, static_cast<unsigned>(first[page]), d,
                 out + static_cast<size_t>(row) * (d + 1));
}

}  // namespace

void launch_gather_decode(const int* first, const int* pos, const int* mind,
                          const unsigned* packed, int n_pages, int d,
                          int max_words, const int* idx, int n_rows, int* out,
                          cudaStream_t stream) {
  if (n_rows <= 0) return;
  gather_decode_kernel<<<n_rows, rt::kDecodeThreads, 0, stream>>>(
      first, pos, mind, packed, n_pages, d, max_words, idx, out);
}

extern "C" int rt_gather_decode(const int* first, const int* pos,
                                const int* mind, const int* packed,
                                int n_pages, int d, int max_words,
                                const int* idx, int n_rows, int* out,
                                void* stream) {
  launch_gather_decode(first, pos, mind,
                       reinterpret_cast<const unsigned*>(packed), n_pages, d,
                       max_words, idx, n_rows, out,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
