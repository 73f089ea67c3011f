// flash_attention: blockwise online-softmax attention over q/k/v
// [bh, seq, d] (the same seq for queries and keys), float32 or bfloat16.
//
// Replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py:75, pallas_call at :89, body
// _flash_kernel at :26).  It computes what that kernel computes, not its
// grid: scores q.k * (1/sqrt(d)), under `causal` the mask row >= col as
// -1e30, a running max m, denominator l and accumulator in float32, and the
// finish acc / max(l, 1e-30) rounded to the input type (round to nearest
// even for bfloat16).  GQA is the caller's (ops.mha repeats the KV heads).
//
// Bound on the H100: causal attention at [60, 2048, 64] does 4*bh*s^2*d/2 =
// 32.2 GFLOP over 63 MB of q/k/v/o, so the tensor-core rate (989 TFLOP/s
// bf16) bounds it, not the bytes.  This first kernel does not reach that
// bound: it runs every product on the float32 FMA units (67 TFLOP/s), so
// that the float32 inputs are computed in float32 as the reference does
// and the bfloat16 ones lose nothing but the output rounding.  Tensor cores
// (mma.sync / wgmma, which would round p to bf16 for the PV product), TMA
// and reading a KV head by index instead of a repeated copy are later work.
//
// Design: one block of 4 warps per (bh, query tile of BQ rows); the query
// tile and each key/value tile of BK rows are staged through shared memory
// as float32, rows padded to d + 1 words so that neither the row-strided
// reads of q nor the column reads of k and v meet bank conflicts.  Lane
// (g, c) of a warp (g = lane / 8, c = lane % 8) owns RT query rows, keys
// c, c + 8, ... of each tile and output dims c, c + 8, ...; a row's max and
// sum reduce over the 8 lanes of its group with shuffles, and the PV
// product reads each probability from its owner by shuffle.  Under
// `causal` the key loop stops at the tile's last row, so tiles wholly above
// the diagonal are never loaded, and blocks start with the heaviest query
// tiles.  Keys past seq (a ragged last tile) weigh exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 128;           // 4 warps
constexpr float kMasked = -1e30f;       // the reference's NEG_INF

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
struct Tile {
  static constexpr int RT = D <= 128 ? 4 : 2;   // query rows per thread
  static constexpr int BQ = 4 * 4 * RT;         // warps x groups x RT
  static constexpr int BK = D <= 128 ? 64 : 32; // keys per tile
  static constexpr int KT = BK / 8;             // keys per thread
  static constexpr int DT = D / 8;              // output dims per thread
  static constexpr int LD = D + 1;              // padded shared row stride
  static constexpr int SMEM =
      (BQ + 2 * BK) * LD * static_cast<int>(sizeof(float));
};

template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t base, int r0, int rows,
                                      int seq) {
  constexpr int LD = Tile<D>::LD;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, col = i % D;
    const int gr = r0 + r;
    dst[r * LD + col] =
        gr < seq ? load_f(src + base + static_cast<size_t>(gr) * D + col)
                 : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int bh, int seq,
             int n_qtiles, int causal, float scale) {
  using C = Tile<D>;
  constexpr int RT = C::RT, KT = C::KT, DT = C::DT, LD = C::LD;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + C::BQ * LD;      // [BK][LD]
  float* vs = ks + C::BK * LD;      // [BK][LD]

  // block b: query tile n_qtiles - 1 - b / bh of head b % bh, so the
  // heaviest causal tiles of every head are scheduled first
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int head = static_cast<int>(blockIdx.x) % bh;
  const int q0 = qt * C::BQ;
  const size_t base = static_cast<size_t>(head) * seq * D;
  const int lane = threadIdx.x & 31;
  const int c = lane & 7;
  const int src_base = lane & ~7;
  const int row0 = (threadIdx.x >> 5) * 4 * RT + (lane >> 3) * RT;

  stage<T, D>(qs, q, base, q0, C::BQ, seq);

  float m[RT], l[RT], acc[RT][DT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[r][j] = 0.f;
  }

  // under `causal` no row of this tile sees a key past its last row
  const int k_end = causal ? min(seq, q0 + C::BQ) : seq;
  const int n_kt = (k_end + C::BK - 1) / C::BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C::BK;
    __syncthreads();                // the previous tile is consumed
    stage<T, D>(ks, k, base, k0, C::BK, seq);
    stage<T, D>(vs, v, base, k0, C::BK, seq);
    __syncthreads();

    float s[RT][KT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < KT; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RT], kv[KT];
#pragma unroll
      for (int r = 0; r < RT; ++r) qv[r] = qs[(row0 + r) * LD + d];
#pragma unroll
      for (int j = 0; j < KT; ++j) kv[j] = ks[(c + 8 * j) * LD + d];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < KT; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = q0 + row0 + r;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int col = k0 + c + 8 * j;
        float x = s[r][j] * scale;
        if (causal && row < col) x = kMasked;
        if (col >= seq) x = -INFINITY;     // a padding key weighs 0
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_cur = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[r][j] = expf(s[r][j] - m_cur);
        sum += s[r][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * alpha + sum;
      m[r] = m_cur;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[r][j] *= alpha;
    }

    // acc += P V: key kk's probability lives in lane (group, kk % 8)
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      float p[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        p[r] = __shfl_sync(0xffffffffu, s[r][kk >> 3], src_base | (kk & 7));
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float vv = vs[kk * LD + c + 8 * j];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r][j] = fmaf(p[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = q0 + row0 + r;
    if (row >= seq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* out = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) store_f(out + c + 8 * j, acc[r][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int seq, int causal, cudaStream_t stream) {
  using C = Tile<D>;
  auto kern = flash_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (seq + C::BQ - 1) / C::BQ;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<n_qtiles * bh, kThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, seq, n_qtiles,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh,
               int seq, int d, int causal, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, seq, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, seq, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, seq, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, bh, seq, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, k, v, o: [bh, seq, d], contiguous.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int bh, int seq, int d, int dtype,
                                  int causal, void* stream) {
  if (bh <= 0 || seq <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, bh, seq, d, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, seq, d, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
