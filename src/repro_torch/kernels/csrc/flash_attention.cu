// flash_attention: blockwise online-softmax attention over q [b, h, seq_q,
// d] and k/v [b, h_kv, seq_k, d], bfloat16 or float32, every tensor read
// and the output written through its own batch, head and sequence strides.
// Query head i reads KV head i / (h / h_kv) by index (GQA), so no repeated
// copy of K and V exists.  Query row `row` is global row q_start + row of
// a sequence whose keys are k/v (q_start + seq_q <= seq_k): under `causal`
// it sees key `col` iff col <= q_start + row.  q_start = 0 with seq_q =
// seq_k is the whole causal attention; a rank of a sequence-parallel mesh
// passes its stretch of the queries against the whole keys.
//
// Replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py:75, pallas_call at :89, body
// _flash_kernel at :26).  It computes what that kernel computes, not its
// grid: scores q.k * (1/sqrt(d)), under `causal` the mask row >= col as
// -1e30 (row counted from q_start), a running max m, denominator l and
// accumulator in float32, and the finish acc / max(l, 1e-30) rounded to the
// input type (round to nearest even for bfloat16).
//
// Bound on the H100: causal attention at [60, 2048, 64] does 4*bh*s^2*d/2 =
// 32.2 GFLOP over 63 MB of q/k/v/o, so the tensor-core rate (989 TFLOP/s
// bf16, 0.0326 ms) bounds it, not the bytes (0.019 ms); with five KV heads
// for fifteen query heads the bytes fall to 0.013 ms and the bound stays.
//
// bfloat16 (flash_wgmma_kernel): a block holds kWG warpgroups of 64 query
// rows each, and two blocks share an SM where registers allow.  Thread 0
// brings each warpgroup's query tile once and the key/value tiles of BK
// rows through a ring of kStages stages in shared memory by TMA
// (cp.async.bulk.tensor, a 4-d tensor map per operand built on the host
// with the strides it was given; 128-byte swizzle, 64-byte for d = 32,
// where a row is 64 bytes), each stage with a `full` mbarrier the copy
// completes and an `empty` one every warp arrives on when it is done, so
// tile j + 1 loads while tile j is computed.  Thread 0 waits for a release
// only when its own warpgroup needs the tile next and otherwise polls, so
// the two warpgroups drift apart instead of running in lock step.  (A
// producer warp of its own would cost a warpgroup's registers: ptxas caps
// a 288-thread block at 168 a thread, and d = 256 spilled.)
//
// A warpgroup computes S = Q K^T with wgmma.m64nBKk16 (A and B K-major
// from shared memory), keeps S in float32 registers, takes the row max and
// sum over the 4 lanes that hold a row, converts P in place into the
// register A fragment of the PV product and runs O += P V with
// wgmma.m64nDk16, V read N-major from the same [keys, d] tile (trans-b),
// never copied transposed.  BK per d keeps S, P and the d/2 accumulators
// in 128 registers (two blocks an SM): 128 keys for d <= 64, 64 for d =
// 128 and 256.  The products and the softmax of one warpgroup run in turn;
// the other warpgroups of the SM fill the tensor cores meanwhile.
// (Overlapping a warpgroup's own softmax with its next products needs a
// second score tile in registers, so one block an SM, and ran slower.)
//
// Numerics: Q K^T is exact products summed in float32; p = exp(s - m) is
// rounded to bfloat16 for the PV product (the TPU kernel keeps p in
// float32; the port's plain attention route and
// scaled_dot_product_attention also cast the probabilities to bf16), and l
// sums the same rounded p, so the output is a convex combination of V's
// rows.  Under `causal` a warpgroup stops at its last row's tile (tiles
// wholly above the diagonal are never loaded) and masks only tiles that
// cross the diagonal; keys past seq_k weigh exactly 0.  Both early exits
// and the diagonal count global rows (q_start + row), so a q_start that is
// a multiple of the query block runs the full call's tiles in the full
// call's order and gives its rows bit for bit.
//
// float32 (flash_fma_kernel): every product on the float32 FMA units, so
// float32 inputs are computed in float32 as the reference does (no TF32).
// One block of 4 warps per (batch, head, query tile of BQ rows); the
// query tile and each key/value tile of BK rows are staged through shared
// memory, rows padded to d + 1 words so that neither the row-strided reads
// of q nor the column reads of k and v meet bank conflicts.  Lane (g, c)
// of a warp (g = lane / 8, c = lane % 8) owns RT query rows, keys c, c + 8,
// ... of each tile and output dims c, c + 8, ...; a row's max and sum
// reduce over the 8 lanes of its group with shuffles, and the PV product
// reads each probability from its owner by shuffle.
//
// Both kernels start with the heaviest causal query tiles of every head
// (the last by global row).
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kMasked = -1e30f;       // the reference's NEG_INF

// ---------------------------------------------------------------- float32

constexpr int kThreads = 128;           // 4 warps

struct Strides {
  int64_t b, h, s;                      // in elements; the last dim is 1
};

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

template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int64_t row_stride, int r0, int rows,
                                      int seq) {
  constexpr int LD = Tile<D>::LD;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, col = i % D;
    const int gr = r0 + r;
    dst[r * LD + col] = gr < seq ? src[gr * row_stride + col] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides qs_, Strides ks_, Strides vs_, Strides os_, int h,
                 int group, int seq_q, int seq_k, int q_start, int n_qtiles,
                 int causal, float scale) {
  using C = Tile<D>;
  constexpr int RT = C::RT, KT = C::KT, DT = C::DT, LD = C::LD;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + C::BQ * LD;      // [BK][LD]
  float* vs = ks + C::BK * LD;      // [BK][LD]

  // block x: query tile n_qtiles - 1 - x / (b h) of head x % (b h), so the
  // heaviest causal tiles of every head are scheduled first
  const int bh = static_cast<int>(gridDim.x) / n_qtiles;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int batch = static_cast<int>(blockIdx.x) % bh / h;
  const int head = static_cast<int>(blockIdx.x) % bh % h;
  const int q0 = qt * C::BQ;
  const float* qh = q + batch * qs_.b + head * qs_.h;
  const float* kh = k + batch * ks_.b + (head / group) * ks_.h;
  const float* vh = v + batch * vs_.b + (head / group) * vs_.h;
  const int lane = threadIdx.x & 31;
  const int c = lane & 7;
  const int src_base = lane & ~7;
  const int row0 = (threadIdx.x >> 5) * 4 * RT + (lane >> 3) * RT;

  stage<D>(qs, qh, qs_.s, q0, C::BQ, seq_q);

  float m[RT], l[RT], acc[RT][DT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[r][j] = 0.f;
  }

  // under `causal` no row of this tile sees a key past its last row
  const int k_end = causal ? min(seq_k, q_start + q0 + C::BQ) : seq_k;
  const int n_kt = (k_end + C::BK - 1) / C::BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C::BK;
    __syncthreads();                // the previous tile is consumed
    stage<D>(ks, kh, ks_.s, k0, C::BK, seq_k);
    stage<D>(vs, vh, vs_.s, k0, C::BK, seq_k);
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
      const int row = q_start + q0 + row0 + r;   // global
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int col = k0 + c + 8 * j;
        float x = s[r][j] * scale;
        if (causal && row < col) x = kMasked;
        if (col >= seq_k) x = -INFINITY;   // a padding key weighs 0
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
    if (row >= seq_q) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* out = o + batch * os_.b + head * os_.h + row * os_.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) out[c + 8 * j] = acc[r][j] / den;
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               const Strides* st, int b, int h, int group, int seq_q,
               int seq_k, int q_start, int causal, cudaStream_t stream) {
  using C = Tile<D>;
  auto kern = flash_fma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (seq_q + C::BQ - 1) / C::BQ;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<n_qtiles * b * h, kThreads, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], h, group, seq_q, seq_k, q_start, n_qtiles, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- bfloat16

constexpr int kWG = 2;                  // warpgroups per block
constexpr int kStages = 2;              // key/value ring depth

template <int D>
struct Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzled row, bytes
  static constexpr int CH = SW / 2;               // bf16 per swizzled row
  static constexpr int NCH = D / CH;              // TMA boxes per tile
  static constexpr int BK = D <= 64 ? 128 : 64;   // keys per tile
  static constexpr int BQ = 64 * kWG;             // query rows per block
  static constexpr int Q_BYTES = 64 * D * 2;      // one warpgroup's queries
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int TILES = kWG * Q_BYTES + 2 * kStages * KV_BYTES;
  // + alignment slack for the 1024-byte swizzle atoms + the mbarriers
  static constexpr int SMEM = TILES + 1024 + 8 * (2 * kStages + 1);
  static constexpr int THREADS = 128 * kWG;
  // two blocks on an SM (each block's loads and epilogue overlap the
  // other's products) as long as 128 registers a thread hold the
  // accumulators: d <= 128; d = 256 takes up to 255
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma swizzle
  // under `causal` warpgroup 0 may skip the block's last tiles; the
  // producer then waits only on stages of tiles every warp computed
  static_assert(64 * (kWG - 1) <= BK * kStages, "ring too shallow");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the barrier's phase `parity` completes; a phase that never
// completes (a lost arrival) traps after about 2^26 polls instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// true once the barrier's phase `parity` has completed (does not wait)
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// one box of a 4-d tensor map (d, seq, head, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p0, p1 rounded to nearest even and packed (p0 in the low half), and
// their rounded values added to *sum
__device__ __forceinline__ uint32_t pack_bf16(float p0, float p1,
                                              float* sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  *sum += __uint_as_float(u << 16) + __uint_as_float(u & 0xFFFF0000u);
  return u;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, Strides os_, int h,
                   int group, int seq_q, int seq_k, int q_start,
                   int n_qblocks, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, SW = C::SW, CH = C::CH, NCH = C::NCH;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                           // [kWG][NCH][64][CH]
  const uint32_t k_s = q_s + kWG * C::Q_BYTES;         // [kStages][NCH][BK][CH]
  const uint32_t v_s = k_s + kStages * C::KV_BYTES;    // [kStages][NCH][BK][CH]
  const uint32_t bars = v_s + kStages * C::KV_BYTES;
  const uint32_t q_bar = bars + 16 * kStages;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int bh = static_cast<int>(gridDim.x) / n_qblocks;
  const int qb = n_qblocks - 1 - static_cast<int>(blockIdx.x) / bh;
  const int batch = static_cast<int>(blockIdx.x) % bh / h;
  const int head = static_cast<int>(blockIdx.x) % bh % h;
  const int q0 = qb * C::BQ;
  // under `causal` no row of the block sees a key past its last row
  const int n_kt =
      ((causal ? min(seq_k, q_start + q0 + C::BQ) : seq_k) + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kWG);     // every warp arrives
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 also produces: the query tiles now, then the key/value tiles
  // up to `upto` - 1, each into the stage its tile - kStages left once
  // every warp has released it.  Within its own tile it only polls for
  // that release (`wait` false: its warpgroup would stall on a warp that
  // waits), and waits only for the tile its warpgroup needs next.
  int next = 0;                         // the next tile to load (thread 0)
  auto produce = [&](int upto, bool wait) {
    for (upto = min(upto, n_kt); next < upto; ++next) {
      const int s = next % kStages;
      if (next >= kStages) {
        const uint32_t parity = ((next / kStages) - 1) & 1;
        if (wait)
          mbar_wait(empty(s), parity);
        else if (!mbar_test(empty(s), parity))
          return;
      }
      mbar_expect_tx(full(s), 2 * C::KV_BYTES);
      for (int c = 0; c < NCH; ++c) {
        tma_load(k_s + s * C::KV_BYTES + c * BK * SW, &kmap, c * CH,
                 next * BK, head / group, batch, full(s));
        tma_load(v_s + s * C::KV_BYTES + c * BK * SW, &vmap, c * CH,
                 next * BK, head / group, batch, full(s));
      }
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, kWG * C::Q_BYTES);
    for (int w = 0; w < kWG; ++w)
      for (int c = 0; c < NCH; ++c)
        tma_load(q_s + w * C::Q_BYTES + c * 64 * SW, &qmap, c * CH,
                 q0 + 64 * w, head, batch, q_bar);
  }

  // warpgroup wg: rows wq0 + r and wq0 + r + 8 of the thread (local;
  // gq0 is wq0's global row)
  const int wg = warp / 4;
  const int wq0 = q0 + 64 * wg;
  const int gq0 = q_start + wq0;
  const int r = (warp % 4) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const int my_kt =
      causal ? min(n_kt, (q_start + min(seq_q, wq0 + 64) - 1) / BK + 1)
             : n_kt;
  const uint32_t my_q = q_s + wg * C::Q_BYTES;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kMasked, m1 = kMasked;     // running max of rows r, r + 8
  float l0 = 0.f, l1 = 0.f;             // this thread's share of the sums

  mbar_wait(q_bar, 0);
  for (int j = 0; j < my_kt; ++j) {
    const int s = j % kStages;
    const int k0 = j * BK;
    if (threadIdx.x == 0) {
      produce(j + 1, true);
      produce(j + kStages, false);
    }
    mbar_wait(full(s), (j / kStages) & 1);

    // S = Q K^T: d / 16 steps of k16 along the swizzled rows
    float sc[BK / 2];
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / CH, off = (kk * 16 % CH) * 2;
      wgmma::Mma<BK>::ss(
          sc, smem_desc(my_q + c * 64 * SW + off, 16, 8 * SW, C::LAYOUT),
          smem_desc(k_s + s * C::KV_BYTES + c * BK * SW + off, 16, 8 * SW,
                    C::LAYOUT),
          kk > 0);
    }
    wgmma::commit();
    if (threadIdx.x == 0) produce(j + kStages, false);
    wgmma::wait<0>();
    wgmma::fence_operand(sc);

    // mask only a tile that crosses the diagonal or the end of the
    // sequence; the row max of the raw scores, then the running max in
    // the log2 domain (scale_log2 = log2(e) / sqrt(d) > 0)
    const bool edge = (causal && k0 + BK - 1 > gq0) || k0 + BK > seq_k;
    if (edge) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = gq0 + r + 8 * (e >> 1);
          const int col = k0 + 8 * n + cq + (e & 1);
          if (causal && row < col) sc[4 * n + e] = kMasked;
          if (col >= seq_k) sc[4 * n + e] = -INFINITY;  // weighs exactly 0
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    const float alpha0 = exp2_approx(m0 - mx0);
    const float alpha1 = exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P in bf16, as the A fragment of P V: p[2n + i] holds row r + 8i,
    // columns 8n + cq, + 1
    uint32_t p[BK / 4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      p[2 * n] =
          pack_bf16(exp2_approx(fmaf(sc[4 * n], scale_log2, -m0)),
                    exp2_approx(fmaf(sc[4 * n + 1], scale_log2, -m0)), &sum0);
      p[2 * n + 1] =
          pack_bf16(exp2_approx(fmaf(sc[4 * n + 2], scale_log2, -m1)),
                    exp2_approx(fmaf(sc[4 * n + 3], scale_log2, -m1)), &sum1);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= alpha0;
      acc[4 * n + 1] *= alpha0;
      acc[4 * n + 2] *= alpha1;
      acc[4 * n + 3] *= alpha1;
    }

    if (threadIdx.x == 0) produce(j + kStages, false);

    // O += P V: BK / 16 steps of k16 down the keys of the [BK, d] tile
    wgmma::fence_operand(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      wgmma::Mma<D>::rs(
          acc, a,
          smem_desc(v_s + s * C::KV_BYTES + kk * 16 * SW, BK * SW, 8 * SW,
                    C::LAYOUT));
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
  // under `causal` warpgroup 0 may stop short of the block's last tile
  if (threadIdx.x == 0) produce(n_kt, true);

  // the row sums over the 4 lanes of a row; out = acc / max(l, 1e-30)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wq0 + r + 8 * i;
    if (row >= seq_q) continue;
    __nv_bfloat16* out = o + batch * os_.b + head * os_.h + row * os_.s;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + cq) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] / den[i],
                                acc[4 * n + 2 * i + 1] / den[i]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor [b, heads, seq, d] with strides `st` as a 4-d tensor map
// (d, seq, head, batch) whose boxes are `cols` x `rows`, swizzled by `sw`
// bytes; out-of-range rows read as 0
bool encode(CUtensorMap* map, const void* ptr, int b, int heads, int seq,
            int d, Strides st, int cols, int rows, int sw) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Strides* st, int b, int h, int h_kv, int seq_q,
                 int seq_k, int q_start, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(&qmap, q, b, h, seq_q, D, st[0], C::CH, 64, C::SW) ||
      !encode(&kmap, k, b, h_kv, seq_k, D, st[1], C::CH, C::BK, C::SW) ||
      !encode(&vmap, v, b, h_kv, seq_k, D, st[2], C::CH, C::BK, C::SW))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qblocks = (seq_q + C::BQ - 1) / C::BQ;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  kern<<<n_qblocks * b * h, C::THREADS, C::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), st[3], h, h / h_kv,
      seq_q, seq_k, q_start, n_qblocks, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_dtype(const void* q, const void* k, const void* v, void* o,
                   const Strides* st, int b, int h, int h_kv, int seq_q,
                   int seq_k, int q_start, int dtype, int causal,
                   cudaStream_t stream) {
  if (dtype == 0)
    return launch_fma<D>(q, k, v, o, st, b, h, h / h_kv, seq_q, seq_k,
                         q_start, causal, stream);
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, o, st, b, h, h_kv, seq_q, seq_k, q_start,
                           causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o: [b, h, seq_q, d]; k, v: [b, h_kv, seq_k, d], h_kv dividing h; each
// with its batch, head and sequence strides in elements (the last stride
// is 1); query row `row` is global row q_start + row, q_start + seq_q <=
// seq_k.  dtype: 0 float32, 1 bfloat16.  The wrapper checks shapes,
// strides (multiples of 8 elements) and 16-byte alignment.
extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int h_kv, int seq_q, int seq_k, int q_start, int d, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int dtype, int causal, void* stream) {
  if (b <= 0 || h <= 0 || seq_q <= 0) return 0;
  if (h_kv <= 0 || h % h_kv || q_start < 0 || q_start + seq_q > seq_k)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                         {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_FLASH_D(DIM)                                                     \
  case DIM:                                                                 \
    return dispatch_dtype<DIM>(q, k, v, o, st, b, h, h_kv, seq_q, seq_k,    \
                               q_start, dtype, causal, s);
  switch (d) {
    RT_FLASH_D(32)
    RT_FLASH_D(64)
    RT_FLASH_D(128)
    RT_FLASH_D(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_FLASH_D
}
