// Fused NeRF point-MLP + alpha composite, backward, for Hopper (sm_90a).
//
// Replaces nerf3dtalker_tpu/ops/pallas/fused_render.py:fused_render_bwd
// (body _bwd_kernel, _mlp_tile_fwd_stash; pallas_call at :659). For the
// cotangents of the forward's outputs (feat [B, R, 256], bg_alpha and depth
// [B, R]) it recomputes the forward, backpropagates the composite in f32
// and the point MLP through all of its layers, and returns every weight and
// bias gradient in f32: the shared ones summed over every point of every
// batch row, the per-batch b0 / b5 / br1 summed over the batch row's
// points. With input_grads it also writes d_pe = g0 w0p^T + g5 w5p^T, d_zd
// and d_zv. It rounds where the TPU kernel rounds: activations and gradient
// activations in bf16 (ReLU masks applied in f32 before the cast), d_sigma
// in f32 before its cast, every product and sum accumulated in f32.
//
// Bound: operations. Per point the recompute is 1,352,064 MACs, the weight
// gradients as many again and the input-gradient chain 1,302,912 (without
// the w0p / w5p rows), 8.01 MFLOP against the ~1.3 KB of pe, z and g it
// must read; at the Reso64 training shape (B=2, R=4096, 524,288 points)
// that is 4.20 TFLOP, 4.25 ms at the card's 989 TFLOP/s bf16 peak. This
// design also writes every activation and gradient activation once to a
// bf16 stash and reads it back (7,617 values a point, 8.0 GB at that shape,
// ~4.8 ms at 3.35 TB/s), so it cannot reach the bound: keeping the stash
// on chip is the step after this one.
//
// What held the first design back, and what this one does about it
// (times: the Reso64 training shape on the H100 80GB HBM3 at 700 W; the
// ray kernel took 37.3 ms and the weight gradients 12.9 ms before):
//   - the weight gradients ran as 64 x 64 wmma tiles over 128 splits of
//     the points (0.69 GB of f32 partials), and a column-sum kernel read
//     every G again with 2-byte loads strided by the row width. Now one
//     pass of the staged X^T G core (xtg_core.cuh: 128 x 128 tiles, a
//     3-stage cp.async ring, ldmatrix + mma.sync, two blocks an SM)
//     computes every dW and, in the blocks that hold output row 0 of a
//     job, the column sums of the G tiles it stages (the bias gradients);
//     dwd = x7^T d_sigma and dbd are a narrow job of the same pass. Splits
//     never cross a batch row (23 a batch row at B=2: 250 MB of partials),
//     then the splits are added in split order. It reads 24 GB from L2
//     (each X by 3 column tiles, each G by 3 row tiles), which bounds it.
//   - the ray kernel's time was not where the first design put it. Timed
//     with one part switched off at a time: without the epilogue 11.6 ms,
//     without the stash stores 25.9, without the weight staging 28.7. The
//     wmma epilogue (each 16x16 tile through shared memory and back) and
//     the stash stores in the block's critical path took most of it.
//     Now:
//     * two rays a block, one warpgroup each: each 64-row ray is one
//       wgmma tile (m64n192k16 / m64n64k16, bf16 -> f32, A and B read from
//       shared memory through descriptors, the accumulators in
//       registers), and every weight chunk staged serves 128 points;
//     * operands in wgmma's core-matrix layout (8 x 8 bf16 blocks of 128
//       contiguous bytes, no swizzle), weights staged by cp.async in 32-row
//       chunks through a 2-slot ring (each layer stages the next one's
//       first chunk during its last chunk and epilogue);
//     * the epilogue on the accumulator registers (bias, ReLU, bf16 pairs,
//       mask bits), written over the layer's own input: one activation
//       buffer a ray (49,152 bytes) instead of two, which is what fits two
//       rays in 220,160 bytes of shared memory;
//     * each layer's output goes to the stash from the next layer's chunk
//       loop in 16-byte streaming stores (evict-first: the 8 GB stream
//       otherwise pushes the weights out of L2; 29 -> 24 ms before wgmma);
//     * the ReLU masks the chain reads (X[0..7], r1) stay in shared memory
//       as bits in the accumulator layout (26,112 bytes a ray); the MASK
//       epilogue reads no device memory;
//     * one warp a ray runs the composite with warp scans (an exclusive
//       product scan for T, a suffix sum for the d_w w term; f32 results
//       equal to the serial loop's to rounding).
//     The steps measured: 37.3 (wmma, one ray a block) -> 28.2 (mma.sync,
//     register epilogue) -> 23.4 (streaming stash stores) -> 19.2 (32-row
//     chunks, next chunk 0 staged early) -> 15.8 ms (wgmma, two rays).
// Left for later work: keeping the stash on chip, and wgmma that runs
// across chunks instead of one chunk at a time.
//
// Launches (one stream, deterministic, no atomics): ray_kernel, one block
// of two warpgroups per pair of rays (the second absent when B * R is
// odd): the forward recompute, the composite backward, the gradient chain
// d_rgb -> d_r1 -> d_r0 -> g7 .. g0 (products with W^T read the staged
// chunk of W as the K-major B operand, so no transposed copy of the weights
// is made), every activation and gradient activation to the stash; then
// xtg_jobs_kernel and xtg_reduce (the core). The only waits are
// cp.async.wait_group, wgmma.wait_group and __syncthreads: no mbarrier or
// TMA handshake that could spin.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "xtg_core.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int H = 384;      // hidden width
constexpr int H2 = 192;     // rgb_1 width
constexpr int PE = 64;      // padded positional encoding width
constexpr int NS = 64;      // samples per ray
constexpr int FEAT = 256;   // feature channels
constexpr int M = NS;       // points per ray: one warpgroup's 64-row wgmma tile
constexpr int RAYS = 2;     // rays per block, one warpgroup each
constexpr int NTHREADS = RAYS * 128;
constexpr int KC = 32;      // contraction rows per staged weight chunk
constexpr int WSTAGES = 2;  // weight ring depth: one chunk in flight while one is used
constexpr size_t HH = (size_t)H * H;
static_assert(M == xtg::BK, "a ray is one row of the X^T G core");

// Shared memory (bytes). Operands are in wgmma's core-matrix layout: a
// [rows][width] bf16 matrix is stored as 8 x 8 core matrices of 128
// contiguous bytes, row group major ([rows / 8][width / 8][8][8]), so a
// descriptor reads it K-major with LBO = 128 (the next 8 columns) and SBO
// = width * 16 (the next 8 rows). Per ray (warpgroup):
constexpr int SZ_ACT = M * H * 2;                   // 49,152: the activations, written in place
constexpr int SZ_PE = M * PE * 2;                   //  8,192
constexpr int MASK_X = (H / 64) * 128;              // mask words of an X layer: 6 a thread
constexpr int MASK_R1 = (H2 / 64) * 128;            // 3 a thread
constexpr int SZ_MASK = (8 * MASK_X + MASK_R1) * 4; // 26,112: the ReLU masks the chain reads
constexpr int SZ_VEC = 4 * M * 4;                   //  1,024: sig_pre, wts, d_sigma, d_w
constexpr int SZ_GF = FEAT * 4;                     //  1,024
constexpr int R_PE = SZ_ACT;
constexpr int R_MASK = R_PE + SZ_PE;
constexpr int R_VEC = R_MASK + SZ_MASK;
constexpr int R_GF = R_VEC + SZ_VEC;
constexpr int SZ_RAY = R_GF + SZ_GF;                // 85,504
// then the weight ring, shared by both rays: slots of [KC][<=384] or
// [<=384][KC] in core matrices
constexpr int SLOT = KC * H;                        // bf16 elements
constexpr int OFF_W = RAYS * SZ_RAY;                // 171,008
constexpr int SMEM = OFF_W + WSTAGES * SLOT * 2;    // 220,160 bytes
static_assert(SMEM <= 232448, "shared memory over the per-block limit");
static_assert(R_PE % 128 == 0 && R_MASK % 128 == 0 && R_VEC % 128 == 0 && R_GF % 128 == 0 &&
              SZ_RAY % 128 == 0 && OFF_W % 128 == 0, "smem alignment");

// The per-point scratch ("stash"): bf16 [N, width] arrays, N = B * R * NS.
struct Stash {
  bf16* pe;    // 64
  bf16* x[8];  // 384 each: outputs of fea_0 .. fea_7
  bf16* r0;    // 384
  bf16* r1;    // 192
  bf16* drgb;  // 256
  bf16* dr1;   // 192
  bf16* dr0;   // 384
  bf16* g[8];  // 384 each: gradient at the pre-activation of fea_0 .. fea_7
  bf16* dsig;  // 1
};
constexpr int STASH_WIDTH = PE + 8 * H + H + H2 + FEAT + H2 + H + 8 * H + 1;  // 7,617

using xtg::cp_async16;
using xtg::cp_async_commit;
using xtg::cp_async_wait;
using hopper::CM;
using hopper::cidx;
using hopper::desc;
using hopper::fence_acc;
using hopper::fence_async_shared;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_n192;
using hopper::wgmma_n64;
using hopper::wgmma_wait;

// One ray's part of the block: its warpgroup and its shared memory.
struct Ray {
  bf16* act;        // [M][<=384] core matrices: a layer's input and, in place, its output
  bf16* pe;         // [M][PE] core matrices
  uint32_t* mask;   // [8 * MASK_X + MASK_R1]
  float* sig_pre;
  float* wts;
  float* dsig;      // d_sigma_pre rounded to bf16, as f32
  float* dw;        // d_w from the rgb head: sum_c rgb[p, c] * g_feat[c]
  float* gf;
  int t;            // thread within the warpgroup
  bool live;        // a block's second ray is absent when B * R is odd
};

enum Epi { RELU_BF16, LINEAR_BF16, MASK_BF16, DOT_COLS, F32_STORE, F32_ADD };

// What a layer's epilogue does with its [M, N] result besides writing it,
// in place, to the ray's activations (RELU / LINEAR / MASK).
struct EpiArgs {
  uint32_t* bits = nullptr;        // mask words: (act > 0) of the output (RELU), or null
  const uint32_t* mask = nullptr;  // mask words of act: v * (act > 0) (MASK)
  const float* rowv = nullptr;     // shared [M]; with colv, v += rowv[r] * colv[c] (MASK)
  const bf16* colv = nullptr;      // device [N]
  float* f32 = nullptr;            // device [M, N] f32 (F32_STORE / F32_ADD)
};

// A layer output in the ray's activations ([M][width] core matrices) on its
// way to the stash ([M, width] in device memory): the next layer, which
// reads it, copies it out in 16-byte stores spread over its own chunk loop.
// Every stash store is a streaming store (st.global.cs, evict-first):
// written once and read back only by the next launch, the 8 GB would
// otherwise push the weights, which every block re-reads, out of L2.
struct Drain {
  const bf16* src = nullptr;
  bf16* dst = nullptr;   // null: nothing to copy (or an absent ray)
  int width = 0;
};

// items [begin, end) of a drain, 8 values each, by the ray's warpgroup
__device__ __forceinline__ void drain_items(const Drain& d, int t, int begin, int end) {
  if (d.dst == nullptr) return;
  const int q = d.width / 8;
  for (int it = begin + t; it < end; it += 128) {
    const int r = it / q, k = it - r * q;
    __stcs(reinterpret_cast<uint4*>(d.dst + (size_t)r * d.width + k * 8),
           *reinterpret_cast<const uint4*>(d.src + ((r >> 3) * q + k) * CM + (r & 7) * 8));
  }
}

// Chunk c of a layer's weights into a ring slot, in core matrices
// [n / 8][KC / 8][8][8]: for op(w) = w (w [k1][n] row-major) the rows of a
// core matrix are k (the B operand N-major); for op(w) = w^T (w [n][k1])
// they are n (K-major). No transposed copy of the weights is made.
__device__ __forceinline__ void stage_weights(bf16* slot, const bf16* __restrict__ w, int n, int k1,
                                              int c, bool trans) {
  if (trans) {
    for (int i = threadIdx.x; i < n * (KC / 8); i += NTHREADS) {
      const int r = i / (KC / 8), q = i % (KC / 8);
      cp_async16(slot + ((r >> 3) * (KC / 8) + q) * CM + (r & 7) * 8,
                 w + (size_t)r * k1 + c * KC + q * 8);
    }
  } else {
    const int cpr = n / 8;
    for (int i = threadIdx.x; i < KC * cpr; i += NTHREADS) {
      const int r = i / cpr, q = i - r * cpr;
      cp_async16(slot + (q * (KC / 8) + (r >> 3)) * CM + (r & 7) * 8,
                 w + (size_t)(c * KC + r) * n + q * 8);
    }
  }
}

// The first weight chunk of a layer, staged by the layer before it during
// its last chunk and its epilogue, so that no layer starts on an L2 round
// trip.
struct Chunk0 {
  const bf16* w = nullptr;   // the layer's first weight operand; null: none
  int n = 0, k1 = 0;         // its N and k1
  bool trans = false;
};

// acc[M, N] = a1[M, k1] @ op(w1) + a2[M, k2] @ op(w2) (+ bias), then EPI,
// for each ray of the block at once. a1 / a2 are the ray's core-matrix
// operands of widths ka1 / ka2. op(w) = w for TRANS == false (w [K, N]
// row-major), w^T for TRANS == true (w [N, K] row-major). k2 == 0 means no
// second operand (only the forward's skip layer fea_5 has one). Weight
// chunks of KC rows come through a 2-slot cp.async ring shared by both
// rays; each warpgroup multiplies its ray's 64 rows by the chunk with
// wgmma (64 x 192 or 64 x 64 pieces of N), the accumulators in registers,
// and its epilogue writes the result over the input it has consumed.
// `drain` (the previous layer's output, which this layer reads) goes to the
// stash a slice a chunk. With `staged0` the previous layer has staged this
// layer's chunk 0 already; `next` is the next layer's chunk 0, staged here
// once slot 0 is free. Starts with every warp past a __syncthreads; ends
// without one (a reader of the activations outside a layer syncs first).
template <int N, Epi EPI, bool TRANS>
__device__ __forceinline__ void layer(
    const Ray& ry, const bf16* a1, int ka1, int k1, const bf16* __restrict__ w1,
    const bf16* a2, int ka2, int k2, const bf16* __restrict__ w2,
    const float* __restrict__ bias, bf16* wbuf, const EpiArgs& e, const Drain& drain,
    bool staged0, const Chunk0& next) {
  constexpr int SEG = N % 192 == 0 ? 192 : 64;   // wgmma widths: 192 or 64 columns
  constexpr int NSEG = N / SEG;
  constexpr int TB = TRANS ? 0 : 1;
  static_assert(N % SEG == 0 && N <= H, "layer width");
  static_assert(WSTAGES == 2, "chunk 0 of the next layer goes to slot 0");
  const int t = ry.t, w4 = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;

  // acc[s][4 j + 2 r + i]: rows 16 w4 + g + 8 r, column s SEG + 8 j + 2 tq + i
  float acc[NSEG][SEG / 2];
#pragma unroll
  for (int s = 0; s < NSEG; ++s)
#pragma unroll
    for (int i = 0; i < SEG / 2; ++i) acc[s][i] = 0.0f;

  const int n1 = k1 / KC;
  const int n = n1 + k2 / KC;
  if (n % WSTAGES != 0) __trap();   // the last chunk would hold slot 0
  if (!staged0) stage_weights(wbuf, w1, N, k1, 0, TRANS);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();   // chunk c has landed; every warpgroup is past chunk c - 1
    if (c + 1 < n) {
      const bool first = c + 1 < n1;
      stage_weights(wbuf + ((c + 1) % WSTAGES) * SLOT, first ? w1 : w2, N, first ? k1 : k2,
                    first ? c + 1 : c + 1 - n1, TRANS);
    } else if (next.w != nullptr) {
      stage_weights(wbuf, next.w, next.n, next.k1, 0, next.trans);   // slot 0: chunk c - 1's
    }
    cp_async_commit();
    const bf16* wt = wbuf + (c % WSTAGES) * SLOT;
    const bf16* a = c < n1 ? a1 : a2;
    const int ka = c < n1 ? ka1 : ka2, kb = (c < n1 ? c : c - n1) * KC;
#pragma unroll
    for (int s = 0; s < NSEG; ++s) fence_acc(acc[s]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const uint64_t da = desc(a + ((kb + 16 * ks) >> 3) * CM, 128, ka * 16);
#pragma unroll
      for (int s = 0; s < NSEG; ++s) {
        const uint64_t db = desc(wt + ((s * SEG / 8) * (KC / 8) + 2 * ks) * CM, 128, KC * 16);
        if constexpr (SEG == 192)
          wgmma_n192<TB>(acc[s], da, db);
        else
          wgmma_n64<TB>(acc[s], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int s = 0; s < NSEG; ++s) fence_acc(acc[s]);
    const int total = M * (drain.width / 8), per = (total + n - 1) / n;
    drain_items(drain, t, c * per, min(total, (c + 1) * per));
  }
  __syncthreads();   // every product and every drain read is done: the input may be overwritten

  if constexpr (EPI == DOT_COLS) {
    // per row: the sum over its columns of (acc + bias) * gf; each thread
    // holds a quarter of them, the lanes tq = 0..3 of a row the rest
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < NSEG; ++s)
#pragma unroll
        for (int j = 0; j < SEG / 8; ++j) {
          const int col = s * SEG + 8 * j + 2 * tq;
          sum += (acc[s][4 * j + 2 * r] + bias[col]) * ry.gf[col] +
                 (acc[s][4 * j + 2 * r + 1] + bias[col + 1]) * ry.gf[col + 1];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (tq == 0) ry.dw[16 * w4 + g + 8 * r] = sum;
    }
  } else {
    constexpr int WORDS = N / 64;   // mask words a thread: N / 2 values
    uint32_t keep[WORDS], word[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      word[k] = 0;
      keep[k] = 0;
      if constexpr (EPI == MASK_BF16) keep[k] = e.mask[k * 128 + t];
    }
#pragma unroll
    for (int s = 0; s < NSEG; ++s)
#pragma unroll
      for (int j = 0; j < SEG / 8; ++j) {
        const int col = s * SEG + 8 * j + 2 * tq;
        float b0 = 0.0f, b1 = 0.0f;
        if (bias != nullptr) {
          b0 = bias[col];
          b1 = bias[col + 1];
        }
        float c0 = 0.0f, c1 = 0.0f;   // MASK: colv at the two columns
        if constexpr (EPI == MASK_BF16) {
          if (e.rowv != nullptr) {
            c0 = __bfloat162float(e.colv[col]);
            c1 = __bfloat162float(e.colv[col + 1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * w4 + g + 8 * r;
          float v0 = acc[s][4 * j + 2 * r] + b0, v1 = acc[s][4 * j + 2 * r + 1] + b1;
          const int bit = ((s * (SEG / 8) + j) * 2 + r) * 2;   // this pair's first bit
          if constexpr (EPI == F32_STORE || EPI == F32_ADD) {
            if (ry.live) {
              float2* dst = reinterpret_cast<float2*>(e.f32 + (size_t)row * N + col);
              if constexpr (EPI == F32_ADD) {
                const float2 o = *dst;
                v0 += o.x;
                v1 += o.y;
              }
              *dst = make_float2(v0, v1);
            }
          } else {
            if constexpr (EPI == RELU_BF16) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            if constexpr (EPI == MASK_BF16) {
              if (e.rowv != nullptr) {
                const float rv = e.rowv[row];
                v0 += rv * c0;
                v1 += rv * c1;
              }
              v0 *= (keep[bit >> 5] >> (bit & 31)) & 1u ? 1.0f : 0.0f;
              v1 *= (keep[bit >> 5] >> ((bit + 1) & 31)) & 1u ? 1.0f : 0.0f;
            }
            const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(ry.act + cidx(row, col, N)) = hv;
            if constexpr (EPI == RELU_BF16) {
              word[bit >> 5] |= (__low2float(hv) > 0.0f ? 1u : 0u) << (bit & 31);
              word[bit >> 5] |= (__high2float(hv) > 0.0f ? 1u : 0u) << ((bit + 1) & 31);
            }
          }
        }
      }
    if constexpr (EPI == RELU_BF16) {
      if (e.bits != nullptr) {
#pragma unroll
        for (int k = 0; k < WORDS; ++k) e.bits[k * 128 + t] = word[k];
      }
    }
  }
}

__device__ __forceinline__ EpiArgs masks(uint32_t* bits, const uint32_t* mask) {
  EpiArgs e;
  e.bits = bits;
  e.mask = mask;
  return e;
}

// 8 f32 -> 8 bf16 (round to nearest) in one 16-byte word
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return u;
}

// Two rays a block, one warpgroup each (ray 2 blockIdx.x + warpgroup).
__global__ void __launch_bounds__(NTHREADS, 1) ray_kernel(
    const float* __restrict__ pe, const float* __restrict__ zd,
    const float* __restrict__ zv, const float* __restrict__ gfeat,
    const float* __restrict__ gbg, const float* __restrict__ gdep,
    const bf16* __restrict__ w0p, const bf16* __restrict__ wh,
    const bf16* __restrict__ w5p, const bf16* __restrict__ w5x,
    const bf16* __restrict__ wd, const bf16* __restrict__ wr0,
    const bf16* __restrict__ wr1, const bf16* __restrict__ wr2,
    const float* __restrict__ b0, const float* __restrict__ bh,
    const float* __restrict__ b5, const float* __restrict__ bd,
    const float* __restrict__ br0, const float* __restrict__ br1,
    const float* __restrict__ br2, float* __restrict__ dpe,
    float* __restrict__ dzd, float* __restrict__ dzv, Stash st, int R, int rays) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x >> 7;
  unsigned char* base = smem + wg * SZ_RAY;
  Ray ry;
  ry.act = reinterpret_cast<bf16*>(base);
  ry.pe = reinterpret_cast<bf16*>(base + R_PE);
  ry.mask = reinterpret_cast<uint32_t*>(base + R_MASK);
  ry.sig_pre = reinterpret_cast<float*>(base + R_VEC);
  ry.wts = ry.sig_pre + M;
  ry.dsig = ry.wts + M;
  ry.dw = ry.dsig + M;
  ry.gf = reinterpret_cast<float*>(base + R_GF);
  ry.t = threadIdx.x & 127;
  bf16* wbuf = reinterpret_cast<bf16*>(smem + OFF_W);

  const int ray = blockIdx.x * RAYS + wg;   // b * R + r
  ry.live = ray < rays;
  const int b = (ry.live ? ray : blockIdx.x * RAYS) / R;
  const int t = ry.t, warp4 = t >> 5, lane = t & 31;
  const size_t p0 = (size_t)ray * M;  // the ray's first point
  uint32_t* mx = ry.mask;             // [8][MASK_X]
  uint32_t* mr1 = mx + 8 * MASK_X;
  bf16* act = ry.act;

  // pe [64 points, 64] f32 -> bf16, in shared memory and in the stash, 8 values a thread
  for (int i = t; i < M * PE / 8; i += 128) {
    const int p = i / (PE / 8), c = (i - p * (PE / 8)) * 8;
    float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (ry.live) {
      const float4* src = reinterpret_cast<const float4*>(pe + (p0 + p) * PE + c);
      const float4 u = src[0], v = src[1];
      f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
      f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
    }
    const uint4 h = pack8(f);
    *reinterpret_cast<uint4*>(ry.pe + cidx(p, c, PE)) = h;
    if (ry.live) __stcs(reinterpret_cast<uint4*>(st.pe + (p0 + p) * PE + c), h);
  }
  for (int c = t; c < FEAT; c += 128) ry.gf[c] = ry.live ? gfeat[(size_t)ray * FEAT + c] : 0.0f;

  // ---- forward recompute, every activation stashed (each by the layer
  // that reads it), every ReLU mask kept as bits; each layer stages the
  // next one's first weight chunk
  bf16* const* X = st.x;
  auto dr = [&](bf16* dst, int width) {
    Drain d;
    d.src = act;
    d.dst = ry.live ? dst : nullptr;
    d.width = width;
    return d;
  };
  auto nx = [](const bf16* w, int n, int k1, bool trans) {
    Chunk0 c;
    c.w = w;
    c.n = n;
    c.k1 = k1;
    c.trans = trans;
    return c;
  };
  const EpiArgs plain;
  layer<H, RELU_BF16, false>(ry, ry.pe, PE, PE, w0p, nullptr, 0, 0, nullptr, b0 + (size_t)b * H,
                             wbuf, masks(mx, nullptr), Drain(), false,
                             nx(wh, H, H, false));                                     // fea_0
  layer<H, RELU_BF16, false>(ry, act, H, H, wh, nullptr, 0, 0, nullptr, bh, wbuf,
                             masks(mx + MASK_X, nullptr), dr(X[0] + p0 * H, H), true,
                             nx(wh + HH, H, H, false));                                // fea_1
  layer<H, RELU_BF16, false>(ry, act, H, H, wh + HH, nullptr, 0, 0, nullptr, bh + H, wbuf,
                             masks(mx + 2 * MASK_X, nullptr), dr(X[1] + p0 * H, H), true,
                             nx(wh + 2 * HH, H, H, false));                            // fea_2
  layer<H, RELU_BF16, false>(ry, act, H, H, wh + 2 * HH, nullptr, 0, 0, nullptr, bh + 2 * H,
                             wbuf, masks(mx + 3 * MASK_X, nullptr), dr(X[2] + p0 * H, H), true,
                             nx(wh + 3 * HH, H, H, false));                            // fea_3
  layer<H, RELU_BF16, false>(ry, act, H, H, wh + 3 * HH, nullptr, 0, 0, nullptr, bh + 3 * H,
                             wbuf, masks(mx + 4 * MASK_X, nullptr), dr(X[3] + p0 * H, H), true,
                             nx(w5p, H, PE, false));                                   // fea_4
  layer<H, RELU_BF16, false>(ry, ry.pe, PE, PE, w5p, act, H, H, w5x, b5 + (size_t)b * H, wbuf,
                             masks(mx + 5 * MASK_X, nullptr), dr(X[4] + p0 * H, H), true,
                             nx(wh + 4 * HH, H, H, false));                            // fea_5 (skip)
  layer<H, RELU_BF16, false>(ry, act, H, H, wh + 4 * HH, nullptr, 0, 0, nullptr, bh + 4 * H,
                             wbuf, masks(mx + 6 * MASK_X, nullptr), dr(X[5] + p0 * H, H), true,
                             nx(wh + 5 * HH, H, H, false));                            // fea_6
  layer<H, RELU_BF16, false>(ry, act, H, H, wh + 5 * HH, nullptr, 0, 0, nullptr, bh + 5 * H,
                             wbuf, masks(mx + 7 * MASK_X, nullptr), dr(X[6] + p0 * H, H), true,
                             nx(wr0, H, H, false));                                    // fea_7
  __syncthreads();   // x7 complete before the density head reads it

  // density head: sigma_pre = x7 @ wd[:, 0] + bd, f32
  for (int p = warp4; p < M; p += 4) {
    float s = 0.0f;
    for (int k = lane; k < H; k += 32)
      s += __bfloat162float(act[cidx(p, k, H)]) * __bfloat162float(wd[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) ry.sig_pre[p] = s + bd[0];
  }

  layer<H, LINEAR_BF16, false>(ry, act, H, H, wr0, nullptr, 0, 0, nullptr, br0, wbuf, plain,
                               dr(X[7] + p0 * H, H), true, nx(wr1, H2, H, false));     // rgb_0
  layer<H2, RELU_BF16, false>(ry, act, H, H, wr1, nullptr, 0, 0, nullptr,
                              br1 + (size_t)b * H2, wbuf, masks(mr1, nullptr),
                              dr(st.r0 + p0 * H, H), true, nx(wr2, FEAT, H2, false));  // rgb_1
  layer<FEAT, DOT_COLS, false>(ry, act, H2, H2, wr2, nullptr, 0, 0, nullptr, br2, wbuf, plain,
                               dr(st.r1 + p0 * H2, H2), true,
                               nx(wr2, H2, FEAT, true));                               // rgb_2 . g_feat
  __syncthreads();

  // ---- composite forward and backward, one warp a ray, two samples a lane, f32
  if (warp4 == 0) {
    constexpr unsigned FULL = 0xffffffffu;
    const int p = 2 * lane;   // this lane's samples p, p + 1
    float2 zd2 = make_float2(0.0f, 0.0f), zv2 = zd2;
    float g_bg = 0.0f, g_depth = 0.0f;
    if (ry.live) {
      zd2 = *reinterpret_cast<const float2*>(zd + p0 + p);
      zv2 = *reinterpret_cast<const float2*>(zv + p0 + p);
      g_bg = gbg[ray];
      g_depth = gdep[ray];
    }
    const float zdv[2] = {zd2.x, zd2.y}, zvv[2] = {zv2.x, zv2.y};
    float sp[2], a[2], tt[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      sp[k] = ry.sig_pre[p + k];
      a[k] = 1.0f - expf(-fmaxf(sp[k], 0.0f) * zdv[k]);
      tt[k] = 1.0f - a[k] + 1e-10f;
    }
    // T[p] = prod_{q < p} t[q]: an inclusive product scan over the lanes of
    // t[p] t[p + 1], shifted by one lane
    float incl = tt[0] * tt[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl = v * incl;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float T[2] = {excl, excl * tt[0]};
    float w[2], d_w[2], c[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      w[k] = a[k] * T[k];
      ry.wts[p + k] = w[k];
      d_w[k] = ry.dw[p + k] + zvv[k] * g_depth - g_bg;
      c[k] = d_w[k] * w[k];
    }
    // suffix[p] = sum_{q > p} d_w[q] w[q]: an inclusive suffix sum over the
    // lanes of c[p] + c[p + 1], shifted by one lane
    float sfx = c[0] + c[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(FULL, sfx, o);
      if (lane + o < 32) sfx = sfx + v;
    }
    float after = __shfl_down_sync(FULL, sfx, 1);
    if (lane == 31) after = 0.0f;
    const float suffix[2] = {after + c[1], after};
    float ds[2], dzdv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float d_alpha = d_w[k] * T[k] - suffix[k] / tt[k];
      const float one_m_a = 1.0f - a[k];
      ds[k] = d_alpha * zdv[k] * one_m_a * (sp[k] > 0.0f ? 1.0f : 0.0f);
      dzdv[k] = d_alpha * fmaxf(sp[k], 0.0f) * one_m_a;
    }
    const __nv_bfloat162 h = __floats2bfloat162_rn(ds[0], ds[1]);
    ry.dsig[p] = __low2float(h);
    ry.dsig[p + 1] = __high2float(h);
    if (ry.live) {
      __stcs(reinterpret_cast<unsigned int*>(st.dsig + p0 + p),
             *reinterpret_cast<const unsigned int*>(&h));
      if (dzd != nullptr) {
        *reinterpret_cast<float2*>(dzd + p0 + p) = make_float2(dzdv[0], dzdv[1]);
        *reinterpret_cast<float2*>(dzv + p0 + p) = make_float2(w[0] * g_depth, w[1] * g_depth);
      }
    }
  }
  __syncthreads();

  // d_rgb = w[p] * g_feat[c], bf16, 8 values a thread, over r1 (already in the stash)
  for (int i = t; i < M * FEAT / 8; i += 128) {
    const int p = i / (FEAT / 8), c = (i - p * (FEAT / 8)) * 8;
    const float wp = ry.wts[p];
    float f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = wp * ry.gf[c + k];
    const uint4 h = pack8(f);
    *reinterpret_cast<uint4*>(act + cidx(p, c, FEAT)) = h;
    if (ry.live) __stcs(reinterpret_cast<uint4*>(st.drgb + (p0 + p) * FEAT + c), h);
  }

  // ---- gradient chain through the MLP: g = mask(g_next @ W^T)
  const Chunk0 after_g5 = dpe != nullptr ? nx(w5p, PE, H, true) : nx(w5x, H, H, true);
  layer<H2, MASK_BF16, true>(ry, act, FEAT, FEAT, wr2, nullptr, 0, 0, nullptr, nullptr, wbuf,
                             masks(nullptr, mr1), Drain(), true, nx(wr1, H, H2, true));  // d_r1
  layer<H, LINEAR_BF16, true>(ry, act, H2, H2, wr1, nullptr, 0, 0, nullptr, nullptr, wbuf, plain,
                              dr(st.dr1 + p0 * H2, H2), true, nx(wr0, H, H, true));      // d_r0
  {
    EpiArgs e = masks(nullptr, mx + 7 * MASK_X);
    e.rowv = ry.dsig;
    e.colv = wd;
    layer<H, MASK_BF16, true>(ry, act, H, H, wr0, nullptr, 0, 0, nullptr, nullptr, wbuf, e,
                              dr(st.dr0 + p0 * H, H), true, nx(wh + 5 * HH, H, H, true));  // g7
  }
  layer<H, MASK_BF16, true>(ry, act, H, H, wh + 5 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            masks(nullptr, mx + 6 * MASK_X), dr(st.g[7] + p0 * H, H), true,
                            nx(wh + 4 * HH, H, H, true));                              // g6
  layer<H, MASK_BF16, true>(ry, act, H, H, wh + 4 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            masks(nullptr, mx + 5 * MASK_X), dr(st.g[6] + p0 * H, H), true,
                            after_g5);                                                 // g5
  if (dpe != nullptr) {
    EpiArgs e;
    e.f32 = dpe + p0 * PE;
    layer<PE, F32_STORE, true>(ry, act, H, H, w5p, nullptr, 0, 0, nullptr, nullptr, wbuf, e,
                               Drain(), true, nx(w5x, H, H, true));                    // g5 w5p^T
  }
  layer<H, MASK_BF16, true>(ry, act, H, H, w5x, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            masks(nullptr, mx + 4 * MASK_X), dr(st.g[5] + p0 * H, H), true,
                            nx(wh + 3 * HH, H, H, true));                              // g4
  layer<H, MASK_BF16, true>(ry, act, H, H, wh + 3 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            masks(nullptr, mx + 3 * MASK_X), dr(st.g[4] + p0 * H, H), true,
                            nx(wh + 2 * HH, H, H, true));                              // g3
  layer<H, MASK_BF16, true>(ry, act, H, H, wh + 2 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            masks(nullptr, mx + 2 * MASK_X), dr(st.g[3] + p0 * H, H), true,
                            nx(wh + HH, H, H, true));                                  // g2
  layer<H, MASK_BF16, true>(ry, act, H, H, wh + HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            masks(nullptr, mx + MASK_X), dr(st.g[2] + p0 * H, H), true,
                            nx(wh, H, H, true));                                       // g1
  layer<H, MASK_BF16, true>(ry, act, H, H, wh, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            masks(nullptr, mx), dr(st.g[1] + p0 * H, H), true,
                            dpe != nullptr ? nx(w0p, PE, H, true) : Chunk0());         // g0
  if (dpe != nullptr) {
    EpiArgs e;
    e.f32 = dpe + p0 * PE;
    layer<PE, F32_ADD, true>(ry, act, H, H, w0p, nullptr, 0, 0, nullptr, nullptr, wbuf, e,
                             Drain(), true, Chunk0());                                 // + g0 w0p^T
  }
  __syncthreads();   // g0 complete: the last stash rows
  drain_items(dr(st.g[0] + p0 * H, H), t, 0, M * H / 8);
}

// the weight-gradient jobs of one launch over the stash, in the order of
// the partials; b0 / b5 / br1 summed per batch row
xtg::Plan weight_plan(const Stash& st, float* dw0p, float* dwh, float* dw5p, float* dw5x,
                      float* dwd, float* dwr0, float* dwr1, float* dwr2, float* db0, float* dbh,
                      float* db5, float* dbd, float* dbr0, float* dbr1, float* dbr2, int B) {
  xtg::Plan plan;
  plan.add(st.pe, st.g[0], PE, H, dw0p, 0, db0, 1, B);
  for (int l = 0; l < 4; ++l)   // fea_1 .. fea_4
    plan.add(st.x[l], st.g[l + 1], H, H, dwh + l * HH, 0, dbh + l * H, 0, B);
  plan.add(st.x[5], st.g[6], H, H, dwh + 4 * HH, 0, dbh + 4 * H, 0, B);   // fea_6
  plan.add(st.x[6], st.g[7], H, H, dwh + 5 * HH, 0, dbh + 5 * H, 0, B);   // fea_7
  plan.add(st.pe, st.g[5], PE, H, dw5p, 0, db5, 1, B);
  plan.add(st.x[4], st.g[5], H, H, dw5x, 0, nullptr, 0, B);
  plan.add(st.x[7], st.dr0, H, H, dwr0, 0, dbr0, 0, B);
  plan.add(st.r0, st.dr1, H, H2, dwr1, 0, dbr1, 1, B);
  plan.add(st.r1, st.drgb, H2, FEAT, dwr2, 0, dbr2, 0, B);
  plan.add(st.x[7], st.dsig, H, 1, dwd, 0, dbd, 0, B);                    // narrow
  return plan;
}

}  // namespace

// Launches the kernels above on `stream`, which belongs to the current
// device, using `scratch` (`scratch_size` bytes, allocated by the caller)
// for the stash and the partial sums. Every output is overwritten.
// dpe / dzd / dzv are written when input_grads is nonzero and may be null
// otherwise. Returns the first cudaError_t of the launches (0 on success);
// the caller raises on anything else.
extern "C" int fused_render_bwd_launch(
    const float* pe, const float* zd, const float* zv, const float* gfeat, const float* gbg,
    const float* gdep, const bf16* w0p, const bf16* wh, const bf16* w5p, const bf16* w5x,
    const bf16* wd, const bf16* wr0, const bf16* wr1, const bf16* wr2, const float* b0,
    const float* bh, const float* b5, const float* bd, const float* br0, const float* br1,
    const float* br2, float* dpe, float* dzd, float* dzv, float* dw0p, float* dwh, float* dw5p,
    float* dw5x, float* dwd, float* dwr0, float* dwr1, float* dwr2, float* db0, float* dbh,
    float* db5, float* dbd, float* dbr0, float* dbr1, float* dbr2, void* scratch, int B, int R,
    int input_grads, long long scratch_size, void* stream) {
  const long long rays = (long long)B * R;
  if (B <= 0 || R <= 0 || rays > INT_MAX / M) return (int)cudaErrorInvalidValue;
  if (input_grads && (dpe == nullptr || dzd == nullptr || dzv == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t N = (size_t)rays * M;

  // stash layout
  bf16* base = static_cast<bf16*>(scratch);
  size_t off = 0;
  auto take = [&](int width) {
    bf16* p = base + off;
    off += N * width;
    return p;
  };
  Stash st;
  st.pe = take(PE);
  for (int l = 0; l < 8; ++l) st.x[l] = take(H);
  st.r0 = take(H);
  st.r1 = take(H2);
  st.drgb = take(FEAT);
  st.dr1 = take(H2);
  st.dr0 = take(H);
  for (int l = 0; l < 8; ++l) st.g[l] = take(H);
  st.dsig = take(1);
  float* partial = reinterpret_cast<float*>(base + off);

  const xtg::Plan plan = weight_plan(st, dw0p, dwh, dw5p, dw5x, dwd, dwr0, dwr1, dwr2, db0, dbh,
                                     db5, dbd, dbr0, dbr1, dbr2, B);
  const int splits_b = xtg::splits_per_batch(plan.tiles(), B, R);
  const size_t need = off * sizeof(bf16) + plan.partial_bytes(B * splits_b);
  if (!plan.ok || scratch_size < 0 || (size_t)scratch_size < need)
    return (int)cudaErrorInvalidValue;

  static std::atomic<bool> smem_set[xtg::MAX_DEVICES];
  cudaError_t err = xtg::allow_smem(ray_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  ray_kernel<<<(unsigned)((rays + RAYS - 1) / RAYS), NTHREADS, SMEM, s>>>(
      pe, zd, zv, gfeat, gbg, gdep, w0p, wh, w5p, w5x, wd, wr0, wr1, wr2, b0, bh, b5, bd, br0,
      br1, br2, input_grads ? dpe : nullptr, input_grads ? dzd : nullptr,
      input_grads ? dzv : nullptr, st, R, (int)rays);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)plan.launch(partial, B, R, splits_b, s);
}

// The X^T G core alone, for its tests: job j is dw[j] = x[j]^T g[j] (x [P,
// in], g [P, out] bf16; out == 1: g [P]) and, unless db[j] is null, db[j] =
// the column sums of g[j]; dims[4 j .. 4 j + 3] = in, out, per_batch of dw,
// per_batch of db. The point axis is B batch rows of rows_per_batch rows
// of 64 points. `scratch` holds the partials. Returns the cudaError_t.
extern "C" int xtg_core_launch(const void* const* x, const void* const* g, const int* dims,
                               float* const* dw, float* const* db, int njobs, int B,
                               int rows_per_batch, void* scratch, long long scratch_size,
                               void* stream) {
  if (njobs <= 0 || njobs > xtg::MAX_JOBS || B <= 0 || rows_per_batch <= 0)
    return (int)cudaErrorInvalidValue;
  xtg::Plan plan;
  for (int j = 0; j < njobs; ++j)
    plan.add(static_cast<const bf16*>(x[j]), static_cast<const bf16*>(g[j]), dims[4 * j],
             dims[4 * j + 1], dw[j], dims[4 * j + 2], db[j], dims[4 * j + 3], B);
  const int splits_b = xtg::splits_per_batch(plan.tiles(), B, rows_per_batch);
  if (!plan.ok || scratch_size < 0 || (size_t)scratch_size < plan.partial_bytes(B * splits_b))
    return (int)cudaErrorInvalidValue;
  return (int)plan.launch(static_cast<float*>(scratch), B, rows_per_batch, splits_b,
                          (cudaStream_t)stream);
}
