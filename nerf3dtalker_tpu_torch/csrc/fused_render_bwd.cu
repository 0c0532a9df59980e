// Fused NeRF point-MLP + alpha composite, backward, for Hopper (sm_90a).
//
// Replaces nerf3dtalker_tpu/ops/pallas/fused_render.py:fused_render_bwd
// (body _bwd_kernel, _mlp_tile_fwd_stash). For the cotangents of the
// forward's outputs (feat [B, R, 256], bg_alpha and depth [B, R]) it
// recomputes the forward, backpropagates the composite in f32 and the point
// MLP through all of its layers, and returns every weight and bias gradient
// in f32: the shared ones summed over every point of every batch row, the
// per-batch b0 / b5 / br1 summed over the batch row's points. With
// input_grads it also writes d_pe = g0 w0p^T + g5 w5p^T, d_zd and d_zv.
// It rounds where the TPU kernel rounds: activations and gradient
// activations in bf16 (ReLU masks applied in f32 before the cast), d_sigma
// in f32 before its cast, every product and sum accumulated in f32.
//
// Bound: compute. Per point the recompute is 1,352,064 MACs, the weight
// gradients as many again and the input-gradient chain 1,302,912 (without
// the w0p / w5p rows), 8.01 MFLOP against the ~1.3 KB of pe, z and g it
// must read; at the Reso64 training shape (B=2, R=4096, 524,288 points)
// that is 4.20 TFLOP, 4.25 ms at the card's 989 TFLOP/s bf16 peak.
//
// Design (a first kernel: simple and right). The TPU kernel accumulates
// every weight gradient in VMEM across a grid that runs in order; here
// blocks run in parallel and in no order, and one ray's stash of
// activations (11 x [64, <=384] bf16, ~475 KB) does not fit in a block's
// 227 KB of shared memory. So the work is cut in four launches on one
// stream, all deterministic (no atomics):
//   1. ray_kernel, one block of 8 warps per ray (64 points), with K1's
//      layer loop (nvcuda::wmma bf16 -> f32, weights streamed from L2 in
//      32-row chunks through a cp.async double buffer): the forward
//      recompute, then the composite backward (one thread, f32), then the
//      gradient chain d_rgb -> d_r1 -> d_r0 -> g7 .. g0, whose products
//      with W^T load W as col_major fragments of a column chunk, so no
//      transposed copy of the weights is made. Every activation and every
//      gradient activation goes to a bf16 scratch in device memory
//      (7,617 values a point, 8.0 GB at the Reso64 training shape).
//   2. xtg_kernel: each dW = X^T G as 64x64 output tiles, the point axis
//      cut in splits of (at most) 64 whole rays that never cross a batch
//      row; one block per (tile, split) sums its split into an f32 partial
//      (128 splits, 0.69 GB of partials at the Reso64 training shape).
//   3. colsum_kernel: the bias gradients (and dwd = x7^T d_sigma, dbd) as
//      f32 column sums of the split, one thread per column.
//   4. reduce_kernel: the partials of the splits added in split order, over
//      all splits or over the batch row's splits for b0 / b5 / br1.
// The scratch traffic (8 GB written, read again by 2 and 3) is the cost of
// this design, not part of the bound. wgmma, TMA, keeping the stash on chip
// and fusing 2-4 are left for later work.

#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int H = 384;      // hidden width
constexpr int H2 = 192;     // rgb_1 width
constexpr int PE = 64;      // padded positional encoding width
constexpr int NS = 64;      // samples per ray
constexpr int FEAT = 256;   // feature channels
constexpr int M = NS;       // points per block: one ray
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MF = M / 16;  // 16-row fragments per block
constexpr int KC = 32;      // contraction rows per staged weight chunk
constexpr int PAD = 8;      // bf16 row padding against bank conflicts
constexpr int LDA = H + PAD;
constexpr int LDP = PE + PAD;
constexpr int LDT = KC + PAD;  // row of a staged column chunk of W (for W^T)
constexpr size_t HH = (size_t)H * H;

constexpr int SZ_PE = M * LDP * 2;
constexpr int SZ_ACT = M * LDA * 2;
constexpr int SZ_W_ROWS = 2 * KC * LDA * 2;
constexpr int SZ_W_COLS = 2 * H * LDT * 2;
constexpr int SZ_W = SZ_W_ROWS > SZ_W_COLS ? SZ_W_ROWS : SZ_W_COLS;
constexpr int SZ_SCR = NWARPS * 256 * 4;
constexpr int NVEC = 7;     // sig_pre, alpha, t, T, wts, d_sigma (bf16-rounded), d_w
constexpr int SZ_VEC = NVEC * M * 4;
constexpr int SZ_DWP = (FEAT / 16) * M * 4;
constexpr int SZ_GF = FEAT * 4;
constexpr int OFF_PE = 0;
constexpr int OFF_A = OFF_PE + SZ_PE;
constexpr int OFF_B = OFF_A + SZ_ACT;
constexpr int OFF_W = OFF_B + SZ_ACT;
constexpr int OFF_SCR = OFF_W + SZ_W;
constexpr int OFF_VEC = OFF_SCR + SZ_SCR;
constexpr int OFF_DWP = OFF_VEC + SZ_VEC;
constexpr int OFF_GF = OFF_DWP + SZ_DWP;
constexpr int SMEM = OFF_GF + SZ_GF;  // 185,344 bytes
static_assert(SMEM <= 232448, "shared memory over the per-block limit");
static_assert(OFF_A % 128 == 0 && OFF_B % 128 == 0 && OFF_W % 128 == 0 &&
              OFF_SCR % 128 == 0 && OFF_VEC % 128 == 0 && OFF_DWP % 128 == 0 &&
              OFF_GF % 128 == 0, "smem alignment");

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

enum Epi { RELU_BF16, LINEAR_BF16, MASK_BF16, DOT_COLS, F32_STORE, F32_ADD };

// Where a layer's epilogue puts its [M, N] result (rows of this ray).
struct EpiArgs {
  bf16* out = nullptr;          // shared [M, LDA] bf16 (RELU / LINEAR / MASK)
  bf16* stash = nullptr;        // device [M, N] bf16 copy, or null
  const bf16* mask = nullptr;   // device [M, N] activation: v * (act > 0) (MASK)
  const float* rowv = nullptr;  // shared [M]; with colv, v += rowv[r] * colv[c] (MASK)
  const bf16* colv = nullptr;   // device [N]
  const float* gf = nullptr;    // shared [N] (DOT_COLS)
  float* dwp = nullptr;         // shared [N / 16][M] per-strip row dots (DOT_COLS)
  float* f32 = nullptr;         // device [M, N] f32 (F32_STORE / F32_ADD)
};

// acc[M, N] = a1[M, k1] @ op(w1) + a2[M, k2] @ op(w2) (+ bias), then EPI.
// a1 / a2 are bf16 in shared memory. op(w) = w for TRANS == false, w being
// [K, N] row-major in device memory and staged KC rows at a time; op(w) =
// w^T for TRANS == true, w being [N, K] row-major and staged KC columns at a
// time (a col_major fragment of the staged chunk is a tile of w^T). k2 == 0
// means no second operand (only the forward's skip layer fea_5 has one).
// Starts and ends with every warp past a __syncthreads, so consecutive
// layers need no barrier between them.
template <int N, Epi EPI, bool TRANS>
__device__ __forceinline__ void layer(
    const bf16* a1, int lda1, int k1, const bf16* __restrict__ w1,
    const bf16* a2, int lda2, int k2, const bf16* __restrict__ w2,
    const float* __restrict__ bias, bf16* wbuf, float* scratch, const EpiArgs& e) {
  constexpr int NF = N / 16;
  constexpr int NJ = (NF + NWARPS - 1) / NWARPS;
  constexpr int LDW = N + PAD;
  constexpr int STAGE = TRANS ? N * LDT : KC * LDW;
  using BLayout = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NJ];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n1 = k1 / KC;
  const int n = n1 + k2 / KC;
  auto stage = [&](int c) {
    bf16* dst = wbuf + (c & 1) * STAGE;
    if constexpr (TRANS) {
      // rows of w [N, k1], columns c*KC .. c*KC + KC: 4 copies of 16 bytes a row
      for (int i = threadIdx.x; i < N * (KC / 8); i += NTHREADS) {
        const int r = i >> 2, q = i & 3;
        cp_async16(dst + r * LDT + q * 8, w1 + (size_t)r * k1 + c * KC + q * 8);
      }
    } else {
      constexpr int CPR = N / 8;  // 16-byte copies per weight row
      const bf16* src = c < n1 ? w1 + (size_t)c * KC * N : w2 + (size_t)(c - n1) * KC * N;
      for (int i = threadIdx.x; i < KC * CPR; i += NTHREADS) {
        const int r = i / CPR, q = i - r * CPR;
        cp_async16(dst + r * LDW + q * 8, src + (size_t)r * N + q * 8);
      }
    }
    cp_async_commit();
  };

  stage(0);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wt = wbuf + (c & 1) * STAGE;
    const bf16* a = c < n1 ? a1 + c * KC : a2 + (c - n1) * KC;
    const int lda = c < n1 ? lda1 : lda2;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[MF];
#pragma unroll
      for (int i = 0; i < MF; ++i) wmma::load_matrix_sync(fa[i], a + i * 16 * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nf = warp + j * NWARPS;
        if (nf < NF) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
          if constexpr (TRANS)
            wmma::load_matrix_sync(fb, wt + nf * 16 * LDT + kk, LDT);
          else
            wmma::load_matrix_sync(fb, wt + kk * LDW + nf * 16, LDW);
#pragma unroll
          for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled by stage(c + 2)
  }

  float* scr = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int nf = warp + j * NWARPS;
    if (nf >= NF) continue;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      if constexpr (EPI == DOT_COLS) {
        // row i*16 + lane: sum over the strip's 16 columns of
        // (acc + bias) * gf, in column order
        if (lane < 16) {
          float s = 0.0f;
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const int col = nf * 16 + c;
            s += (scr[lane * 16 + c] + bias[col]) * e.gf[col];
          }
          e.dwp[nf * M + i * 16 + lane] = s;
        }
      } else {
        // lane's 8 elements of the 16x16 tile: rows 2t + lane / 16, column lane % 16
        const int col = nf * 16 + (lane & 15);
        float keep[8];  // MASK: the activation's (act > 0), all 8 loads in flight together
        if constexpr (EPI == MASK_BF16) {
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int row = i * 16 + 2 * t + (lane >> 4);
            keep[t] = __bfloat162float(e.mask[(size_t)row * N + col]) > 0.0f ? 1.0f : 0.0f;
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int q = lane + 32 * t, row = i * 16 + (q >> 4);
          float v = scr[q];
          if (bias != nullptr) v += bias[col];
          if constexpr (EPI == F32_STORE) {
            e.f32[(size_t)row * N + col] = v;
          } else if constexpr (EPI == F32_ADD) {
            e.f32[(size_t)row * N + col] += v;
          } else {
            if constexpr (EPI == RELU_BF16) v = fmaxf(v, 0.0f);
            if constexpr (EPI == MASK_BF16) {
              if (e.rowv != nullptr) v += e.rowv[row] * __bfloat162float(e.colv[col]);
              v *= keep[t];
            }
            const bf16 h = __float2bfloat16(v);
            e.out[row * LDA + col] = h;
            if (e.stash != nullptr) e.stash[(size_t)row * N + col] = h;
          }
        }
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ EpiArgs to(bf16* out, bf16* stash, const bf16* mask = nullptr) {
  EpiArgs e;
  e.out = out;
  e.stash = stash;
  e.mask = mask;
  return e;
}

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
    float* __restrict__ dzd, float* __restrict__ dzv, Stash st, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pe_s = reinterpret_cast<bf16*>(smem + OFF_PE);
  bf16* xa = reinterpret_cast<bf16*>(smem + OFF_A);
  bf16* xb = reinterpret_cast<bf16*>(smem + OFF_B);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + OFF_W);
  float* scratch = reinterpret_cast<float*>(smem + OFF_SCR);
  float* sig_pre = reinterpret_cast<float*>(smem + OFF_VEC);
  float* alpha = sig_pre + M;
  float* tv = alpha + M;
  float* trans = tv + M;
  float* wts = trans + M;
  float* dsig = wts + M;   // d_sigma_pre rounded to bf16, as f32
  float* dw = dsig + M;    // d_w from the rgb head: sum_c rgb[p, c] * g_feat[c]
  float* dwp = reinterpret_cast<float*>(smem + OFF_DWP);
  float* gf = reinterpret_cast<float*>(smem + OFF_GF);

  const int ray = blockIdx.x;  // b * R + r
  const int b = ray / R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t p0 = (size_t)ray * M;  // the ray's first point

  // pe [64 points, 64] f32 -> bf16, in shared memory and in the stash
  const float4* pe4 = reinterpret_cast<const float4*>(pe + p0 * PE);
  for (int i = tid; i < M * PE / 4; i += NTHREADS) {
    const float4 v = pe4[i];
    const int p = i / (PE / 4), c = (i - p * (PE / 4)) * 4;
    const bf16 h[4] = {__float2bfloat16(v.x), __float2bfloat16(v.y), __float2bfloat16(v.z),
                       __float2bfloat16(v.w)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pe_s[p * LDP + c + k] = h[k];
      st.pe[(p0 + p) * PE + c + k] = h[k];
    }
  }
  for (int c = tid; c < FEAT; c += NTHREADS) gf[c] = gfeat[(size_t)ray * FEAT + c];

  // ---- forward recompute, every activation stashed
  bf16* const* X = st.x;
  layer<H, RELU_BF16, false>(pe_s, LDP, PE, w0p, nullptr, 0, 0, nullptr, b0 + (size_t)b * H,
                             wbuf, scratch, to(xa, X[0] + p0 * H));           // fea_0
  layer<H, RELU_BF16, false>(xa, LDA, H, wh, nullptr, 0, 0, nullptr, bh, wbuf, scratch,
                             to(xb, X[1] + p0 * H));                          // fea_1
  layer<H, RELU_BF16, false>(xb, LDA, H, wh + HH, nullptr, 0, 0, nullptr, bh + H, wbuf,
                             scratch, to(xa, X[2] + p0 * H));                 // fea_2
  layer<H, RELU_BF16, false>(xa, LDA, H, wh + 2 * HH, nullptr, 0, 0, nullptr, bh + 2 * H,
                             wbuf, scratch, to(xb, X[3] + p0 * H));           // fea_3
  layer<H, RELU_BF16, false>(xb, LDA, H, wh + 3 * HH, nullptr, 0, 0, nullptr, bh + 3 * H,
                             wbuf, scratch, to(xa, X[4] + p0 * H));           // fea_4
  layer<H, RELU_BF16, false>(pe_s, LDP, PE, w5p, xa, LDA, H, w5x, b5 + (size_t)b * H, wbuf,
                             scratch, to(xb, X[5] + p0 * H));                 // fea_5 (skip)
  layer<H, RELU_BF16, false>(xb, LDA, H, wh + 4 * HH, nullptr, 0, 0, nullptr, bh + 4 * H,
                             wbuf, scratch, to(xa, X[6] + p0 * H));           // fea_6
  layer<H, RELU_BF16, false>(xa, LDA, H, wh + 5 * HH, nullptr, 0, 0, nullptr, bh + 5 * H,
                             wbuf, scratch, to(xb, X[7] + p0 * H));           // fea_7
  __syncthreads();  // x7 = xb complete before the density head reads it

  // density head: sigma_pre = x7 @ wd[:, 0] + bd, f32
  for (int p = warp; p < M; p += NWARPS) {
    float s = 0.0f;
    for (int k = lane; k < H; k += 32)
      s += __bfloat162float(xb[p * LDA + k]) * __bfloat162float(wd[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sig_pre[p] = s + bd[0];
  }

  layer<H, LINEAR_BF16, false>(xb, LDA, H, wr0, nullptr, 0, 0, nullptr, br0, wbuf, scratch,
                               to(xa, st.r0 + p0 * H));                       // rgb_0
  layer<H2, RELU_BF16, false>(xa, LDA, H, wr1, nullptr, 0, 0, nullptr, br1 + (size_t)b * H2,
                              wbuf, scratch, to(xb, st.r1 + p0 * H2));        // rgb_1
  {
    EpiArgs e;
    e.gf = gf;
    e.dwp = dwp;
    layer<FEAT, DOT_COLS, false>(xb, LDA, H2, wr2, nullptr, 0, 0, nullptr, br2, wbuf,
                                 scratch, e);                                 // rgb_2 . g_feat
  }
  __syncthreads();
  if (tid < M) {
    float s = 0.0f;
    for (int f = 0; f < FEAT / 16; ++f) s += dwp[f * M + tid];
    dw[tid] = s;
  }
  __syncthreads();

  // ---- composite forward and backward, one thread, f32
  if (tid == 0) {
    const float* zdr = zd + p0;
    const float* zvr = zv + p0;
    float tr = 1.0f;
    for (int p = 0; p < M; ++p) {
      const float a = 1.0f - expf(-fmaxf(sig_pre[p], 0.0f) * zdr[p]);
      const float t = 1.0f - a + 1e-10f;
      alpha[p] = a;
      tv[p] = t;
      trans[p] = tr;
      wts[p] = a * tr;
      tr *= t;
    }
    const float g_bg = gbg[ray], g_depth = gdep[ray];
    float suffix = 0.0f;  // sum over later samples of d_w * w
    for (int p = M - 1; p >= 0; --p) {
      const float d_w = dw[p] + zvr[p] * g_depth - g_bg;
      const float d_alpha = d_w * trans[p] - suffix / tv[p];
      suffix += d_w * wts[p];
      const float one_m_a = 1.0f - alpha[p];
      const float d_sigma = d_alpha * zdr[p] * one_m_a * (sig_pre[p] > 0.0f ? 1.0f : 0.0f);
      const bf16 h = __float2bfloat16(d_sigma);
      dsig[p] = __bfloat162float(h);
      st.dsig[p0 + p] = h;
      if (dzd != nullptr) {
        dzd[p0 + p] = d_alpha * fmaxf(sig_pre[p], 0.0f) * one_m_a;
        dzv[p0 + p] = wts[p] * g_depth;
      }
    }
  }
  __syncthreads();

  // d_rgb = w[p] * g_feat[c], bf16
  for (int i = tid; i < M * FEAT; i += NTHREADS) {
    const int p = i / FEAT, c = i - p * FEAT;
    const bf16 h = __float2bfloat16(wts[p] * gf[c]);
    xa[p * LDA + c] = h;
    st.drgb[(p0 + p) * FEAT + c] = h;
  }

  // ---- gradient chain through the MLP: g = mask(g_next @ W^T)
  layer<H2, MASK_BF16, true>(xa, LDA, FEAT, wr2, nullptr, 0, 0, nullptr, nullptr, wbuf, scratch,
                             to(xb, st.dr1 + p0 * H2, st.r1 + p0 * H2));       // d_r1
  layer<H, LINEAR_BF16, true>(xb, LDA, H2, wr1, nullptr, 0, 0, nullptr, nullptr, wbuf, scratch,
                              to(xa, st.dr0 + p0 * H));                        // d_r0
  {
    EpiArgs e = to(xb, st.g[7] + p0 * H, X[7] + p0 * H);
    e.rowv = dsig;
    e.colv = wd;
    layer<H, MASK_BF16, true>(xa, LDA, H, wr0, nullptr, 0, 0, nullptr, nullptr, wbuf, scratch,
                              e);                                              // g7
  }
  layer<H, MASK_BF16, true>(xb, LDA, H, wh + 5 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            scratch, to(xa, st.g[6] + p0 * H, X[6] + p0 * H));  // g6
  layer<H, MASK_BF16, true>(xa, LDA, H, wh + 4 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            scratch, to(xb, st.g[5] + p0 * H, X[5] + p0 * H));  // g5
  if (dpe != nullptr) {
    EpiArgs e;
    e.f32 = dpe + p0 * PE;
    layer<PE, F32_STORE, true>(xb, LDA, H, w5p, nullptr, 0, 0, nullptr, nullptr, wbuf, scratch,
                               e);                                             // g5 w5p^T
  }
  layer<H, MASK_BF16, true>(xb, LDA, H, w5x, nullptr, 0, 0, nullptr, nullptr, wbuf, scratch,
                            to(xa, st.g[4] + p0 * H, X[4] + p0 * H));           // g4
  layer<H, MASK_BF16, true>(xa, LDA, H, wh + 3 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            scratch, to(xb, st.g[3] + p0 * H, X[3] + p0 * H));  // g3
  layer<H, MASK_BF16, true>(xb, LDA, H, wh + 2 * HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            scratch, to(xa, st.g[2] + p0 * H, X[2] + p0 * H));  // g2
  layer<H, MASK_BF16, true>(xa, LDA, H, wh + HH, nullptr, 0, 0, nullptr, nullptr, wbuf,
                            scratch, to(xb, st.g[1] + p0 * H, X[1] + p0 * H));  // g1
  layer<H, MASK_BF16, true>(xb, LDA, H, wh, nullptr, 0, 0, nullptr, nullptr, wbuf, scratch,
                            to(xa, st.g[0] + p0 * H, X[0] + p0 * H));           // g0
  if (dpe != nullptr) {
    EpiArgs e;
    e.f32 = dpe + p0 * PE;
    layer<PE, F32_ADD, true>(xa, LDA, H, w0p, nullptr, 0, 0, nullptr, nullptr, wbuf, scratch,
                             e);                                               // + g0 w0p^T
  }
}

// ---- weight gradients: dW = X^T G over one split of the point axis

// rays per reduction split (at most): 4,096 points, so that the column sums
// (one thread per column walks its split) have blocks enough to fill the card
constexpr int SPLIT_RAYS = 64;
constexpr int XT = 64;      // output tile edge
constexpr int XK = 32;      // points per staged chunk
constexpr int XLD = XT + PAD;
constexpr int MAX_XJOBS = 12;

struct XJob {
  const bf16* x;  // [N, in]
  const bf16* g;  // [N, out]
  int in, out;
  int part;       // offset of dW [in, out] within a split's partials
};
struct XJobs {
  XJob job[MAX_XJOBS];
  int tile_start[MAX_XJOBS + 1];
  int n;
};

__global__ void __launch_bounds__(128) xtg_kernel(XJobs jobs, float* __restrict__ partial,
                                                  size_t split_stride, int chunk) {
  constexpr int BUF = 2 * XK * XLD * (int)sizeof(bf16);
  __shared__ __align__(128) unsigned char raw[2 * BUF];
  bf16(*xs)[XK][XLD] = reinterpret_cast<bf16(*)[XK][XLD]>(raw);        // [2][XK][XLD]
  bf16(*gs)[XK][XLD] = reinterpret_cast<bf16(*)[XK][XLD]>(raw + BUF);  // [2][XK][XLD]
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.tile_start[j + 1]) ++j;
  const XJob jb = jobs.job[j];
  const int t = blockIdx.x - jobs.tile_start[j];
  const int tiles_n = jb.out / XT;
  const int m0 = (t / tiles_n) * XT, n0 = (t % tiles_n) * XT;
  const size_t pbeg = (size_t)blockIdx.y * chunk;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k) wmma::fill_fragment(acc[i][k], 0.0f);

  auto stage = [&](int c) {
    const size_t p = pbeg + (size_t)c * XK;
    for (int i = threadIdx.x; i < XK * (XT / 8); i += 128) {
      const int r = i / (XT / 8), q = i - r * (XT / 8);
      cp_async16(&xs[c & 1][r][q * 8], jb.x + (p + r) * jb.in + m0 + q * 8);
      cp_async16(&gs[c & 1][r][q * 8], jb.g + (p + r) * jb.out + n0 + q * 8);
    }
    cp_async_commit();
  };

  const int n = chunk / XK;
  stage(0);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < XK; kk += 16) {
      // A = X^T: element (m, k) is xs[k][m], a col_major fragment
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &xs[c & 1][kk][wm + i * 16], XLD);
#pragma unroll
      for (int k = 0; k < 2; ++k) wmma::load_matrix_sync(fb[k], &gs[c & 1][kk][wn + k * 16], XLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k) wmma::mma_sync(acc[i][k], fa[i], fb[k], acc[i][k]);
    }
    __syncthreads();
  }
  float* out = partial + blockIdx.y * split_stride + jb.part;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      wmma::store_matrix_sync(out + (size_t)(m0 + wm + i * 16) * jb.out + n0 + wn + k * 16,
                              acc[i][k], jb.out, wmma::mem_row_major);
}

// ---- bias gradients (and dwd, dbd): column sums over one split

constexpr int MAX_CJOBS = 13;

struct CJob {
  const bf16* src;  // [N, width]
  const bf16* wt;   // [N] per-point factor, or null
  int width;
  int part;         // offset within a split's partials
  int col_start;    // first global column of this job
};
struct CJobs {
  CJob job[MAX_CJOBS];
  int n, cols;
};

__global__ void __launch_bounds__(128) colsum_kernel(CJobs jobs, float* __restrict__ partial,
                                                     size_t split_stride, int chunk) {
  const int col = blockIdx.x * 128 + threadIdx.x;
  if (col >= jobs.cols) return;
  int j = 0;
  while (j + 1 < jobs.n && col >= jobs.job[j + 1].col_start) ++j;
  const CJob jb = jobs.job[j];
  const int c = col - jb.col_start;
  const size_t pbeg = (size_t)blockIdx.y * chunk;
  const bf16* s = jb.src + pbeg * jb.width + c;
  float acc = 0.0f;
  if (jb.wt != nullptr) {
    const bf16* w = jb.wt + pbeg;
#pragma unroll 8
    for (int p = 0; p < chunk; ++p)
      acc += __bfloat162float(s[(size_t)p * jb.width]) * __bfloat162float(w[p]);
  } else {
#pragma unroll 8
    for (int p = 0; p < chunk; ++p) acc += __bfloat162float(s[(size_t)p * jb.width]);
  }
  partial[blockIdx.y * split_stride + jb.part + c] = acc;
}

// ---- the splits' partials added in split order

constexpr int MAX_RJOBS = MAX_XJOBS + MAX_CJOBS;

struct RJob {
  float* out;
  int part, count, per_batch;
  int start;  // first global output index of this job
};
struct RJobs {
  RJob job[MAX_RJOBS];
  int n, total;
};

__global__ void __launch_bounds__(256) reduce_kernel(RJobs jobs, const float* __restrict__ partial,
                                                     size_t split_stride, int splits,
                                                     int splits_per_batch) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= jobs.total) return;
  int j = 0;
  while (j + 1 < jobs.n && idx >= jobs.job[j + 1].start) ++j;
  const RJob jb = jobs.job[j];
  const int local = idx - jb.start;
  int s0 = 0, s1 = splits, i = local;
  if (jb.per_batch) {
    const int b = local / jb.count;
    i = local - b * jb.count;
    s0 = b * splits_per_batch;
    s1 = s0 + splits_per_batch;
  }
  float acc = 0.0f;
  for (int s = s0; s < s1; ++s) acc += partial[s * split_stride + jb.part + i];
  jb.out[local] = acc;
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

// Launches the four kernels above on `stream`, which belongs to the current
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
  const int rays_per_split = gcd(R, SPLIT_RAYS);
  const int chunk = rays_per_split * M;
  const int splits = (int)(rays / rays_per_split);
  const int splits_per_batch = R / rays_per_split;

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

  // jobs: weight gradients first, then the column sums
  XJobs xj{};
  RJobs rj{};
  int part = 0;
  auto xjob = [&](const bf16* x, const bf16* g, int in, int out, float* dst) {
    XJob& jb = xj.job[xj.n];
    jb.x = x;
    jb.g = g;
    jb.in = in;
    jb.out = out;
    jb.part = part;
    xj.tile_start[xj.n + 1] = xj.tile_start[xj.n] + (in / XT) * (out / XT);
    ++xj.n;
    rj.job[rj.n] = RJob{dst, part, in * out, 0, rj.total};
    rj.total += in * out;
    ++rj.n;
    part += in * out;
  };
  xjob(st.pe, st.g[0], PE, H, dw0p);
  for (int l = 0; l < 4; ++l) xjob(st.x[l], st.g[l + 1], H, H, dwh + l * HH);  // fea_1..4
  xjob(st.x[5], st.g[6], H, H, dwh + 4 * HH);                                  // fea_6
  xjob(st.x[6], st.g[7], H, H, dwh + 5 * HH);                                  // fea_7
  xjob(st.pe, st.g[5], PE, H, dw5p);
  xjob(st.x[4], st.g[5], H, H, dw5x);
  xjob(st.x[7], st.dr0, H, H, dwr0);
  xjob(st.r0, st.dr1, H, H2, dwr1);
  xjob(st.r1, st.drgb, H2, FEAT, dwr2);

  CJobs cj{};
  auto cjob = [&](const bf16* src, const bf16* wt, int width, float* dst, int per_batch) {
    cj.job[cj.n] = CJob{src, wt, width, part, cj.cols};
    ++cj.n;
    cj.cols += width;
    rj.job[rj.n] = RJob{dst, part, width, per_batch, rj.total};
    rj.total += per_batch ? B * width : width;
    ++rj.n;
    part += width;
  };
  cjob(st.x[7], st.dsig, H, dwd, 0);
  cjob(st.dsig, nullptr, 1, dbd, 0);
  cjob(st.g[0], nullptr, H, db0, 1);
  for (int l = 0; l < 4; ++l) cjob(st.g[l + 1], nullptr, H, dbh + l * H, 0);
  cjob(st.g[5], nullptr, H, db5, 1);
  cjob(st.g[6], nullptr, H, dbh + 4 * H, 0);
  cjob(st.g[7], nullptr, H, dbh + 5 * H, 0);
  cjob(st.dr0, nullptr, H, dbr0, 0);
  cjob(st.dr1, nullptr, H2, dbr1, 1);
  cjob(st.drgb, nullptr, FEAT, dbr2, 0);

  const size_t split_stride = ((size_t)part + 63) / 64 * 64;
  const size_t need = off * sizeof(bf16) + (size_t)splits * split_stride * sizeof(float);
  if (scratch_size < 0 || (size_t)scratch_size < need) return (int)cudaErrorInvalidValue;

  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load()) {
    err = cudaFuncSetAttribute(ray_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true);
  }
  cudaStream_t s = (cudaStream_t)stream;
  ray_kernel<<<(unsigned)rays, NTHREADS, SMEM, s>>>(
      pe, zd, zv, gfeat, gbg, gdep, w0p, wh, w5p, w5x, wd, wr0, wr1, wr2, b0, bh, b5, bd, br0,
      br1, br2, input_grads ? dpe : nullptr, input_grads ? dzd : nullptr,
      input_grads ? dzv : nullptr, st, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  xtg_kernel<<<dim3(xj.tile_start[xj.n], splits), 128, 0, s>>>(xj, partial, split_stride, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  colsum_kernel<<<dim3((cj.cols + 127) / 128, splits), 128, 0, s>>>(cj, partial, split_stride,
                                                                      chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<(rj.total + 255) / 256, 256, 0, s>>>(rj, partial, split_stride, splits,
                                                       splits_per_batch);
  return (int)cudaGetLastError();
}
