// Fused phase-stacked upsampler block, forward, for Hopper (sm_90a).
//
// Replaces nerf3dtalker_tpu/ops/pallas/fused_upsampler.py:_fwd_call (body
// _fwd_kernel, _forward_body -> models/phase_renderer.py:
// phase_block_forward). One PixelShuffleUpsample block of the NeuralRenderer
// decoder plus the rgb pyramid step, level i -> i+1, on phase stacks
// [B, 4^i, Hc, Wc, C] -> [B, 4^(i+1), Hc, Wc, Cn] (bf16), addressed as the
// fine images they are:
//   h1 = lrelu(D1 x), h2 = lrelu(D2 h1) (phase-major columns q = p*C + c),
//   z = h2 + x[(4c + p) mod C] (the tiled identity, a gather: the TPU's
//   product with a 0/1 matrix copies the same values), pixel shuffle (z's
//   column p*C + c is channel c of fine pixel (2u + p/2, 2v + p%2)),
//   up = blur3 (reflect), net' = lrelu(feat_layer up),
//   rgb' = blur3(bilinear2x(rgb)) + feat_2_rgb net' (clamped bilinear),
//   with rgb = feat_2_rgb_0 x computed here for block 0.
// It rounds where the plain version (models/phase_renderer.py) rounds:
// bf16 operands, f32 sums, f32 bias, bf16 after each product + bias and
// after every elementwise op.
//
// Bound: operations. A block's products are ~6.5 GFLOP per Reso64 image
// (D1 + D2 on the level-i pixels, feat_layer on the level-(i+1) ones) for
// ~15-40 MB of bf16 in and out, above the card's ~295 FLOP/byte.
//
// Design (a first kernel: simple and right). The TPU kernel keeps whole
// row strips of every intermediate in 120 MB of VMEM; a block here has
// 227 KB of shared memory, and block 2's D2 output alone is 8 MB a Reso64
// image. So one block of 16 warps takes a tile of 8x8 level-i pixels (a
// 16x16 tile of the output) and keeps every intermediate in shared memory:
//   1. the 10x10 window of x (a one-pixel halo, clamped at the image edge:
//      the stencils' reflect and clamp taps read only in-image pixels) and
//      the rgb window; the rgb path (bilinear, blur) over the output tile;
//   2. h1 = lrelu(D1 x) over the window, [112, 2C] bf16 (padded rows);
//   3. D2 in chunks of 16 channels: the columns {p*C + c} of all four
//      phases for c in the chunk, its epilogue adds the gathered identity;
//      the chunk is pixel-shuffled, blurred (vertical then horizontal, as
//      the plain version) and multiplied into feat_layer's f32 accumulators
//      as one split-K step, so the 4C-wide D2 output never exists whole;
//   4. the feat_layer epilogue, the rgb head and the rgb sum, written out.
// Weights stream from L2 in row chunks through a cp.async double buffer;
// products run on the tensor cores through nvcuda::wmma (bf16 -> f32,
// 16x16x16). The halo recomputes D1 and D2 on 100 window pixels for 64
// owned ones (1.56x of their products). wgmma, TMA and larger tiles are
// left for later work.

#include <atomic>
#include <climits>
#include <cstdint>

#include <mma.h>

#include "fused_upsampler_common.cuh"

using namespace nvcuda;
using namespace fu;

namespace {

constexpr int T = 8;                     // level-i tile edge
constexpr int WIN = T + 2;               // window edge: one-pixel halo
constexpr int NWIN = WIN * WIN;          // 100 window pixels
constexpr int M = (NWIN + 15) / 16 * 16; // 112 rows of the window products
constexpr int MF = M / 16;
constexpr int FT = 2 * T;                // fine output tile edge
constexpr int NF = FT * FT;              // 256 output pixels
constexpr int FW = FT + 2;               // fine window edge of the stencils
constexpr int KCH = 16;                  // channels per D2 chunk
constexpr int NZ = 4 * KCH;              // D2 columns per chunk (four phases)
constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;                   // bf16 row padding against bank conflicts
constexpr int KC1 = 16;                  // weight rows per staged chunk, D1
constexpr int KC2 = 32;                  // weight rows per staged chunk, D2

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

constexpr int al128(int x) { return (x + 127) / 128 * 128; }

template <int C, int CN>
struct Geo {
  static constexpr int C2 = 2 * C, C4 = 4 * C;
  static constexpr int NB1 = C2 < 256 ? C2 : 256;  // D1 columns per pass
  static constexpr int LDX = C + PAD, LDH = C2 + PAD, LDW1 = NB1 + PAD;
  static constexpr int LDZ = NZ + PAD, LDW2 = NZ + PAD, LDU = KCH + PAD;
  static constexpr int LDF = CN + PAD, LDN = CN + PAD;
  static constexpr int SZ_H = al128(M * LDH * 2);
  static constexpr int SZ_X = al128(M * LDX * 2);
  static constexpr int SZ_W1 = al128(2 * KC1 * LDW1 * 2);
  static constexpr int SZ_W2 = al128(2 * KC2 * LDW2 * 2);
  static constexpr int SZ_Z = al128(M * LDZ * 2);
  static constexpr int SZ_VB = al128(FT * FW * KCH * 2);
  static constexpr int SZ_UP = al128(NF * LDU * 2);
  static constexpr int SZ_WF = al128(KCH * LDF * 2);
  static constexpr int SZ_A = SZ_X + SZ_W1;                           // phases 0-1
  static constexpr int SZ_B = SZ_W2 + SZ_Z + SZ_VB + SZ_UP + SZ_WF;   // phase 2
  static constexpr int SZ_AB = SZ_A > SZ_B ? SZ_A : SZ_B;
  static constexpr int SZ_SCR = NWARPS * 256 * 4;
  static constexpr int SZ_RGBW = al128(NWIN * 3 * 4);
  static constexpr int SZ_RP = al128(FW * WIN * 3 * 4);
  static constexpr int SZ_BIL = al128(FW * FW * 3 * 4);
  static constexpr int SZ_RUP = al128(NF * 3 * 4);
  static constexpr int OFF_H = 0;
  static constexpr int OFF_AB = OFF_H + SZ_H;
  static constexpr int OFF_X = OFF_AB, OFF_W1 = OFF_AB + SZ_X;
  static constexpr int OFF_W2 = OFF_AB, OFF_Z = OFF_W2 + SZ_W2, OFF_VB = OFF_Z + SZ_Z;
  static constexpr int OFF_UP = OFF_VB + SZ_VB, OFF_WF = OFF_UP + SZ_UP;
  static constexpr int OFF_SCR = OFF_AB + SZ_AB;
  static constexpr int OFF_RGBW = OFF_SCR + SZ_SCR;
  static constexpr int OFF_RP = OFF_RGBW + SZ_RGBW;
  static constexpr int OFF_BIL = OFF_RP + SZ_RP;
  static constexpr int OFF_RUP = OFF_BIL + SZ_BIL;
  static constexpr int SMEM = OFF_RUP + SZ_RUP;
  static_assert(SMEM <= 232448, "shared memory over the per-block limit");
  static_assert(NF * LDN * 2 <= SZ_H, "net' must fit where h1 was");
  static_assert(C % KCH == 0 && C2 % NB1 == 0 && CN % 16 == 0, "block widths");
};

// acc[j] (j < NPW) holds the 16x16 output fragment pidx = warp + j * NWARPS
// of an [MR * 16, NCF * 16] product: row fragment pidx / NCF, column
// fragment pidx % NCF.
template <int MR, int NCF>
struct Pairs {
  static constexpr int N = MR * NCF;
  static constexpr int NPW = (N + NWARPS - 1) / NWARPS;
};

// acc = A[MR*16, K] @ W[K, cols], A bf16 in shared memory (row stride lda),
// W bf16 row-major in global memory (row stride ldw), its columns picked by
// col_of(j) for each run of 8 staged columns j. W streams through `wbuf` in
// KC-row chunks (cp.async double buffer). Ends past a __syncthreads.
template <int MR, int NCF, int KC, class ColOf>
__device__ __forceinline__ void cta_gemm(const bf16* A, int lda, int K, const bf16* __restrict__ W,
                                         int ldw, ColOf col_of, bf16* wbuf, Acc* acc) {
  constexpr int N = NCF * 16, LDW = N + PAD, CPR = N / 8;
  constexpr int NPW = Pairs<MR, NCF>::NPW, NP = Pairs<MR, NCF>::N;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NPW; ++j) wmma::fill_fragment(acc[j], 0.0f);
  const int n = K / KC;
  auto issue = [&](int c) {
    bf16* dst = wbuf + (c & 1) * KC * LDW;
    for (int e = threadIdx.x; e < KC * CPR; e += NTHREADS) {
      const int r = e / CPR, g = e - r * CPR;
      cp_async16(dst + r * LDW + g * 8, W + (size_t)(c * KC + r) * ldw + col_of(g * 8));
    }
    cp_async_commit();
  };
  issue(0);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wt = wbuf + (c & 1) * KC * LDW;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int pidx = warp + j * NWARPS;
        if (pidx < NP) {
          const int rf = pidx / NCF, cf = pidx - rf * NCF;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, A + rf * 16 * lda + c * KC + kk, lda);
          wmma::load_matrix_sync(fb, wt + kk * LDW + cf * 16, LDW);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled by issue(c + 2)
  }
}

// epi(row, col, value) over every element of the product held in acc,
// through a 16x16 f32 per-warp scratch tile
template <int MR, int NCF, class Epi>
__device__ __forceinline__ void cta_epilogue(Acc* acc, float* scratch, Epi epi) {
  constexpr int NPW = Pairs<MR, NCF>::NPW, NP = Pairs<MR, NCF>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int pidx = warp + j * NWARPS;
    if (pidx < NP) {
      const int rf = pidx / NCF, cf = pidx - rf * NCF;
      wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) epi(rf * 16 + (e >> 4), cf * 16 + (e & 15), scr[e]);
      __syncwarp();
    }
  }
}

struct ColRun {  // D1: columns col0 + j
  int col0;
  __device__ int operator()(int j) const { return col0 + j; }
};

struct ColChunk {  // D2 chunk: staged column j = p * KCH + cc is global p * C + c0 + cc
  int C, c0;
  __device__ int operator()(int j) const { return (j / KCH) * C + c0 + (j % KCH); }
};

template <int C, int CN>
__global__ void __launch_bounds__(NTHREADS, 1) fwd_kernel(
    const bf16* __restrict__ net, const bf16* __restrict__ rgb, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    const bf16* __restrict__ wf, const float* __restrict__ bfv, const bf16* __restrict__ wr,
    const float* __restrict__ br, const bf16* __restrict__ wr0, const float* __restrict__ br0,
    bf16* __restrict__ net_out, bf16* __restrict__ rgb_out, int Hc, int Wc, int lvl) {
  using G = Geo<C, CN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H1 = reinterpret_cast<bf16*>(smem + G::OFF_H);
  bf16* NN = H1;  // net' [NF, LDN] after the chunk loop
  bf16* X = reinterpret_cast<bf16*>(smem + G::OFF_X);
  bf16* WS1 = reinterpret_cast<bf16*>(smem + G::OFF_W1);
  bf16* WS2 = reinterpret_cast<bf16*>(smem + G::OFF_W2);
  bf16* Z = reinterpret_cast<bf16*>(smem + G::OFF_Z);
  bf16* VB = reinterpret_cast<bf16*>(smem + G::OFF_VB);
  bf16* UP = reinterpret_cast<bf16*>(smem + G::OFF_UP);
  bf16* WF = reinterpret_cast<bf16*>(smem + G::OFF_WF);
  float* SCR = reinterpret_cast<float*>(smem + G::OFF_SCR);
  float* RGBW = reinterpret_cast<float*>(smem + G::OFF_RGBW);
  float* RP = reinterpret_cast<float*>(smem + G::OFF_RP);
  float* BIL = reinterpret_cast<float*>(smem + G::OFF_BIL);
  float* RUP = reinterpret_cast<float*>(smem + G::OFF_RUP);

  const int S = Hc << lvl, SW = Wc << lvl;  // level-i image
  const int S2 = 2 * S, SW2 = 2 * SW;       // level-(i+1) image
  const int tiles_c = SW / T;
  const int tr = blockIdx.x / tiles_c, tc = blockIdx.x - tr * tiles_c;
  const int u0 = tr * T, v0 = tc * T;       // level-i origin of the tile
  const int U0 = 2 * u0, V0 = 2 * v0;       // level-(i+1) origin
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  // window pixel w -> its level-i pixel (clamped to the image)
  auto win_pix = [&](int w) -> size_t {
    const int wr_ = w / WIN, wc = w - wr_ * WIN;
    const int u = min(max(u0 - 1 + wr_, 0), S - 1), v = min(max(v0 - 1 + wc, 0), SW - 1);
    return pix(b, u, v, lvl, Hc, Wc);
  };

  // ---- phase 0: the x window (zero rows past NWIN), the rgb path
  constexpr int CPRX = C / 8;
  for (int e = tid; e < M * CPRX; e += NTHREADS) {
    const int w = e / CPRX, g = e - w * CPRX;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (w < NWIN) v = *reinterpret_cast<const uint4*>(net + win_pix(w) * C + g * 8);
    *reinterpret_cast<uint4*>(X + w * G::LDX + g * 8) = v;
  }
  __syncthreads();
  for (int e = tid; e < NWIN * 3; e += NTHREADS) {
    const int w = e / 3, k = e - w * 3;
    float v;
    if (lvl == 0) {  // rgb_0 = feat_2_rgb_0(x)
      float s = 0.0f;
      const bf16* xr = X + w * G::LDX;
      for (int c = 0; c < C; ++c) s += __bfloat162float(xr[c]) * __bfloat162float(wr0[c * 3 + k]);
      v = rd(s + br0[k]);
    } else {
      v = __bfloat162float(rgb[win_pix(w) * 3 + k]);
    }
    RGBW[e] = v;
  }
  __syncthreads();
  // bilinear 2x, rows: RP[lr][wc][k] at fine row U0 - 1 + lr, level-i column v0 - 1 + wc
  for (int e = tid; e < FW * WIN * 3; e += NTHREADS) {
    const int lr = e / (WIN * 3), rem = e - lr * (WIN * 3), wc = rem / 3, k = rem - wc * 3;
    const int U = U0 - 1 + lr;
    if (U < 0 || U >= S2) continue;
    const int f = U >> 1;
    const int nb = (U & 1) ? min(f + 1, S - 1) : max(f - 1, 0);
    RP[e] = bilin(RGBW[((f - u0 + 1) * WIN + wc) * 3 + k],
                  RGBW[((nb - u0 + 1) * WIN + wc) * 3 + k]);
  }
  __syncthreads();
  // bilinear 2x, columns: BIL[lr][lc][k] at fine (U0 - 1 + lr, V0 - 1 + lc)
  for (int e = tid; e < FW * FW * 3; e += NTHREADS) {
    const int lr = e / (FW * 3), rem = e - lr * (FW * 3), lc = rem / 3, k = rem - lc * 3;
    const int U = U0 - 1 + lr, V = V0 - 1 + lc;
    if (U < 0 || U >= S2 || V < 0 || V >= SW2) continue;
    const int g = V >> 1;
    const int nb = (V & 1) ? min(g + 1, SW - 1) : max(g - 1, 0);
    BIL[e] = bilin(RP[(lr * WIN + (g - v0 + 1)) * 3 + k], RP[(lr * WIN + (nb - v0 + 1)) * 3 + k]);
  }
  __syncthreads();
  // blur (reflect), vertical then horizontal, over the output tile
  for (int e = tid; e < NF * 3; e += NTHREADS) {
    const int n = e / 3, k = e - n * 3;
    const int U = U0 + n / FT, V = V0 + n % FT;
    const int Um = reflect_m1(U), Up = reflect_p1(U, S2);
    auto at = [&](int Uq, int Vq) { return BIL[((Uq - U0 + 1) * FW + (Vq - V0 + 1)) * 3 + k]; };
    auto vb = [&](int Vq) { return blur3(at(Um, Vq), at(U, Vq), at(Up, Vq)); };
    RUP[e] = blur3(vb(reflect_m1(V)), vb(V), vb(reflect_p1(V, SW2)));
  }

  // ---- phase 1: h1 = lrelu(D1 x) over the window
  for (int nb = 0; nb < G::C2 / G::NB1; ++nb) {
    Acc acc[Pairs<MF, G::NB1 / 16>::NPW];
    cta_gemm<MF, G::NB1 / 16, KC1>(X, G::LDX, C, w1, G::C2, ColRun{nb * G::NB1}, WS1, acc);
    cta_epilogue<MF, G::NB1 / 16>(acc, SCR, [&](int r, int c, float v) {
      const int col = nb * G::NB1 + c;
      H1[r * G::LDH + col] = __float2bfloat16(lrelu(rd(v + b1[col])));
    });
  }

  // ---- phase 2: D2 chunk by chunk, shuffled, blurred, into feat_layer
  constexpr int DF_NCF = CN / 16;
  constexpr int DF_NPW = Pairs<NF / 16, DF_NCF>::NPW;
  static_assert(Pairs<NF / 16, DF_NCF>::N % NWARPS == 0, "feat_layer fragments per warp");
  Acc accf[DF_NPW];
#pragma unroll
  for (int j = 0; j < DF_NPW; ++j) wmma::fill_fragment(accf[j], 0.0f);
  const int warp = tid >> 5;
  for (int c0 = 0; c0 < C; c0 += KCH) {
    __syncthreads();  // h1 written (first chunk); the last chunk's buffers read
    for (int e = tid; e < KCH * (CN / 8); e += NTHREADS) {
      const int r = e / (CN / 8), g = e - r * (CN / 8);
      cp_async16(WF + r * G::LDF + g * 8, wf + (size_t)(c0 + r) * CN + g * 8);
    }
    cp_async_commit();  // waited for inside cta_gemm (wait_group counts it)
    Acc acc2[Pairs<MF, NZ / 16>::NPW];
    cta_gemm<MF, NZ / 16, KC2>(H1, G::LDH, G::C2, w2, G::C4, ColChunk{C, c0}, WS2, acc2);
    cta_epilogue<MF, NZ / 16>(acc2, SCR, [&](int r, int j, float v) {
      if (r >= NWIN) return;
      const int p = j / KCH, c = c0 + j % KCH;
      const float a2 = rd(v + b2[p * C + c]);
      const float t = __bfloat162float(net[win_pix(r) * C + ((4 * c + p) & (C - 1))]);
      Z[r * G::LDZ + j] = __float2bfloat16(rd(lrelu(a2) + t));
    });
    __syncthreads();
    // vertical blur of the shuffled chunk: VB[lr][lc][cc] at fine (U0 + lr, V0 - 1 + lc)
    for (int e = tid; e < FT * FW * KCH; e += NTHREADS) {
      const int lr = e / (FW * KCH), rem = e - lr * (FW * KCH), lc = rem / KCH;
      const int cc = rem - lc * KCH;
      const int U = U0 + lr, V = V0 - 1 + lc;
      if (V < 0 || V >= SW2) continue;
      const int wcol = (V >> 1) - v0 + 1, pc = V & 1;
      auto y = [&](int Uq) {
        const int w = ((Uq >> 1) - u0 + 1) * WIN + wcol;
        return __bfloat162float(Z[w * G::LDZ + (((Uq & 1) << 1) | pc) * KCH + cc]);
      };
      VB[e] = __float2bfloat16(blur3(y(reflect_m1(U)), y(U), y(reflect_p1(U, S2))));
    }
    __syncthreads();
    // horizontal blur -> UP[n][cc], n = output pixel
    for (int e = tid; e < NF * KCH; e += NTHREADS) {
      const int n = e / KCH, cc = e - n * KCH;
      const int lr = n / FT, V = V0 + n % FT;
      auto vb = [&](int Vq) { return __bfloat162float(VB[(lr * FW + (Vq - V0 + 1)) * KCH + cc]); };
      UP[n * G::LDU + cc] =
          __float2bfloat16(blur3(vb(reflect_m1(V)), vb(V), vb(reflect_p1(V, SW2))));
    }
    __syncthreads();
    // feat_layer split-K step: accf += UP[NF, KCH] @ WF[KCH, CN]
#pragma unroll
    for (int j = 0; j < DF_NPW; ++j) {
      const int pidx = warp + j * NWARPS;
      const int rf = pidx / DF_NCF, cf = pidx - rf * DF_NCF;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, UP + rf * 16 * G::LDU, G::LDU);
      wmma::load_matrix_sync(fb, WF + cf * 16, G::LDF);
      wmma::mma_sync(accf[j], fa, fb, accf[j]);
    }
  }
  __syncthreads();  // every warp is past its last read of h1, which net' overwrites

  // ---- phase 3: net' = lrelu(feat_layer), the rgb head, the rgb sum
  cta_epilogue<NF / 16, DF_NCF>(accf, SCR, [&](int n, int c, float v) {
    const bf16 o = __float2bfloat16(lrelu(rd(v + bfv[c])));
    NN[n * G::LDN + c] = o;
    net_out[pix(b, U0 + n / FT, V0 + n % FT, lvl + 1, Hc, Wc) * CN + c] = o;
  });
  __syncthreads();
  for (int e = tid; e < NF * 3; e += NTHREADS) {
    const int n = e / 3, k = e - n * 3;
    float s = 0.0f;
    for (int c = 0; c < CN; ++c)
      s += __bfloat162float(NN[n * G::LDN + c]) * __bfloat162float(wr[c * 3 + k]);
    const float r = rd(s + br[k]);
    rgb_out[pix(b, U0 + n / FT, V0 + n % FT, lvl + 1, Hc, Wc) * 3 + k] =
        __float2bfloat16(rd(RUP[e] + r));
  }
}

template <int C, int CN>
int launch(const bf16* net, const bf16* rgb, const bf16* w1, const float* b1, const bf16* w2,
           const float* b2, const bf16* wf, const float* bfv, const bf16* wr, const float* br,
           const bf16* wr0, const float* br0, bf16* net_out, bf16* rgb_out, int B, int Hc,
           int Wc, int lvl, cudaStream_t stream) {
  using G = Geo<C, CN>;
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load()) {
    err = cudaFuncSetAttribute(fwd_kernel<C, CN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true);
  }
  const long long tiles = (long long)((Hc << lvl) / T) * ((Wc << lvl) / T);
  if (tiles > INT_MAX || B > 65535) return (int)cudaErrorInvalidValue;
  fwd_kernel<C, CN><<<dim3((unsigned)tiles, (unsigned)B), NTHREADS, G::SMEM, stream>>>(
      net, rgb, w1, b1, w2, b2, wf, bfv, wr, br, wr0, br0, net_out, rgb_out, Hc, Wc, lvl);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one block per 8x8 level-`level` tile and batch row on `stream`,
// which belongs to the current device. rgb is read for level > 0 only;
// wr0 / br0 for level 0 only. Widths (C, Cn): (256, 128), (128, 64),
// (64, 32); Hc and Wc multiples of 8. Returns the cudaError_t of the launch
// (0 on success); the caller raises on anything else.
extern "C" int fused_upsampler_fwd_launch(
    const bf16* net, const bf16* rgb, const bf16* w1, const float* b1, const bf16* w2,
    const float* b2, const bf16* wf, const float* bfv, const bf16* wr, const float* br,
    const bf16* wr0, const float* br0, bf16* net_out, bf16* rgb_out, int B, int Hc, int Wc,
    int level, int C, int Cn, void* stream) {
  if (B <= 0 || Hc <= 0 || Wc <= 0 || Hc % T || Wc % T || level < 0 || level > 6)
    return (int)cudaErrorInvalidValue;
  if ((level > 0 && rgb == nullptr) || (level == 0 && (wr0 == nullptr || br0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FU_LAUNCH(c, cn)                                                                      \
  if (C == c && Cn == cn)                                                                     \
    return launch<c, cn>(net, rgb, w1, b1, w2, b2, wf, bfv, wr, br, wr0, br0, net_out, rgb_out, \
                         B, Hc, Wc, level, s);
  FU_LAUNCH(256, 128)
  FU_LAUNCH(128, 64)
  FU_LAUNCH(64, 32)
#undef FU_LAUNCH
  return (int)cudaErrorInvalidValue;
}
