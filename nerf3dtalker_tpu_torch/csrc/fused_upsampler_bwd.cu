// Fused phase-stacked upsampler block, backward, for Hopper (sm_90a).
//
// Replaces nerf3dtalker_tpu/ops/pallas/fused_upsampler.py:_bwd_call (body
// _bwd_kernel: jax.vjp of the block's forward, weight gradients accumulated
// across the grid, :208-221, and the XLA overlap-add of the strips' input
// gradients, :367). For the cotangents of one block's outputs (g_net' and
// g_rgb', bf16) it recomputes the block's forward and returns g_net (f32),
// g_rgb (f32, block > 0) and every weight and bias gradient (f32), with the
// arithmetic of the plain version (models/phase_renderer.py:
// phase_block_backward): gradient activations rounded to bf16 where the
// forward value is bf16, the leaky-ReLU slope applied by the sign of the
// pre-activation, the transposed stencils in f32, every product and sum
// accumulated in f32.
//
// Bound: operations. The recompute is the forward's ~6.5 GFLOP per Reso64
// image and block; the backward adds two products of the same size for the
// input-gradient chain and two for the weight gradients: ~32 GFLOP per
// image and block, against ~40-100 MB of inputs and outputs.
//
// Design (a first kernel: simple and right). The TPU kernel runs its grid
// in order and sums the weight gradients in VMEM across steps; blocks here
// run in any order. So, as in fused_render_bwd.cu, the work is a sequence
// of launches on one stream, all deterministic (no atomics), that pass
// every Dense layer's input and output gradient through a bf16 device
// scratch (the stash):
//   1. gemm D1 -> h1; gemm D2 -> h2 and z = h2 + tiled identity (level i);
//   2. up_kernel: up = blur3(shuffle(z)) (level i+1);
//   3. gemm feat_layer -> net' and g_af, its epilogue folding in
//      g_net' + g_rgb' wr^T and the leaky-ReLU slope;
//      gemm g_up = g_af wf^T;
//   4. gz_kernel: g_y = transposed blur of g_up, written out tap by tap with
//      the reflect edges (fine row 1 gets row 0's gradient twice, row S-2
//      row S-1's), unshuffled to g_z at level i; g_a2 = slope(h2) g_z; the
//      tiled identity's transpose (channel c_x sums the four lanes
//      p = c_x mod 4, c = c_x / 4 + m C / 4) into an f32 g_tile;
//   5. rgb path: rgb1_kernel, the transposed blur of g_rgb' (f32);
//      rgb2_kernel, the transposed clamped bilinear (in[0] also gets 0.25
//      out[0], in[S-1] 0.25 out[2S-1]) to level i;
//   6. gemm g_a1 = slope(h1) (g_a2 w2^T); gemm g_net = g_a1 w1^T + g_tile
//      (+ g_rgb_0 wr_0^T for block 0);
//   7. xtg_kernel: dW = X^T G as 32x32 tiles over splits of the pixel
//      axis; colsum_kernel: the bias sums and the 3-wide rgb heads' weight
//      gradients; reduce_kernel: the splits added in split order.
// Every pixel's input gradient is computed by one thread or one product
// row, so no windows overlap and the TPU kernel's overlap-add has no
// counterpart. The stash traffic is the cost of this design, not part of
// the bound. Keeping intermediates on chip (as the forward kernel does),
// wgmma and TMA are left for later work.

#include <atomic>
#include <climits>
#include <cstdint>

#include <mma.h>

#include "fused_upsampler_common.cuh"

using namespace nvcuda;
using namespace fu;

namespace {

constexpr int PAD = 8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// ---- row-tile products: out[rows, N] = epi(A[rows, K] @ B)

enum Epi { E_H1, E_Z, E_AF, E_BF16, E_MASK, E_GX };

struct EpiArgs {
  bf16* out = nullptr;            // [rows, N] bf16
  bf16* out2 = nullptr;           // [rows, N] bf16 (E_Z: z; E_AF: g_af)
  float* fout = nullptr;          // [rows, N] f32 (E_GX)
  const float* bias = nullptr;    // [N]
  const bf16* aux = nullptr;      // E_Z: x [rows, C]; E_AF: g_net' [rows, N]; E_MASK: h1
  const bf16* aux3 = nullptr;     // E_AF: g_rgb' [rows, 3]; E_GX: g_rgb_0 [rows, 3] or null
  const bf16* w3 = nullptr;       // E_AF: wr [N, 3]; E_GX: wr_0 [N, 3]
  const float* ftile = nullptr;   // E_GX: g_tile [rows, N]
  int C = 0;                      // E_Z: channels of x
};

template <int EPI>
__device__ __forceinline__ void epilogue(const EpiArgs& ep, size_t r, int c, int N, float v) {
  const size_t o = r * N + c;
  if constexpr (EPI == E_H1) {
    ep.out[o] = __float2bfloat16(lrelu(rd(v + ep.bias[c])));
  } else if constexpr (EPI == E_Z) {
    const float h2 = lrelu(rd(v + ep.bias[c]));
    const int C = ep.C;
    const int src = (4 * (c % C) + c / C) & (C - 1);  // lane q = p*C + cc reads x[(4cc + p) mod C]
    ep.out[o] = __float2bfloat16(h2);
    ep.out2[o] = __float2bfloat16(rd(h2 + __bfloat162float(ep.aux[r * C + src])));
  } else if constexpr (EPI == E_AF) {
    const float af = rd(v + ep.bias[c]);
    ep.out[o] = __float2bfloat16(lrelu(af));
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      s += __bfloat162float(ep.aux3[r * 3 + k]) * __bfloat162float(ep.w3[c * 3 + k]);
    const float g = rd(__bfloat162float(ep.aux[o]) + s);
    ep.out2[o] = __float2bfloat16(af >= 0.0f ? g : rd(0.2f * g));
  } else if constexpr (EPI == E_BF16) {
    ep.out[o] = __float2bfloat16(v);
  } else if constexpr (EPI == E_MASK) {
    const float g = rd(v);
    ep.out[o] = __float2bfloat16(__bfloat162float(ep.aux[o]) >= 0.0f ? g : rd(0.2f * g));
  } else {  // E_GX
    float g = v + ep.ftile[o];
    if (ep.aux3 != nullptr) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s += __bfloat162float(ep.aux3[r * 3 + k]) * __bfloat162float(ep.w3[c * 3 + k]);
      g += s;
    }
    ep.fout[o] = g;
  }
}

constexpr int GBM = 64;          // rows per block
constexpr int GKC = 32;          // contraction per staged chunk
constexpr int GLD = GKC + PAD;

// A [rows, K] bf16 row-major; TRANS ? W [N, K] (out = A W^T) : W [K, N]
// (out = A W), bf16 row-major. 4 warps, each 16 rows x BN columns.
template <int BN, bool TRANS, int EPI>
__global__ void __launch_bounds__(128) gemm_kernel(const bf16* __restrict__ A,
                                                   const bf16* __restrict__ W, int K, int N,
                                                   EpiArgs ep) {
  constexpr int NCF = BN / 16;
  constexpr int LDB = TRANS ? GLD : BN + PAD;
  constexpr int BSZ = TRANS ? BN * GLD : GKC * (BN + PAD);
  __shared__ __align__(128) bf16 As[2][GBM * GLD];
  __shared__ __align__(128) bf16 Bs[2][BSZ];
  __shared__ __align__(128) float scr[4][256];
  const size_t m0 = (size_t)blockIdx.x * GBM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Acc acc[NCF];
#pragma unroll
  for (int j = 0; j < NCF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  auto stage = [&](int c) {
    const int k0 = c * GKC;
    for (int e = threadIdx.x; e < GBM * (GKC / 8); e += 128) {
      const int r = e / (GKC / 8), q = e - r * (GKC / 8);
      cp_async16(&As[c & 1][r * GLD + q * 8], A + (m0 + r) * K + k0 + q * 8);
    }
    if constexpr (TRANS) {
      for (int e = threadIdx.x; e < BN * (GKC / 8); e += 128) {
        const int r = e / (GKC / 8), q = e - r * (GKC / 8);
        cp_async16(&Bs[c & 1][r * GLD + q * 8], W + (size_t)(n0 + r) * K + k0 + q * 8);
      }
    } else {
      for (int e = threadIdx.x; e < GKC * (BN / 8); e += 128) {
        const int r = e / (BN / 8), q = e - r * (BN / 8);
        cp_async16(&Bs[c & 1][r * (BN + PAD) + q * 8], W + (size_t)(k0 + r) * N + n0 + q * 8);
      }
    }
    cp_async_commit();
  };

  const int nk = K / GKC;
  stage(0);
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &As[c & 1][warp * 16 * GLD + kk], GLD);
#pragma unroll
      for (int j = 0; j < NCF; ++j) {
        if constexpr (TRANS) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, &Bs[c & 1][j * 16 * GLD + kk], LDB);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &Bs[c & 1][kk * LDB + j * 16], LDB);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();
  }
  float* s = scr[warp];
#pragma unroll
  for (int j = 0; j < NCF; ++j) {
    wmma::store_matrix_sync(s, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      epilogue<EPI>(ep, m0 + warp * 16 + (e >> 4), n0 + j * 16 + (e & 15), N, s[e]);
    __syncwarp();
  }
}

// ---- stencils

struct Grid {  // level-i image of a block: Hc x Wc coarse, 2^lvl phases a side
  int B, Hc, Wc, lvl;
};

// up[n', c] = blur3 of the pixel-shuffled z at fine pixel n' of level i+1,
// vertical then horizontal with bf16 rounding per op, as the forward
__global__ void __launch_bounds__(256) up_kernel(const bf16* __restrict__ z, bf16* __restrict__ up,
                                                 Grid g, int C) {
  const int S2 = (g.Hc << g.lvl) * 2, SW2 = (g.Wc << g.lvl) * 2;
  const size_t total = (size_t)g.B * S2 * SW2 * C;
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < total; e += (size_t)gridDim.x * 256) {
    const size_t n = e / C;
    const int c = (int)(e - n * C);
    int b, U, V;
    unpix(n, g.lvl + 1, g.Hc, g.Wc, b, U, V);
    auto y = [&](int Uq, int Vq) {
      const size_t w = pix(b, Uq >> 1, Vq >> 1, g.lvl, g.Hc, g.Wc);
      return __bfloat162float(z[w * 4 * C + (((Uq & 1) << 1) | (Vq & 1)) * C + c]);
    };
    const int Um = reflect_m1(U), Up = reflect_p1(U, S2);
    auto vb = [&](int Vq) { return blur3(y(Um, Vq), y(U, Vq), y(Up, Vq)); };
    up[e] = __float2bfloat16(blur3(vb(reflect_m1(V)), vb(V), vb(reflect_p1(V, SW2))));
  }
}

// transpose of the reflect-padded [1,2,1]/4 blur along one axis of size S,
// at index v, of f(u): 0.5 f(v) + 0.25 f(v-1) + 0.25 f(v+1), plus the
// reflected taps at the edges (v == 1 gets f(0) again: row -1 read row 1;
// v == S-2 gets f(S-1) again: row S read row S-2). f32, in the plain
// version's order.
template <class F>
__device__ __forceinline__ float blur_t(int v, int S, F f) {
  float a = 0.5f * f(v);
  if (v >= 1) a += 0.25f * f(v - 1);
  if (v + 1 < S) a += 0.25f * f(v + 1);
  if (v == 1) a += 0.25f * f(0);
  if (v == S - 2) a += 0.25f * f(S - 1);
  return a;
}

// transpose of the clamped half-pixel bilinear 2x along one axis (2S -> S),
// at index f, of g(u), u a fine index: 0.75 g(2f) + 0.75 g(2f+1) + 0.25
// g(2f+2) + 0.25 g(2f-1), and the clamped taps piled on the edges (f == 0
// gets 0.25 g(0) again, f == S-1 gets 0.25 g(2S-1) again). f32; the 0.75
// products and their sum rounded apart, as the plain version's ops.
template <class F>
__device__ __forceinline__ float bilin_t(int f, int S, F g) {
  float a = __fadd_rn(__fmul_rn(0.75f, g(2 * f)), __fmul_rn(0.75f, g(2 * f + 1)));
  if (f + 1 <= S - 1) a += 0.25f * g(2 * f + 2);
  if (f >= 1) a += 0.25f * g(2 * f - 1);
  if (f == 0) a += 0.25f * g(0);
  if (f == S - 1) a += 0.25f * g(2 * S - 1);
  return a;
}

constexpr int GZ_VALUES = 4096;  // g_z values of one gz_kernel block (4 C per pixel)

// per level-i pixel: g_z (the transposed blur of g_up at its four fine
// children, rounded to bf16), g_a2 = slope(h2) g_z, g_tile = the tiled
// identity's transpose of g_z (f32)
__global__ void __launch_bounds__(256) gz_kernel(const bf16* __restrict__ gup,
                                                 const bf16* __restrict__ h2,
                                                 bf16* __restrict__ ga2, float* __restrict__ gtile,
                                                 Grid g, int C) {
  __shared__ float gz[GZ_VALUES];
  const int C4 = 4 * C, px = GZ_VALUES / C4;
  const int S2 = (g.Hc << g.lvl) * 2, SW2 = (g.Wc << g.lvl) * 2;
  const size_t n0 = (size_t)blockIdx.x * px;
  for (int e = threadIdx.x; e < px * C4; e += 256) {
    const int k = e / C4, q = e - k * C4;
    const int p = q / C, c = q - p * C;
    int b, u, v;
    unpix(n0 + k, g.lvl, g.Hc, g.Wc, b, u, v);
    const int U = 2 * u + (p >> 1), V = 2 * v + (p & 1);
    auto row = [&](int Uq) {
      return blur_t(V, SW2, [&](int Vq) {
        return __bfloat162float(gup[pix(b, Uq, Vq, g.lvl + 1, g.Hc, g.Wc) * C + c]);
      });
    };
    gz[e] = rd(blur_t(U, S2, row));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < px * C4; e += 256) {
    const size_t o = (n0 + e / C4) * C4 + e % C4;
    const float v = gz[e];
    ga2[o] = __float2bfloat16(__bfloat162float(h2[o]) >= 0.0f ? v : rd(0.2f * v));
  }
  const int C_4 = C / 4;
  for (int e = threadIdx.x; e < px * C; e += 256) {
    const int k = e / C, cx = e - k * C;
    const float* row = gz + k * C4 + (cx & 3) * C + (cx >> 2);
    gtile[(n0 + k) * C + cx] = ((row[0] + row[C_4]) + row[2 * C_4]) + row[3 * C_4];
  }
}

// the transposed blur of g_rgb' at level i+1, f32
__global__ void __launch_bounds__(256) rgb1_kernel(const bf16* __restrict__ grgb,
                                                   float* __restrict__ gbil, Grid g) {
  const int S2 = (g.Hc << g.lvl) * 2, SW2 = (g.Wc << g.lvl) * 2;
  const size_t total = (size_t)g.B * S2 * SW2 * 3;
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < total; e += (size_t)gridDim.x * 256) {
    const size_t n = e / 3;
    const int k = (int)(e - n * 3);
    int b, U, V;
    unpix(n, g.lvl + 1, g.Hc, g.Wc, b, U, V);
    auto row = [&](int Uq) {
      return blur_t(V, SW2, [&](int Vq) {
        return __bfloat162float(grgb[pix(b, Uq, Vq, g.lvl + 1, g.Hc, g.Wc) * 3 + k]);
      });
    };
    gbil[e] = blur_t(U, S2, row);
  }
}

// the transposed bilinear to level i: g_rgb (f32, block > 0) or g_rgb_0
// (bf16, block 0)
__global__ void __launch_bounds__(256) rgb2_kernel(const float* __restrict__ gbil,
                                                   float* __restrict__ grgb,
                                                   bf16* __restrict__ grgb0, Grid g) {
  const int S = g.Hc << g.lvl, SW = g.Wc << g.lvl;
  const size_t total = (size_t)g.B * S * SW * 3;
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < total; e += (size_t)gridDim.x * 256) {
    const size_t n = e / 3;
    const int k = (int)(e - n * 3);
    int b, u, v;
    unpix(n, g.lvl, g.Hc, g.Wc, b, u, v);
    auto row = [&](int Uq) {
      return bilin_t(v, SW,
                     [&](int Vq) { return gbil[pix(b, Uq, Vq, g.lvl + 1, g.Hc, g.Wc) * 3 + k]; });
    };
    const float a = bilin_t(u, S, row);
    if (grgb0 != nullptr) grgb0[e] = __float2bfloat16(a);
    else grgb[e] = a;
  }
}

// ---- weight gradients over splits of the pixel axis

constexpr int XT = 32;      // output tile edge
constexpr int XK = 32;      // pixels per staged chunk
constexpr int XLD = XT + PAD;
constexpr int MAX_JOBS = 12;

struct XJob {
  const bf16* x;     // [rows, in]
  const bf16* g;     // [rows, out]
  int in, out;
  int chunk;         // rows per split
  int tiles;         // (in / XT) * (out / XT)
  size_t part;       // offset of the job's partials: [splits][in][out]
  int block_start;   // first blockIdx.x of the job: tiles * splits blocks
};
struct XJobs {
  XJob job[MAX_JOBS];
  int n, blocks;
};

__global__ void __launch_bounds__(128) xtg_kernel(XJobs jobs, float* __restrict__ partial) {
  __shared__ __align__(128) bf16 xs[2][XK][XLD];
  __shared__ __align__(128) bf16 gs[2][XK][XLD];
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.job[j + 1].block_start) ++j;
  const XJob jb = jobs.job[j];
  const int local = blockIdx.x - jb.block_start;
  const int split = local / jb.tiles, t = local - split * jb.tiles;
  const int tiles_n = jb.out / XT;
  const int m0 = (t / tiles_n) * XT, n0 = (t % tiles_n) * XT;
  const size_t pbeg = (size_t)split * jb.chunk;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;
  Acc acc;
  wmma::fill_fragment(acc, 0.0f);
  auto stage = [&](int c) {
    const size_t p = pbeg + (size_t)c * XK;
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;  // 32 rows x 4 copies
    cp_async16(&xs[c & 1][r][q * 8], jb.x + (p + r) * jb.in + m0 + q * 8);
    cp_async16(&gs[c & 1][r][q * 8], jb.g + (p + r) * jb.out + n0 + q * 8);
    cp_async_commit();
  };
  const int n = jb.chunk / XK;
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, &xs[c & 1][kk][wm], XLD);
      wmma::load_matrix_sync(fb, &gs[c & 1][kk][wn], XLD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  float* out = partial + jb.part + (size_t)split * jb.in * jb.out;
  wmma::store_matrix_sync(out + (size_t)(m0 + wm) * jb.out + n0 + wn, acc, jb.out,
                          wmma::mem_row_major);
}

struct CJob {
  const bf16* src;   // [rows, ld], columns [0, width) summed
  const bf16* wt;    // per-row factor wt[r * 3], or null
  int ld, width;
  int chunk;
  size_t part;       // [splits][width]
  int block_start;   // splits * ceil(width / 128) blocks
  int col_blocks;
};
struct CJobs {
  CJob job[MAX_JOBS];
  int n, blocks;
};

__global__ void __launch_bounds__(128) colsum_kernel(CJobs jobs, float* __restrict__ partial) {
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.job[j + 1].block_start) ++j;
  const CJob jb = jobs.job[j];
  const int local = blockIdx.x - jb.block_start;
  const int split = local / jb.col_blocks;
  const int col = (local - split * jb.col_blocks) * 128 + threadIdx.x;
  if (col >= jb.width) return;
  const size_t pbeg = (size_t)split * jb.chunk;
  const bf16* s = jb.src + pbeg * jb.ld + col;
  float acc = 0.0f;
  if (jb.wt != nullptr) {
    const bf16* w = jb.wt + pbeg * 3;
    for (int p = 0; p < jb.chunk; ++p)
      acc += __bfloat162float(s[(size_t)p * jb.ld]) * __bfloat162float(w[(size_t)p * 3]);
  } else {
    for (int p = 0; p < jb.chunk; ++p) acc += __bfloat162float(s[(size_t)p * jb.ld]);
  }
  partial[jb.part + (size_t)split * jb.width + col] = acc;
}

struct RJob {
  float* out;        // out[e * stride]
  size_t part;       // [splits][count]
  int count, splits, stride;
  int start;         // first global index of the job
};
struct RJobs {
  RJob job[2 * MAX_JOBS];
  int n, total;
};

__global__ void __launch_bounds__(256) reduce_kernel(RJobs jobs,
                                                     const float* __restrict__ partial) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= jobs.total) return;
  int j = 0;
  while (j + 1 < jobs.n && idx >= jobs.job[j + 1].start) ++j;
  const RJob jb = jobs.job[j];
  const int e = idx - jb.start;
  float acc = 0.0f;
  for (int s = 0; s < jb.splits; ++s) acc += partial[jb.part + (size_t)s * jb.count + e];
  jb.out[(size_t)e * jb.stride] = acc;
}

// ---- scratch layout

constexpr size_t al256(size_t x) { return (x + 255) / 256 * 256; }

int split_rows(size_t rows) {  // largest power of two <= 4096 that divides rows
  int c = 4096;
  while (rows % c) c >>= 1;
  return c;
}

struct Layout {
  size_t h1, h2, z, up, nn, gaf, gup, ga2, ga1, grgb0, gtile, gbil, partial, total;
  size_t Ni, Nf;
  // partial offsets (floats) and split counts of each weight-gradient job
  size_t p_w1, p_w2, p_wf, p_b1, p_b2, p_bf, p_wr, p_br, p_wr0, p_br0;
  int ci, cf;  // split rows at level i, i+1
};

Layout layout(int B, int Hc, int Wc, int lvl, int C, int Cn) {
  Layout L{};
  L.Ni = (size_t)B * ((size_t)1 << (2 * lvl)) * Hc * Wc;
  L.Nf = 4 * L.Ni;
  L.ci = split_rows(L.Ni);
  L.cf = split_rows(L.Nf);
  const size_t si = L.Ni / L.ci, sf = L.Nf / L.cf;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += al256(bytes);
    return at;
  };
  L.h1 = take(L.Ni * 2 * C * 2);
  L.h2 = take(L.Ni * 4 * C * 2);
  L.z = take(L.Ni * 4 * C * 2);
  L.up = take(L.Nf * C * 2);
  L.nn = take(L.Nf * Cn * 2);
  L.gaf = take(L.Nf * Cn * 2);
  L.gup = take(L.Nf * C * 2);
  L.ga2 = take(L.Ni * 4 * C * 2);
  L.ga1 = take(L.Ni * 2 * C * 2);
  L.grgb0 = take(lvl == 0 ? L.Ni * 3 * 2 : 0);
  L.gtile = take(L.Ni * C * 4);
  L.gbil = take(L.Nf * 3 * 4);
  size_t pf = 0;  // floats
  auto part = [&](size_t n) {
    const size_t at = pf;
    pf += (n + 63) / 64 * 64;
    return at;
  };
  L.p_w1 = part(si * C * 2 * C);
  L.p_w2 = part(si * 2 * C * 4 * C);
  L.p_wf = part(sf * C * Cn);
  L.p_b1 = part(si * 2 * C);
  L.p_b2 = part(si * 4 * C);
  L.p_bf = part(sf * Cn);
  L.p_wr = part(3 * sf * Cn);
  L.p_br = part(sf * 3);
  L.p_wr0 = part(lvl == 0 ? 3 * si * C : 0);
  L.p_br0 = part(lvl == 0 ? si * 3 : 0);
  L.partial = take(pf * 4);
  L.total = off;
  return L;
}

bool dims_ok(int B, int Hc, int Wc, int lvl, int C, int Cn) {
  const bool widths = (C == 256 && Cn == 128) || (C == 128 && Cn == 64) || (C == 64 && Cn == 32);
  return widths && B > 0 && Hc > 0 && Wc > 0 && Hc % 8 == 0 && Wc % 8 == 0 && lvl >= 0 &&
         lvl <= 6;
}

unsigned grid_for(size_t total) {
  const size_t blocks = (total + 255) / 256;
  return (unsigned)(blocks < 65535u * 64u ? blocks : 65535u * 64u);
}

template <int BN, bool TRANS, int EPI>
cudaError_t gemm(const bf16* A, const bf16* W, size_t rows, int K, int N, const EpiArgs& ep,
                 cudaStream_t s) {
  gemm_kernel<BN, TRANS, EPI><<<dim3((unsigned)(rows / GBM), N / BN), 128, 0, s>>>(A, W, K, N, ep);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch one launch needs at these dims (0 at dims the
// kernels do not take).
extern "C" long long fused_upsampler_bwd_scratch_bytes(int B, int Hc, int Wc, int level, int C,
                                                      int Cn) {
  if (!dims_ok(B, Hc, Wc, level, C, Cn)) return 0;
  return (long long)layout(B, Hc, Wc, level, C, Cn).total;
}

// Launches the kernels above on `stream`, which belongs to the current
// device, using `scratch` (`scratch_size` bytes, allocated by the caller).
// Every output is overwritten. rgb and g_rgb are read / written for
// level > 0 only; wr0, br0, dwr0, dbr0 for level 0 only. Returns the first
// cudaError_t of the launches (0 on success); the caller raises on anything
// else.
extern "C" int fused_upsampler_bwd_launch(
    const bf16* net, const bf16* rgb, const bf16* gnn, const bf16* grgb, const bf16* w1,
    const float* b1, const bf16* w2, const float* b2, const bf16* wf, const float* bfv,
    const bf16* wr, const float* br, const bf16* wr0, const float* br0, float* gnet, float* grgb_in,
    float* dw1, float* db1, float* dw2, float* db2, float* dwf, float* dbf, float* dwr, float* dbr,
    float* dwr0, float* dbr0, void* scratch, long long scratch_size, int B, int Hc, int Wc,
    int level, int C, int Cn, void* stream) {
  (void)rgb;  // the block's backward does not read its rgb input: rgb' is linear in it
  if (!dims_ok(B, Hc, Wc, level, C, Cn)) return (int)cudaErrorInvalidValue;
  if ((level > 0 && grgb_in == nullptr) ||
      (level == 0 && (wr0 == nullptr || dwr0 == nullptr || dbr0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(B, Hc, Wc, level, C, Cn);
  if (scratch_size < 0 || (size_t)scratch_size < L.total) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  auto bfp = [&](size_t off) { return reinterpret_cast<bf16*>(base + off); };
  auto f32p = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  bf16 *h1 = bfp(L.h1), *h2 = bfp(L.h2), *z = bfp(L.z), *up = bfp(L.up), *nn = bfp(L.nn);
  bf16 *gaf = bfp(L.gaf), *gup = bfp(L.gup), *ga2 = bfp(L.ga2), *ga1 = bfp(L.ga1);
  bf16* grgb0 = level == 0 ? bfp(L.grgb0) : nullptr;
  float *gtile = f32p(L.gtile), *gbil = f32p(L.gbil), *partial = f32p(L.partial);
  const Grid g{B, Hc, Wc, level};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define FU_TRY(x)                             \
  if ((err = (x)) != cudaSuccess) return (int)err;

  // 1. recompute h1, h2, z at level i
  EpiArgs e1;
  e1.out = h1;
  e1.bias = b1;
  FU_TRY((gemm<64, false, E_H1>(net, w1, L.Ni, C, 2 * C, e1, s)));
  EpiArgs e2;
  e2.out = h2;
  e2.out2 = z;
  e2.bias = b2;
  e2.aux = net;
  e2.C = C;
  FU_TRY((gemm<64, false, E_Z>(h1, w2, L.Ni, 2 * C, 4 * C, e2, s)));
  // 2. up at level i+1
  up_kernel<<<grid_for(L.Nf * C), 256, 0, s>>>(z, up, g, C);
  FU_TRY(cudaGetLastError());
  // 3. net', g_af; g_up
  EpiArgs e3;
  e3.out = nn;
  e3.out2 = gaf;
  e3.bias = bfv;
  e3.aux = gnn;
  e3.aux3 = grgb;
  e3.w3 = wr;
  if (Cn >= 64) {
    FU_TRY((gemm<64, false, E_AF>(up, wf, L.Nf, C, Cn, e3, s)));
  } else {
    FU_TRY((gemm<32, false, E_AF>(up, wf, L.Nf, C, Cn, e3, s)));
  }
  EpiArgs e4;
  e4.out = gup;
  FU_TRY((gemm<64, true, E_BF16>(gaf, wf, L.Nf, Cn, C, e4, s)));
  // 4. g_z -> g_a2, g_tile at level i
  gz_kernel<<<(unsigned)(L.Ni / (GZ_VALUES / (4 * C))), 256, 0, s>>>(gup, h2, ga2, gtile, g, C);
  FU_TRY(cudaGetLastError());
  // 5. the rgb path
  rgb1_kernel<<<grid_for(L.Nf * 3), 256, 0, s>>>(grgb, gbil, g);
  FU_TRY(cudaGetLastError());
  rgb2_kernel<<<grid_for(L.Ni * 3), 256, 0, s>>>(gbil, grgb_in, grgb0, g);
  FU_TRY(cudaGetLastError());
  // 6. g_a1; g_net
  EpiArgs e5;
  e5.out = ga1;
  e5.aux = h1;
  FU_TRY((gemm<64, true, E_MASK>(ga2, w2, L.Ni, 4 * C, 2 * C, e5, s)));
  EpiArgs e6;
  e6.fout = gnet;
  e6.ftile = gtile;
  e6.aux3 = grgb0;
  e6.w3 = wr0;
  FU_TRY((gemm<64, true, E_GX>(ga1, w1, L.Ni, 2 * C, C, e6, s)));

  // 7. weight gradients: X^T G tiles, column sums, the splits in order
  const int si = (int)(L.Ni / L.ci), sf = (int)(L.Nf / L.cf);
  XJobs xj{};
  RJobs rj{};
  auto rjob = [&](float* out, size_t part, int count, int splits, int stride) {
    rj.job[rj.n] = RJob{out, part, count, splits, stride, rj.total};
    rj.total += count;
    ++rj.n;
  };
  auto xjob = [&](const bf16* x, const bf16* gg, int in, int out, int chunk, int splits,
                  size_t part, float* dst) {
    const int tiles = (in / XT) * (out / XT);
    xj.job[xj.n] = XJob{x, gg, in, out, chunk, tiles, part, xj.blocks};
    xj.blocks += tiles * splits;
    ++xj.n;
    rjob(dst, part, in * out, splits, 1);
  };
  xjob(net, ga1, C, 2 * C, L.ci, si, L.p_w1, dw1);
  xjob(h1, ga2, 2 * C, 4 * C, L.ci, si, L.p_w2, dw2);
  xjob(up, gaf, C, Cn, L.cf, sf, L.p_wf, dwf);
  CJobs cj{};
  auto cjob = [&](const bf16* src, const bf16* wt, int ld, int width, int chunk, int splits,
                  size_t part, float* dst, int stride) {
    const int cb = (width + 127) / 128;
    cj.job[cj.n] = CJob{src, wt, ld, width, chunk, part, cj.blocks, cb};
    cj.blocks += cb * splits;
    ++cj.n;
    rjob(dst, part, width, splits, stride);
  };
  cjob(ga1, nullptr, 2 * C, 2 * C, L.ci, si, L.p_b1, db1, 1);
  cjob(ga2, nullptr, 4 * C, 4 * C, L.ci, si, L.p_b2, db2, 1);
  cjob(gaf, nullptr, Cn, Cn, L.cf, sf, L.p_bf, dbf, 1);
  for (int k = 0; k < 3; ++k)  // dwr[c, k] = sum_r net'[r, c] g_rgb'[r, k]
    cjob(nn, grgb + k, Cn, Cn, L.cf, sf, L.p_wr + (size_t)k * sf * Cn, dwr + k, 3);
  cjob(grgb, nullptr, 3, 3, L.cf, sf, L.p_br, dbr, 1);
  if (level == 0) {
    for (int k = 0; k < 3; ++k)
      cjob(net, grgb0 + k, C, C, L.ci, si, L.p_wr0 + (size_t)k * si * C, dwr0 + k, 3);
    cjob(grgb0, nullptr, 3, 3, L.ci, si, L.p_br0, dbr0, 1);
  }
  xtg_kernel<<<xj.blocks, 128, 0, s>>>(xj, partial);
  FU_TRY(cudaGetLastError());
  colsum_kernel<<<cj.blocks, 128, 0, s>>>(cj, partial);
  FU_TRY(cudaGetLastError());
  reduce_kernel<<<(rj.total + 255) / 256, 256, 0, s>>>(rj, partial);
  FU_TRY(cudaGetLastError());
#undef FU_TRY
  return 0;
}
