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
// Design: four launches on one stream, all deterministic (no atomics; every
// sum in a fixed order), through a bf16 stash in device scratch:
//   1. the recompute pass: fused_upsampler_tile.cuh's tile kernel in its
//      backward mode, on wgmma with the weights as a pre-packed stream. Per
//      8 x 8 level-i tile it recomputes h1, z, up and net' on chip and, in
//      feat_layer's epilogue, g_af = slope(af) rd(g_net' + g_rgb' wr^T),
//      then g_up = g_af wf^T for the tile's 256 output pixels. It writes h1,
//      the signs of a2 (a byte an element), up, net', g_af and g_up;
//   2. the chain pass (chain_kernel): per 8 x 8 level-i tile, persistent
//      blocks of two warpgroups, channel chunks of 16 channels (64 lanes of
//      the four phases): g_z = the transposed blur of g_up (reflect edges;
//      the chunk's fine window staged by cp.async during the chunk before,
//      8 channels a thread) at the four fine children of each pixel,
//      rounded; g_a2 = slope(a2)
//      g_z, to the stash and to shared memory; the tiled identity's
//      transpose summed in registers over the four chunks that share its
//      channels (chunks ordered so) and stored as g_net's start; g_a1 =
//      g_a2 w2^T accumulated on wgmma over the chunks (each warpgroup half
//      of the 2C columns; the products of one chunk run over the next
//      chunk's stencil), then slope(h1) and bf16, to the stash and to shared
//      memory; g_net = g_a1 w1^T + g_tile (+ g_rgb_0 wr_0^T for block 0) on
//      wgmma. w2^T and w1^T come as one K-major stream (chain_stream_chunks)
//      through the same mbarrier ring. The rgb path (the transposed blur,
//      then the transposed clamped bilinear, f32, in the plain version's
//      order) runs per pixel at the tile's start;
//   3. the weight gradients on the shared X^T G core (xtg_core.cuh):
//      dW1 = net^T g_a1 (+ db1), dW2 = h1^T g_a2 (+ db2), dWf = up^T g_af
//      (+ dbf) at the finer level (a job of 4x the points), dwr = net'^T
//      g_rgb' and dbr as three narrow jobs on g_rgb's columns, and for
//      block 0 dwr0 = net^T g_rgb_0, dbr0; then xtg_reduce adds the splits
//      in split order.
// It replaces a first kernel of 13 launches on nvcuda::wmma (7.382 ms per
// Reso64 B=2 pass on the H100 80GB HBM3 at 700 W).

#include "fused_upsampler_tile.cuh"
#include "xtg_core.cuh"

namespace {

using fu::bf16;
using fu::bf162;
using fut::NTHREADS;
using fut::ld2;
using fut::st2;
using hopper::CM;
using hopper::cidx;
using hopper::desc;
using hopper::fence_acc;
using hopper::fence_async_shared;

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

// blur_t on 8 channels: f(u, o) writes the 8 values at u into o
template <class F>
__device__ __forceinline__ void blur_t8(int v, int S, float (&a)[8], F f) {
  float y[8];
  f(v, y);
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = 0.5f * y[k];
  auto add = [&](int u) {
    f(u, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] += 0.25f * y[k];
  };
  if (v >= 1) add(v - 1);
  if (v + 1 < S) add(v + 1);
  if (v == 1) add(0);
  if (v == S - 2) add(S - 1);
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

// ---- the chain pass

constexpr int KCH2 = 16;   // channels a chunk
constexpr int NL = 4 * KCH2;   // its lanes (four phases): the chunk's g_a2 width
constexpr int GWIN = 2 * fut::T + 2;   // fine window edge of the transposed blur: a one-pixel halo
constexpr int RWIN = GWIN + 2;         // g_rgb' window edge of the rgb path (blur, then bilinear)

// The chain's weight stream (chain_stream_chunks): per channel chunk ch (in
// the order c0 = (ch / 4) KCH2 + (ch % 4) C / 4), per phase p, the K-major
// chunk of w2^T over the lanes p C + c0 .. + KCH2 [2C / 8][2][8][8]; then
// w1^T by 16 columns of w1, [C / 8][2][8][8].
template <int C>
struct ChainStream {
  static constexpr int NJ2 = C / KCH2, NW2 = 4 * NJ2, NW1 = 2 * C / 16;
  static constexpr int B_W2 = 16 * 2 * C * 2, B_W1 = 16 * C * 2;
  static constexpr int NCHUNKS = NW2 + NW1;
  static constexpr long long BYTES = (long long)NW2 * B_W2 + (long long)NW1 * B_W1;
  static constexpr int SLOT = B_W2, STAGES = 4, DEPTH = 1;
  static_assert(NJ2 % 4 == 0 && B_W1 % 128 == 0, "chain chunks");
  __device__ static void at(int q, uint32_t& off, uint32_t& bytes) {
    if (q < NW2) {
      off = q * B_W2;
      bytes = B_W2;
    } else {
      off = NW2 * B_W2 + (q - NW2) * B_W1;
      bytes = B_W1;
    }
  }
};

// Shared memory (bytes): two g_a2 chunks [64][NL] and g_a1 [64][2C] (core
// matrices), g_rgb_0 of the tile [64][3] f32, two windows of g_up [18 x
// 18][KCH2] (the second holds the rgb path's g_rgb' [20 x 20][3] and
// transposed blur [18 x 18][3], f32, before the chunk loop), the ring.
template <int C>
struct ChainSmem {
  using St = ChainStream<C>;
  static constexpr int GW_BYTES = GWIN * GWIN * KCH2 * 2;
  static constexpr int OFF_A2 = 0;
  static constexpr int OFF_A1 = OFF_A2 + 2 * 64 * NL * 2;
  static constexpr int OFF_GR0 = OFF_A1 + 64 * 2 * C * 2;
  static constexpr int OFF_GW = OFF_GR0 + fut::al128(64 * 3 * 4);
  static constexpr int OFF_RGW = OFF_GW + GW_BYTES;
  static constexpr int OFF_GBW = OFF_RGW + fut::al128(RWIN * RWIN * 3 * 4);
  static constexpr int OFF_RING = OFF_GW + 2 * fut::al128(GW_BYTES);
  static constexpr int SMEM = OFF_RING + fut::Ring<St>::BYTES;
  static_assert(OFF_GBW + GWIN * GWIN * 3 * 4 <= OFF_RING, "the rgb path fits the second window");
  static_assert(GW_BYTES % 128 == 0, "window alignment");
  static_assert(SMEM <= 232448, "shared memory over the per-block limit");
};

struct ChainParams {
  const bf16* gups;         // g_up [Nf, C]
  const unsigned char* sg;  // a2 >= 0 [Ni, 4C]
  const bf16* h1s;          // h1 [Ni, 2C]
  const bf16* grgb;         // g_rgb' [Nf, 3]
  const unsigned char* ws;  // the chain's weight stream
  const bf16* wr0;          // [C, 3] (level 0)
  float* gnet;              // [Ni, C]
  float* grgb_in;           // [Ni, 3] (level > 0)
  bf16* grgb0;              // [Ni, 3] stash (level 0)
  bf16* ga2s;               // [Ni, 4C]
  bf16* ga1s;               // [Ni, 2C]
  int B, Hc, Wc, lvl;
};

// two blocks an SM where the compiler fits them in 128 registers (C <= 128:
// 0.68 against 0.76 ms for block 2's chain at B=2 on the H100, in turns)
template <int C>
__global__ void __launch_bounds__(NTHREADS, C == 256 ? 1 : 2)
    chain_kernel(const __grid_constant__ ChainParams p) {
  using St = ChainStream<C>;
  using Sm = ChainSmem<C>;
  constexpr int C2 = 2 * C, C4 = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const A2 = reinterpret_cast<bf16*>(smem + Sm::OFF_A2);
  bf16* const A1 = reinterpret_cast<bf16*>(smem + Sm::OFF_A1);
  float* const GR0 = reinterpret_cast<float*>(smem + Sm::OFF_GR0);
  bf16* const GW = reinterpret_cast<bf16*>(smem + Sm::OFF_GW);
  float* const RGW = reinterpret_cast<float*>(smem + Sm::OFF_RGW);
  float* const GBW = reinterpret_cast<float*>(smem + Sm::OFF_GBW);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w4 = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lvl = p.lvl, S = p.Hc << lvl, SW = p.Wc << lvl, S2 = 2 * S, SW2 = 2 * SW;
  const int tiles_c = SW / fut::T, tpi = (S / fut::T) * tiles_c, total = p.B * tpi;
  const int mine = (int)blockIdx.x < total ? (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;

  fut::Ring<St> rg;
  rg.setup(smem + Sm::OFF_RING, p.ws, wg, mine);
  if (tid == 0) rg.init();
  __syncthreads();
  rg.prime();

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int b = tile / tpi, tt = tile - b * tpi, tr = tt / tiles_c, tc = tt - tr * tiles_c;
    const int u0 = tr * fut::T, v0 = tc * fut::T;
    auto ipix = [&](int ul) { return fu::pix(b, u0 + (ul >> 3), v0 + (ul & 7), lvl, p.Hc, p.Wc); };
    auto fpix = [&](int U, int V) { return fu::pix(b, U, V, lvl + 1, p.Hc, p.Wc); };

    const int Uw = 2 * u0 - 1, Vw = 2 * v0 - 1;   // the fine window's origin
    // g_up of channels c0 .. c0 + KCH2 on the fine window, 16-byte cp.async
    // (pixels outside the image are never read)
    auto win_copy = [&](bf16* gw, int c0) {
      for (int e = tid; e < GWIN * GWIN * 2; e += NTHREADS) {
        const int px = e >> 1, r = px / GWIN, cl = px - r * GWIN;
        const int U = Uw + r, V = Vw + cl;
        if (U < 0 || U >= S2 || V < 0 || V >= SW2) continue;
        fu::cp_async16(gw + px * KCH2 + (e & 1) * 8, p.gups + fpix(U, V) * C + c0 + (e & 1) * 8);
      }
      fu::cp_async_commit();
    };

    __syncthreads();   // the last tile is done with g_a1, g_rgb_0 and the windows
    win_copy(GW, 0);
    // ---- the rgb path: g_rgb of the tile's pixels, through shared memory:
    // g_rgb' on a [20 x 20] window, its transposed blur on the [18 x 18]
    // fine window, then the transposed bilinear per pixel
    for (int e = tid; e < RWIN * RWIN * 3; e += NTHREADS) {
      const int r = e / (RWIN * 3), rem = e - r * (RWIN * 3), cl = rem / 3, k = rem - cl * 3;
      const int U = Uw - 1 + r, V = Vw - 1 + cl;
      RGW[e] = (U < 0 || U >= S2 || V < 0 || V >= SW2)
                   ? 0.0f : __bfloat162float(p.grgb[fpix(U, V) * 3 + k]);
    }
    __syncthreads();
    for (int e = tid; e < GWIN * GWIN * 3; e += NTHREADS) {
      const int r = e / (GWIN * 3), rem = e - r * (GWIN * 3), cl = rem / 3, k = rem - cl * 3;
      const int Uq = Uw + r, Vq = Vw + cl;
      if (Uq < 0 || Uq >= S2 || Vq < 0 || Vq >= SW2) continue;
      GBW[e] = blur_t(Uq, S2, [&](int Ur) {
        return blur_t(Vq, SW2, [&](int Vr) { return RGW[((Ur - Uw + 1) * RWIN + (Vr - Vw + 1)) * 3 + k]; });
      });
    }
    __syncthreads();
    if (tid < 64 * 3) {
      const int ul = tid / 3, k = tid - ul * 3;
      const int u = u0 + (ul >> 3), v = v0 + (ul & 7);
      auto row = [&](int Uq) {
        return bilin_t(v, SW, [&](int Vq) { return GBW[((Uq - Uw) * GWIN + (Vq - Vw)) * 3 + k]; });
      };
      const float a = bilin_t(u, S, row);
      if (lvl == 0) {
        GR0[ul * 3 + k] = fu::rd(a);
        p.grgb0[ipix(ul) * 3 + k] = __float2bfloat16(a);
      } else {
        p.grgb_in[ipix(ul) * 3 + k] = a;
      }
    }
    fu::cp_async_wait<0>();
    __syncthreads();   // the first window has landed; the rgb path is done with the second

    // ---- channel chunks: g_z, g_a2, g_tile; g_a1 += g_a2 w2^T
    float acc1[C / 2];   // g_a1's columns [wg C, wg C + C) of the tile's 64 pixels
#pragma unroll
    for (int k = 0; k < C / 2; ++k) acc1[k] = 0.0f;
    float gt[2][8];      // this thread's g_tile values, summed over the four chunks that share them
#pragma unroll 1
    for (int ch = 0; ch < St::NJ2; ++ch) {
      const int jj = ch >> 2, m = ch & 3, c0 = jj * KCH2 + m * (C / 4);
      bf16* const A2c = A2 + (ch & 1) * 64 * NL;
      const bf16* gw = GW + (ch & 1) * (Sm::GW_BYTES / 2);
      if (ch + 1 < St::NJ2)   // the next chunk's window, over this chunk's stencil
        win_copy(GW + ((ch + 1) & 1) * (Sm::GW_BYTES / 2),
                 ((ch + 1) >> 2) * KCH2 + ((ch + 1) & 3) * (C / 4));
      // g_z of (pixel, phase, 8 channels) items: 16-byte loads from the window
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int e = tid + it * NTHREADS;
        const int ul = e >> 3, pz = (e >> 1) & 3, c8 = 8 * (e & 1);
        const int u = u0 + (ul >> 3), v = v0 + (ul & 7), c = c0 + c8;
        const int U = 2 * u + (pz >> 1), V = 2 * v + (pz & 1);
        const size_t ip = fu::pix(b, u, v, lvl, p.Hc, p.Wc);
        const uint2 sgn = *reinterpret_cast<const uint2*>(p.sg + ip * C4 + pz * C + c);
        float gz[8];
        blur_t8(U, S2, gz, [&](int Uq, float (&row)[8]) {
          blur_t8(V, SW2, row, [&](int Vq, float (&o)[8]) {
            fut::unpack8(*reinterpret_cast<const uint4*>(gw + ((Uq - Uw) * GWIN + (Vq - Vw)) * KCH2 + c8), o);
          });
        });
        uint32_t ow[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bf162 z = fu::cvt2(gz[2 * q], gz[2 * q + 1]);
          const float2 zf = fu::f2(z);
          const uint32_t bytes = (q < 2 ? sgn.x : sgn.y) >> (16 * (q & 1));
          const bf162 ga = fu::slope2(z, make_float2((bytes & 0xffu) ? 1.0f : -1.0f,
                                                     (bytes & 0xff00u) ? 1.0f : -1.0f));
          ow[q] = *reinterpret_cast<const uint32_t*>(&ga);
          gt[it][2 * q] = m == 0 ? zf.x : gt[it][2 * q] + zf.x;
          gt[it][2 * q + 1] = m == 0 ? zf.y : gt[it][2 * q + 1] + zf.y;
        }
        const uint4 o = make_uint4(ow[0], ow[1], ow[2], ow[3]);
        *reinterpret_cast<uint4*>(A2c + cidx(ul, pz * KCH2 + c8, NL)) = o;
        *reinterpret_cast<uint4*>(p.ga2s + ip * C4 + pz * C + c) = o;
        if (m == 3) {   // lane p C + c adds into channel (4c + p) mod C
#pragma unroll
          for (int k = 0; k < 8; ++k) p.gnet[ip * C + 4 * (jj * KCH2 + c8 + k) + pz] = gt[it][k];
        }
      }
      fu::cp_async_wait<0>();   // this thread's copies of the next window have landed
      if (ch > 0) rg.finish();   // the last chunk's products (run over this stencil)
      fence_acc(acc1);
      fence_async_shared();
      __syncthreads();   // the chunk's g_a2 is complete, and visible to wgmma
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {
        const bf16* wt = rg.acquire();
        fence_acc(acc1);
        hopper::wgmma_fence();
        hopper::wgmma<C, 0>(acc1, desc(A2c + 2 * s * CM, 128, NL * 16),
                            desc(wt + (wg * C / 8) * 2 * CM, 128, 16 * 16));
        hopper::wgmma_commit();
        rg.step();
      }
    }
    rg.finish();
    fence_acc(acc1);
    // g_a1 = slope(h1) rd(g_a2 w2^T): to the stash and to shared memory
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ul = 16 * w4 + g + 8 * r;
      const size_t ip = ipix(ul);
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int n = wg * C + 8 * j + 2 * tq;
        const bf162 ga = fu::slope2(fu::cvt2(acc1[4 * j + 2 * r], acc1[4 * j + 2 * r + 1]),
                                    ld2(p.h1s + ip * C2 + n));
        *reinterpret_cast<bf162*>(A1 + cidx(ul, n, C2)) = ga;
        *reinterpret_cast<bf162*>(p.ga1s + ip * C2 + n) = ga;
      }
    }
    fence_async_shared();
    __syncthreads();   // g_a1 is complete; g_tile is stored

    // ---- g_net = g_a1 w1^T + g_tile (+ g_rgb_0 wr_0^T): columns [wg C/2, wg C/2 + C/2)
    float acc2[C / 4];
#pragma unroll
    for (int k = 0; k < C / 4; ++k) acc2[k] = 0.0f;
#pragma unroll 1
    for (int r2 = 0; r2 < C2 / 16; ++r2) {
      const bf16* wt = rg.acquire();
      fence_acc(acc2);
      hopper::wgmma_fence();
      hopper::wgmma<C / 2, 0>(acc2, desc(A1 + 2 * r2 * CM, 128, C2 * 16),
                              desc(wt + (wg * C / 16) * 2 * CM, 128, 16 * 16));
      hopper::wgmma_commit();
      rg.step();
    }
    rg.finish();
    fence_acc(acc2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ul = 16 * w4 + g + 8 * r;
      const size_t ip = ipix(ul);
#pragma unroll
      for (int j = 0; j < C / 16; ++j) {
        const int cx = wg * (C / 2) + 8 * j + 2 * tq;
        float2* dst = reinterpret_cast<float2*>(p.gnet + ip * C + cx);
        const float2 tile_g = *dst;
        float vx = acc2[4 * j + 2 * r] + tile_g.x, vy = acc2[4 * j + 2 * r + 1] + tile_g.y;
        if (lvl == 0) {
          float sx = 0.0f, sy = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            sx += GR0[ul * 3 + k] * __bfloat162float(p.wr0[cx * 3 + k]);
            sy += GR0[ul * 3 + k] * __bfloat162float(p.wr0[cx * 3 + 3 + k]);
          }
          vx += sx;
          vy += sy;
        }
        *dst = make_float2(vx, vy);
      }
    }
  }
}

// ---- scratch layout and the weight-gradient plan

constexpr size_t al256(size_t x) { return (x + 255) / 256 * 256; }

// the X^T G core's blocks aimed at (2 waves of two blocks an SM on 132 SMs):
// the splits of the point axis follow from the plan's tiles, and the f32
// partials from the splits (at 4 waves block 0's partials made its scratch
// larger than the 13-launch design's)
constexpr int XTG_BLOCKS = 528;

bool dims_ok(int B, int Hc, int Wc, int lvl, int C, int Cn) {
  const bool widths = (C == 256 && Cn == 128) || (C == 128 && Cn == 64) || (C == 64 && Cn == 32);
  return widths && B > 0 && Hc > 0 && Wc > 0 && Hc % fut::T == 0 && Wc % fut::T == 0 && lvl >= 0 &&
         lvl <= 6;
}

struct Outs {
  float *dw1, *db1, *dw2, *db2, *dwf, *dbf, *dwr, *dbr, *dwr0, *dbr0;
};

struct Layout {
  size_t Ni, Nf;
  size_t h1, sg, up, nn, gaf, gup, ga2, ga1, grgb0, partial, total;
  int rows, splits;
};

// the weight-gradient jobs over the stash at `base` (null: sizes only)
xtg::Plan weight_plan(const Layout& L, unsigned char* base, const bf16* net, const bf16* grgb,
                      int lvl, int C, int Cn, const Outs& o) {
  auto bfp = [&](size_t off) { return reinterpret_cast<const bf16*>(base + off); };
  xtg::Plan plan;
  plan.add(net, bfp(L.ga1), C, 2 * C, o.dw1, 0, o.db1, 0, 1);
  plan.add(bfp(L.h1), bfp(L.ga2), 2 * C, 4 * C, o.dw2, 0, o.db2, 0, 1);
  plan.add(bfp(L.up), bfp(L.gaf), C, Cn, o.dwf, 0, o.dbf, 0, 1, 0, 4);
  for (int k = 0; k < 3; ++k)   // dwr[:, k] = net'^T g_rgb'[:, k], dbr[k]
    plan.add(bfp(L.nn), grgb + k, Cn, 1, o.dwr + k, 0, o.dbr + k, 0, 1, 3, 4, 3);
  if (lvl == 0)
    for (int k = 0; k < 3; ++k)
      plan.add(net, bfp(L.grgb0) + k, C, 1, o.dwr0 + k, 0, o.dbr0 + k, 0, 1, 3, 1, 3);
  return plan;
}

Layout layout(int B, int Hc, int Wc, int lvl, int C, int Cn) {
  Layout L{};
  L.Ni = (size_t)B * ((size_t)1 << (2 * lvl)) * Hc * Wc;
  L.Nf = 4 * L.Ni;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += al256(bytes);
    return at;
  };
  L.h1 = take(L.Ni * 2 * C * 2);
  L.sg = take(L.Ni * 4 * C);
  L.up = take(L.Nf * C * 2);
  L.nn = take(L.Nf * Cn * 2);
  L.gaf = take(L.Nf * Cn * 2);
  L.gup = take(L.Nf * C * 2);
  L.ga2 = take(L.Ni * 4 * C * 2);
  L.ga1 = take(L.Ni * 2 * C * 2);
  L.grgb0 = take(lvl == 0 ? L.Ni * 3 * 2 : 0);
  L.rows = (int)(L.Ni / xtg::BK);
  const Outs none{};
  const xtg::Plan plan = weight_plan(L, nullptr, nullptr, nullptr, lvl, C, Cn, none);
  const int per = plan.tiles();
  int sp = (XTG_BLOCKS + per / 2) / per;
  L.splits = sp < 1 ? 1 : (sp > L.rows ? L.rows : sp);
  L.partial = take(plan.partial_bytes(L.splits));
  L.total = off;
  return L;
}

template <int C>
cudaError_t launch_chain(const ChainParams& p, cudaStream_t s) {
  static std::atomic<int> fit[fut::MAX_DEVICES];
  cudaError_t err;
  const int res = fut::resident(chain_kernel<C>, ChainSmem<C>::SMEM, fit, &err);
  if (res <= 0) return err;
  const long long tiles = fut::tiles_of(p.B, p.Hc, p.Wc, p.lvl);
  if (tiles <= 0 || tiles > INT_MAX) return cudaErrorInvalidValue;
  chain_kernel<C><<<(unsigned)(tiles < res ? tiles : res), NTHREADS, ChainSmem<C>::SMEM, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch one launch needs at these dims (0 at dims the
// kernels do not take): the stash, then the X^T G core's partials.
extern "C" long long fused_upsampler_bwd_scratch_bytes(int B, int Hc, int Wc, int level, int C,
                                                      int Cn) {
  if (!dims_ok(B, Hc, Wc, level, C, Cn)) return 0;
  return (long long)layout(B, Hc, Wc, level, C, Cn).total;
}

// Launches the four kernels above on `stream`, which belongs to the current
// device, using `scratch` (`scratch_size` bytes, allocated by the caller).
// ws_rec and ws_chain are the block's packed streams (pack_streams kinds
// "rec" and "chain"); the biases f32 (b2 phase-major), wr [Cn, 3]
// and wr0 [C, 3] bf16. Every output is overwritten. g_rgb is written for
// level > 0 only; wr0, dwr0, dbr0 are used for level 0 only. Returns the
// first cudaError_t of the launches (0 on success); the caller raises on
// anything else.
extern "C" int fused_upsampler_bwd_launch(
    const bf16* net, const bf16* gnn, const bf16* grgb, const unsigned char* ws_rec,
    const unsigned char* ws_chain, const float* b1, const float* b2, const float* bfv,
    const bf16* wr, const bf16* wr0, float* gnet, float* grgb_in, float* dw1,
    float* db1, float* dw2, float* db2, float* dwf, float* dbf, float* dwr, float* dbr,
    float* dwr0, float* dbr0, void* scratch, long long scratch_size, int B, int Hc, int Wc,
    int level, int C, int Cn, void* stream) {
  if (!dims_ok(B, Hc, Wc, level, C, Cn) || ws_rec == nullptr || ws_chain == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((level > 0 && grgb_in == nullptr) ||
      (level == 0 && (wr0 == nullptr || dwr0 == nullptr || dbr0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(B, Hc, Wc, level, C, Cn);
  if (scratch_size < 0 || (size_t)scratch_size < L.total) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  auto bfp = [&](size_t off) { return reinterpret_cast<bf16*>(base + off); };
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;

  // 1. the recompute pass
  fut::TileParams tp{};
  tp.net = net;
  tp.ws = ws_rec;
  tp.b1 = b1;
  tp.b2 = b2;
  tp.bfv = bfv;
  tp.wr = wr;
  tp.gnn = gnn;
  tp.grgb = grgb;
  tp.h1s = bfp(L.h1);
  tp.sg = base + L.sg;
  tp.ups = bfp(L.up);
  tp.nns = bfp(L.nn);
  tp.gafs = bfp(L.gaf);
  tp.gups = bfp(L.gup);
  tp.B = B;
  tp.Hc = Hc;
  tp.Wc = Wc;
  tp.lvl = level;
  // 2. the chain pass
  ChainParams cp{};
  cp.gups = bfp(L.gup);
  cp.sg = base + L.sg;
  cp.h1s = bfp(L.h1);
  cp.grgb = grgb;
  cp.ws = ws_chain;
  cp.wr0 = wr0;
  cp.gnet = gnet;
  cp.grgb_in = grgb_in;
  cp.grgb0 = level == 0 ? bfp(L.grgb0) : nullptr;
  cp.ga2s = bfp(L.ga2);
  cp.ga1s = bfp(L.ga1);
  cp.B = B;
  cp.Hc = Hc;
  cp.Wc = Wc;
  cp.lvl = level;
  if (C == 256) {
    if ((err = fut::launch_tile<256, 128, true>(tp, s)) != cudaSuccess) return (int)err;
    if ((err = launch_chain<256>(cp, s)) != cudaSuccess) return (int)err;
  } else if (C == 128) {
    if ((err = fut::launch_tile<128, 64, true>(tp, s)) != cudaSuccess) return (int)err;
    if ((err = launch_chain<128>(cp, s)) != cudaSuccess) return (int)err;
  } else {
    if ((err = fut::launch_tile<64, 32, true>(tp, s)) != cudaSuccess) return (int)err;
    if ((err = launch_chain<64>(cp, s)) != cudaSuccess) return (int)err;
  }
  // 3. the weight gradients, then their splits in order
  const Outs o{dw1, db1, dw2, db2, dwf, dbf, dwr, dbr, dwr0, dbr0};
  const xtg::Plan plan = weight_plan(L, base, net, grgb, level, C, Cn, o);
  return (int)plan.launch(reinterpret_cast<float*>(base + L.partial), 1, L.rows, L.splits, s);
}

// The design's numbers at these dims: out[0..8] = level-i tiles, the
// recompute pass's grid blocks, the chain pass's grid blocks, chunks a tile
// and bytes of the recompute and the chain streams, the X^T G core's splits
// and blocks. Returns the cudaError_t.
extern "C" int fused_upsampler_bwd_design(int B, int Hc, int Wc, int level, int C, int Cn,
                                          long long* out) {
  if (!dims_ok(B, Hc, Wc, level, C, Cn)) return (int)cudaErrorInvalidValue;
  long long rec[8];
  cudaError_t err;
  static std::atomic<int> fit[3][fut::MAX_DEVICES];
  int chain_res;
  if (C == 256) {
    if ((err = fut::design_tile<256, 128, true>(B, Hc, Wc, level, rec)) != cudaSuccess) return (int)err;
    chain_res = fut::resident(chain_kernel<256>, ChainSmem<256>::SMEM, fit[0], &err);
  } else if (C == 128) {
    if ((err = fut::design_tile<128, 64, true>(B, Hc, Wc, level, rec)) != cudaSuccess) return (int)err;
    chain_res = fut::resident(chain_kernel<128>, ChainSmem<128>::SMEM, fit[1], &err);
  } else {
    if ((err = fut::design_tile<64, 32, true>(B, Hc, Wc, level, rec)) != cudaSuccess) return (int)err;
    chain_res = fut::resident(chain_kernel<64>, ChainSmem<64>::SMEM, fit[2], &err);
  }
  if (chain_res <= 0) return (int)err;
  const long long chain_chunks = C == 256 ? ChainStream<256>::NCHUNKS
                                 : C == 128 ? ChainStream<128>::NCHUNKS
                                            : ChainStream<64>::NCHUNKS;
  const long long chain_bytes = C == 256 ? ChainStream<256>::BYTES
                                : C == 128 ? ChainStream<128>::BYTES
                                           : ChainStream<64>::BYTES;
  const Layout L = layout(B, Hc, Wc, level, C, Cn);
  const Outs none{};
  const xtg::Plan plan = weight_plan(L, nullptr, nullptr, nullptr, level, C, Cn, none);
  const long long v[9] = {rec[0],       rec[1], rec[0] < chain_res ? rec[0] : chain_res,
                          rec[3],       chain_chunks, rec[4], chain_bytes, L.splits,
                          (long long)plan.tiles() * L.splits};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return cudaSuccess;
}
