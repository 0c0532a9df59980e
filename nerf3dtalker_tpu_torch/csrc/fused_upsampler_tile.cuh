// The fused upsampler's tile kernel for Hopper (sm_90a): one
// PixelShuffleUpsample block plus the rgb pyramid step over 8 x 8 level-i
// tiles, on wgmma, its weights read as one pre-packed stream through an
// mbarrier ring of bulk copies. fused_upsampler_fwd.cu launches it as
// K5-fwd; fused_upsampler_bwd.cu launches its backward mode (BWD) as the
// recompute pass of K5-bwd, which writes what the later passes read instead
// of the block's outputs.
//
// The block (models/phase_renderer.py: phase_block_forward), level i ->
// i+1, on phase stacks addressed as the fine images they are:
//   h1 = lrelu(D1 x), h2 = lrelu(D2 h1) (phase-major columns q = p C + c),
//   z = h2 + x[(4c + p) mod C] (the tiled identity), pixel shuffle, up =
//   blur3 (reflect), net' = lrelu(feat_layer up), rgb' = blur3(bilinear2x(
//   rgb)) + feat_2_rgb net', with rgb = feat_2_rgb_0 x for block 0.
// It rounds where the plain version rounds: bf16 operands, f32 sums, bf16
// after each product + bias (the products accumulate onto the f32 bias)
// and after every elementwise op.
//
// Design. A block of two warpgroups walks (batch row, tile) pairs
// (persistent: as many blocks as fit on the card at once). Per tile:
//   - the 10 x 10 window of x (a one-pixel halo, clamped at the image edge;
//     the stencils read only in-image pixels) lands by cp.async in the
//     core-matrix layout (hopper.cuh), 104 rows (13 row groups, the last 4
//     rows zero); the next tile's window is issued as soon as the last D2
//     epilogue, the last reader of x, is past. Warpgroup 0's wgmma tile is
//     window rows 0..63, warpgroup 1's rows 40..103 (it keeps rows 64..103);
//   - D1 in column passes of N1 (m64nN1k16, the accumulators starting at
//     the bias), its epilogue on the registers into h1 [104][2C] (bf16
//     core matrices);
//   - D2 in channel chunks of KCH channels: the chunk's 4 KCH columns
//     {p C + c} of all four phases, over K = 2C in KC2-row weight chunks;
//     the epilogue adds the tiled identity from the staged x window and
//     writes z [100][4 KCH] row-major; each warpgroup pixel-shuffles and
//     blurs its 128 of the 16 x 16 output pixels (a vertical pass over the
//     window's 18 fine columns, then a horizontal one, 8 channels a thread)
//     into up [256][KCH] (core matrices), and multiplies it
//     into feat_layer's f32 accumulators (two m64nCn tiles a warpgroup,
//     starting at the bias) as one split-K step, so the 4C-wide D2 output
//     never exists whole;
//   - the epilogue: net' and the rgb head (each row's sum over its columns
//     from the registers, then over the four lanes of a row by shuffles),
//     plus the rgb path (bilinear, blur) computed at the tile's start.
// The weights of a tile are one stream (ops/kernels/fused_upsampler.py:
// pack_streams, tile_stream_chunks): W1's chunks pass by pass, then per channel chunk
// W2's chunks and feat_layer's KCH rows, each chunk [N / 8][rows / 8][8][8]
// and one bulk copy into a ring of STAGES slots with a full and an empty
// mbarrier each. Thread 0 of each warpgroup issues every other chunk (a
// producer warpgroup of its own left the others 168 registers in K1); every
// wait is bounded (hopper.cuh: mbar_wait traps). The chunk loops have no
// block-wide barrier: a warpgroup issues chunk c's products, then waits for
// chunk c - 1's and releases its slot. Each channel chunk has two
// block-wide barriers (z complete before the stencil; the stencil's reads
// done before the next z) and two per warpgroup (the blur's vertical pass,
// then up, complete before they are read).
//
// SPLIT (forward, block 0 when its tiles are fewer than the clusters of two
// the card holds at once, as at B = 1 and on small grids): a cluster of two
// blocks takes each tile. Block r computes D1's column pass r and writes its
// h1 into both blocks' shared memory; then D2's channel chunks [r NJ / 2,
// (r + 1) NJ / 2) and their feat_layer split-K steps (block 0's accumulators
// start at the bias, block 1's at 0). Each block sends its partial sums of
// the peer's 128 output pixels through distributed shared memory, and
// warpgroup r of block r adds them to its own and runs the epilogue of
// pixels 128 r .. 128 r + 127, so every sum is own + peer in one fixed
// order. Four cluster barriers a tile: the tile's start (the peer is done
// with its shared memory), h1 complete, D2 done (h1 is free for the partial
// sums), the partial sums landed.
//
// BWD (the recompute pass of the backward): no rgb path; the D1 epilogue
// also writes h1 of the tile's own 64 pixels, the D2 epilogue the signs of
// a2 (one byte an element), the stencil up; feat_layer's epilogue forms
// g_af = slope(af) (g_net' + g_rgb' wr^T) and writes net' and g_af; then
// g_up = g_af wf^T (the stream's tail holds wf^T in K-major chunks) is
// written for the tile's 256 output pixels. Every value is computed by one
// thread in a fixed order: two launches give the same bits.

#pragma once

#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_upsampler_common.cuh"
#include "hopper.cuh"

namespace {
namespace fut {

using fu::bf16;
using hopper::CM;
using hopper::cidx;
using hopper::desc;
using hopper::fence_acc;
using hopper::fence_async_shared;
using hopper::mbar_wait;
using hopper::smem_addr;

constexpr int NTHREADS = 256;   // two consumer warpgroups
constexpr int MAX_DEVICES = 64;

constexpr int al128(int x) { return (x + 127) / 128 * 128; }

using fu::bf162;

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ void st2(bf16* p, float x, float y) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(x, y);
}
// 8 bf16 in one 16-byte word <-> 8 f32
__device__ __forceinline__ void unpack8(uint4 u, float (&o)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&w[k]));
    o[2 * k] = f.x;
    o[2 * k + 1] = f.y;
  }
}
// a = blur3(a, x, c) on 8 values, by pairs
__device__ __forceinline__ void blur8(float (&a)[8], const float (&x)[8], const float (&c)[8]) {
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    const float2 r = fu::blur3x2(make_float2(a[k], a[k + 1]), make_float2(x[k], x[k + 1]),
                                 make_float2(c[k], c[k + 1]));
    a[k] = r.x;
    a[k + 1] = r.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bf162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- the weight ring

// S: the stream of one tile (static NCHUNKS, SLOT, STAGES, DEPTH: product
// groups in flight behind the newest, and at(q, off, bytes)). Shared memory at `base`: STAGES slots of SLOT bytes, then
// STAGES full and STAGES empty mbarriers. Both warpgroups consume every chunk (the
// empty barrier counts their 8 warps); thread 0 of warpgroup w issues the
// chunks w, w + 2, ... of the block's whole walk.
template <class S>
struct Ring {
  static constexpr int STAGES = S::STAGES;
  static constexpr int BYTES = STAGES * S::SLOT + 16 * STAGES;
  unsigned char* slots;
  const unsigned char* stream;
  int i;        // chunks consumed by this thread's warpgroup
  int pend;     // of those, the ones whose slots it has not released
  int issued;   // the next chunk this producer issues
  int total;    // chunks of the block's walk

  __device__ void setup(unsigned char* base, const unsigned char* ws, int wg, int tiles) {
    slots = base;
    stream = ws;
    i = 0;
    pend = 0;
    issued = wg;
    total = tiles * S::NCHUNKS;
  }
  __device__ uint32_t slot(int s) const { return smem_addr(slots) + s * S::SLOT; }
  __device__ uint32_t full(int s) const { return smem_addr(slots) + STAGES * S::SLOT + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return smem_addr(slots) + STAGES * S::SLOT + 8 * (STAGES + s);
  }
  // thread 0 of the block, before the block's first barrier
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);   // the producer's expect_tx
      hopper::mbar_init(empty(s), 8);  // every warp of the block
    }
    fence_async_shared();   // the barriers are visible to the bulk copies
  }
  // the producer: of its chunks issued .. min(upto, total - 1), those up to
  // `must` once their slot is free, the later ones only while it is free
  // already; each chunk is one bulk copy into slot (chunk % STAGES)
  __device__ void produce(int upto, int must) {
    for (; issued <= upto && issued < total; issued += 2) {
      const int j = issued, s = j % STAGES;
      const uint32_t parity = ((j / STAGES) & 1) ^ 1;   // the slot's previous use released
      if (j <= must)
        mbar_wait(empty(s), parity);
      else if (!hopper::mbar_test_wait(empty(s), parity))
        break;
      uint32_t off, bytes;
      S::at(j % S::NCHUNKS, off, bytes);
      hopper::mbar_expect_tx(full(s), bytes);
      hopper::bulk_load(slot(s), stream + off, bytes, full(s));
    }
  }
  __device__ void prime() {
    if ((threadIdx.x & 127) == 0) produce(STAGES - 1, STAGES - 1);
  }
  // waits for chunk i; its slot
  __device__ const bf16* acquire() const {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    return reinterpret_cast<const bf16*>(slots + s * S::SLOT);
  }
  __device__ void release(int k) const {
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty(k % STAGES));
  }
  // after chunk i's products are issued and committed: keep at most
  // S::DEPTH groups of products in flight behind them, releasing the slot of
  // the chunk whose products are done; keep the stream ahead
  __device__ void step() {
    if (pend == S::DEPTH) {
      hopper::wgmma_wait<S::DEPTH>();
      release(i - S::DEPTH);
    } else {
      ++pend;
    }
    if ((threadIdx.x & 127) == 0) produce(i - 1 + STAGES, i + 1);
    ++i;
  }
  // every product issued is done; the slots of the chunks consumed released
  __device__ void finish() {
    hopper::wgmma_wait<0>();
    for (; pend > 0; --pend) release(i - pend);
  }
};

// ---- the tile kernel's configuration

constexpr int T = 8;          // level-i tile edge
constexpr int WIN = T + 2;    // window edge: a one-pixel halo
constexpr int NWIN = WIN * WIN;
constexpr int ROWS = 104;     // window rows staged: 13 row groups
constexpr int FT = 2 * T;     // output tile edge
constexpr int NF = FT * FT;   // 256 output pixels
constexpr int FW = FT + 2;    // fine window edge of the rgb stencils
constexpr int GKC = 16;       // contraction rows of a g_up chunk (BWD)

// per block widths: D1's pass width N1 and chunk rows KC1, D2's channels
// a chunk KCH and chunk rows KC2, g_up's pass width GNB (BWD), chunks of
// 8 KB at most; MINB: blocks an SM the compiler is asked to fit
template <int C, int CN>
struct TileCfg;
template <>
struct TileCfg<256, 128> {
  static constexpr int N1 = 256, KC1 = 16, KCH = 16, KC2 = 64, GNB = 128, MINB = 1;
};
template <>
struct TileCfg<128, 64> {
  static constexpr int N1 = 256, KC1 = 16, KCH = 32, KC2 = 32, GNB = 128, MINB = 1;
};
template <>
struct TileCfg<64, 32> {
  static constexpr int N1 = 128, KC1 = 32, KCH = 16, KC2 = 64, GNB = 64, MINB = 2;
};

// One tile's weight stream (tile_stream_chunks lays it out): W1 [C, 2C] by
// passes of N1 columns, KC1 rows a chunk; then per channel chunk j the
// NK2 chunks of W2's columns {p C + j KCH + cc} (KC2 rows each, columns in
// the order p KCH + cc) and rows [j KCH, j KCH + KCH) of wf [C, Cn]; BWD
// adds wf^T for g_up: per pass of GNB output columns, Cn / GKC K-major
// chunks. Chunk q: offset and bytes in closed form.
template <int C, int CN, bool BWD>
struct TileStream {
  using Cf = TileCfg<C, CN>;
  static constexpr int C2 = 2 * C, N1 = Cf::N1, KC1 = Cf::KC1, KCH = Cf::KCH, KC2 = Cf::KC2;
  static constexpr int NZ = 4 * KCH, GNB = Cf::GNB;
  static constexpr int NP1 = C2 / N1, ND1 = NP1 * (C / KC1), NK2 = C2 / KC2, NJ = C / KCH;
  static constexpr int NG = BWD ? (C / GNB) * (CN / GKC) : 0;
  static constexpr int B1 = KC1 * N1 * 2, B2 = KC2 * NZ * 2, BF = KCH * CN * 2, BG = GKC * GNB * 2;
  static constexpr int PER = NK2 * B2 + BF;   // bytes of one channel chunk
  static constexpr int NCHUNKS = ND1 + NJ * (NK2 + 1) + NG;
  static constexpr int SLOT = 8192, STAGES = 4, DEPTH = 1;
  static constexpr long long BYTES = (long long)ND1 * B1 + (long long)NJ * PER + (long long)NG * BG;
  static_assert(B1 <= SLOT && B2 <= SLOT && BF <= SLOT && BG <= SLOT, "a chunk fits a slot");
  static_assert(B1 % 128 == 0 && B2 % 128 == 0 && BF % 128 == 0 && BG % 128 == 0,
                "chunks keep the stream 128-byte aligned");
  static_assert(C2 % N1 == 0 && C % KC1 == 0 && C2 % KC2 == 0 && C % KCH == 0 && KCH % 16 == 0 &&
                    C % GNB == 0 && CN % GKC == 0 && KC1 % 16 == 0 && KC2 % 16 == 0,
                "block widths");
  __device__ static void at(int q, uint32_t& off, uint32_t& bytes) {
    if (q < ND1) {
      off = q * B1;
      bytes = B1;
      return;
    }
    q -= ND1;
    if (q < NJ * (NK2 + 1)) {
      const int j = q / (NK2 + 1), s = q - j * (NK2 + 1);
      off = ND1 * B1 + j * PER + s * B2;
      bytes = s < NK2 ? B2 : BF;
      return;
    }
    q -= NJ * (NK2 + 1);
    off = ND1 * B1 + NJ * PER + q * BG;
    bytes = BG;
  }
};

// The stream of block r of a SPLIT pair: W1's pass r, then the channel
// chunks [r NJ / 2, (r + 1) NJ / 2), read from the forward's tile stream
template <int C, int CN>
struct HalfStream {
  using St = TileStream<C, CN, false>;
  static constexpr int ND1 = St::ND1 / 2, NJ = St::NJ / 2;
  static constexpr int NCHUNKS = ND1 + NJ * (St::NK2 + 1);
  static constexpr int SLOT = St::SLOT, STAGES = St::STAGES, DEPTH = St::DEPTH;
  static_assert(St::NP1 == 2 && St::NJ % 2 == 0, "a pair splits D1 by its two passes");
  __device__ static void at(int q, uint32_t& off, uint32_t& bytes) {
    const int r = hopper::cluster_rank();
    St::at(q < ND1 ? q + r * ND1 : St::ND1 + r * NJ * (St::NK2 + 1) + (q - ND1), off, bytes);
  }
};

// Shared memory (bytes): h1 [104][2C] and the x window [104][C] (core
// matrices; h1 is then g_af [256][Cn] in BWD), the ring, z [100][4 KCH + 8]
// (row-major; the rgb path's temporaries before the first D2 epilogue), up
// [256][KCH] (core matrices), the blur's vertical pass [2][8][18][KCH] and,
// forward only, the upsampled rgb [256][3] f32. SPLIT: the peer's partial
// sums of feat_layer [128 pixels][Cn] f32 land where h1 was.
template <int C, int CN, bool BWD>
struct TileSmem {
  using St = TileStream<C, CN, BWD>;
  static constexpr int LDZ = St::NZ + 8;
  static constexpr int OFF_H1 = 0;
  static constexpr int OFF_X = OFF_H1 + ROWS * 2 * C * 2;
  static constexpr int OFF_RING = OFF_X + ROWS * C * 2;
  static constexpr int OFF_Z = al128(OFF_RING + Ring<St>::BYTES);
  static constexpr int OFF_UP = OFF_Z + al128(NWIN * LDZ * 2);
  static constexpr int OFF_VB = OFF_UP + NF * St::KCH * 2;   // [2][8][18][KCH], per warpgroup
  static constexpr int OFF_RUP = OFF_VB + 2 * 8 * FW * St::KCH * 2;
  static constexpr int SMEM = OFF_RUP + (BWD ? 0 : NF * 3 * 4);
  static constexpr int OFF_RGBW = OFF_Z, OFF_RP = OFF_RGBW + al128(NWIN * 3 * 4);
  static constexpr int OFF_BIL = OFF_RP + al128(FW * WIN * 3 * 4);
  static_assert(OFF_BIL + FW * FW * 3 * 4 <= OFF_UP, "the rgb path's temporaries fit in z");
  static_assert(NF * CN * 2 <= OFF_X, "g_af fits where h1 was");
  static_assert(128 * CN * 4 <= OFF_X, "the peer's partial sums fit where h1 was");
  static_assert(OFF_RING % 128 == 0, "ring alignment");
  static_assert(SMEM <= 232448, "shared memory over the per-block limit");
};

struct TileParams {
  const bf16* net;          // [B, 4^i, Hc, Wc, C]
  const bf16* rgb;          // [B, 4^i, Hc, Wc, 3] (level > 0, forward)
  const unsigned char* ws;  // the weight stream
  const float* b1;
  const float* b2;          // phase-major
  const float* bfv;
  const bf16* wr;           // [Cn, 3]
  const float* br;
  const bf16* wr0;          // [C, 3] (level 0, forward)
  const float* br0;
  bf16* net_out;            // forward: [B, 4^(i+1), Hc, Wc, Cn]
  bf16* rgb_out;            // forward: [B, 4^(i+1), Hc, Wc, 3]
  const bf16* gnn;          // BWD: g_net' [.., Cn]
  const bf16* grgb;         // BWD: g_rgb' [.., 3]
  bf16* h1s;                // BWD stash: h1 [Ni, 2C]
  unsigned char* sg;        //   a2 >= 0 [Ni, 4C]
  bf16* ups;                //   up [Nf, C]
  bf16* nns;                //   net' [Nf, Cn]
  bf16* gafs;               //   g_af [Nf, Cn]
  bf16* gups;               //   g_up [Nf, C]
  int B, Hc, Wc, lvl;
};

template <int C, int CN, bool BWD, bool SPLIT = false>
__global__ void __launch_bounds__(NTHREADS, TileCfg<C, CN>::MINB)
    tile_kernel(const __grid_constant__ TileParams p) {
  static_assert(!(BWD && SPLIT), "the backward's recompute pass takes a tile a block");
  using St = TileStream<C, CN, BWD>;
  using Sm = TileSmem<C, CN, BWD>;
  using Rs = std::conditional_t<SPLIT, HalfStream<C, CN>, St>;
  constexpr int C2 = 2 * C, C4 = 4 * C, N1 = St::N1, KC1 = St::KC1, KCH = St::KCH;
  constexpr int KC2 = St::KC2, NZ = St::NZ, LDZ = Sm::LDZ, GNB = St::GNB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const H1 = reinterpret_cast<bf16*>(smem + Sm::OFF_H1);
  bf16* const GAF = H1;
  bf16* const X = reinterpret_cast<bf16*>(smem + Sm::OFF_X);
  bf16* const Z = reinterpret_cast<bf16*>(smem + Sm::OFF_Z);
  bf16* const UP = reinterpret_cast<bf16*>(smem + Sm::OFF_UP);
  float* const RUP = reinterpret_cast<float*>(smem + Sm::OFF_RUP);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w4 = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lvl = p.lvl, S = p.Hc << lvl, SW = p.Wc << lvl, S2 = 2 * S, SW2 = 2 * SW;
  const int tiles_c = SW / T, tpi = (S / T) * tiles_c, total = p.B * tpi;
  // SPLIT: the pair (cluster) walks the tiles; crank is this block's rank in it
  const int crank = SPLIT ? hopper::cluster_rank() : 0;
  const int first = SPLIT ? (int)blockIdx.x >> 1 : (int)blockIdx.x;
  const int stride = SPLIT ? (int)gridDim.x >> 1 : (int)gridDim.x;
  const int mine = first < total ? (total - first + stride - 1) / stride : 0;
  // the peer's h1 (SPLIT)
  const uint32_t h1_peer = SPLIT ? hopper::map_shared(smem_addr(H1), crank ^ 1) : 0u;

  bf16* const VB = reinterpret_cast<bf16*>(smem + Sm::OFF_VB) + wg * (8 * FW * KCH);

  Ring<Rs> rg;
  rg.setup(smem + Sm::OFF_RING, p.ws, wg, mine);
  if (tid == 0) rg.init();
  __syncthreads();
  rg.prime();

  // the warpgroup's wgmma rows of the window, and those whose results it keeps
  const int m0 = wg ? 40 : 0, keep0 = wg ? 64 : 0, keep1 = wg ? ROWS : 64;

  // issues the copies of tile tl's x window (clamped to the image) into X;
  // the rows past the window are zero
  auto stage_window = [&](int tl) {
    const int b = tl / tpi, tt = tl - b * tpi, u0 = (tt / tiles_c) * T, v0 = (tt % tiles_c) * T;
    for (int e = tid; e < ROWS * (C / 8); e += NTHREADS) {
      const int w = e / (C / 8), q = e - w * (C / 8);
      bf16* dst = X + cidx(w, q * 8, C);
      if (w < NWIN) {
        const int a = w / WIN, c = w - a * WIN;
        const int u = min(max(u0 - 1 + a, 0), S - 1), v = min(max(v0 - 1 + c, 0), SW - 1);
        fu::cp_async16(dst, p.net + fu::pix(b, u, v, lvl, p.Hc, p.Wc) * C + q * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    fu::cp_async_commit();
  };

  for (int tile = first; tile < total; tile += stride) {
    const int b = tile / tpi, tt = tile - b * tpi, tr = tt / tiles_c, tc = tt - tr * tiles_c;
    const int u0 = tr * T, v0 = tc * T, U0 = 2 * u0, V0 = 2 * v0;
    // window row w -> its level-i pixel (clamped to the image)
    auto win_pix = [&](int w) -> size_t {
      const int a = w / WIN, c = w - a * WIN;
      const int u = min(max(u0 - 1 + a, 0), S - 1), v = min(max(v0 - 1 + c, 0), SW - 1);
      return fu::pix(b, u, v, lvl, p.Hc, p.Wc);
    };
    // window row w of the tile's own 8 x 8 pixels, or -1
    auto own_pix = [&](int w) -> long long {
      const int a = w / WIN, c = w - a * WIN;
      if (w >= NWIN || a < 1 || a > T || c < 1 || c > T) return -1;
      return (long long)fu::pix(b, u0 - 1 + a, v0 - 1 + c, lvl, p.Hc, p.Wc);
    };
    auto out_pix = [&](int n) -> size_t {
      return fu::pix(b, U0 + (n >> 4), V0 + (n & 15), lvl + 1, p.Hc, p.Wc);
    };

    if constexpr (SPLIT)
      hopper::cluster_sync();   // both blocks are done with the last tile (the peer with its h1)
    else
      __syncthreads();   // the last tile is done with x, z, up and the rgb path
    if (tile == first) stage_window(tile);   // a later tile's was issued during the one before
    fu::cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();   // the window is in place, and visible to wgmma

    if constexpr (!BWD) {
      // ---- the rgb path over the output tile (f32, bf16-rounded per op)
      float* RGBW = reinterpret_cast<float*>(smem + Sm::OFF_RGBW);
      float* RP = reinterpret_cast<float*>(smem + Sm::OFF_RP);
      float* BIL = reinterpret_cast<float*>(smem + Sm::OFF_BIL);
      if (lvl == 0) {   // rgb_0 = feat_2_rgb_0(x): a warp a pixel, lanes over channels
        for (int w = tid >> 5; w < NWIN; w += NTHREADS / 32) {
          float s[3] = {0.0f, 0.0f, 0.0f};
          for (int c = lane; c < C; c += 32) {
            const float xv = __bfloat162float(X[cidx(w, c, C)]);
#pragma unroll
            for (int k = 0; k < 3; ++k) s[k] += xv * __bfloat162float(p.wr0[c * 3 + k]);
          }
#pragma unroll
          for (int k = 0; k < 3; ++k) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
            if (lane == 0) RGBW[w * 3 + k] = fu::rd(s[k] + p.br0[k]);
          }
        }
      } else {
        for (int e = tid; e < NWIN * 3; e += NTHREADS)
          RGBW[e] = __bfloat162float(p.rgb[win_pix(e / 3) * 3 + e % 3]);
      }
      __syncthreads();
      // bilinear 2x, rows: RP[lr][wc][k] at fine row U0 - 1 + lr, level-i column v0 - 1 + wc
      for (int e = tid; e < FW * WIN * 3; e += NTHREADS) {
        const int lr = e / (WIN * 3), rem = e - lr * (WIN * 3), wc = rem / 3, k = rem - wc * 3;
        const int U = U0 - 1 + lr;
        if (U < 0 || U >= S2) continue;
        const int f = U >> 1;
        const int nb = (U & 1) ? min(f + 1, S - 1) : max(f - 1, 0);
        RP[e] = fu::bilin(RGBW[((f - u0 + 1) * WIN + wc) * 3 + k],
                          RGBW[((nb - u0 + 1) * WIN + wc) * 3 + k]);
      }
      __syncthreads();
      // bilinear 2x, columns: BIL[lr][lc][k] at fine (U0 - 1 + lr, V0 - 1 + lc)
      for (int e = tid; e < FW * FW * 3; e += NTHREADS) {
        const int lr = e / (FW * 3), rem = e - lr * (FW * 3), lc = rem / 3, k = rem - lc * 3;
        const int U = U0 - 1 + lr, V = V0 - 1 + lc;
        if (U < 0 || U >= S2 || V < 0 || V >= SW2) continue;
        const int gv = V >> 1;
        const int nb = (V & 1) ? min(gv + 1, SW - 1) : max(gv - 1, 0);
        BIL[e] = fu::bilin(RP[(lr * WIN + (gv - v0 + 1)) * 3 + k],
                           RP[(lr * WIN + (nb - v0 + 1)) * 3 + k]);
      }
      __syncthreads();
      // blur (reflect), vertical then horizontal
      for (int e = tid; e < NF * 3; e += NTHREADS) {
        const int n = e / 3, k = e - n * 3;
        const int U = U0 + n / FT, V = V0 + n % FT;
        const int Um = fu::reflect_m1(U), Up = fu::reflect_p1(U, S2);
        auto at = [&](int Uq, int Vq) { return BIL[((Uq - U0 + 1) * FW + (Vq - V0 + 1)) * 3 + k]; };
        auto vb = [&](int Vq) { return fu::blur3(at(Um, Vq), at(U, Vq), at(Up, Vq)); };
        RUP[e] = fu::blur3(vb(fu::reflect_m1(V)), vb(V), vb(fu::reflect_p1(V, SW2)));
      }
      // the first D2 epilogue, which overwrites the temporaries, is past
      // the barrier after D1
    }

    // ---- D1: h1 = lrelu(x W1 + b1) over the window, N1 columns a pass
    const bf16* xa = X + (m0 >> 3) * (C >> 3) * CM;
#pragma unroll 1
    for (int p1 = SPLIT ? crank : 0; p1 < (SPLIT ? crank + 1 : St::NP1); ++p1) {
      float acc[N1 / 2];
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b1 + p1 * N1 + 8 * j + 2 * tq));
        acc[4 * j] = acc[4 * j + 2] = bb.x;
        acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
      }
#pragma unroll 1
      for (int kc = 0; kc < C / KC1; ++kc) {
        const bf16* wt = rg.acquire();
        fence_acc(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC1 / 16; ++ks)
          hopper::wgmma<N1, 1>(acc, desc(xa + ((kc * KC1 + 16 * ks) >> 3) * CM, 128, C * 16),
                               desc(wt + 2 * ks * CM, 128, KC1 * 16));
        hopper::wgmma_commit();
        rg.step();
      }
      rg.finish();
      fence_acc(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 16 * w4 + g + 8 * r;
        if (row < keep0 || row >= keep1) continue;
        const long long op = BWD ? own_pix(row) : -1;
#pragma unroll
        for (int j = 0; j < N1 / 8; ++j) {
          const int col = p1 * N1 + 8 * j + 2 * tq;
          const bf162 h = fu::lrelu2(fu::cvt2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
          *reinterpret_cast<bf162*>(H1 + cidx(row, col, C2)) = h;
          if constexpr (SPLIT)
            hopper::st_cluster_u32(h1_peer + 2 * cidx(row, col, C2),
                                   *reinterpret_cast<const uint32_t*>(&h));
          if (BWD && op >= 0) *reinterpret_cast<bf162*>(p.h1s + (size_t)op * C2 + col) = h;
        }
      }
    }
    fence_async_shared();
    if constexpr (SPLIT) {
      hopper::fence_async_shared_cluster();
      hopper::cluster_sync();   // both halves of h1 are in both blocks
      fence_async_shared();
    } else {
      __syncthreads();   // h1 is complete, and visible to D2's wgmma
    }

    // ---- D2 by channel chunks, shuffled, blurred, into feat_layer
    float accf[2][CN / 2];
#pragma unroll
    for (int j = 0; j < CN / 8; ++j) {
      const float2 bb = SPLIT && crank
                            ? make_float2(0.0f, 0.0f)
                            : __ldg(reinterpret_cast<const float2*>(p.bfv + 8 * j + 2 * tq));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        accf[mt][4 * j] = accf[mt][4 * j + 2] = bb.x;
        accf[mt][4 * j + 1] = accf[mt][4 * j + 3] = bb.y;
      }
    }
    const bf16* ha = H1 + (m0 >> 3) * (C2 >> 3) * CM;
#pragma unroll 1
    for (int j = SPLIT ? crank * (St::NJ / 2) : 0, j1 = SPLIT ? j + St::NJ / 2 : St::NJ; j < j1;
         ++j) {
      float acc2[NZ / 2];
#pragma unroll
      for (int jj = 0; jj < NZ / 8; ++jj) {
        const int l = 8 * jj + 2 * tq, pz = l / KCH, cc = l - pz * KCH;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b2 + pz * C + j * KCH + cc));
        acc2[4 * jj] = acc2[4 * jj + 2] = bb.x;
        acc2[4 * jj + 1] = acc2[4 * jj + 3] = bb.y;
      }
#pragma unroll 1
      for (int s = 0; s < St::NK2; ++s) {
        const bf16* wt = rg.acquire();
        fence_acc(acc2);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC2 / 16; ++ks)
          hopper::wgmma<NZ, 1>(acc2, desc(ha + ((s * KC2 + 16 * ks) >> 3) * CM, 128, C2 * 16),
                               desc(wt + 2 * ks * CM, 128, KC2 * 16));
        hopper::wgmma_commit();
        rg.step();
      }
      rg.finish();
      fence_acc(acc2);
      __syncthreads();   // every warp is past its stencil reads of the last chunk's z
      // z = lrelu(a2) + the tiled identity, from the staged window
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 16 * w4 + g + 8 * r;
        if (row < keep0 || row >= keep1 || row >= NWIN) continue;
        const long long op = BWD ? own_pix(row) : -1;
#pragma unroll
        for (int jj = 0; jj < NZ / 8; ++jj) {
          const int l = 8 * jj + 2 * tq, pz = l / KCH, c = j * KCH + l - pz * KCH;
          const bf162 a2 = fu::cvt2(acc2[4 * jj + 2 * r], acc2[4 * jj + 2 * r + 1]);
          const float2 h = fu::f2(fu::lrelu2(a2));
          const float tx = __bfloat162float(X[cidx(row, (4 * c + pz) & (C - 1), C)]);
          const float ty = __bfloat162float(X[cidx(row, (4 * c + 4 + pz) & (C - 1), C)]);
          *reinterpret_cast<bf162*>(Z + row * LDZ + l) = fu::cvt2(h.x + tx, h.y + ty);
          if (BWD && op >= 0) {
            const float2 a = fu::f2(a2);
            *reinterpret_cast<uint16_t*>(p.sg + (size_t)op * C4 + pz * C + c) =
                (uint16_t)((a.x >= 0.0f ? 1u : 0u) | (a.y >= 0.0f ? 0x100u : 0u));
          }
        }
      }
      __syncthreads();   // z is complete
      // the last read of x in this tile is past: the next tile's window loads
      // under this one's last stencil, feat_layer step and epilogue
      if (j == j1 - 1 && tile + stride < total) stage_window(tile + stride);
      // shuffle + blur of this warpgroup's 128 output pixels (fine rows 8 wg
      // .. 8 wg + 7), 8 channels a step (16-byte loads and stores): the
      // vertical pass over the 18 fine columns of the window into VB, then
      // the horizontal pass into up
      for (int e = t; e < 8 * FW * (KCH / 8); e += 128) {
        const int rc = e / (KCH / 8), c8 = 8 * (e % (KCH / 8));
        const int lr = rc / FW, U = U0 + 8 * wg + lr, V = V0 - 1 + (rc - lr * FW);
        if (V < 0 || V >= SW2) continue;
        auto y = [&](int Uq, float (&o)[8]) {
          const int w = ((Uq >> 1) - u0 + 1) * WIN + ((V >> 1) - v0 + 1);
          unpack8(*reinterpret_cast<const uint4*>(Z + w * LDZ + (((Uq & 1) << 1) | (V & 1)) * KCH + c8), o);
        };
        float a[8], x[8], c[8];
        y(fu::reflect_m1(U), a);
        y(U, x);
        y(fu::reflect_p1(U, S2), c);
        blur8(a, x, c);
        *reinterpret_cast<uint4*>(VB + rc * KCH + c8) = pack8(a);
      }
      hopper::named_barrier(1 + wg, 128);   // the warpgroup's vertical pass is complete
      for (int e = t; e < 128 * (KCH / 8); e += 128) {
        const int nl = e / (KCH / 8), c8 = 8 * (e % (KCH / 8));
        const int lr = nl >> 4, V = V0 + (nl & 15), n = 128 * wg + nl;
        auto vb = [&](int Vq, float (&o)[8]) {
          unpack8(*reinterpret_cast<const uint4*>(VB + (lr * FW + Vq - V0 + 1) * KCH + c8), o);
        };
        float a[8], x[8], c[8];
        vb(fu::reflect_m1(V), a);
        vb(V, x);
        vb(fu::reflect_p1(V, SW2), c);
        blur8(a, x, c);
        const uint4 o = pack8(a);
        *reinterpret_cast<uint4*>(UP + cidx(n, c8, KCH)) = o;
        if constexpr (BWD) *reinterpret_cast<uint4*>(p.ups + out_pix(n) * C + j * KCH + c8) = o;
      }
      fence_async_shared();
      hopper::named_barrier(1 + wg, 128);   // the warpgroup's up rows are complete
      // feat_layer's split-K step: accf += up [its 128 rows, KCH] wf[j KCH .., :]
      {
        const bf16* wt = rg.acquire();
        fence_acc(accf[0]);
        fence_acc(accf[1]);
        hopper::wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int ks = 0; ks < KCH / 16; ++ks)
            hopper::wgmma<CN, 1>(
                accf[mt], desc(UP + ((128 * wg + 64 * mt) >> 3) * (KCH >> 3) * CM + 2 * ks * CM, 128,
                               KCH * 16),
                desc(wt + 2 * ks * CM, 128, KCH * 16));
        hopper::wgmma_commit();
        rg.step();
        rg.finish();
        fence_acc(accf[0]);
        fence_acc(accf[1]);
      }
    }

    if constexpr (SPLIT) {
      // the peer's 128 output pixels' partial sums to the peer, then own +
      // peer for this block's (warpgroup crank's) pixels
      const float4* PS = reinterpret_cast<const float4*>(H1);   // [2][CN / 4][128]
      hopper::cluster_sync();   // both blocks are past D2: h1 is free
      if (wg != crank) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int k = 0; k < CN / 8; ++k)
            hopper::st_cluster_f4(h1_peer + 16 * ((mt * (CN / 8) + k) * 128 + t),
                                  make_float4(accf[mt][4 * k], accf[mt][4 * k + 1],
                                              accf[mt][4 * k + 2], accf[mt][4 * k + 3]));
      }
      hopper::cluster_sync();   // the peer's partial sums have landed
      if (wg == crank) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int k = 0; k < CN / 8; ++k) {
            const float4 v = PS[(mt * (CN / 8) + k) * 128 + t];
            accf[mt][4 * k] += v.x;
            accf[mt][4 * k + 1] += v.y;
            accf[mt][4 * k + 2] += v.z;
            accf[mt][4 * k + 3] += v.w;
          }
      }
    }

    // ---- feat_layer's epilogue
    if constexpr (!BWD) {
      if (SPLIT && wg != crank) continue;   // the peer's pixels
      // net' = lrelu(af); rgb' = the rgb path + rd(net' wr + br)
      float s[2][2][3] = {};
#pragma unroll
      for (int j = 0; j < CN / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        float w0[3], w1[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          w0[k] = __bfloat162float(p.wr[col * 3 + k]);
          w1[k] = __bfloat162float(p.wr[col * 3 + 3 + k]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 128 * wg + 64 * mt + 16 * w4 + g + 8 * r;
            const bf162 ob = fu::lrelu2(fu::cvt2(accf[mt][4 * j + 2 * r], accf[mt][4 * j + 2 * r + 1]));
            *reinterpret_cast<bf162*>(p.net_out + out_pix(n) * CN + col) = ob;
            const float2 o = fu::f2(ob);
#pragma unroll
            for (int k = 0; k < 3; ++k) s[mt][r][k] += o.x * w0[k] + o.y * w1[k];
          }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 128 * wg + 64 * mt + 16 * w4 + g + 8 * r;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float v = s[mt][r][k];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (tq == k)
              p.rgb_out[out_pix(n) * 3 + k] =
                  __float2bfloat16(fu::rd(RUP[n * 3 + k] + fu::rd(v + p.br[k])));
          }
        }
    } else {
      // net' and g_af = slope(af) rd(g_net' + g_rgb' wr^T), to the stash and
      // (g_af) to shared memory as g_up's A operand
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 128 * wg + 64 * mt + 16 * w4 + g + 8 * r;
          const size_t op = out_pix(n);
          float gr[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) gr[k] = __bfloat162float(p.grgb[op * 3 + k]);
#pragma unroll
          for (int j = 0; j < CN / 8; ++j) {
            const int col = 8 * j + 2 * tq;
            const bf162 af = fu::cvt2(accf[mt][4 * j + 2 * r], accf[mt][4 * j + 2 * r + 1]);
            *reinterpret_cast<bf162*>(p.nns + op * CN + col) = fu::lrelu2(af);
            const float2 gn = ld2(p.gnn + op * CN + col);
            float sx = 0.0f, sy = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              sx += gr[k] * __bfloat162float(p.wr[col * 3 + k]);
              sy += gr[k] * __bfloat162float(p.wr[col * 3 + 3 + k]);
            }
            const bf162 ga = fu::slope2(fu::cvt2(gn.x + sx, gn.y + sy), fu::f2(af));
            *reinterpret_cast<bf162*>(p.gafs + op * CN + col) = ga;
            *reinterpret_cast<bf162*>(GAF + cidx(n, col, CN)) = ga;
          }
        }
      fence_async_shared();
      hopper::named_barrier(1 + wg, 128);   // the warpgroup's g_af rows are complete
      // g_up = g_af wf^T over the warpgroup's 128 pixels, GNB columns a pass
#pragma unroll 1
      for (int pg = 0; pg < C / GNB; ++pg) {
        float accg[2][GNB / 2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int k = 0; k < GNB / 2; ++k) accg[mt][k] = 0.0f;
#pragma unroll 1
        for (int s = 0; s < CN / GKC; ++s) {
          const bf16* wt = rg.acquire();
          fence_acc(accg[0]);
          fence_acc(accg[1]);
          hopper::wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            hopper::wgmma<GNB, 0>(
                accg[mt],
                desc(GAF + ((128 * wg + 64 * mt) >> 3) * (CN >> 3) * CM + ((s * GKC) >> 3) * CM, 128,
                     CN * 16),
                desc(wt, 128, GKC * 16));
          hopper::wgmma_commit();
          rg.step();
        }
        rg.finish();
        fence_acc(accg[0]);
        fence_acc(accg[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 128 * wg + 64 * mt + 16 * w4 + g + 8 * r;
            bf16* dst = p.gups + out_pix(n) * C + pg * GNB + 2 * tq;
#pragma unroll
            for (int j = 0; j < GNB / 8; ++j)
              st2(dst + 8 * j, accg[mt][4 * j + 2 * r], accg[mt][4 * j + 2 * r + 1]);
          }
      }
    }
  }
}

// ---- host side

// a launch of `grid` blocks of the tile kernel in clusters of two (the
// attribute array `a` outlives the configuration)
inline cudaLaunchConfig_t pair_config(cudaLaunchAttribute (&a)[1], unsigned grid, int smem,
                                      cudaStream_t s) {
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = 2;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  return cfg;
}

// the blocks of `kernel` resident on the current device at once (pairs:
// its clusters of two), and the shared-memory limit raised, once per device
template <class K>
inline int resident(K kernel, int smem, std::atomic<int> (&fit)[MAX_DEVICES], cudaError_t* err,
                    bool pairs = false) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return -1;
  if (dev >= MAX_DEVICES) {
    *err = cudaErrorInvalidDevice;
    return -1;
  }
  int n = fit[dev].load();
  if (n == 0) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err != cudaSuccess) return -1;
    if (pairs) {
      cudaLaunchAttribute a[1];
      const cudaLaunchConfig_t cfg = pair_config(a, 2, smem, nullptr);
      *err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (*err != cudaSuccess) return -1;
    } else {
      int per_sm = 0, sms = 0;
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
      if (*err != cudaSuccess) return -1;
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (*err != cudaSuccess) return -1;
      n = per_sm * sms;
    }
    if (n <= 0) {
      *err = cudaErrorInvalidConfiguration;
      return -1;
    }
    fit[dev].store(n);
  }
  return n;
}

inline long long tiles_of(int B, int Hc, int Wc, int lvl) {
  return (long long)B * ((Hc << lvl) / T) * ((Wc << lvl) / T);
}

// The launch's shape: the grid's blocks, the blocks resident at once,
// blocks a tile (2: SPLIT pairs). The forward of block 0 (C = 256) takes
// pairs when its tiles are no more than the pairs resident at once, so that
// one wave of pairs covers every tile on twice the SMs; otherwise (and for
// every other block, whose tiles fill the card) a tile a block.
struct TileShape {
  int grid, resident, cluster;
};
template <int C, int CN, bool BWD>
cudaError_t tile_shape(long long tiles, TileShape* sh) {
  using Sm = TileSmem<C, CN, BWD>;
  static std::atomic<int> fit[MAX_DEVICES], fit2[MAX_DEVICES];
  cudaError_t err = cudaSuccess;
  if (tiles <= 0 || tiles > INT_MAX / 2) return cudaErrorInvalidValue;
  if constexpr (!BWD && C == 256) {
    const int pairs = resident(tile_kernel<C, CN, false, true>, Sm::SMEM, fit2, &err, true);
    if (pairs <= 0) return err;
    if (tiles <= pairs) {
      *sh = TileShape{(int)(2 * tiles), 2 * pairs, 2};
      return cudaSuccess;
    }
  }
  const int res = resident(tile_kernel<C, CN, BWD>, Sm::SMEM, fit, &err);
  if (res <= 0) return err;
  *sh = TileShape{(int)(tiles < res ? tiles : res), res, 1};
  return cudaSuccess;
}

template <int C, int CN, bool BWD>
cudaError_t launch_tile(const TileParams& p, cudaStream_t s) {
  using Sm = TileSmem<C, CN, BWD>;
  TileShape sh;
  const cudaError_t err = tile_shape<C, CN, BWD>(tiles_of(p.B, p.Hc, p.Wc, p.lvl), &sh);
  if (err != cudaSuccess) return err;
  if constexpr (!BWD && C == 256) {
    if (sh.cluster == 2) {
      cudaLaunchAttribute a[1];
      const cudaLaunchConfig_t cfg = pair_config(a, (unsigned)sh.grid, Sm::SMEM, s);
      const cudaError_t e = cudaLaunchKernelEx(&cfg, tile_kernel<C, CN, false, true>, p);
      return e != cudaSuccess ? e : cudaGetLastError();
    }
  }
  tile_kernel<C, CN, BWD><<<(unsigned)sh.grid, NTHREADS, Sm::SMEM, s>>>(p);
  return cudaGetLastError();
}

// The design's numbers for reports: out[0..7] = tiles, blocks of the
// grid (persistent), blocks resident at once, chunks a tile, stream bytes,
// shared memory a block, channels a D2 chunk, blocks a tile (cluster size)
template <int C, int CN, bool BWD>
cudaError_t design_tile(int B, int Hc, int Wc, int lvl, long long* out) {
  using St = TileStream<C, CN, BWD>;
  using Sm = TileSmem<C, CN, BWD>;
  const long long tiles = tiles_of(B, Hc, Wc, lvl);
  TileShape sh;
  const cudaError_t err = tile_shape<C, CN, BWD>(tiles, &sh);
  if (err != cudaSuccess) return err;
  const long long v[8] = {tiles,    sh.grid,  sh.resident, St::NCHUNKS,
                          St::BYTES, Sm::SMEM, St::KCH,     sh.cluster};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return cudaSuccess;
}

}  // namespace fut
}  // namespace
