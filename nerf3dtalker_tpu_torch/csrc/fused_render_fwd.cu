// Fused NeRF point-MLP + alpha composite, forward, for Hopper (sm_90a).
//
// Replaces nerf3dtalker_tpu/ops/pallas/fused_render.py:fused_render_fwd
// (body _fwd_kernel, _mlp_tile, _composite_tile). Per ray it evaluates the
// 8-layer 384-wide point MLP over the ray's 64 samples, the density and rgb
// heads, and the alpha composite, and writes feat [256] f32, bg_alpha and
// depth. It rounds where the TPU kernel rounds: pe is cast to bf16 on entry,
// operands are bf16, products accumulate in f32 (onto the bias, in f32),
// every ReLU output (and r0) is cast to bf16, sigma and rgb stay f32.
//
// Bound: operations. One point costs 1,352,064 MACs (2.70 MFLOP) against the
// 256 B of pe it reads, so at the Reso64 serving shape (B=4, R=4096, 1,048,576
// points, 2.84 TFLOP) the tensor cores, not device memory, set the floor
// (2.87 ms at 989 TFLOP/s). The weights (2.7 MB bf16) do not fit in a
// block's shared memory; they stay in L2 and stream through every block, so
// the bytes each block reads from L2 per point it computes decide whether
// the tensor cores can be fed.
//
// Design:
//   - two rays a block, one warpgroup each: a ray's 64 points are one wgmma
//     M tile (m64n192k16 for the 384- and 192-wide layers, 4 x m64n64k16
//     for rgb_2's 256), A and B read from shared memory through descriptors
//     in the core-matrix layout (hopper.cuh), the f32 accumulators in
//     registers (192 a thread at N = 384), where the products accumulate
//     onto the bias. The epilogue works on the registers (ReLU, bf16 pairs)
//     and writes the layer's output over the input it has consumed: one
//     49,152-byte activation buffer a ray.
//     fea_5 reads pe and x4 as two K ranges of one accumulation;
//   - the whole network's weights are one stream of 118 chunks of 32 rows
//     (2,703,360 bytes), laid out once per call by the wrapper
//     (ops/kernels/fused_render.py:pack_stream) in the order and the
//     core-matrix layout in which the warpgroups read them, so each chunk is
//     one contiguous bulk copy (cp.async.bulk) and no tensor map is needed;
//   - the chunks pass through a ring of STAGES slots with a full and an
//     empty mbarrier each. The producers are thread 0 of each warpgroup,
//     taking every other chunk: a warpgroup of its own would leave the
//     others 168 registers a thread (ptxas held the kernel there with
//     setmaxnreg, and spilled), where they take 255. They walk the stream
//     without regard to layer boundaries, keeping the chunks up to
//     STAGES - 1 ahead in flight: the next one they wait for, the later
//     ones they issue only if their slot is free already. A warpgroup waits on a
//     slot's full barrier, issues the chunk's wgmmas, commits, and waits for
//     the chunk before (wait_group 1), whose slot each of its warps then
//     releases: the products of one chunk run over the next chunk's wait.
//     The chunk loop has no __syncthreads; each warpgroup syncs its own 128
//     threads twice a layer (named barriers) around the in-place epilogue,
//     and the block twice a pair of rays;
//   - persistent blocks: the grid holds as many blocks as fit on the card
//     at once (one an SM), and each walks pairs of rays, so the ring runs on
//     from one pair into the next. The L2 serves the stream once per pair:
//     22.1 GB a Reso64 launch of 16,384 rays, against 44.3 GB for a block
//     per ray. A warpgroup whose ray is absent (B R odd) runs on zeros and
//     stores nothing. (Sharing each chunk between the two blocks of a
//     cluster by multicast halves the L2 reads, but was slower on the H100:
//     the SMs still take in every byte, and the slots of both blocks wait
//     on the slower of them);
//   - the biases (the shared ones once, the batch row's ones every pair)
//     and the density head are read from shared memory;
//   - the density head is reduced from fea_7's epilogue registers, the
//     composite runs on one warp a ray with warp scans (during rgb_0's first
//     chunk), and rgb_2's weighted sum over the samples is reduced from its
//     accumulators; feat, bg_alpha and depth are the only stores.
// Every mbarrier wait is bounded (hopper.cuh: mbar_wait traps after about a
// second), so a layout or phase bug ends the launch with an error, not a
// hang. Every sum is in a fixed order: two launches give the same bits.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

extern __shared__ __align__(128) unsigned char smem[];   // the block's dynamic shared memory

namespace {

using hopper::CM;
using hopper::cidx;
using hopper::desc;
using hopper::fence_acc;
using hopper::fence_async_shared;
using hopper::mbar_wait;
using hopper::smem_addr;

constexpr int H = 384;      // hidden width
constexpr int H2 = 192;     // rgb_1 width
constexpr int PE = 64;      // padded positional encoding width
constexpr int NS = 64;      // samples per ray
constexpr int FEAT = 256;   // feature channels
constexpr int M = NS;       // points per ray: one warpgroup's 64-row wgmma tile
constexpr int RAYS = 2;     // rays per block, one warpgroup each
constexpr int NTHREADS = RAYS * 128;
constexpr int KC = 32;      // weight rows per chunk
constexpr int STAGES = 4;   // ring slots

// The stream, in the order the layers consume it: fea_0 (pe rows), fea_1 ..
// fea_4, fea_5 (pe rows, then x4 rows), fea_6, fea_7, rgb_0, rgb_1, rgb_2.
// Layer l's chunk c is rows [c KC, c KC + KC) of its [K, N] weights, stored
// [N / 8][KC / 8][8][8] (pack_stream).
constexpr int NLAYERS = 11;
__host__ __device__ constexpr int layer_n(int l) { return l < 9 ? H : l == 9 ? H2 : FEAT; }
__host__ __device__ constexpr int layer_chunks(int l) {
  return l == 0 ? PE / KC : l == 5 ? (PE + H) / KC : l == 10 ? H2 / KC : H / KC;
}
constexpr int stream_chunks() {
  int n = 0;
  for (int l = 0; l < NLAYERS; ++l) n += layer_chunks(l);
  return n;
}
constexpr long long stream_bytes() {
  long long n = 0;
  for (int l = 0; l < NLAYERS; ++l) n += (long long)layer_chunks(l) * KC * layer_n(l) * 2;
  return n;
}
constexpr int NCHUNKS = stream_chunks();
static_assert(NCHUNKS == 118 && stream_bytes() == 2703360, "the weight stream");
// chunk q of the stream: the 384-wide layers' chunks come first, then
// rgb_1's, then rgb_2's (a closed form: walking the layers cost the
// producer 450 clocks a chunk on the H100)
constexpr int NC_H = NCHUNKS - H / KC - H2 / KC;   // 100
static_assert(layer_n(8) == H && layer_n(9) == H2 && layer_chunks(9) == H / KC &&
              layer_n(10) == FEAT && layer_chunks(10) == H2 / KC, "the stream's tail");
__device__ __forceinline__ void chunk_at(int q, uint32_t& off, uint32_t& bytes) {
  constexpr uint32_t BH = KC * H * 2, BH2 = KC * H2 * 2, BF = KC * FEAT * 2;
  if (q < NC_H) {
    bytes = BH;
    off = q * BH;
  } else if (q < NC_H + H / KC) {
    bytes = BH2;
    off = NC_H * BH + (q - NC_H) * BH2;
  } else {
    bytes = BF;
    off = NC_H * BH + (H / KC) * BH2 + (q - NC_H - H / KC) * BF;
  }
}

// Shared memory (bytes). Per ray (warpgroup): its activations, written in
// place ([M][<=384] core matrices); its pe tile ([M][PE] core matrices, then,
// once fea_5 has read it, rgb_2's column sums [4 warps][FEAT] f32); sigma,
// the composite weights, z_dists and zvals. Then the ring and its barriers,
// the density head, and the biases: bh, br0, br2, and b0, b5, br1 of the
// batch row of the pair's first ray.
constexpr int SZ_ACT = M * H * 2;        // 49,152
constexpr int SZ_PE = M * PE * 2;        //  8,192
constexpr int SZ_VEC = 4 * M * 4;        //  1,024
constexpr int R_PE = SZ_ACT;
constexpr int R_VEC = R_PE + SZ_PE;
constexpr int SZ_RAY = R_VEC + SZ_VEC;   // 58,368
constexpr int SLOT = KC * H;             // bf16 elements: the widest chunk
constexpr int OFF_W = RAYS * SZ_RAY;     // 116,736
constexpr int OFF_FULL = OFF_W + STAGES * SLOT * 2;
constexpr int OFF_EMPTY = OFF_FULL + STAGES * 8;
constexpr int OFF_WD = OFF_EMPTY + STAGES * 8;
constexpr int OFF_BIAS = OFF_WD + H * 2;
// f32 offsets in the bias area
constexpr int BI_BH = 0, BI_BR0 = BI_BH + 6 * H, BI_BR2 = BI_BR0 + H;
constexpr int BI_ROW = BI_BR2 + FEAT;    // from here per batch row: b0, b5, br1
constexpr int BI_B0 = BI_ROW, BI_B5 = BI_B0 + H, BI_BR1 = BI_B5 + H;
constexpr int NBIAS = BI_BR1 + H2;       // 3,904
constexpr int SMEM = OFF_BIAS + NBIAS * 4;   // 231,488 bytes
static_assert(SMEM <= 232448, "shared memory over the per-block limit");
static_assert(R_PE % 128 == 0 && SZ_RAY % 128 == 0 && OFF_W % 128 == 0 && OFF_FULL % 8 == 0 &&
                  OFF_BIAS % 16 == 0,
              "smem alignment");
static_assert(4 * FEAT * 4 <= SZ_PE, "rgb_2's column sums fit in the pe tile");
static_assert((KC * H2 * 2) % 16 == 0, "bulk copies move multiples of 16 bytes");

// the shared-memory address of slot / barrier s
__device__ __forceinline__ uint32_t slot_addr(int s) { return smem_addr(smem + OFF_W) + s * SLOT * 2; }
__device__ __forceinline__ uint32_t full_bar(int s) { return smem_addr(smem + OFF_FULL) + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(int s) { return smem_addr(smem + OFF_EMPTY) + 8 * s; }

struct Params {
  const float* pe;
  const float* zd;
  const float* zv;
  const bf16* ws;     // the weight stream
  const bf16* wd;     // the density head [H]
  const float* b0;    // [B, H]
  const float* bh;    // [6, H]
  const float* b5;    // [B, H]
  const float* bd;    // [1]
  const float* br0;   // [H]
  const float* br1;   // [B, H2]
  const float* br2;   // [FEAT]
  float* feat;
  float* bg;
  float* depth;
  int R;
  int rays;
};

// One warpgroup: its ray. Its shared memory lies at smem + wg * SZ_RAY.
struct Ray {
  int wg;
  int t;         // thread within the warpgroup
  int ray;       // b * R + r
  bool live;     // false: an absent ray, computed on zeros and not stored
  __device__ __forceinline__ unsigned char* base() const { return smem + wg * SZ_RAY; }
  __device__ __forceinline__ bf16* act() const { return reinterpret_cast<bf16*>(base()); }
  __device__ __forceinline__ bf16* pe() const { return reinterpret_cast<bf16*>(base() + R_PE); }
  __device__ __forceinline__ float* red() const { return reinterpret_cast<float*>(base() + R_PE); }
  __device__ __forceinline__ float* sig() const { return reinterpret_cast<float*>(base() + R_VEC); }
  __device__ __forceinline__ float* wts() const { return sig() + M; }
  __device__ __forceinline__ float* zd() const { return sig() + 2 * M; }
  __device__ __forceinline__ float* zv() const { return sig() + 3 * M; }
  __device__ __forceinline__ void sync() const { hopper::named_barrier(1 + wg, 128); }
};

// The stream's position: chunks consumed by this thread's warpgroup and, for
// the warpgroup's thread 0, the next chunk it issues. `total`: chunks of
// this block's whole walk.
struct Pipe {
  int i;
  int issued;
  int total;
};

// Thread 0 of warpgroup w issues the chunks w, w + RAYS, ... (the two share
// the work: issuing a chunk held the issuing warp ~500 clocks on the H100):
// of pp.issued .. min(upto, total - 1), those up to `must` once their slot
// is free, the later ones only while it is free already. Each chunk goes
// into slot (chunk % STAGES), one bulk copy.
__device__ __forceinline__ void produce(const Params& p, Pipe& pp, int upto, int must) {
  for (; pp.issued <= upto && pp.issued < pp.total; pp.issued += RAYS) {
    const int j = pp.issued, s = j % STAGES;
    const uint32_t parity = ((j / STAGES) & 1) ^ 1;   // the slot's previous use released
    if (j <= must)
      mbar_wait(empty_bar(s), parity);
    else if (!hopper::mbar_test_wait(empty_bar(s), parity))
      break;
    uint32_t off, bytes;
    chunk_at(j % NCHUNKS, off, bytes);
    hopper::mbar_expect_tx(full_bar(s), bytes);
    hopper::bulk_load(slot_addr(s), reinterpret_cast<const unsigned char*>(p.ws) + off, bytes,
                      full_bar(s));
  }
}

// the warp's release of chunk i's slot
__device__ __forceinline__ void release(int i) {
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty_bar(i % STAGES));
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

// Composite, one warp, two samples a lane, f32: w_p = alpha_p T_p with T_p =
// prod_{q<p} (1 - alpha_q + 1e-10) by an exclusive product scan over the
// lanes; bg_alpha = 1 - sum w, depth = sum w zv.
__device__ __forceinline__ void composite(const Params& p, const Ray& ry) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = ry.t & 31, k = 2 * lane;
  const float2 zd2 = *reinterpret_cast<const float2*>(ry.zd() + k);
  const float2 zv2 = *reinterpret_cast<const float2*>(ry.zv() + k);
  const float* sig = ry.sig();
  const float a0 = 1.0f - expf(-sig[k] * zd2.x), a1 = 1.0f - expf(-sig[k + 1] * zd2.y);
  const float t0 = 1.0f - a0 + 1e-10f, t1 = 1.0f - a1 + 1e-10f;
  float incl = t0 * t1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = v * incl;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 1.0f;
  const float w0 = a0 * excl, w1 = a1 * (excl * t0);
  ry.wts()[k] = w0;
  ry.wts()[k + 1] = w1;
  float sum = w0 + w1, dep = w0 * zv2.x + w1 * zv2.y;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, o);
    dep += __shfl_xor_sync(FULL, dep, o);
  }
  if (lane == 0 && ry.live) {
    p.bg[ry.ray] = 1.0f - sum;
    p.depth[ry.ray] = dep;
  }
}

enum Epi { RELU, RELU_DENSITY, LINEAR, WEIGHTED_SUM };

// acc[M, N] = bias + a1[M, n1 KC] @ (the layer's first n1 chunks) + a2[M,
// ...] @ (the rest), n chunks in all, then EPI:
//   RELU / LINEAR: bf16(relu(acc)) / bf16(acc), written over the ray's
//     activations ([M][N] core matrices);
//   RELU_DENSITY: RELU, and sigma = relu(x @ wd + bd) of that output;
//   WEIGHTED_SUM: feat[n] = sum_p wts[p] acc[p, n].
// a1 / a2 are core-matrix operands of widths ka1 / ka2. With `comp`, warp 3
// (which issues no chunks) runs the composite once the first chunk's
// products are issued. Starts and ends with the warpgroup's writes of the
// activations visible to wgmma.
template <int N, Epi EPI>
__device__ __forceinline__ void layer(const Params& p, const Ray& ry, Pipe& pp, const bf16* a1,
                                      int ka1, int n1, const bf16* a2, int ka2, int n,
                                      const float* bias, bool comp) {
  constexpr int SEG = N % 192 == 0 ? 192 : 64;   // wgmma widths: 192 or 64 columns
  constexpr int NSEG = N / SEG;
  static_assert(N % SEG == 0 && N <= H, "layer width");
  const int t = ry.t, w4 = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;

  // acc[s][4 j + 2 r + i]: row 16 w4 + g + 8 r, column s SEG + 8 j + 2 tq + i.
  // The products accumulate onto the bias (f32, from shared memory): with
  // the bias added in the epilogue instead, K1 took 5.5-5.6 ms against
  // 4.7-4.8 at B=4 on the H100
  float acc[NSEG][SEG / 2];
#pragma unroll
  for (int s = 0; s < NSEG; ++s)
#pragma unroll
    for (int j = 0; j < SEG / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + s * SEG + 8 * j + 2 * tq);
      acc[s][4 * j] = bb.x;
      acc[s][4 * j + 1] = bb.y;
      acc[s][4 * j + 2] = bb.x;
      acc[s][4 * j + 3] = bb.y;
    }

  for (int c = 0; c < n; ++c) {
    const int slot = pp.i % STAGES;
    mbar_wait(full_bar(slot), (pp.i / STAGES) & 1);
    const bf16* wt = reinterpret_cast<const bf16*>(smem + OFF_W) + slot * SLOT;
    const bool first = c < n1;
    const bf16* a = first ? a1 : a2;
    const int ka = first ? ka1 : ka2, kb = (first ? c : c - n1) * KC;
#pragma unroll
    for (int s = 0; s < NSEG; ++s) fence_acc(acc[s]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const uint64_t da = desc(a + ((kb + 16 * ks) >> 3) * CM, 128, ka * 16);
#pragma unroll
      for (int s = 0; s < NSEG; ++s) {
        const uint64_t db = desc(wt + ((s * SEG / 8) * (KC / 8) + 2 * ks) * CM, 128, KC * 16);
        if constexpr (SEG == 192)
          hopper::wgmma_n192<1>(acc[s], da, db);
        else
          hopper::wgmma_n64<1>(acc[s], da, db);
      }
    }
    hopper::wgmma_commit();
    if (c > 0) {
      hopper::wgmma_wait<1>();   // chunk i - 1 is done: its slot is free
      release(pp.i - 1);
    }
    if (t == 0) produce(p, pp, pp.i - 1 + STAGES, pp.i + 1);
    if (comp && c == 0 && w4 == 3) composite(p, ry);
    ++pp.i;
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < NSEG; ++s) fence_acc(acc[s]);
  release(pp.i - 1);
  ry.sync();   // every warp's products are done: the input may be overwritten

  if constexpr (EPI == WEIGHTED_SUM) {
    // per column: the thread's two rows weighted, then the 8 rows of the
    // warp (lanes g = 0..7) by shuffles, then the 4 warps through shared memory
    float* red = ry.red();
    const float wa = ry.wts()[16 * w4 + g], wb = ry.wts()[16 * w4 + g + 8];
#pragma unroll
    for (int s = 0; s < NSEG; ++s)
#pragma unroll
      for (int j = 0; j < SEG / 8; ++j) {
        const int col = s * SEG + 8 * j + 2 * tq;
        float v[2] = {wa * acc[s][4 * j] + wb * acc[s][4 * j + 2],
                      wa * acc[s][4 * j + 1] + wb * acc[s][4 * j + 3]};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
        }
        if (g == 0) *reinterpret_cast<float2*>(red + w4 * FEAT + col) = make_float2(v[0], v[1]);
      }
    ry.sync();
    for (int col = t; col < FEAT; col += 128) {
      const float sum = red[col] + red[FEAT + col] + red[2 * FEAT + col] + red[3 * FEAT + col];
      if (ry.live) p.feat[(size_t)ry.ray * FEAT + col] = sum;
    }
  } else {
    bf16* act = ry.act();
    float dens[2] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < NSEG; ++s)
#pragma unroll
      for (int j = 0; j < SEG / 8; ++j) {
        const int col = s * SEG + 8 * j + 2 * tq;
        float2 wdc = make_float2(0.0f, 0.0f);
        if constexpr (EPI == RELU_DENSITY)
          wdc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(smem + OFF_WD + 2 * col));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * w4 + g + 8 * r;
          float v0 = acc[s][4 * j + 2 * r], v1 = acc[s][4 * j + 2 * r + 1];
          if constexpr (EPI != LINEAR) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(act + cidx(row, col, N)) = hv;
          if constexpr (EPI == RELU_DENSITY)
            dens[r] += __low2float(hv) * wdc.x + __high2float(hv) * wdc.y;
        }
      }
    if constexpr (EPI == RELU_DENSITY) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dens[r] += __shfl_xor_sync(0xffffffffu, dens[r], 1);
        dens[r] += __shfl_xor_sync(0xffffffffu, dens[r], 2);
        if (tq == 0) ry.sig()[16 * w4 + g + 8 * r] = fmaxf(dens[r] + p.bd[0], 0.0f);
      }
    }
    fence_async_shared();
    ry.sync();   // the output is complete, and visible to the next layer's wgmma
  }
}

// Persistent blocks walking pairs of rays: see the note at the top.
__global__ void __launch_bounds__(NTHREADS, 1)
    fused_render_fwd_kernel(const __grid_constant__ Params p) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full_bar(s), 1);                   // the producer's expect_tx
      hopper::mbar_init(empty_bar(s), 4 * RAYS);           // every warp of the block
    }
    fence_async_shared();   // the initialised barriers are visible to the bulk copies
  }
  float* const sb = reinterpret_cast<float*>(smem + OFF_BIAS);
  for (int k = threadIdx.x; k < H; k += NTHREADS) {
    reinterpret_cast<bf16*>(smem + OFF_WD)[k] = p.wd[k];
    sb[BI_BR0 + k] = p.br0[k];
  }
  for (int k = threadIdx.x; k < 6 * H; k += NTHREADS) sb[BI_BH + k] = p.bh[k];
  for (int k = threadIdx.x; k < FEAT; k += NTHREADS) sb[BI_BR2 + k] = p.br2[k];
  __syncthreads();   // the barriers, wd and the shared biases are set before any copy or read

  const int pairs = (p.rays + RAYS - 1) / RAYS;
  Ray ry;
  ry.wg = threadIdx.x >> 7;
  ry.t = threadIdx.x & 127;
  Pipe pp;
  pp.i = 0;
  pp.issued = ry.wg;
  pp.total = (blockIdx.x < pairs ? (pairs - blockIdx.x + gridDim.x - 1) / gridDim.x : 0) * NCHUNKS;
  if (ry.t == 0) produce(p, pp, STAGES - 1, STAGES - 1);

  const bf16* act = ry.act();
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    ry.ray = pair * RAYS + ry.wg;
    ry.live = ry.ray < p.rays;
    const int row = pair * RAYS / p.R;   // the batch row of the pair's first ray
    const int b = ry.live ? ry.ray / p.R : row;
    // the last pair's column sums and per-row biases are read (by both
    // warpgroups): the pe tile and the row's biases may be rewritten
    __syncthreads();
    for (int k = threadIdx.x; k < H; k += NTHREADS) {
      sb[BI_B0 + k] = p.b0[(size_t)row * H + k];
      sb[BI_B5 + k] = p.b5[(size_t)row * H + k];
    }
    for (int k = threadIdx.x; k < H2; k += NTHREADS) sb[BI_BR1 + k] = p.br1[(size_t)row * H2 + k];
    // a second ray of another batch row reads its row's biases from L2
    const bool own = b == row;
    const float* b0 = own ? sb + BI_B0 : p.b0 + (size_t)b * H;
    const float* b5 = own ? sb + BI_B5 : p.b5 + (size_t)b * H;
    const float* br1 = own ? sb + BI_BR1 : p.br1 + (size_t)b * H2;
    // pe [64 points, 64] f32 -> bf16 core matrices, 8 values a thread
    for (int i = ry.t; i < M * PE / 8; i += 128) {
      const int pt = i / (PE / 8), c = (i - pt * (PE / 8)) * 8;
      float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (ry.live) {
        const float4* src =
            reinterpret_cast<const float4*>(p.pe + ((size_t)ry.ray * M + pt) * PE + c);
        const float4 u = src[0], v = src[1];
        f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
        f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
      }
      *reinterpret_cast<uint4*>(ry.pe() + cidx(pt, c, PE)) = pack8(f);
    }
    if (ry.t < M) {   // the composite's inputs
      ry.zd()[ry.t] = ry.live ? p.zd[(size_t)ry.ray * M + ry.t] : 0.0f;
      ry.zv()[ry.t] = ry.live ? p.zv[(size_t)ry.ray * M + ry.t] : 0.0f;
    }
    fence_async_shared();
    __syncthreads();   // pe, z and the row's biases are in place

    const bf16* pe = ry.pe();
    const float* bh = sb + BI_BH;
    layer<H, RELU>(p, ry, pp, pe, PE, PE / KC, nullptr, 0, PE / KC, b0, false);        // fea_0
    for (int l = 0; l < 4; ++l)                                                         // fea_1..4
      layer<H, RELU>(p, ry, pp, act, H, H / KC, nullptr, 0, H / KC, bh + l * H, false);
    layer<H, RELU>(p, ry, pp, pe, PE, PE / KC, act, H, (PE + H) / KC, b5, false);      // fea_5
    layer<H, RELU>(p, ry, pp, act, H, H / KC, nullptr, 0, H / KC, bh + 4 * H, false);  // fea_6
    layer<H, RELU_DENSITY>(p, ry, pp, act, H, H / KC, nullptr, 0, H / KC, bh + 5 * H,
                           false);                                                      // fea_7
    layer<H, LINEAR>(p, ry, pp, act, H, H / KC, nullptr, 0, H / KC, sb + BI_BR0, true); // rgb_0
    layer<H2, RELU>(p, ry, pp, act, H, H / KC, nullptr, 0, H / KC, br1, false);         // rgb_1
    layer<FEAT, WEIGHTED_SUM>(p, ry, pp, act, H2, H2 / KC, nullptr, 0, H2 / KC, sb + BI_BR2,
                              false);                                                   // rgb_2
  }
}

// the blocks resident on the device at once (one an SM); per device, found once
int resident_blocks(int dev) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> fit[kMaxDevices];
  int n = fit[dev].load();
  if (n == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_render_fwd_kernel,
                                                      NTHREADS, SMEM) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        per_sm * sms <= 0)
      return -1;
    n = per_sm * sms;
    fit[dev].store(n);
  }
  return n;
}

// raises the kernel's shared-memory limit once per device; the device
int prepare(cudaError_t* err) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return -1;
  if (dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return -1;
  }
  if (!smem_set[dev].load()) {
    *err = cudaFuncSetAttribute(fused_render_fwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (*err != cudaSuccess) return -1;
    smem_set[dev].store(true);
  }
  return dev;
}

}  // namespace

// Launches the kernel on `stream`, which belongs to the current device. `ws`
// is the packed weight stream (ops/kernels/fused_render.py:pack_stream,
// 2,703,360 bytes), `wd` the density head [H] bf16; the biases are f32 (b0,
// b5 [B, H], br1 [B, H2] per batch row). Returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
extern "C" int fused_render_fwd_launch(
    const float* pe, const float* zd, const float* zv, const bf16* ws, const bf16* wd,
    const float* b0, const float* bh, const float* b5, const float* bd, const float* br0,
    const float* br1, const float* br2, float* feat, float* bg, float* depth, int B, int R,
    void* stream) {
  const long long rays = (long long)B * R;
  if (B <= 0 || R <= 0 || rays > INT_MAX - RAYS) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int dev = prepare(&err);
  if (dev < 0) return (int)err;
  const int resident = resident_blocks(dev);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int pairs = (int)((rays + RAYS - 1) / RAYS);
  const Params p{pe, zd, zv, ws, wd, b0, bh, b5, bd, br0, br1, br2, feat, bg, depth, R, (int)rays};
  fused_render_fwd_kernel<<<(unsigned)(pairs < resident ? pairs : resident), NTHREADS, SMEM,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The design's numbers for reports: out[0..6] = rays a block, ring slots,
// rows a chunk, chunks in the stream, bytes in the stream, shared memory a
// block, blocks resident on the current device (the grid's most). Returns
// the cudaError_t.
extern "C" int fused_render_fwd_design(long long* out) {
  cudaError_t err;
  const int dev = prepare(&err);
  if (dev < 0) return (int)err;
  const int resident = resident_blocks(dev);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long v[7] = {RAYS, STAGES, KC, NCHUNKS, stream_bytes(), SMEM, resident};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}
