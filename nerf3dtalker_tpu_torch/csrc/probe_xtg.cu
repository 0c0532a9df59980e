// The weight-gradient product X^T G (bf16 in, f32 out) in four operand
// modes, for Hopper (sm_90a).
//
// Replaces scripts/probe_mosaic_bf16T.py (the pallas_call at :57, kernels
// from mk_kernel :25-47), which asks whether the TPU compiler runs a bf16
// transposed contraction at the matrix unit's bf16 rate when its operands
// are (a) read from the inputs, (b) computed in the kernel, (c) staged
// through on-chip scratch, or (d) widened to f32. The product is the one
// the fused render backward forms for every weight gradient
// (csrc/fused_render_bwd.cu), and both run on the same staged core
// (xtg_core.cuh). Inputs x [N, K], g [N, H], w [K, H], all bf16,
// row-major; N, K and H multiples of 64, N at least 64 * SPLITS, K at most
// KMAX for the modes that form x'.
//
//   mode 0 loaded    out [K, H] = x^T g: the core's ring of cp.async stages
//                    of x and g, ldmatrix.trans into mma.sync
//   mode 1 computed  out [H, H] = x'^T g with x' = bf16(relu(x w)): each
//                    block forms the x' tile of each 64-point stage once
//                    (mma.sync from x rows and the block's w columns, both
//                    staged in shared memory) into the stage's X slot, and
//                    the core's warps read it as they read a loaded X tile
//   mode 2 scratch   the same, with the f32 product x w written to an
//                    explicit f32 shared scratch tile first and rounded to
//                    bf16 in a second pass
//   mode 3 f32       the x' of mode 2, and the product x'^T g in f32 on the
//                    CUDA cores from the same staged tiles
//
// Bound at the probe's shapes (N = 1024, K = H = 384): about 2.5 MB of
// operands and output against 0.30 GFLOP per product (0.60 with x w), so the
// bytes set the floor (~0.7 us at 3.35 TB/s), below a launch's own cost.
// What held the first version back: every fragment was loaded element by
// element from global memory, one block of 4 warps per 64 x 64 tile gave
// 36 blocks, and in `computed` every warp recomputed its own x'. Here the
// operands are staged (16-byte cp.async, ldmatrix), and the point axis is
// split: at N = 1024 the 128 x 128 tiles give only 9 blocks for 132 SMs, so
// each tile's 16 stages of 64 points are cut into SPLITS = 8 splits of two
// stages (72 blocks), and the 8 splits of a tile are one thread block
// cluster: each rank writes its partial tile to its own shared memory, and
// after a cluster barrier each rank adds 16 rows of the 8 tiles, read
// across the cluster in 16-byte loads, in rank order (deterministic, no
// partials in device memory, one launch). Eight is the largest portable
// cluster; 16 (non-portable) measured 15.9 us a call and 4 measured 10.2,
// against 8.1 for 8; pushing each partial into its owner's shared memory
// instead of reading it back measured 9.7 (the card below).
// What bounds it: fixed costs, not its 0.6 us of bytes. Timed from a CUDA
// graph on the H100 80GB HBM3 at 700 W, an empty launch of the same grid
// takes 1.4 us, and the sum over the splits most of the rest (without it
// 4.7 us; cuBLAS computes the same product in 4.2-4.6 us there).
//
// Waits: cp.async.wait_group and the cluster barrier, both hardware waits
// that complete when the copies land and every block of the cluster
// arrives (the blocks of a cluster are resident together); no mbarrier or
// TMA handshake that could spin.

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "xtg_core.cuh"

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

using namespace xtg;

constexpr int SPLITS = 8;      // cluster size along the split axis
constexpr int KMAX = 384;      // contraction of x w in the forming modes
constexpr int LDX = KMAX + 8;  // staged row of x
constexpr int LDO = BN + 4;    // f32 tile row
constexpr int TILE_F32_BYTES = BM * LDO * 4;   // 67,584

// forming modes' shared memory: w columns [KMAX][LDS], x rows [BK][LDX]
// (aliased by the f32 scratch [BK][LDO] of mode 2), the g tile and the x'
// tile [BK][LDS]
constexpr int OFF_W = 0;
constexpr int OFF_X = OFF_W + KMAX * LDS * 2;   // 104,448
constexpr int OFF_G = OFF_X + BK * LDX * 2;     // 154,624
constexpr int OFF_XP = OFF_G + TILE * 2;        // 172,032
constexpr int SMEM_FORMED = OFF_XP + TILE * 2;  // 189,440
constexpr int SMEM_LOADED = RING_BYTES;         // 104,448
static_assert(BK * LDO * 4 <= BK * LDX * 2, "the f32 scratch fits in the x rows");
static_assert(TILE_F32_BYTES <= SMEM_LOADED && TILE_F32_BYTES <= SMEM_FORMED,
              "the partial tile fits in the block's shared memory");
static_assert(BM % SPLITS == 0, "each rank of the cluster adds whole rows");

// The cluster's partial tiles (each block's in its own shared memory, f32
// [BM][LDO] at `tile`) added in rank order; rank r writes rows r * BM /
// SPLITS .. of out [.., ld] at (m0, n0), inside mvalid x nvalid.
__device__ __forceinline__ void cluster_sum(float* tile, float* __restrict__ out, int ld, int m0,
                                            int n0, int mvalid, int nvalid) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's partial tile is written
  constexpr int ROWS = BM / SPLITS;
  const int rank = (int)cluster.block_rank();
  for (int i = threadIdx.x; i < ROWS * BN / 4; i += NTHREADS) {
    const int r = rank * ROWS + i / (BN / 4), c = (i % (BN / 4)) * 4;
    if (r < mvalid && c < nvalid) {
      float4 v[SPLITS];   // every rank's four values in flight at once
#pragma unroll
      for (int q = 0; q < SPLITS; ++q)
        v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, q) + r * LDO + c);
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < SPLITS; ++q) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * ld + n0 + c) = s;
    }
  }
  cluster.sync();   // no block leaves while another reads its tile
}

// the warp's accumulator into the f32 tile
__device__ __forceinline__ void acc_to_tile(const Acc& acc, float* tile, int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + 16 * mi + g, c = wn + 8 * ni + 2 * t;
      *reinterpret_cast<float2*>(tile + r * LDO + c) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * LDO + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// mode 0: out [K, H] = x^T g
__global__ void __cluster_dims__(1, SPLITS, 1) __launch_bounds__(NTHREADS, 1)
xtg_loaded(const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ out, int N,
           int K, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring_base = reinterpret_cast<bf16*>(smem);
  const int tiles_n = (H + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int mvalid = min(BM, K - m0), nvalid = min(BN, H - n0);
  long long first;
  int count;
  split_rows(blockIdx.y, N / BK, SPLITS, first, count);
  const int wm = warp_m(), wn = warp_n();
  const bool active = wm < mvalid && wn < nvalid;
  Acc acc;
  zero(acc);
  ring(
      count,
      [&](int s, int slot) {
        bf16* xs = ring_base + slot * 2 * TILE;
        const size_t p = (size_t)(first + s) * BK;
        stage_tile(xs, x, p, K, m0, mvalid);
        stage_tile(xs + TILE, g, p, H, n0, nvalid);
      },
      [&](int slot) {
        const bf16* xs = ring_base + slot * 2 * TILE;
        if (active) mma_stage(acc, xs, xs + TILE, wm, wn);
      });
  float* tile = reinterpret_cast<float*>(smem);   // the ring is done with
  if (active) acc_to_tile(acc, tile, wm, wn);
  cluster_sum(tile, out, H, m0, n0, mvalid, nvalid);
}

// modes 1-3: out [H, H] = x'^T g with x' = bf16(relu(x w)), tile rows from
// the x' columns m0 .., tile columns from the g columns n0 ..
template <int MODE>
__global__ void __cluster_dims__(1, SPLITS, 1) __launch_bounds__(NTHREADS, 1)
xtg_formed(const bf16* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ w,
           float* __restrict__ out, int N, int K, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem + OFF_W);
  bf16* xc = reinterpret_cast<bf16*>(smem + OFF_X);
  float* scr = reinterpret_cast<float*>(smem + OFF_X);   // mode 2: aliases xc
  bf16* gt = reinterpret_cast<bf16*>(smem + OFF_G);
  bf16* xp = reinterpret_cast<bf16*>(smem + OFF_XP);
  const int tiles_n = (H + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int mvalid = min(BM, H - m0), nvalid = min(BN, H - n0);
  long long first;
  int count;
  split_rows(blockIdx.y, N / BK, SPLITS, first, count);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j8 = lane >> 3, i8 = lane & 7, gq = lane >> 2, tq = lane & 3;
  const int wm = warp_m(), wn = warp_n();
  const bool active = wm < mvalid && wn < nvalid;
  // forming x': warp rows fr .. fr + 15 (points), columns fc .. fc + 63 (x' columns)
  const int fr = (warp & 3) * 16, fc = (warp >> 2) * 64;
  Acc acc;
  zero(acc);
  // mode 3: thread rows mi .. mi + 7 (x' columns), columns ni .. ni + 7 (g columns)
  const int mi = (tid >> 4) * 8, ni = (tid & 15) * 8;
  float facc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) facc[a][b] = 0.0f;

  // w columns m0 .., every row, once
  for (int i = tid; i < K * (BM / 8); i += NTHREADS) {
    const int r = i / (BM / 8), q = i - r * (BM / 8);
    if (q * 8 < mvalid) cp_async16(ws + r * LDS + q * 8, w + (size_t)r * H + m0 + q * 8);
  }
  for (int s = 0; s < count; ++s) {
    const size_t p = (size_t)(first + s) * BK;
    for (int i = tid; i < BK * (K / 8); i += NTHREADS) {
      const int r = i / (K / 8), q = i - r * (K / 8);
      cp_async16(xc + r * LDX + q * 8, x + (p + r) * K + q * 8);
    }
    stage_tile(gt, g, p, H, n0, nvalid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // x' [BK points, BM columns] = x [BK, K] w [K, m0 ..]
    float c[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) c[a][b] = 0.0f;
    const bool forms = fc < mvalid;
    if (forms) {
      for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t a[4];   // matrices (p, k0), (p+8, k0), (p, k0+8), (p+8, k0+8)
        ldsm_x4(a, xc + (fr + i8 + ((j8 & 1) << 3)) * LDX + k0 + ((j8 >> 1) << 3));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t b[4];   // matrices (k0, n), (k0+8, n), (k0, n+8), (k0+8, n+8)
          ldsm_x4_t(b, ws + (k0 + i8 + ((j8 & 1) << 3)) * LDS + fc + 16 * nj + ((j8 >> 1) << 3));
          mma(c[2 * nj], a, b[0], b[1]);
          mma(c[2 * nj + 1], a, b[2], b[3]);
        }
      }
    }
    if constexpr (MODE == 1) {
      if (forms) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = fc + 8 * n8 + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(xp + (fr + gq) * LDS + col) =
              __floats2bfloat162_rn(fmaxf(c[n8][0], 0.0f), fmaxf(c[n8][1], 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(xp + (fr + gq + 8) * LDS + col) =
              __floats2bfloat162_rn(fmaxf(c[n8][2], 0.0f), fmaxf(c[n8][3], 0.0f));
        }
      }
    } else {
      __syncthreads();   // every warp is done with the x rows that scr aliases
      if (forms) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = fc + 8 * n8 + 2 * tq;
          *reinterpret_cast<float2*>(scr + (fr + gq) * LDO + col) = make_float2(c[n8][0], c[n8][1]);
          *reinterpret_cast<float2*>(scr + (fr + gq + 8) * LDO + col) =
              make_float2(c[n8][2], c[n8][3]);
        }
      }
      __syncthreads();
      for (int i = tid; i < BK * BM / 2; i += NTHREADS) {
        const int r = i / (BM / 2), col = 2 * (i - r * (BM / 2));
        const float2 v = *reinterpret_cast<const float2*>(scr + r * LDO + col);
        *reinterpret_cast<__nv_bfloat162*>(xp + r * LDS + col) =
            __floats2bfloat162_rn(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f));
      }
    }
    __syncthreads();   // x' is complete

    if constexpr (MODE == 3) {
      for (int r = 0; r < BK; ++r) {
        const uint4 xu = *reinterpret_cast<const uint4*>(xp + r * LDS + mi);
        const uint4 gu = *reinterpret_cast<const uint4*>(gt + r * LDS + ni);
        const bf16* xv = reinterpret_cast<const bf16*>(&xu);
        const bf16* gv = reinterpret_cast<const bf16*>(&gu);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b)
            facc[a][b] = fmaf(__bfloat162float(xv[a]), __bfloat162float(gv[b]), facc[a][b]);
      }
    } else {
      if (active) mma_stage(acc, xp, gt, wm, wn);
    }
    __syncthreads();   // the next stage overwrites x, g and x'
  }

  float* tile = reinterpret_cast<float*>(smem);
  if constexpr (MODE == 3) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; b += 2)
        *reinterpret_cast<float2*>(tile + (mi + a) * LDO + ni + b) =
            make_float2(facc[a][b], facc[a][b + 1]);
  } else {
    if (active) acc_to_tile(acc, tile, wm, wn);
  }
  cluster_sum(tile, out, H, m0, n0, mvalid, nvalid);
}

}  // namespace

// x [N, K], g [N, H], w [K, H] bf16; out f32 [K, H] (mode 0) or [H, H]
// (modes 1-3). Returns the launch's cudaError_t.
extern "C" int probe_xtg_launch(const void* x, const void* g, const void* w, float* out,
                                int N, int K, int H, int mode, void* stream) {
  if (N <= 0 || K <= 0 || H <= 0 || N % BK || K % 64 || H % 64 || N / BK < SPLITS ||
      mode < 0 || mode > 3 || (mode > 0 && K > KMAX))
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(g);
  const auto* wb = static_cast<const bf16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = mode == 0 ? K : H;
  const dim3 grid(((rows + BM - 1) / BM) * ((H + BN - 1) / BN), SPLITS);
  static std::atomic<bool> set[4][MAX_DEVICES];
  cudaError_t err = cudaSuccess;
  switch (mode) {
    case 0:
      if ((err = allow_smem(xtg_loaded, SMEM_LOADED, set[0])) != cudaSuccess) return (int)err;
      xtg_loaded<<<grid, NTHREADS, SMEM_LOADED, s>>>(xb, gb, out, N, K, H);
      break;
    case 1:
      if ((err = allow_smem(xtg_formed<1>, SMEM_FORMED, set[1])) != cudaSuccess) return (int)err;
      xtg_formed<1><<<grid, NTHREADS, SMEM_FORMED, s>>>(xb, gb, wb, out, N, K, H);
      break;
    case 2:
      if ((err = allow_smem(xtg_formed<2>, SMEM_FORMED, set[2])) != cudaSuccess) return (int)err;
      xtg_formed<2><<<grid, NTHREADS, SMEM_FORMED, s>>>(xb, gb, wb, out, N, K, H);
      break;
    default:
      if ((err = allow_smem(xtg_formed<3>, SMEM_FORMED, set[3])) != cudaSuccess) return (int)err;
      xtg_formed<3><<<grid, NTHREADS, SMEM_FORMED, s>>>(xb, gb, wb, out, N, K, H);
      break;
  }
  return (int)cudaGetLastError();
}
