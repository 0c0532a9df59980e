// Fused NeRF point-MLP + alpha composite, forward, for Hopper (sm_90a).
//
// Replaces nerf3dtalker_tpu/ops/pallas/fused_render.py:fused_render_fwd
// (body _fwd_kernel, _mlp_tile, _composite_tile). Per ray it evaluates the
// 8-layer 384-wide point MLP over the ray's 64 samples, the density and rgb
// heads, and the alpha composite, and writes feat [256] f32, bg_alpha and
// depth. It rounds where the TPU kernel rounds: pe is cast to bf16 on entry,
// operands are bf16, products accumulate in f32, biases are added in f32,
// every ReLU output (and r0) is cast to bf16, sigma and rgb stay f32.
//
// Bound: compute. One point costs 1,352,064 MACs (2.70 MFLOP) against the
// 256 B of pe it reads, so at the Reso64 serving shape (B=4, R=4096, 1,048,576
// points, 2.84 TFLOP) the tensor cores, not HBM, set the floor.
//
// Design (a first kernel: simple and right). The TPU kernel keeps all
// ~1.35 M MLP weights (2.7 MB bf16) resident in VMEM; that does not fit in
// an SM's 227 KB of shared memory. Here one block of 8 warps takes one ray
// (64 points) and keeps its [64, 384] activations in shared memory as bf16,
// in two ping-pong buffers. Each layer's weights stream from global memory
// in 32-row chunks through a cp.async double buffer; at 2.7 MB they stay
// resident in the 50 MB L2, and every block re-reads all of them: 2,704,128
// bytes of L2 traffic per block, 44.3 GB per Reso64 launch of 16,384 blocks.
// Products run on the tensor cores through nvcuda::wmma (bf16 x bf16 -> f32,
// 16x16x16); each warp owns a set of 16-column strips of the layer's output.
// The epilogue goes through a 1 KB per-warp f32 scratch tile: bias, ReLU,
// bf16 cast. The density head (one live column) is a warp dot product; the
// composite is a sequential exclusive product over the ray's 64 samples in
// f32; the rgb head's f32 output is reduced against the weights in the last
// layer's epilogue and never reaches device memory. wgmma, TMA and
// persistent blocks are left for later work.

#include <atomic>
#include <climits>
#include <cstdint>

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
constexpr int KC = 32;      // weight rows per staged chunk
constexpr int PAD = 8;      // bf16 row padding against bank conflicts
constexpr int LDA = H + PAD;
constexpr int LDP = PE + PAD;

constexpr int SZ_PE = M * LDP * 2;
constexpr int SZ_ACT = M * LDA * 2;
constexpr int SZ_W = 2 * KC * (H + PAD) * 2;
constexpr int SZ_SCR = NWARPS * 256 * 4;
constexpr int SZ_VEC = 2 * M * 4;
constexpr int OFF_PE = 0;
constexpr int OFF_A = OFF_PE + SZ_PE;
constexpr int OFF_B = OFF_A + SZ_ACT;
constexpr int OFF_W = OFF_B + SZ_ACT;
constexpr int OFF_SCR = OFF_W + SZ_W;
constexpr int OFF_VEC = OFF_SCR + SZ_SCR;
constexpr int SMEM = OFF_VEC + SZ_VEC;  // 168,448 bytes
static_assert(SMEM <= 232448, "shared memory over the per-block limit");
static_assert(OFF_A % 128 == 0 && OFF_B % 128 == 0 && OFF_W % 128 == 0 &&
              OFF_SCR % 128 == 0 && OFF_VEC % 128 == 0, "smem alignment");

enum Epi { RELU_BF16, LINEAR_BF16, WEIGHTED_SUM };

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

// out[M, N] = epi(a1[M, k1] @ w1[k1, N] + a2[M, k2] @ w2[k2, N] + bias).
// a1/a2 are bf16 in shared memory; w1/w2 are bf16 [K, N] row-major in global
// memory, staged KC rows at a time. k2 == 0 means no second operand (only
// the skip layer fea_5 has one). WEIGHTED_SUM writes
// feat_out[n] = sum_p wts[p] * (acc[p, n] + bias[n]) instead of `out`.
// Starts and ends with every warp past a __syncthreads, so consecutive
// layers need no barrier between them.
template <int N, Epi EPI>
__device__ __forceinline__ void layer(
    const bf16* a1, int lda1, int k1, const bf16* __restrict__ w1,
    const bf16* a2, int lda2, int k2, const bf16* __restrict__ w2,
    const float* __restrict__ bias, bf16* out, bf16* wbuf, float* scratch,
    const float* wts, float* __restrict__ feat_out) {
  constexpr int NF = N / 16;
  constexpr int NJ = (NF + NWARPS - 1) / NWARPS;
  constexpr int LDW = N + PAD;
  constexpr int CPR = N / 8;  // 16-byte copies per weight row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NJ];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n1 = k1 / KC;
  const int n = n1 + k2 / KC;
  auto issue = [&](int c) {
    const bf16* src = c < n1 ? w1 + (size_t)c * KC * N : w2 + (size_t)(c - n1) * KC * N;
    bf16* dst = wbuf + (c & 1) * KC * LDW;
    for (int i = threadIdx.x; i < KC * CPR; i += NTHREADS) {
      const int r = i / CPR, q = i - r * CPR;
      cp_async16(dst + r * LDW + q * 8, src + (size_t)r * N + q * 8);
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, wt + kk * LDW + nf * 16, LDW);
#pragma unroll
          for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled by issue(c + 2)
  }

  float* scr = scratch + warp * 256;
  if constexpr (EPI == WEIGHTED_SUM) {
    const int col = lane & 15, half = lane >> 4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nf = warp + j * NWARPS;
      if (nf < NF) {
        const float b = bias[nf * 16 + col];
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int r = half * 8; r < half * 8 + 8; ++r)
            part += wts[i * 16 + r] * (scr[r * 16 + col] + b);
          __syncwarp();
        }
        part += __shfl_xor_sync(0xffffffffu, part, 16);
        if (half == 0) feat_out[nf * 16 + col] = part;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nf = warp + j * NWARPS;
      if (nf < NF) {
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = e >> 4, col = nf * 16 + (e & 15);
            float v = scr[e] + bias[col];
            if (EPI == RELU_BF16) v = fmaxf(v, 0.0f);
            out[(i * 16 + r) * LDA + col] = __float2bfloat16(v);
          }
          __syncwarp();
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) fused_render_fwd_kernel(
    const float* __restrict__ pe, const float* __restrict__ zd,
    const float* __restrict__ zv, const bf16* __restrict__ w0p,
    const bf16* __restrict__ wh, const bf16* __restrict__ w5p,
    const bf16* __restrict__ w5x, const bf16* __restrict__ wd,
    const bf16* __restrict__ wr0, const bf16* __restrict__ wr1,
    const bf16* __restrict__ wr2, const float* __restrict__ b0,
    const float* __restrict__ bh, const float* __restrict__ b5,
    const float* __restrict__ bd, const float* __restrict__ br0,
    const float* __restrict__ br1, const float* __restrict__ br2,
    float* __restrict__ feat, float* __restrict__ bg, float* __restrict__ depth,
    int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pe_s = reinterpret_cast<bf16*>(smem + OFF_PE);
  bf16* xa = reinterpret_cast<bf16*>(smem + OFF_A);
  bf16* xb = reinterpret_cast<bf16*>(smem + OFF_B);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + OFF_W);
  float* scratch = reinterpret_cast<float*>(smem + OFF_SCR);
  float* sig = reinterpret_cast<float*>(smem + OFF_VEC);
  float* wts = sig + M;

  const int ray = blockIdx.x;  // b * R + r
  const int b = ray / R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // pe [64 points, 64] f32 -> bf16 shared tile
  const float4* pe4 = reinterpret_cast<const float4*>(pe + (size_t)ray * M * PE);
  for (int i = tid; i < M * PE / 4; i += NTHREADS) {
    const float4 v = pe4[i];
    const int p = i / (PE / 4), c = (i - p * (PE / 4)) * 4;
    bf16* d = pe_s + p * LDP + c;
    d[0] = __float2bfloat16(v.x);
    d[1] = __float2bfloat16(v.y);
    d[2] = __float2bfloat16(v.z);
    d[3] = __float2bfloat16(v.w);
  }

  const size_t HH = (size_t)H * H;
  layer<H, RELU_BF16>(pe_s, LDP, PE, w0p, nullptr, 0, 0, nullptr, b0 + (size_t)b * H, xa,
                      wbuf, scratch, nullptr, nullptr);                      // fea_0
  layer<H, RELU_BF16>(xa, LDA, H, wh, nullptr, 0, 0, nullptr, bh, xb, wbuf, scratch,
                      nullptr, nullptr);                                     // fea_1
  layer<H, RELU_BF16>(xb, LDA, H, wh + HH, nullptr, 0, 0, nullptr, bh + H, xa, wbuf,
                      scratch, nullptr, nullptr);                            // fea_2
  layer<H, RELU_BF16>(xa, LDA, H, wh + 2 * HH, nullptr, 0, 0, nullptr, bh + 2 * H, xb,
                      wbuf, scratch, nullptr, nullptr);                      // fea_3
  layer<H, RELU_BF16>(xb, LDA, H, wh + 3 * HH, nullptr, 0, 0, nullptr, bh + 3 * H, xa,
                      wbuf, scratch, nullptr, nullptr);                      // fea_4
  layer<H, RELU_BF16>(pe_s, LDP, PE, w5p, xa, LDA, H, w5x, b5 + (size_t)b * H, xb, wbuf,
                      scratch, nullptr, nullptr);                            // fea_5 (skip)
  layer<H, RELU_BF16>(xb, LDA, H, wh + 4 * HH, nullptr, 0, 0, nullptr, bh + 4 * H, xa,
                      wbuf, scratch, nullptr, nullptr);                      // fea_6
  layer<H, RELU_BF16>(xa, LDA, H, wh + 5 * HH, nullptr, 0, 0, nullptr, bh + 5 * H, xb,
                      wbuf, scratch, nullptr, nullptr);                      // fea_7
  __syncthreads();  // x = xb complete before the density head reads it

  // density head: sigma = relu(x @ wd[:, 0] + bd), f32
  for (int p = warp; p < M; p += NWARPS) {
    float s = 0.0f;
    for (int k = lane; k < H; k += 32)
      s += __bfloat162float(xb[p * LDA + k]) * __bfloat162float(wd[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sig[p] = fmaxf(s + bd[0], 0.0f);
  }

  layer<H, LINEAR_BF16>(xb, LDA, H, wr0, nullptr, 0, 0, nullptr, br0, xa, wbuf, scratch,
                        nullptr, nullptr);                                   // rgb_0

  // composite: w_p = alpha_p * prod_{q<p} (1 - alpha_q + 1e-10), f32
  if (tid == 0) {
    const float* zdr = zd + (size_t)ray * M;
    const float* zvr = zv + (size_t)ray * M;
    float trans = 1.0f, acc = 0.0f, dep = 0.0f;
    for (int p = 0; p < M; ++p) {
      const float alpha = 1.0f - expf(-sig[p] * zdr[p]);
      const float w = alpha * trans;
      wts[p] = w;
      acc += w;
      dep += w * zvr[p];
      trans *= 1.0f - alpha + 1e-10f;
    }
    bg[ray] = 1.0f - acc;
    depth[ray] = dep;
  }

  layer<H2, RELU_BF16>(xa, LDA, H, wr1, nullptr, 0, 0, nullptr, br1 + (size_t)b * H2, xb,
                       wbuf, scratch, nullptr, nullptr);                     // rgb_1
  layer<FEAT, WEIGHTED_SUM>(xb, LDA, H2, wr2, nullptr, 0, 0, nullptr, br2, nullptr, wbuf,
                            scratch, wts, feat + (size_t)ray * FEAT);        // rgb_2 + sum
}

}  // namespace

// Launches one block per ray on `stream`, which belongs to the current
// device. Returns the cudaError_t of the launch (0 on success); the caller
// raises on anything else. The shared-memory limit is raised once per device.
extern "C" int fused_render_fwd_launch(
    const float* pe, const float* zd, const float* zv, const bf16* w0p, const bf16* wh,
    const bf16* w5p, const bf16* w5x, const bf16* wd, const bf16* wr0, const bf16* wr1,
    const bf16* wr2, const float* b0, const float* bh, const float* b5, const float* bd,
    const float* br0, const float* br1, const float* br2, float* feat, float* bg,
    float* depth, int B, int R, void* stream) {
  const long long rays = (long long)B * R;
  if (B <= 0 || R <= 0 || rays > INT_MAX) return (int)cudaErrorInvalidValue;
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load()) {
    err = cudaFuncSetAttribute(fused_render_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true);
  }
  fused_render_fwd_kernel<<<(unsigned)rays, NTHREADS, SMEM, (cudaStream_t)stream>>>(
      pe, zd, zv, w0p, wh, w5p, w5x, wd, wr0, wr1, wr2, b0, bh, b5, bd, br0, br1, br2,
      feat, bg, depth, R);
  return (int)cudaGetLastError();
}
