// The weight-gradient product X^T G (bf16 in, f32 out) in four operand
// modes, for Hopper (sm_90a).
//
// Replaces scripts/probe_mosaic_bf16T.py (the pallas_call at :57, kernels
// from mk_kernel :25-47), which asks whether the TPU compiler runs a bf16
// transposed contraction at the matrix unit's bf16 rate when its operands
// are (a) read from the inputs, (b) computed in the kernel, (c) staged
// through on-chip scratch, or (d) widened to f32. The product is the one
// the fused render backward forms for every weight gradient
// (csrc/fused_render_bwd.cu, xtg_kernel). Inputs x [N, K], g [N, H],
// w [K, H], all bf16, row-major; N, K and H multiples of 64.
//
//   mode 0 loaded    out [K, H] = x^T g
//   mode 1 computed  out [H, H] = x'^T g with x' = bf16(relu(x w)); x' never
//                    leaves the registers: the f32 accumulator fragments of
//                    x'^T = relu(w^T x^T) become, rounded to bf16, the A
//                    fragments of the second product
//   mode 2 scratch   the same, with x' and g staged through shared memory
//   mode 3 f32       the same x' (bf16, from the scratch path), and the
//                    product x'^T g in f32 on the CUDA cores
//
// Bound at the probe's shapes (N = 1024, K = H = 384): about 2.5 MB of
// operands and output against 0.30 GFLOP per product (0.60 with x w), so the
// bytes set the floor (~0.7 us at 3.35 TB/s) and one launch is shorter than
// a launch's own overhead.
//
// Design: simple and right. Every product is mma.sync m16n8k16 (bf16 x bf16
// -> f32) with fragments loaded element by element from global memory (the
// 2.5 MB stay in L2) or from shared memory; one block of 4 warps per 64 x 64
// output tile, each warp a 32 x 32 quarter. The computed modes recompute x'
// in every block that needs its columns. No cp.async, ldmatrix, wgmma or
// TMA: the probe measures where the operands come from, not how fast the
// loads can be made.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;       // output tile per block
constexpr int NTHREADS = 128;  // 4 warps, each a 32 x 32 quarter
constexpr int CHUNK = 64;      // rows of N staged per step (scratch, f32)
constexpr int LDS = TILE + 8;  // shared row stride in bf16

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a b for one m16n8k16 tile (A row-major 16x16, B column-major 16x8)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment loaders. A(r, c) and B(r, c) are read through element functors;
// lane = 4 * grp + tig. A holds rows grp and grp + 8, columns 2 tig (+1) and
// 2 tig + 8 (+1); B holds rows 2 tig (+1) and 2 tig + 8 (+1) of column grp.
template <typename F>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], F at, int grp, int tig) {
  const int c = 2 * tig;
  a[0] = pack(at(grp, c), at(grp, c + 1));
  a[1] = pack(at(grp + 8, c), at(grp + 8, c + 1));
  a[2] = pack(at(grp, c + 8), at(grp, c + 9));
  a[3] = pack(at(grp + 8, c + 8), at(grp + 8, c + 9));
}

template <typename F>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], F at, int grp, int tig) {
  const int r = 2 * tig;
  b[0] = pack(at(r, grp), at(r + 1, grp));
  b[1] = pack(at(r + 8, grp), at(r + 9, grp));
}

// the warp's 32 x 32 accumulator to out [rows, ld] at (row0, col0)
__device__ __forceinline__ void store_tile(float* out, int ld, int row0, int col0,
                                           const float (&acc)[2][4][4], int grp, int tig) {
  for (int mi = 0; mi < 2; ++mi)
    for (int ni = 0; ni < 4; ++ni) {
      const int r = row0 + 16 * mi + grp, c = col0 + 8 * ni + 2 * tig;
      out[(long long)r * ld + c] = acc[mi][ni][0];
      out[(long long)r * ld + c + 1] = acc[mi][ni][1];
      out[(long long)(r + 8) * ld + c] = acc[mi][ni][2];
      out[(long long)(r + 8) * ld + c + 1] = acc[mi][ni][3];
    }
}

// mode 0: out [K, H] = x^T g, operands straight from global memory
__global__ void __launch_bounds__(NTHREADS)
xtg_loaded(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
           float* __restrict__ out, int N, int K, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * TILE + 32 * (warp >> 1);   // k
  const int col0 = blockIdx.x * TILE + 32 * (warp & 1);    // h
  float acc[2][4][4] = {};
  for (int n0 = 0; n0 < N; n0 += 16) {
    uint32_t a[2][4], b[4][2];
    for (int mi = 0; mi < 2; ++mi)   // A(k, n) = x[n, k]
      load_a(a[mi], [&](int r, int c) {
        return x[(long long)(n0 + c) * K + row0 + 16 * mi + r];
      }, grp, tig);
    for (int ni = 0; ni < 4; ++ni)   // B(n, h) = g[n, h]
      load_b(b[ni], [&](int r, int c) {
        return g[(long long)(n0 + r) * H + col0 + 8 * ni + c];
      }, grp, tig);
    for (int mi = 0; mi < 2; ++mi)
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[mi], b[ni]);
  }
  store_tile(out, H, row0, col0, acc, grp, tig);
}

// mode 1: out [H, H] = x'^T g; x'^T rows of this warp come from
// relu(w^T x^T) and pass from accumulator to A fragment in registers
__global__ void __launch_bounds__(NTHREADS)
xtg_computed(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
             const uint16_t* __restrict__ w, float* __restrict__ out, int N, int K, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * TILE + 32 * (warp >> 1);   // h1
  const int col0 = blockIdx.x * TILE + 32 * (warp & 1);    // h2
  float acc[2][4][4] = {};
  for (int n0 = 0; n0 < N; n0 += 16) {
    // x'^T [32 h1, 16 n] = w^T [h1, K] x^T [K, n]: 2 m-tiles x 2 n8-tiles
    float xt[2][2][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[2][4], b[2][2];
      for (int mi = 0; mi < 2; ++mi)   // A(h1, k) = w[k, h1]
        load_a(a[mi], [&](int r, int c) {
          return w[(long long)(k0 + c) * H + row0 + 16 * mi + r];
        }, grp, tig);
      for (int ni = 0; ni < 2; ++ni)   // B(k, n) = x[n, k]
        load_b(b[ni], [&](int r, int c) {
          return x[(long long)(n0 + 8 * ni + c) * K + k0 + r];
        }, grp, tig);
      for (int mi = 0; mi < 2; ++mi)
        for (int ni = 0; ni < 2; ++ni) mma(xt[mi][ni], a[mi], b[ni]);
    }
    // accumulator (rows h1, columns n) -> A fragment (rows h1, depth n)
    uint32_t a[2][4];
    for (int mi = 0; mi < 2; ++mi) {
      const float(&c0)[4] = xt[mi][0];
      const float(&c1)[4] = xt[mi][1];
      a[mi][0] = pack(f2bf(fmaxf(c0[0], 0.f)), f2bf(fmaxf(c0[1], 0.f)));
      a[mi][1] = pack(f2bf(fmaxf(c0[2], 0.f)), f2bf(fmaxf(c0[3], 0.f)));
      a[mi][2] = pack(f2bf(fmaxf(c1[0], 0.f)), f2bf(fmaxf(c1[1], 0.f)));
      a[mi][3] = pack(f2bf(fmaxf(c1[2], 0.f)), f2bf(fmaxf(c1[3], 0.f)));
    }
    for (int ni = 0; ni < 4; ++ni) {   // B(n, h2) = g[n, h2]
      uint32_t b[2];
      load_b(b, [&](int r, int c) {
        return g[(long long)(n0 + r) * H + col0 + 8 * ni + c];
      }, grp, tig);
      for (int mi = 0; mi < 2; ++mi) mma(acc[mi][ni], a[mi], b);
    }
  }
  store_tile(out, H, row0, col0, acc, grp, tig);
}

// x' [CHUNK n, TILE h1] = bf16(relu(x[n0:, :] w[:, h1b:])) into shared xs;
// warp w computes rows 16 w .. 16 w + 15
__device__ __forceinline__ void stage_xprime(uint16_t* xs, const uint16_t* __restrict__ x,
                                             const uint16_t* __restrict__ w, int n0,
                                             int h1b, int K, int H, int warp, int grp,
                                             int tig) {
  float c[8][4] = {};
  const int nb = n0 + 16 * warp;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    load_a(a, [&](int r, int cc) { return x[(long long)(nb + r) * K + k0 + cc]; }, grp, tig);
    for (int ni = 0; ni < 8; ++ni) {
      uint32_t b[2];
      load_b(b, [&](int r, int cc) {
        return w[(long long)(k0 + r) * H + h1b + 8 * ni + cc];
      }, grp, tig);
      mma(c[ni], a, b);
    }
  }
  for (int ni = 0; ni < 8; ++ni) {
    const int r = 16 * warp + grp, col = 8 * ni + 2 * tig;
    xs[r * LDS + col] = f2bf(fmaxf(c[ni][0], 0.f));
    xs[r * LDS + col + 1] = f2bf(fmaxf(c[ni][1], 0.f));
    xs[(r + 8) * LDS + col] = f2bf(fmaxf(c[ni][2], 0.f));
    xs[(r + 8) * LDS + col + 1] = f2bf(fmaxf(c[ni][3], 0.f));
  }
}

// g [CHUNK n, TILE h2] into shared gs, two values per thread and step
__device__ __forceinline__ void stage_g(uint16_t* gs, const uint16_t* __restrict__ g, int n0,
                                        int h2b, int H) {
  for (int i = threadIdx.x; i < CHUNK * TILE / 2; i += NTHREADS) {
    const int r = i / (TILE / 2), c = 2 * (i % (TILE / 2));
    const uint32_t v = *reinterpret_cast<const uint32_t*>(g + (long long)(n0 + r) * H + h2b + c);
    *reinterpret_cast<uint32_t*>(gs + r * LDS + c) = v;
  }
}

// modes 2 and 3: x' and g staged through shared memory per chunk of N;
// the product on the tensor cores (mode 2) or in f32 on the CUDA cores
template <bool F32>
__global__ void __launch_bounds__(NTHREADS)
xtg_staged(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
           const uint16_t* __restrict__ w, float* __restrict__ out, int N, int K, int H) {
  __shared__ __align__(16) uint16_t xs[CHUNK * LDS];
  __shared__ __align__(16) uint16_t gs[CHUNK * LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int h1b = blockIdx.y * TILE, h2b = blockIdx.x * TILE;
  const int r0 = 32 * (warp >> 1), c0 = 32 * (warp & 1);   // the warp's quarter
  float acc[2][4][4] = {};
  // f32 mode: thread t owns rows 4 (t / 8) .. +3 and columns 8 (t % 8) .. +7
  const int fr = 4 * (threadIdx.x / 8), fc = 8 * (threadIdx.x % 8);
  float facc[4][8] = {};
  for (int n0 = 0; n0 < N; n0 += CHUNK) {
    stage_xprime(xs, x, w, n0, h1b, K, H, warp, grp, tig);
    stage_g(gs, g, n0, h2b, H);
    __syncthreads();
    if constexpr (F32) {
      for (int n = 0; n < CHUNK; ++n) {
        float xv[4], gv[8];
        for (int i = 0; i < 4; ++i) xv[i] = bf2f(xs[n * LDS + fr + i]);
        for (int j = 0; j < 8; ++j) gv[j] = bf2f(gs[n * LDS + fc + j]);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(xv[i], gv[j], facc[i][j]);
      }
    } else {
      for (int k0 = 0; k0 < CHUNK; k0 += 16) {
        uint32_t a[2][4], b[4][2];
        for (int mi = 0; mi < 2; ++mi)   // A(h1, n) = xs[n, h1]
          load_a(a[mi], [&](int r, int c) { return xs[(k0 + c) * LDS + r0 + 16 * mi + r]; },
                 grp, tig);
        for (int ni = 0; ni < 4; ++ni)   // B(n, h2) = gs[n, h2]
          load_b(b[ni], [&](int r, int c) { return gs[(k0 + r) * LDS + c0 + 8 * ni + c]; },
                 grp, tig);
        for (int mi = 0; mi < 2; ++mi)
          for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[mi], b[ni]);
      }
    }
    __syncthreads();
  }
  if constexpr (F32) {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j)
        out[(long long)(h1b + fr + i) * H + h2b + fc + j] = facc[i][j];
  } else {
    store_tile(out, H, h1b + r0, h2b + c0, acc, grp, tig);
  }
}

}  // namespace

// x [N, K], g [N, H], w [K, H] bf16; out f32 [K, H] (mode 0) or [H, H]
// (modes 1-3). Returns the launch's cudaError_t.
extern "C" int probe_xtg_launch(const void* x, const void* g, const void* w, float* out,
                                int N, int K, int H, int mode, void* stream) {
  if (N <= 0 || K <= 0 || H <= 0 || N % TILE || K % TILE || H % TILE || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* gb = static_cast<const uint16_t*>(g);
  const auto* wb = static_cast<const uint16_t*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H / TILE, (mode == 0 ? K : H) / TILE);
  switch (mode) {
    case 0: xtg_loaded<<<grid, NTHREADS, 0, s>>>(xb, gb, out, N, K, H); break;
    case 1: xtg_computed<<<grid, NTHREADS, 0, s>>>(xb, gb, wb, out, N, K, H); break;
    case 2: xtg_staged<false><<<grid, NTHREADS, 0, s>>>(xb, gb, wb, out, N, K, H); break;
    default: xtg_staged<true><<<grid, NTHREADS, 0, s>>>(xb, gb, wb, out, N, K, H); break;
  }
  return (int)cudaGetLastError();
}
