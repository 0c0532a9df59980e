// Shared pieces of the fused upsampler kernels (fused_upsampler_tile.cuh,
// fused_upsampler_bwd.cu): bf16 rounding, the leaky ReLU, the stencils'
// arithmetic, phase-stack addressing and cp.async.
//
// Phase stacks. A level-l image of a batch row is held as 4^l phase planes
// on the coarse Hc x Wc grid, [B, 4^l, Hc, Wc, C] with flat phase
// p = pr * 2^l + pc and fine pixel (U, V) = (hc * 2^l + pr, wc * 2^l + pc).
// The kernels address it as the fine image it is.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fu {

typedef __nv_bfloat16 bf16;

// round to bf16 and back: every value the plain version holds in bf16
__device__ __forceinline__ float rd(float x) { return __bfloat162float(__float2bfloat16(x)); }

// (a + 2x + b) * 0.25 with the bf16 rounding of each op, as PyTorch
// evaluates it on bf16 tensors (2x and the * 0.25 are exact)
__device__ __forceinline__ float blur3(float a, float x, float b) {
  return rd(rd(rd(a + 2.0f * x) + b) * 0.25f);
}

// 0.75 y + 0.25 a with the bf16 rounding of each op (bilinear 2x tap)
__device__ __forceinline__ float bilin(float y, float a) {
  return rd(rd(0.75f * y) + rd(0.25f * a));
}

// The same roundings on pairs, one cvt.rn.bf16x2.f32 for both values (the
// conversions bound the kernels' epilogues and stencils): bf16 pairs and
// their f32 values
typedef __nv_bfloat162 bf162;
__device__ __forceinline__ bf162 cvt2(float x, float y) { return __floats2bfloat162_rn(x, y); }
__device__ __forceinline__ float2 f2(bf162 v) { return __bfloat1622float2(v); }

// per half: v where pre >= 0, else bf16(0.2 v) (the leaky ReLU, or its
// slope applied to a cotangent v by the sign of its pre-activation)
__device__ __forceinline__ bf162 slope2(bf162 v, float2 pre) {
  const float2 f = f2(v);
  const bf162 s = cvt2(0.2f * f.x, 0.2f * f.y);
  return __halves2bfloat162(pre.x >= 0.0f ? __low2bfloat16(v) : __low2bfloat16(s),
                            pre.y >= 0.0f ? __high2bfloat16(v) : __high2bfloat16(s));
}
__device__ __forceinline__ bf162 lrelu2(bf162 v) { return slope2(v, f2(v)); }

// blur3 on a pair
__device__ __forceinline__ float2 blur3x2(float2 a, float2 x, float2 b) {
  float2 t = f2(cvt2(a.x + 2.0f * x.x, a.y + 2.0f * x.y));
  t = f2(cvt2(t.x + b.x, t.y + b.y));
  return f2(cvt2(t.x * 0.25f, t.y * 0.25f));
}

// reflect (blur) and clamp (bilinear) neighbors on a fine axis of size S
__device__ __forceinline__ int reflect_m1(int u) { return u == 0 ? 1 : u - 1; }
__device__ __forceinline__ int reflect_p1(int u, int S) { return u == S - 1 ? S - 2 : u + 1; }

// flat pixel index of fine pixel (U, V) of batch row b in a level-l stack
__device__ __forceinline__ size_t pix(int b, int U, int V, int l, int Hc, int Wc) {
  const int m = (1 << l) - 1;
  const int p = ((U & m) << l) | (V & m);
  return (((size_t)b << (2 * l)) + p) * (size_t)Hc * Wc + (size_t)(U >> l) * Wc + (V >> l);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace fu
