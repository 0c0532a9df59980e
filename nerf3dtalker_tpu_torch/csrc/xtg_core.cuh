// The staged X^T G core (bf16 in, f32 out) shared by the fused render
// backward's weight-gradient pass (fused_render_bwd.cu), the fused
// upsampler backward's (fused_upsampler_bwd.cu) and the x^T g probe
// (probe_xtg.cu), for Hopper (sm_90a).
//
// A job is dW [in, out] = X^T G over the point axis, X [P, in] and G
// [P, out] bf16 row-major, plus optionally db [out] = the column sums of G
// (a bias gradient), or, for a narrow job (out == 1, G [P]), dW [in] =
// X^T g and db = sum g. The point axis is cut into blocks of BK points
// ("rows"); `rows_per_batch` of them make one batch row, and each batch row
// is cut into `splits_per_batch` splits of whole rows that never cross a
// batch row. A job may read G with a row stride of its own (a narrow job's
// g one column of a [P, 3] matrix) and may have `scale` times the launch's
// points (split s of it is `scale` times split s of the launch's rows: the
// fused upsampler's jobs at the finer level), and the reduction may write
// an output with a stride (one column of a [in, 3] gradient). One thread block computes one output tile of one job over one
// split into an f32 partial; `xtg_reduce` then adds the splits' partials in
// split order (all splits, or the batch row's splits for a per-batch
// output). Every sum is f32 in a fixed order: no atomics, the same bits on
// every run.
//
// Block: 8 warps over a BM x BN = 128 x 128 output tile, each warp a 64 x 32
// part; X and G tiles of BK = 64 points are staged through a ring of STAGES
// = 3 cp.async stages (one __syncthreads a stage); fragments are read with
// ldmatrix.trans (X is stored [point][in], so X^T's A fragments are the
// transposed 8x8 matrices; G is [point][out], K-major rows, so its B
// fragments are transposed too) into mma.sync m16n8k16 bf16 -> f32. Rows are
// padded by 16 bytes (272-byte stride), so the 8 rows an ldmatrix reads lie
// on 8 different bank groups. The ring and the bias-combine area take
// 106,496 bytes: two blocks an SM. Tiles at the edge of a job whose in or
// out is 64 mod 128 leave the warps past the edge idle.
//
// Waits: cp.async.wait_group is the only wait; it returns when the block's
// own copies have landed (a faulting copy faults the launch), so there is
// no handshake that could spin. The core uses no mbarrier and no TMA.

#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Internal linkage: each kernel library that includes the core has its own
// copy, and its own once-per-device flags, even when several are loaded
namespace {
namespace xtg {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;            // output tile rows (X columns, "in")
constexpr int BN = 128;            // output tile columns (G columns, "out")
constexpr int BK = 64;             // points per stage
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int NTHREADS = 256;      // 8 warps: 2 (m) x 4 (n), each 64 x 32
constexpr int LDS = BM + 8;        // staged row stride, bf16 (BM == BN)
constexpr int TILE = BK * LDS;     // elements of one staged operand tile
constexpr int RING_BYTES = STAGES * 2 * TILE * 2;   // X and G per stage
constexpr int COMB_FLOATS = 4 * BN;
constexpr int SMEM = RING_BYTES + COMB_FLOATS * 4;  // 106,496 bytes
static_assert(BM == BN, "one tile shape for X and G");
static_assert(2 * SMEM + 2048 <= 233472, "two blocks an SM");
// splits are chosen so that about this many blocks run: 32 blocks an SM of
// the H100's 132, i.e. 16 waves of two blocks an SM, so that blocks of
// unequal cost (edge tiles, bias sums) even out (at the Reso64 training
// shape 5.46 ms, against 5.75 at half the target and 6.4 at a quarter, on
// the H100 80GB HBM3 at 700 W)
constexpr int TARGET_BLOCKS = 4224;
constexpr int MAX_JOBS = 16;
constexpr int MAX_RJOBS = 32;
constexpr int MAX_DEVICES = 64;

// sets `kernel`'s dynamic shared-memory limit to `bytes` once per device
template <class K>
inline cudaError_t allow_smem(K kernel, int bytes, std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev].load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev].store(true);
  }
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices, transposed; lane l gives the row address of row
// l & 7 of matrix l >> 3
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b, m16n8k16, A row-major, B column-major, bf16 -> f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [0, BK) and columns [c0, c0 + width) of src [.., ld], from row p0,
// into a staged tile; width a multiple of 8 and at most BM
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* __restrict__ src, size_t p0,
                                           int ld, int c0, int width) {
  const int chunks = width >> 3;   // 16-byte copies a row
  for (int i = threadIdx.x; i < BK * (BM / 8); i += NTHREADS) {
    const int r = i / (BM / 8), q = i - r * (BM / 8);
    if (q < chunks) cp_async16(tile + r * LDS + q * 8, src + (p0 + r) * (size_t)ld + c0 + q * 8);
  }
}

// The warp's 64 x 32 accumulator: [m16 tile][n8 tile][4]
typedef float Acc[4][4][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
}

// acc += xs^T gs over the BK staged points, for the warp's rows wm .. wm+63
// (columns of xs) and columns wn .. wn+31 (columns of gs)
__device__ __forceinline__ void mma_stage(Acc& acc, const bf16* xs, const bf16* gs, int wm,
                                          int wn) {
  const int lane = threadIdx.x & 31, j = lane >> 3, i = lane & 7;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)   // matrices (k0, m), (k0, m+8), (k0+8, m), (k0+8, m+8)
      ldsm_x4_t(a[mi], xs + (k0 + i + ((j >> 1) << 3)) * LDS + wm + 16 * mi + ((j & 1) << 3));
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)   // matrices (k0, n), (k0+8, n), (k0, n+8), (k0+8, n+8)
      ldsm_x4_t(b[nj], gs + (k0 + i + ((j & 1) << 3)) * LDS + wn + 16 * nj + ((j >> 1) << 3));
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
  }
}

// the warp's accumulator to out [.., ld] at tile origin (row0 + wm, col0 + wn)
__device__ __forceinline__ void store_acc(const Acc& acc, float* __restrict__ out, int ld,
                                          int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const size_t r = (size_t)(row0 + 16 * mi + g), c = col0 + 8 * ni + 2 * t;
      *reinterpret_cast<float2*>(out + r * ld + c) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * ld + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// the warp's place in the 128 x 128 tile
__device__ __forceinline__ int warp_m() { return ((threadIdx.x >> 5) & 1) * 64; }
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 6) * 32; }

// The ring: load(s, slot) issues the cp.async copies of stage s into ring
// slot `slot`; body(slot) consumes them. STAGES - 1 stages are in flight
// while one is consumed; one __syncthreads a stage. Ends with every copy
// landed and every warp past the last body (a __syncthreads).
template <class Load, class Body>
__device__ __forceinline__ void ring(int count, Load load, Body body) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < count; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage s has landed; every warp is past stage s - 1
    if (s + STAGES - 1 < count) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    body(s % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- the jobs of one launch

struct Job {
  const bf16* x;   // [P, in]
  const bf16* g;   // [P, out] ([P] for a narrow job), row stride g_ld
  int in, out;     // out == 1: a narrow job
  int part;        // offset of dW within a split's partials
  int bias_part;   // offset of db within a split's partials, or -1
  int g_ld;        // G's row stride in elements
  int scale;       // points of the job per point of the launch's axis
};

struct Jobs {
  Job job[MAX_JOBS];
  int tile_start[MAX_JOBS + 1];
  int n;
};

__host__ __device__ inline int tiles_of(int in, int out) {
  return ((in + BM - 1) / BM) * (out == 1 ? 1 : (out + BN - 1) / BN);
}

// split y of the point axis -> [first row, row count) of BK points
__device__ __forceinline__ void split_rows(int y, int rows_per_batch, int splits_per_batch,
                                           long long& first, int& count) {
  const int b = y / splits_per_batch, s = y - b * splits_per_batch;
  const long long lo = (long long)rows_per_batch * s / splits_per_batch;
  const long long hi = (long long)rows_per_batch * (s + 1) / splits_per_batch;
  first = (long long)b * rows_per_batch + lo;
  count = (int)(hi - lo);
}

// grid (tiles of every job, splits); partial + blockIdx.y * split_stride is
// this split's partials
__global__ void __launch_bounds__(NTHREADS, 2)
xtg_jobs_kernel(Jobs jobs, float* __restrict__ partial, size_t split_stride, int rows_per_batch,
                int splits_per_batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring_base = reinterpret_cast<bf16*>(smem);
  float* comb = reinterpret_cast<float*>(smem + RING_BYTES);
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.tile_start[j + 1]) ++j;
  const Job jb = jobs.job[j];
  const bool narrow = jb.out == 1;
  const int t = blockIdx.x - jobs.tile_start[j];
  const int tiles_n = narrow ? 1 : (jb.out + BN - 1) / BN;
  const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
  const int mvalid = min(BM, jb.in - m0), nvalid = narrow ? 1 : min(BN, jb.out - n0);
  const bool bias = jb.bias_part >= 0 && m0 == 0;
  long long first;
  int count;
  split_rows(blockIdx.y, rows_per_batch, splits_per_batch, first, count);
  first *= jb.scale;
  count *= jb.scale;
  float* out = partial + blockIdx.y * split_stride;
  const int tid = threadIdx.x;

  auto load = [&](int s, int slot) {
    bf16* xs = ring_base + slot * 2 * TILE;
    const size_t p = (size_t)(first + s) * BK;
    stage_tile(xs, jb.x, p, jb.in, m0, mvalid);
    if (narrow) {
      if (jb.g_ld == 1) {
        if (tid < BK / 8) cp_async16(xs + TILE + tid * 8, jb.g + p + tid * 8);
      } else if (tid < BK) {   // a strided column: plain loads, seen after the ring's barrier
        xs[TILE + tid] = jb.g[(p + tid) * (size_t)jb.g_ld];
      }
    } else {
      stage_tile(xs + TILE, jb.g, p, jb.g_ld, n0, nvalid);
    }
  };

  const int wm = warp_m(), wn = warp_n();
  const bool active = !narrow && wm < mvalid && wn < nvalid;
  Acc acc;
  zero(acc);
  // bias sums: column pair 2 cp of the tile over rows 16 rg .. 16 rg + 15 of
  // each stage. Narrow job: column nc of X times g over rows 32 nh ..
  // 32 nh + 31, and the sum of g over the same rows
  const int cp = tid & 63, rg = tid >> 6, nc = tid & (BM - 1), nh = tid >> 7;
  float s0 = 0.0f, s1 = 0.0f, gs_sum = 0.0f;

  ring(count, load, [&](int slot) {
    const bf16* xs = ring_base + slot * 2 * TILE;
    const bf16* gs = xs + TILE;
    if (narrow) {
      if (nc < mvalid) {
#pragma unroll 8
        for (int r = 32 * nh; r < 32 * nh + 32; ++r) {
          const float gv = __bfloat162float(gs[r]);
          s0 = fmaf(__bfloat162float(xs[r * LDS + nc]), gv, s0);
          gs_sum += gv;
        }
      }
    } else {
      if (active) mma_stage(acc, xs, gs, wm, wn);
      if (bias && 2 * cp < nvalid) {
#pragma unroll
        for (int r = 16 * rg; r < 16 * rg + 16; ++r) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(gs + r * LDS + 2 * cp);
          s0 += __low2float(v);
          s1 += __high2float(v);
        }
      }
    }
  });

  if (narrow) {
    comb[nh * BM + nc] = s0;
    if (nc == 0) comb[2 * BM + nh] = gs_sum;
    __syncthreads();
    if (tid < mvalid) out[jb.part + m0 + tid] = comb[tid] + comb[BM + tid];
    if (bias && tid == 0) out[jb.bias_part] = comb[2 * BM] + comb[2 * BM + 1];
    return;
  }
  if (active) store_acc(acc, out + jb.part, jb.out, m0 + wm, n0 + wn);
  if (bias) {
    comb[rg * BN + 2 * cp] = s0;
    comb[rg * BN + 2 * cp + 1] = s1;
    __syncthreads();
    if (tid < nvalid)
      out[jb.bias_part + n0 + tid] =
          ((comb[tid] + comb[BN + tid]) + comb[2 * BN + tid]) + comb[3 * BN + tid];
  }
}

// ---- the splits' partials added in split order

struct RJob {
  float* out;
  int part, count, per_batch;
  int start;    // first global output index of this job
  int stride;   // of out
};

struct RJobs {
  RJob job[MAX_RJOBS];
  int n, total;
};

__global__ void __launch_bounds__(256)
xtg_reduce(RJobs jobs, const float* __restrict__ partial, size_t split_stride, int splits,
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
  jb.out[(size_t)local * jb.stride] = acc;
}

// ---- host side: a plan of jobs, its scratch size and its launches

inline int splits_per_batch(int tiles, int batches, int rows_per_batch) {
  const long long per = (long long)tiles * batches;
  long long s = (2LL * TARGET_BLOCKS + per) / (2 * per);   // TARGET / per, rounded
  if (s < 1) s = 1;
  if (s > rows_per_batch) s = rows_per_batch;
  return (int)s;
}

struct Plan {
  Jobs jobs{};
  RJobs rjobs{};
  int part = 0;       // f32 values per split so far
  bool ok = true;

  // dW = X^T G (in a multiple of 64 and out of 32, or out == 1 for a
  // narrow job and in a multiple of 8), into dw; db = the column sums of G
  // into db unless null. per_batch_w / per_batch_b: the output is
  // [batches, ...], each batch row's own sum. g_ld: G's row stride (0: out);
  // scale: the job's points per point of the launch's axis; stride: of dw
  // and db (a narrow job's column of an [in, k] gradient).
  void add(const bf16* x, const bf16* g, int in, int out, float* dw, int per_batch_w, float* db,
           int per_batch_b, int batches, int g_ld = 0, int scale = 1, int stride = 1) {
    const bool narrow = out == 1;
    if (jobs.n >= MAX_JOBS || rjobs.n + 2 > MAX_RJOBS || in <= 0 || in % (narrow ? 8 : 64) ||
        (!narrow && (out <= 0 || out % 32)) || scale < 1 || stride < 1 ||
        (g_ld != 0 && g_ld < out) || (!narrow && g_ld % 8)) {
      ok = false;
      return;
    }
    Job& jb = jobs.job[jobs.n];
    jb.x = x;
    jb.g = g;
    jb.in = in;
    jb.out = out;
    jb.g_ld = g_ld != 0 ? g_ld : out;
    jb.scale = scale;
    jb.part = take(dw, in * out, per_batch_w, batches, stride);
    jb.bias_part = db != nullptr ? take(db, out, per_batch_b, batches, stride) : -1;
    jobs.tile_start[jobs.n + 1] = jobs.tile_start[jobs.n] + tiles_of(in, out);
    ++jobs.n;
  }

  // room for one output in each split's partials, at a multiple of 4
  // floats (the tiles are stored as float2)
  int take(float* dst, int count, int per_batch, int batches, int stride = 1) {
    RJob& r = rjobs.job[rjobs.n++];
    r = RJob{dst, part, count, per_batch, rjobs.total, stride};
    rjobs.total += per_batch ? batches * count : count;
    const int at = part;
    part += (count + 3) / 4 * 4;
    return at;
  }

  int tiles() const { return jobs.tile_start[jobs.n]; }
  size_t split_stride() const { return ((size_t)part + 63) / 64 * 64; }
  size_t partial_bytes(int splits) const { return (size_t)splits * split_stride() * sizeof(float); }

  // the core over every job, then the reduction; the point axis is
  // batches x rows_per_batch rows of BK points
  cudaError_t launch(float* partial, int batches, int rows_per_batch, int splits_b,
                     cudaStream_t s) const {
    if (!ok || jobs.n == 0 || batches <= 0 || rows_per_batch <= 0 || splits_b <= 0 ||
        splits_b > rows_per_batch || (long long)batches * splits_b > 65535)
      return cudaErrorInvalidValue;
    static std::atomic<bool> smem_set[MAX_DEVICES];
    cudaError_t err = allow_smem(xtg_jobs_kernel, SMEM, smem_set);
    if (err != cudaSuccess) return err;
    const int splits = batches * splits_b;
    xtg_jobs_kernel<<<dim3(tiles(), splits), NTHREADS, SMEM, s>>>(jobs, partial, split_stride(),
                                                                  rows_per_batch, splits_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    xtg_reduce<<<(rjobs.total + 255) / 256, 256, 0, s>>>(rjobs, partial, split_stride(), splits,
                                                         splits_b);
    return cudaGetLastError();
  }
};

}  // namespace xtg
}  // namespace
