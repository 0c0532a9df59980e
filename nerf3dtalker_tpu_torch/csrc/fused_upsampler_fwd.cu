// Fused phase-stacked upsampler block, forward, for Hopper (sm_90a).
//
// Replaces nerf3dtalker_tpu/ops/pallas/fused_upsampler.py:_fwd_call (body
// _fwd_kernel, _forward_body -> models/phase_renderer.py:
// phase_block_forward). One PixelShuffleUpsample block of the NeuralRenderer
// decoder plus the rgb pyramid step, level i -> i+1, on phase stacks
// [B, 4^i, Hc, Wc, C] -> [B, 4^(i+1), Hc, Wc, Cn] (bf16).
//
// Bound: operations for blocks 0 and 1, bytes for block 2. A block's
// products are ~6.5 GFLOP per Reso64 image (D1 + D2 on the level-i pixels,
// feat_layer on the level-(i+1) ones) against ~15-40 MB of bf16 in and out.
//
// Design: fused_upsampler_tile.cuh (tile_kernel, forward mode): 8 x 8
// level-i tiles walked by persistent blocks of two warpgroups, every
// product on wgmma with the accumulators starting at the bias and the
// epilogues on the registers, the weights one pre-packed stream
// (ops/kernels/fused_upsampler.py:pack_streams) through an mbarrier
// ring of bulk copies, D2 in channel chunks multiplied straight into
// feat_layer's accumulators, the tiled identity from the staged x window
// and the rgb heads reduced from the registers; block 0 on a grid of fewer
// tiles than the card holds pairs (B = 1) takes a cluster of two blocks a
// tile, each with half of D1 and of D2's channels. It replaces a first kernel
// on nvcuda::wmma (16-channel D2 chunks re-streaming W2 through a cp.async
// double buffer with two barriers a 32-row step, 4.108 ms per Reso64 B=4
// pass on the H100 80GB HBM3 at 700 W).

#include "fused_upsampler_tile.cuh"

namespace {

bool dims_ok(int B, int Hc, int Wc, int level) {
  return B > 0 && Hc > 0 && Wc > 0 && Hc % fut::T == 0 && Wc % fut::T == 0 && level >= 0 &&
         level <= 6;
}

}  // namespace

// Launches the kernel on `stream`, which belongs to the current device. `ws`
// is the block's packed weight stream (pack_streams kind "fwd"), the
// biases f32 (b2 phase-major), wr [Cn, 3] and wr0 [C, 3] bf16. rgb is read
// for level > 0 only; wr0 / br0 for level 0 only. Widths (C, Cn): (256,
// 128), (128, 64), (64, 32); Hc and Wc multiples of 8. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else.
extern "C" int fused_upsampler_fwd_launch(
    const fu::bf16* net, const fu::bf16* rgb, const unsigned char* ws, const float* b1,
    const float* b2, const float* bfv, const fu::bf16* wr, const float* br, const fu::bf16* wr0,
    const float* br0, fu::bf16* net_out, fu::bf16* rgb_out, int B, int Hc, int Wc, int level,
    int C, int Cn, void* stream) {
  if (!dims_ok(B, Hc, Wc, level) || ws == nullptr) return (int)cudaErrorInvalidValue;
  if ((level > 0 && rgb == nullptr) || (level == 0 && (wr0 == nullptr || br0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  fut::TileParams p{};
  p.net = net;
  p.rgb = rgb;
  p.ws = ws;
  p.b1 = b1;
  p.b2 = b2;
  p.bfv = bfv;
  p.wr = wr;
  p.br = br;
  p.wr0 = wr0;
  p.br0 = br0;
  p.net_out = net_out;
  p.rgb_out = rgb_out;
  p.B = B;
  p.Hc = Hc;
  p.Wc = Wc;
  p.lvl = level;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 256 && Cn == 128) return (int)fut::launch_tile<256, 128, false>(p, s);
  if (C == 128 && Cn == 64) return (int)fut::launch_tile<128, 64, false>(p, s);
  if (C == 64 && Cn == 32) return (int)fut::launch_tile<64, 32, false>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The design's numbers at these dims (fut::design_tile): out[0..7] = tiles,
// grid blocks, blocks resident at once, chunks a tile, stream bytes, shared
// memory a block, channels a D2 chunk, blocks a tile (2: a cluster pair).
// Returns the cudaError_t.
extern "C" int fused_upsampler_fwd_design(int B, int Hc, int Wc, int level, int C, int Cn,
                                          long long* out) {
  if (!dims_ok(B, Hc, Wc, level)) return (int)cudaErrorInvalidValue;
  if (C == 256 && Cn == 128) return (int)fut::design_tile<256, 128, false>(B, Hc, Wc, level, out);
  if (C == 128 && Cn == 64) return (int)fut::design_tile<128, 64, false>(B, Hc, Wc, level, out);
  if (C == 64 && Cn == 32) return (int)fut::design_tile<64, 32, false>(B, Hc, Wc, level, out);
  return (int)cudaErrorInvalidValue;
}
