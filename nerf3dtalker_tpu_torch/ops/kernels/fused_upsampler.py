"""Fused phase-stacked upsampler: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd Function that joins them (port of
`nerf3dtalker_tpu/ops/pallas/fused_upsampler.py`).

  phase_block_fwd   one PixelShuffleUpsample block plus the rgb pyramid
                    step, level i -> i+1, `csrc/fused_upsampler_fwd.cu`
                    (the tile kernel of `csrc/fused_upsampler_tile.cuh`);
                    plain version `reference_block_fwd`
  phase_block_bwd   its recompute backward, `csrc/fused_upsampler_bwd.cu`
                    (a recompute pass, a chain pass, the X^T G core's two
                    launches); plain version `reference_block_bwd`
  pack_streams      a block's weights in the order and chunk layout the
                    kernels read them (`tile_stream_chunks`,
                    `chain_stream_chunks`)
  PhaseBlockApply   the differentiable block: forward through the first,
                    backward through the second
  fused_upsampler   the whole decoder, featmap -> image

Tensors at these functions are the JAX package's phase stacks
`[B, P, Hc, Wc, C]` with P = 4^i planes (flat phase pr * 2^i + pc), in
bf16 between blocks when computing in bf16 and in f32 otherwise. Input
and weight gradients are f32. A wrapper launches its kernel on a CUDA
tensor and takes the plain version, with the same arithmetic, on a CPU
tensor. There is no other route: a CUDA tensor the kernel does not take
raises. The kernels choose their own tiles, so there is no strip size to
pass (the TPU kernel's `strip_rows` was its VMEM tuning).

Weight list of block i (`block_weight_list`): w1 [C, 2C], b1, w2pm
[2C, 4C] (phase-major columns), b2pm, wf [C, Cn], bf, wr_{i+1} [Cn, 3],
br_{i+1}, and for i == 0 also wr_0 [C, 3], br_0. The TPU kernel's tile
matrix is not an input: the kernels gather the tiled identity by index.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import torch

from nerf3dtalker_tpu_torch.models import phase_renderer as pr

# (C, Cn) of the blocks the CUDA kernels are compiled for: the decoder of
# config.reso64 and config.reso32 (256 -> 128 -> 64 -> 32)
KERNEL_DIMS = ((256, 128), (128, 64), (64, 32))
TILE = 8   # level-i pixels per tile edge in both kernels: Hc and Wc are multiples of it


def io_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def block_weight_list(pp: Dict[str, torch.Tensor], i: int) -> List[torch.Tensor]:
    """Block i's weights from `extract_phase_params` in the kernels'
    argument order (biases 1-D)."""
    return [pp[k] for k in pr.block_param_names(i)]


def _bp(wl: List[torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return dict(zip(pr.block_param_names(i), wl))


def _levels(x: torch.Tensor) -> int:
    P = x.shape[1]
    L = round(P ** 0.5)
    if L * L != P or L & (L - 1):
        raise ValueError(f"{P} phase planes is not 4^i")
    return L


def reference_block_fwd(net, rgb, wl, i: int, compute_dtype=torch.float32):
    """Plain version of the forward kernel: `phase_block_forward` over the
    batch. net [B, P, Hc, Wc, C], rgb [B, P, Hc, Wc, 3] (ignored, may be
    None, for i == 0) -> (net_next [B, 4P, Hc, Wc, Cn], rgb_next
    [B, 4P, Hc, Wc, 3]) in the io dtype."""
    B, P, Hc, Wc, C = net.shape
    L = _levels(net)
    n = net.reshape(B, L, L, Hc, Wc, C)
    r = n.new_zeros(n.shape[:-1] + (3,)) if rgb is None else rgb.reshape(B, L, L, Hc, Wc, 3)
    nn_, rn = pr.phase_block_forward(n, r, _bp(wl, i), i, compute_dtype)
    iodt = io_dtype(compute_dtype)
    return (nn_.reshape(B, 4 * P, Hc, Wc, -1).to(iodt),
            rn.reshape(B, 4 * P, Hc, Wc, 3).to(iodt))


def reference_block_bwd(net, rgb, wl, i: int, g_net_next, g_rgb_next,
                        compute_dtype=torch.float32):
    """Plain version of the backward kernel: the VJP of the plain forward
    (`phase_renderer.phase_block_backward`). Returns (g_net, g_rgb, weight
    gradients in `wl` order), f32; g_rgb is zeros for i == 0."""
    B, P, Hc, Wc, C = net.shape
    L = _levels(net)
    n = net.reshape(B, L, L, Hc, Wc, C)
    r = n.new_zeros(n.shape[:-1] + (3,)) if rgb is None else rgb.reshape(B, L, L, Hc, Wc, 3)
    gn = g_net_next.reshape(B, 2 * L, 2 * L, Hc, Wc, -1)
    gr = g_rgb_next.reshape(B, 2 * L, 2 * L, Hc, Wc, 3)
    bp = _bp(wl, i)
    g_net, g_rgb, gw = pr.phase_block_backward(n, r, bp, i, gn, gr, compute_dtype)
    return (g_net.reshape(net.shape), g_rgb.reshape(B, P, Hc, Wc, 3),
            [gw[k] for k in bp])


# --------------------------------------------------------------- kernels


def _check(name, t, shape, dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_dims(C: int, Cn: int, Hc: int, Wc: int) -> None:
    """The CUDA kernels' gate: raises at widths they are not compiled for,
    or at a grid that is not a whole number of tiles."""
    if (C, Cn) not in KERNEL_DIMS:
        raise ValueError(f"the fused upsampler kernels are compiled for (C, Cn) in "
                         f"{KERNEL_DIMS}; this block has ({C}, {Cn})")
    if Hc % TILE or Wc % TILE:
        raise ValueError(f"the fused upsampler kernels take a featmap grid that is a "
                         f"multiple of {TILE}; got {Hc}x{Wc}")


@functools.lru_cache(maxsize=None)
def _weight_specs(i: int, C: int, Cn: int):
    """(shape, dtype) of each of block i's kernel weights."""
    shapes = [(C, 2 * C), (2 * C,), (2 * C, 4 * C), (4 * C,), (C, Cn), (Cn,), (Cn, 3), (3,)]
    if i == 0:
        shapes += [(C, 3), (3,)]
    return tuple((torch.Size(s), torch.bfloat16 if len(s) == 2 else torch.float32) for s in shapes)


def _kernel_weights(wl, i, C, Cn, dev):
    """Cast the weight list to the kernels' types (bf16 kernels, f32
    biases) and check their shapes (the wrappers' host time per call is
    part of every kernel time the smoke takes, so the common case, weights
    already of the kernels' types, costs a few attribute reads)."""
    specs = _weight_specs(i, C, Cn)
    if len(wl) != len(specs):
        raise ValueError(f"block {i} takes {len(specs)} weights, got {len(wl)}")
    out = []
    for k, (w, (shape, dtype)) in enumerate(zip(wl, specs)):
        if w.dtype != dtype:
            w = w.to(dtype)
        if not w.is_contiguous():
            w = w.contiguous()
        if w.device != dev or w.shape != shape or w.data_ptr() % 16:
            if w.device != dev:
                raise ValueError(f"weight {k} is on {w.device}, net on {dev}")
            _check(f"weight {k}", w, shape, dtype)
        out.append(w)
    if i != 0:
        out += [None, None]
    return out


# ---------------------------------------------------- the weight streams
#
# The kernels read a block's weights as pre-packed streams of chunks, each
# one bulk copy into their shared memory and a wgmma B operand as it lands:
# a chunk B [k, n] (k the contraction) is stored as 8 x 8 core matrices
# [n / 8][k / 8][8][8], N-major (a core matrix's rows are k, its columns n;
# the kernel reads it with TB = 1) or K-major (rows n, columns k; TB = 0).
# Chunk sizes per block widths are those of `csrc/fused_upsampler_tile.cuh`
# (TileCfg) and `csrc/fused_upsampler_bwd.cu` (ChainStream); the card tests
# hold each stream's chunks and bytes here against the kernels' design
# queries (`fwd_design`, `bwd_design`).

# (C, Cn) -> D1's pass width and chunk rows, D2's channels a chunk and
# chunk rows, g_up's pass width (the backward's recompute pass)
TILE_CFG = {
    (256, 128): dict(N1=256, KC1=16, KCH=16, KC2=64, GNB=128),
    (128, 64): dict(N1=256, KC1=16, KCH=32, KC2=32, GNB=128),
    (64, 32): dict(N1=128, KC1=32, KCH=16, KC2=64, GNB=64),
}
GKC = 16        # contraction rows of a g_up chunk
CHAIN_KCH = 16  # channels a chunk of the backward's chain pass


def _core_n_major(b: torch.Tensor) -> torch.Tensor:
    k, n = b.shape
    return b.reshape(k // 8, 8, n // 8, 8).permute(2, 0, 1, 3).reshape(-1)


def _core_k_major(b: torch.Tensor) -> torch.Tensor:
    k, n = b.shape
    return b.t().reshape(n // 8, 8, k // 8, 8).permute(0, 2, 1, 3).reshape(-1)


def _w2_cols(C: int, c0: int, kch: int) -> List[int]:
    """D2's columns {p C + c0 + cc} of a channel chunk, in the order p KCH + cc."""
    return [p * C + c0 + cc for p in range(4) for cc in range(kch)]


def tile_stream_chunks(C: int, Cn: int, bwd: bool):
    """The tile kernel's stream, chunk by chunk in order: (name, major,
    B [k, n] as a function of (w1, w2pm, wf)). Forward: W1 by passes of
    N1 columns in KC1-row chunks; per channel chunk j, W2's chunks over
    its columns and wf's rows [j KCH, j KCH + KCH). Backward (the
    recompute pass) adds wf^T for g_up = g_af wf^T, per pass of GNB
    columns, GKC rows of the contraction a chunk."""
    cfg = TILE_CFG[(C, Cn)]
    N1, KC1, KCH, KC2, GNB = (cfg[k] for k in ("N1", "KC1", "KCH", "KC2", "GNB"))
    out = []
    for p1 in range(2 * C // N1):
        for kc in range(C // KC1):
            out.append((f"w1[{kc * KC1}:, {p1 * N1}:]", "n",
                        lambda w1, w2, wf, kc=kc, p1=p1:
                        w1[kc * KC1:(kc + 1) * KC1, p1 * N1:(p1 + 1) * N1]))
    for j in range(C // KCH):
        cols = _w2_cols(C, j * KCH, KCH)
        for s in range(2 * C // KC2):
            out.append((f"w2[{s * KC2}:, chunk {j}]", "n",
                        lambda w1, w2, wf, s=s, cols=cols: w2[s * KC2:(s + 1) * KC2][:, cols]))
        out.append((f"wf[{j * KCH}:]", "n", lambda w1, w2, wf, j=j: wf[j * KCH:(j + 1) * KCH]))
    if bwd:
        for pg in range(C // GNB):
            for s in range(Cn // GKC):
                out.append((f"wf^T[{s * GKC}:, {pg * GNB}:]", "k",
                            lambda w1, w2, wf, s=s, pg=pg:
                            wf[pg * GNB:(pg + 1) * GNB, s * GKC:(s + 1) * GKC].t()))
    return out


def chain_stream_chunks(C: int):
    """The backward chain pass's stream, chunk by chunk in order (as
    `tile_stream_chunks`): per channel chunk ch (c0 = (ch // 4) CHAIN_KCH +
    (ch % 4) C / 4, so that the four chunks whose tiled-identity transposes
    add into the same channels come one after another), per phase p, w2^T
    over the lanes p C + c0 .. + CHAIN_KCH; then w1^T, 16 columns of w1 a
    chunk. Every chunk is K-major."""
    out = []
    for ch in range(C // CHAIN_KCH):
        c0 = (ch // 4) * CHAIN_KCH + (ch % 4) * (C // 4)
        for p in range(4):
            q0 = p * C + c0
            out.append((f"w2^T[{q0}:]", "k",
                        lambda w1, w2, wf, q0=q0: w2[:, q0:q0 + CHAIN_KCH].t()))
    for r in range(2 * C // 16):
        out.append((f"w1^T[{16 * r}:]", "k", lambda w1, w2, wf, r=r: w1[:, 16 * r:16 * r + 16].t()))
    return out


def stream_layout(chunks, C: int, Cn: int):
    """(name, major, k, n, offset in elements) of each chunk of a stream."""
    shapes = (C, 2 * C), (2 * C, 4 * C), (C, Cn)
    dummy = [torch.empty(s, dtype=torch.int8, device="meta") for s in shapes]
    out, off = [], 0
    for name, major, fn in chunks:
        k, n = fn(*dummy).shape
        out.append((name, major, k, n, off))
        off += k * n
    return out


def _pack(chunks, w1, w2, wf) -> torch.Tensor:
    return torch.cat([(_core_n_major if major == "n" else _core_k_major)(fn(w1, w2, wf))
                      for _, major, fn in chunks])


@functools.lru_cache(maxsize=None)
def _stream_index(kinds: tuple, C: int, Cn: int, device: torch.device):
    """(index of each element of the streams `kinds`, one after another, in
    cat(w1, w2pm, wf) flattened; each stream's length)."""
    sizes = (C * 2 * C, 2 * C * 4 * C, C * Cn)
    flat = torch.arange(sum(sizes), dtype=torch.int64)
    w1, w2, wf = (t.reshape(s) for t, s in zip(flat.split(sizes),
                                                ((C, 2 * C), (2 * C, 4 * C), (C, Cn))))
    parts = [_pack(chain_stream_chunks(C) if kind == "chain"
                   else tile_stream_chunks(C, Cn, kind == "rec"), w1, w2, wf) for kind in kinds]
    return torch.cat(parts).to(device), [t.numel() for t in parts]


def pack_streams(kinds: tuple, w1, w2pm, wf) -> List[torch.Tensor]:
    """Block weights as the kernels read them, flat, in their dtype: for
    each kind, "fwd" (K5-fwd's tile stream), "rec" (K5-bwd's recompute
    pass) or "chain" (its chain pass). One gather through a cached index
    for all of them."""
    C, Cn = wf.shape
    idx, lens = _stream_index(kinds, C, Cn, w1.device)
    flat = torch.index_select(torch.cat([w1.reshape(-1), w2pm.reshape(-1), wf.reshape(-1)]), 0, idx)
    return flat.split(lens)


# --------------------------------------------------------------- kernels

_c_fns: Dict[str, object] = {}


def _c_fn(lib_name: str, sym: str, argtypes, restype=ctypes.c_int):
    """C function `sym` of kernel library `lib_name`, built, loaded and
    bound at its first use."""
    fn = _c_fns.get(sym)
    if fn is None:
        from nerf3dtalker_tpu_torch.ops.kernels import build

        fn = getattr(build.load(lib_name), sym)
        fn.argtypes = argtypes
        fn.restype = restype
        _c_fns[sym] = fn
    return fn


# every pointer as c_void_p: left undeclared, ctypes passes a Python int as
# a 32-bit C int and cuts the pointer
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_P] * 12 + [_I] * 6 + [_P]        # ..., B, Hc, Wc, level, C, Cn, stream
# ..., scratch bytes, B, Hc, Wc, level, C, Cn, stream
_BWD_ARGS = [_P] * 23 + [_LL] + [_I] * 6 + [_P]
_SCRATCH_ARGS = [_I] * 6
_DESIGN_ARGS = [_I] * 6 + [_P]
_FWD_DESIGN_KEYS = ("tiles", "grid_blocks", "resident_blocks", "chunks_per_tile", "stream_bytes",
                    "smem_bytes", "d2_channels_per_chunk", "cluster_size")
_BWD_DESIGN_KEYS = ("tiles", "recompute_grid_blocks", "chain_grid_blocks",
                    "recompute_chunks_per_tile", "chain_chunks_per_tile", "recompute_stream_bytes",
                    "chain_stream_bytes", "xtg_splits", "xtg_blocks")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _design(lib: str, keys, B: int, Hc: int, Wc: int, i: int, C: int, Cn: int, device=None):
    out = (ctypes.c_longlong * len(keys))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = _c_fn(lib, f"{lib}_design", _DESIGN_ARGS)(B, Hc, Wc, i, C, Cn, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{lib}_design failed: cudaError_t {err}")
    return dict(zip(keys, out))


def fwd_design(B: int, Hc: int, Wc: int, i: int, C: int, Cn: int, device=None) -> Dict[str, int]:
    """K5-fwd's design as compiled, at these dims: tiles, the persistent
    grid's blocks, blocks resident at once, stream chunks a tile, stream
    bytes, shared memory a block, channels a D2 chunk, blocks a tile (2:
    block 0 at fewer tiles than the card holds cluster pairs)."""
    return _design("fused_upsampler_fwd", _FWD_DESIGN_KEYS, B, Hc, Wc, i, C, Cn, device)


def bwd_design(B: int, Hc: int, Wc: int, i: int, C: int, Cn: int, device=None) -> Dict[str, int]:
    """K5-bwd's design as compiled, at these dims: tiles, the recompute and
    chain passes' grid blocks, stream chunks a tile and stream bytes, the
    X^T G core's splits and blocks."""
    return _design("fused_upsampler_bwd", _BWD_DESIGN_KEYS, B, Hc, Wc, i, C, Cn, device)


def phase_block_fwd(net: torch.Tensor, rgb: Optional[torch.Tensor], wl: List[torch.Tensor],
                    i: int, compute_dtype: torch.dtype = torch.bfloat16):
    """Block i forward: (net_next [B, 4P, Hc, Wc, Cn], rgb_next
    [B, 4P, Hc, Wc, 3]). A CPU tensor runs `reference_block_fwd`; a CUDA
    tensor launches the kernel (bf16 operands and activations, f32 sums),
    on the current stream, with the weights packed into its stream."""
    if net.device.type == "cpu":
        return reference_block_fwd(net, rgb, wl, i, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16")
    B, P, Hc, Wc, C = net.shape
    L = _levels(net)
    if L != 1 << i:
        raise ValueError(f"block {i} takes {4 ** i} phase planes, got {P}")
    Cn = wl[4].shape[1]
    check_dims(C, Cn, Hc, Wc)
    _check("net", net, (B, P, Hc, Wc, C), torch.bfloat16)
    if i > 0:
        _check("rgb", rgb, (B, P, Hc, Wc, 3), torch.bfloat16)
    w = _kernel_weights(wl, i, C, Cn, net.device)
    ws, = pack_streams(("fwd",), w[0], w[2], w[4])
    net_out = torch.empty((B, 4 * P, Hc, Wc, Cn), dtype=torch.bfloat16, device=net.device)
    rgb_out = torch.empty((B, 4 * P, Hc, Wc, 3), dtype=torch.bfloat16, device=net.device)
    ptrs = [net.data_ptr(), _ptr(rgb if i > 0 else None), ws.data_ptr()]
    ptrs += [_ptr(t) for t in (w[1], w[3], w[5], w[6], w[7], w[8], w[9])]
    ptrs += [net_out.data_ptr(), rgb_out.data_ptr()]
    with torch.cuda.device(net.device):   # the launch goes to the current device
        err = _c_fn("fused_upsampler_fwd", "fused_upsampler_fwd_launch", _FWD_ARGS)(
            *ptrs, B, Hc, Wc, i, C, Cn, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_upsampler_fwd kernel launch failed: cudaError_t {err}")
    phase_block_fwd.launches += 1
    return net_out, rgb_out


phase_block_fwd.launches = 0


def scratch_bytes(B: int, Hc: int, Wc: int, i: int, C: int, Cn: int) -> int:
    """Bytes of device scratch one backward launch of block i needs (its
    bf16 stash of activations and gradient activations, the signs of a2
    and the X^T G core's f32 partial sums), as the kernel library computes
    it."""
    fn = _c_fn("fused_upsampler_bwd", "fused_upsampler_bwd_scratch_bytes", _SCRATCH_ARGS,
               ctypes.c_longlong)
    return int(fn(B, Hc, Wc, i, C, Cn))


def phase_block_bwd(net: torch.Tensor, rgb: Optional[torch.Tensor], wl: List[torch.Tensor],
                    i: int, g_net_next: torch.Tensor, g_rgb_next: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """Backward of block i for the cotangents of its two outputs: (g_net,
    g_rgb, weight gradients in `wl` order), f32, as `reference_block_bwd`.
    A CPU tensor runs `reference_block_bwd`; a CUDA tensor launches the
    kernels on the current stream with a fresh device scratch."""
    if net.device.type == "cpu":
        return reference_block_bwd(net, rgb, wl, i, g_net_next, g_rgb_next, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16")
    B, P, Hc, Wc, C = net.shape
    L = _levels(net)
    if L != 1 << i:
        raise ValueError(f"block {i} takes {4 ** i} phase planes, got {P}")
    Cn = wl[4].shape[1]
    check_dims(C, Cn, Hc, Wc)
    dev = net.device
    _check("net", net, (B, P, Hc, Wc, C), torch.bfloat16)
    if i > 0:
        _check("rgb", rgb, (B, P, Hc, Wc, 3), torch.bfloat16)
    _check("g_net_next", g_net_next, (B, 4 * P, Hc, Wc, Cn), torch.bfloat16)
    _check("g_rgb_next", g_rgb_next, (B, 4 * P, Hc, Wc, 3), torch.bfloat16)
    w = _kernel_weights(wl, i, C, Cn, dev)
    ws_rec, ws_chain = pack_streams(("rec", "chain"), w[0], w[2], w[4])
    f32 = dict(dtype=torch.float32, device=dev)
    g_net = torch.empty(net.shape, **f32)
    g_rgb = torch.empty((B, P, Hc, Wc, 3), **f32) if i > 0 else None
    gw = [torch.empty(t.shape, **f32) if t is not None else None for t in w]
    nbytes = scratch_bytes(B, Hc, Wc, i, C, Cn)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ptrs = [net.data_ptr(), g_net_next.data_ptr(), g_rgb_next.data_ptr(), ws_rec.data_ptr(),
            ws_chain.data_ptr()] + [_ptr(t) for t in (w[1], w[3], w[5], w[6], w[8])]
    ptrs += [g_net.data_ptr(), _ptr(g_rgb)] + [_ptr(t) for t in gw] + [scratch.data_ptr()]
    with torch.cuda.device(dev):
        err = _c_fn("fused_upsampler_bwd", "fused_upsampler_bwd_launch", _BWD_ARGS)(
            *ptrs, nbytes, B, Hc, Wc, i, C, Cn, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_upsampler_bwd kernel launch failed: cudaError_t {err}")
    phase_block_bwd.launches += 1
    if g_rgb is None:
        g_rgb = torch.zeros((B, P, Hc, Wc, 3), **f32)
    return g_net, g_rgb, [g for g in gw if g is not None]


phase_block_bwd.launches = 0


# ------------------------------------------------------- differentiable API


class PhaseBlockApply(torch.autograd.Function):
    """Differentiable block i (counterpart of the JAX `phase_block_apply`
    custom_vjp): `phase_block_fwd` forward, one `phase_block_bwd` launch
    backward. The weights come in as positional tensors, so their
    gradients flow on through `extract_phase_params` to the NeuralRenderer
    parameters. The cotangents are cast to the io dtype first, as the JAX
    backward casts them."""

    @staticmethod
    def forward(ctx, i, compute_dtype, net, rgb, *wl):
        ctx.i, ctx.compute_dtype = i, compute_dtype
        ctx.save_for_backward(net, rgb, *wl)
        return phase_block_fwd(net, rgb, list(wl), i, compute_dtype)

    @staticmethod
    def backward(ctx, g_net_next, g_rgb_next):
        net, rgb, *wl = ctx.saved_tensors
        iodt = io_dtype(ctx.compute_dtype)
        g_net, g_rgb, gw = phase_block_bwd(
            net, rgb, wl, ctx.i, g_net_next.to(iodt).contiguous(),
            g_rgb_next.to(iodt).contiguous(), ctx.compute_dtype)
        return (None, None, g_net.to(net.dtype), g_rgb.to(rgb.dtype),
                *(g.to(w.dtype) for g, w in zip(gw, wl)))


def fused_upsampler(
    x: torch.Tensor,                  # [B, Hc, Wc, C] featmap
    pp: Dict[str, torch.Tensor],      # extract_phase_params output
    n_blocks: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    final_actvn: bool = True,
) -> torch.Tensor:
    """Full fused decoder: featmap -> [B, img, img, 3] f32. The phase
    unstack and the f32 sigmoid stay in PyTorch, outside the kernels."""
    iodt = io_dtype(compute_dtype)
    B, Hc, Wc, C = x.shape
    net = x.to(iodt)[:, None]                       # [B, 1, Hc, Wc, C]
    rgb = torch.zeros((B, 1, Hc, Wc, 3), dtype=iodt, device=x.device)
    for i in range(n_blocks):
        net, rgb = PhaseBlockApply.apply(i, compute_dtype, net, rgb, *block_weight_list(pp, i))
    L = 1 << n_blocks
    img = rgb.float().reshape(B, L, L, Hc, Wc, 3).permute(0, 3, 1, 4, 2, 5)
    img = img.reshape(B, Hc * L, Wc * L, 3)
    return torch.sigmoid(img) if final_actvn else img
