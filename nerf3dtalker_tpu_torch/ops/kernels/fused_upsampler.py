"""Fused phase-stacked upsampler: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd Function that joins them (port of
`nerf3dtalker_tpu/ops/pallas/fused_upsampler.py`).

  phase_block_fwd   one PixelShuffleUpsample block plus the rgb pyramid
                    step, level i -> i+1, `csrc/fused_upsampler_fwd.cu`;
                    plain version `reference_block_fwd`
  phase_block_bwd   its recompute backward, `csrc/fused_upsampler_bwd.cu`;
                    plain version `reference_block_bwd`
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


def _kernel_weights(wl, i, C, Cn, dev):
    """Cast the weight list to the kernels' types (bf16 kernels, f32
    biases) and check their shapes."""
    shapes = [(C, 2 * C), (2 * C,), (2 * C, 4 * C), (4 * C,), (C, Cn), (Cn,), (Cn, 3), (3,)]
    if i == 0:
        shapes += [(C, 3), (3,)]
    if len(wl) != len(shapes):
        raise ValueError(f"block {i} takes {len(shapes)} weights, got {len(wl)}")
    out = []
    for k, (w, shape) in enumerate(zip(wl, shapes)):
        dtype = torch.bfloat16 if len(shape) == 2 else torch.float32
        if w.device != dev:
            raise ValueError(f"weight {k} is on {w.device}, net on {dev}")
        w = w.detach().to(dtype).contiguous()
        _check(f"weight {k}", w, shape, dtype)
        out.append(w)
    if i != 0:
        out += [None, None]
    return out


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
_FWD_ARGS = [_P] * 14 + [_I] * 6 + [_P]        # ..., B, Hc, Wc, level, C, Cn, stream
# ..., scratch bytes, B, Hc, Wc, level, C, Cn, stream
_BWD_ARGS = [_P] * 27 + [_LL] + [_I] * 6 + [_P]
_SCRATCH_ARGS = [_I] * 6


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def phase_block_fwd(net: torch.Tensor, rgb: Optional[torch.Tensor], wl: List[torch.Tensor],
                    i: int, compute_dtype: torch.dtype = torch.bfloat16):
    """Block i forward: (net_next [B, 4P, Hc, Wc, Cn], rgb_next
    [B, 4P, Hc, Wc, 3]). A CPU tensor runs `reference_block_fwd`; a CUDA
    tensor launches the kernel (bf16 operands and activations, f32 sums),
    on the current stream."""
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
    net_out = torch.empty((B, 4 * P, Hc, Wc, Cn), dtype=torch.bfloat16, device=net.device)
    rgb_out = torch.empty((B, 4 * P, Hc, Wc, 3), dtype=torch.bfloat16, device=net.device)
    ptrs = [net.data_ptr(), _ptr(rgb if i > 0 else None)] + [_ptr(t) for t in w]
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
    bf16 stash of activations and gradient activations and the f32 partial
    sums of the weight gradients), as the kernel library computes it."""
    fn = _c_fn("fused_upsampler_bwd", "fused_upsampler_bwd_scratch_bytes", _SCRATCH_ARGS,
               ctypes.c_longlong)
    return int(fn(B, Hc, Wc, i, C, Cn))


def phase_block_bwd(net: torch.Tensor, rgb: Optional[torch.Tensor], wl: List[torch.Tensor],
                    i: int, g_net_next: torch.Tensor, g_rgb_next: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """Backward of block i for the cotangents of its two outputs: (g_net,
    g_rgb, weight gradients in `wl` order), f32, as `reference_block_bwd`.
    A CPU tensor runs `reference_block_bwd`; a CUDA tensor launches the
    kernel on the current stream with a fresh device scratch."""
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
    f32 = dict(dtype=torch.float32, device=dev)
    g_net = torch.empty(net.shape, **f32)
    g_rgb = torch.empty((B, P, Hc, Wc, 3), **f32) if i > 0 else None
    gw = [torch.empty(t.shape, **f32) if t is not None else None for t in w]
    nbytes = scratch_bytes(B, Hc, Wc, i, C, Cn)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ptrs = [net.data_ptr(), _ptr(rgb if i > 0 else None), g_net_next.data_ptr(),
            g_rgb_next.data_ptr()] + [_ptr(t) for t in w]
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
