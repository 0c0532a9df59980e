"""Fused NeRF point-MLP + volume compositing: the CUDA kernel's wrapper
and its plain PyTorch version (port of
`nerf3dtalker_tpu/ops/pallas/fused_render.py`).

`fused_render_fwd` launches `csrc/fused_render_fwd.cu` on a CUDA tensor and
takes `reference_render`, the plain version with the same arithmetic, on a
CPU tensor. There is no other route: a CUDA tensor the kernel does not take
raises.

Packed weight layout (kernels [in, out]; per-batch conditioning codes folded
into biases by `pack_weights`, a linear op in front of the kernel):
  w0p   [PE_PAD, H]  fea_0 rows for the (padded) positional encoding
  wh    [6, H, H]    fea_1..4, fea_6, fea_7
  w5p   [PE_PAD, H]  fea_5 skip rows for the PE
  w5x   [H, H]       fea_5 rows for the hidden state
  wd    [H, 1]       density head
  wr0   [H, H]       rgb_0 (no activation after it)
  wr1   [H, H2]      rgb_1 hidden rows (appearance code folded into br1)
  wr2   [H2, FEAT]   rgb_2
  b0, b5 [B, H]; br1 [B, H2] per batch; bh [6, H]; bd []; br0 [H]; br2 [FEAT]
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# the dims the CUDA kernel is compiled for (Reso32/64 flagship)
H = 384
H2 = 192
PE_PAD = 64
NS = 64
FEAT = 256

_WEIGHTS = ("w0p", "wh", "w5p", "w5x", "wd", "wr0", "wr1", "wr2")
_BIASES = ("b0", "bh", "b5", "bd", "br0", "br1", "br2")


def pe_pad_for(p_live: int) -> int:
    """Padded PE width (63 -> 64), shared by pack_weights and the model."""
    return -(-p_live // 8) * 8


def pack_weights(mlp_params: Dict[str, torch.Tensor], shape_code, appea_code,
                 audio_style) -> Dict[str, torch.Tensor]:
    """Fold NeRFMLP params (flax names, [in, out] kernels) and the
    per-batch [B, ...] codes into the kernel layout above."""
    p = mlp_params
    S = shape_code.shape[-1]
    A = audio_style.shape[-1]
    p_live = p["fea_0_kernel"].shape[0] - S - A
    pad = pe_pad_for(p_live) - p_live

    def pad_pe_rows(k):
        return F.pad(k, (0, 0, 0, pad))

    k0 = p["fea_0_kernel"]
    b0 = (shape_code @ k0[p_live:p_live + S] + audio_style @ k0[p_live + S:]
          + p["fea_0_bias"])
    hidden = p["fea_1_kernel"].shape[0]
    k5 = p["fea_5_kernel"]
    b5 = shape_code @ k5[p_live:p_live + S] + p["fea_5_bias"]
    kr1 = p["rgb_1_kernel"]
    br1 = appea_code @ kr1[hidden:] + p["rgb_1_bias"]
    idx = (1, 2, 3, 4, 6, 7)
    return {
        "w0p": pad_pe_rows(k0[:p_live]),
        "wh": torch.stack([p[f"fea_{i}_kernel"] for i in idx]),
        "w5p": pad_pe_rows(k5[:p_live]),
        "w5x": k5[p_live + S:],
        "wd": p["density_kernel"],
        "wr0": p["rgb_0_kernel"],
        "wr1": kr1[:hidden],
        "wr2": p["rgb_2_kernel"],
        "b0": b0,
        "bh": torch.stack([p[f"fea_{i}_bias"] for i in idx]),
        "b5": b5,
        "bd": p["density_bias"].reshape(()),
        "br0": p["rgb_0_bias"],
        "br1": br1,
        "br2": p["rgb_2_bias"],
    }


def _mm(a, b):
    """Operands in the compute dtype, f32 accumulate and f32 result (a
    product of two bf16 values is exact in f32)."""
    return a.float() @ b.float()


def _mlp_tile(pe, w, b0, b5, br1, dtype):
    """Point MLP: pe [N, PE_PAD] -> (rgb [N, FEAT] f32, sigma [N] f32),
    rounding to `dtype` where the TPU kernel rounds."""
    pe = pe.to(dtype)
    x = torch.relu(_mm(pe, w["w0p"]) + b0).to(dtype)
    for i in range(4):
        x = torch.relu(_mm(x, w["wh"][i]) + w["bh"][i]).to(dtype)
    x = torch.relu(_mm(pe, w["w5p"]) + _mm(x, w["w5x"]) + b5).to(dtype)
    for i in range(4, 6):
        x = torch.relu(_mm(x, w["wh"][i]) + w["bh"][i]).to(dtype)
    sigma = torch.relu(_mm(x, w["wd"])[:, 0] + w["bd"])
    r = (_mm(x, w["wr0"]) + w["br0"]).to(dtype)
    r = torch.relu(_mm(r, w["wr1"]) + br1).to(dtype)
    rgb = _mm(r, w["wr2"]) + w["br2"]
    return rgb, sigma


def _composite(rgb, sigma, z_dists, zvals):
    """rgb [R*NS, FEAT], sigma [R*NS] -> feat [R, FEAT], bg_alpha, depth."""
    r, ns = z_dists.shape
    sigma = sigma.reshape(r, ns)
    alpha = 1.0 - torch.exp(-sigma * z_dists)
    t = 1.0 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], 1), 1)
    w = alpha * trans
    feat = torch.sum(rgb.reshape(r, ns, -1) * w[:, :, None], dim=1)
    return feat, 1.0 - w.sum(-1), (w * zvals).sum(-1)


def reference_render(pe, z_dists, zvals, weights, compute_dtype=torch.float32):
    """Plain version of the kernel: the same arithmetic in PyTorch ops.
    Shapes as `fused_render_fwd`; one batch row at a time."""
    B, R, ns, pe_pad = pe.shape
    w = {k: (v.to(compute_dtype) if k.startswith("w") else v.float())
         for k, v in weights.items()}
    outs = []
    for b in range(B):
        rgb, sigma = _mlp_tile(pe[b].reshape(R * ns, pe_pad), w, w["b0"][b],
                               w["b5"][b], w["br1"][b], compute_dtype)
        outs.append(_composite(rgb, sigma, z_dists[b], zvals[b]))
    return tuple(torch.stack(o) for o in zip(*outs))


def _check(name, t, shape, dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _kernel_args(pe, z_dists, zvals, weights):
    """Validate the kernel's operands and cast the packed weights to the
    kernel's types (bf16 weights, f32 biases), as the TPU wrapper does."""
    B, R = pe.shape[:2]
    dev = pe.device
    _check("pe", pe, (B, R, NS, PE_PAD), torch.float32)
    _check("z_dists", z_dists, (B, R, NS), torch.float32)
    _check("zvals", zvals, (B, R, NS), torch.float32)
    shapes = {
        "w0p": (PE_PAD, H), "wh": (6, H, H), "w5p": (PE_PAD, H), "w5x": (H, H),
        "wd": (H, 1), "wr0": (H, H), "wr1": (H, H2), "wr2": (H2, FEAT),
        "b0": (B, H), "bh": (6, H), "b5": (B, H), "bd": (), "br0": (H,),
        "br1": (B, H2), "br2": (FEAT,),
    }
    cast = {}
    for k in _WEIGHTS + _BIASES:
        dtype = torch.bfloat16 if k in _WEIGHTS else torch.float32
        v = weights[k]
        if v.device != dev:
            raise ValueError(f"weight {k} is on {v.device}, pe on {dev}")
        cast[k] = v.to(dtype).contiguous()
        _check(k, cast[k], shapes[k], dtype)
    return cast


_launch_fn = None


def _c_fn():
    """The C launcher, built, loaded and bound at the first launch."""
    global _launch_fn
    if _launch_fn is None:
        from nerf3dtalker_tpu_torch.ops.kernels import build

        fn = build.load("fused_render_fwd").fused_render_fwd_launch
        # every pointer as c_void_p: left undeclared, ctypes passes a Python
        # int as a 32-bit C int and cuts the pointer
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def fused_render_fwd(
    pe: torch.Tensor,        # [B, R, NS, PE_PAD] f32 (PE padded 63 -> 64)
    z_dists: torch.Tensor,   # [B, R, NS] f32
    zvals: torch.Tensor,     # [B, R, NS] f32
    weights: Dict[str, torch.Tensor],   # see pack_weights()
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (features [B, R, FEAT], bg_alpha [B, R], depth [B, R]), f32.

    A CPU tensor runs `reference_render`. A CUDA tensor launches the kernel,
    which computes in bf16 with f32 accumulation, on the current stream."""
    if pe.device.type == "cpu":
        return reference_render(pe, z_dists, zvals, weights, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16")
    w = _kernel_args(pe, z_dists, zvals, weights)
    B, R = pe.shape[:2]
    feat = torch.empty((B, R, FEAT), dtype=torch.float32, device=pe.device)
    bg = torch.empty((B, R), dtype=torch.float32, device=pe.device)
    depth = torch.empty((B, R), dtype=torch.float32, device=pe.device)
    ptrs = [t.data_ptr() for t in (pe, z_dists, zvals)]
    ptrs += [w[k].data_ptr() for k in _WEIGHTS + _BIASES]
    ptrs += [t.data_ptr() for t in (feat, bg, depth)]
    with torch.cuda.device(pe.device):   # the launch goes to the current device
        err = _c_fn()(*ptrs, B, R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_render_fwd kernel launch failed: cudaError_t {err}")
    fused_render_fwd.launches += 1
    return feat, bg, depth


fused_render_fwd.launches = 0
