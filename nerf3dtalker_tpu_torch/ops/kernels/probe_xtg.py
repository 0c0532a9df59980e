"""The xᵀ·g probe: the CUDA kernel's wrapper and its plain PyTorch version
(port of `scripts/probe_mosaic_bf16T.py`, the `pallas_call` at :57 over
`mk_kernel` :25-47).

  probe_xtg   `csrc/probe_xtg.cu`; plain version `reference_xtg`

The weight-gradient product of the fused render backward, `xᵀ·g` with bf16
operands and an f32 result, in the probe's four operand modes:

  loaded    x [N, K], g [N, H] read as they are -> [K, H]
  computed  x' = bf16(relu(x·w)) made in the kernel and fed to the product
            from registers -> x'ᵀ·g [H, H]
  scratch   the same, x' and g staged through shared memory
  f32       the same x', the product in f32

Nothing in the package calls it: it is the yardstick for the
weight-gradient part of `csrc/fused_render_bwd.cu`. The wrapper launches the
kernel on CUDA tensors and takes the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from nerf3dtalker_tpu_torch.ops.kernels.fused_render import _c_fn, _check

MODES = ("loaded", "computed", "scratch", "f32")
# the probe's shapes (probe_mosaic_bf16T.py:14)
N, K, H = 1024, 384, 384

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]   # x, g, w, out, N, K, H, mode, stream


def reference_xtg(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version: f32 products of the bf16 values; x' rounded to bf16
    after the ReLU, as the probe rounds it."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "loaded":
        return x.float().T @ g.float()
    xp = torch.relu(x.float() @ w.float()).to(torch.bfloat16)
    return xp.float().T @ g.float()


def probe_xtg(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x [N, K], g [N, H], w [K, H] bf16 (N, K, H multiples of 64) -> f32
    [K, H] for `loaded`, [H, H] otherwise. A CPU tensor runs
    `reference_xtg`; a CUDA tensor launches the kernel on the current
    stream."""
    if x.device.type == "cpu":
        return reference_xtg(x, g, w, mode)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n, k = x.shape
    h = g.shape[1]
    if n % 64 or k % 64 or h % 64:
        raise ValueError(f"N, K, H must be multiples of 64, got {(n, k, h)}")
    _check("x", x, (n, k), torch.bfloat16)
    _check("g", g, (n, h), torch.bfloat16)
    _check("w", w, (k, h), torch.bfloat16)
    out = torch.empty((k if mode == "loaded" else h, h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _c_fn("probe_xtg", _ARGS)(x.data_ptr(), g.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), n, k, h, MODES.index(mode),
                                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_xtg kernel launch failed: cudaError_t {err}")
    probe_xtg.launches += 1
    return out


probe_xtg.launches = 0
