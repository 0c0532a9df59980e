"""The xᵀ·g probe: the CUDA kernel's wrapper and its plain PyTorch version
(port of `scripts/probe_mosaic_bf16T.py`, the `pallas_call` at :57 over
`mk_kernel` :25-47).

  probe_xtg   `csrc/probe_xtg.cu`; plain version `reference_xtg`

The weight-gradient product of the fused render backward, `xᵀ·g` with bf16
operands and an f32 result, in the probe's four operand modes:

  loaded    x [N, K], g [N, H] read as they are -> [K, H]
  computed  x' = bf16(relu(x·w)) formed in the kernel, one tile of the
            point axis at a time, and fed to the product -> x'ᵀ·g [H, H]
  scratch   the same, x·w through an explicit f32 shared-memory tile
  f32       the same x', the product in f32

Every mode runs on the X^T G core that the weight-gradient pass of
`csrc/fused_render_bwd.cu` runs on (`csrc/xtg_core.cuh`), with the point
axis cut into `SPLITS` splits added in a thread block cluster. Nothing in
the package calls it: it is the yardstick for that pass. The wrapper
launches the kernel on CUDA tensors and takes the plain version on CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from nerf3dtalker_tpu_torch.ops.kernels.fused_render import _c_fn, _check

MODES = ("loaded", "computed", "scratch", "f32")
_MODE_INDEX = {m: i for i, m in enumerate(MODES)}
# the probe's shapes (probe_mosaic_bf16T.py:14)
N, K, H = 1024, 384, 384
# splits of the point axis (`SPLITS` in the kernel: one cluster a tile), and
# the largest contraction K of x·w that the forming modes stage
SPLITS = 8
K_MAX = 384

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


def _ok(t: torch.Tensor, shape) -> bool:
    """The cheap test of what `_check` checks, for the launch path."""
    return (t.is_cuda and t.dtype == torch.bfloat16 and t.shape == shape and t.is_contiguous()
            and t.data_ptr() % 16 == 0)


def probe_xtg(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x [N, K], g [N, H], w [K, H] bf16 (N, K, H multiples of 64, N at
    least 64 x SPLITS, K at most K_MAX unless `loaded`) -> f32 [K, H] for
    `loaded`, [H, H] otherwise. A CPU tensor runs `reference_xtg`; a CUDA
    tensor launches the kernel on the current stream. The launch path does
    little on the host: the product is a few microseconds on the card."""
    if not x.is_cuda:
        return reference_xtg(x, g, w, mode)
    index = _MODE_INDEX.get(mode)
    if index is None:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n, k = x.shape
    h = g.shape[1]
    if n % 64 or k % 64 or h % 64:
        raise ValueError(f"N, K, H must be multiples of 64, got {(n, k, h)}")
    if n < 64 * SPLITS or (index and k > K_MAX):
        raise ValueError(f"N must be at least {64 * SPLITS} and K at most {K_MAX}, "
                         f"got {(n, k)}")
    if not (_ok(x, (n, k)) and _ok(g, (n, h)) and (index == 0 or _ok(w, (k, h)))):
        _check("x", x, (n, k), torch.bfloat16)
        _check("g", g, (n, h), torch.bfloat16)
        _check("w", w, (k, h), torch.bfloat16)   # `loaded` does not read w
    # the launch goes to the calling thread's current device, on that
    # device's current stream (the raw handle: a Stream object a call would
    # cost more than the product)
    dev = x.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return probe_xtg(x, g, w, mode)
    out = torch.empty((h if index else k, h), dtype=torch.float32, device=dev)
    err = _c_fn("probe_xtg", _ARGS)(x.data_ptr(), g.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    n, k, h, index, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"probe_xtg kernel launch failed: cudaError_t {err}")
    probe_xtg.launches += 1
    return out


probe_xtg.launches = 0
