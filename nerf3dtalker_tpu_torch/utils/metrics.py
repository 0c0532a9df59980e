"""Image quality metrics for validation: SSIM and PSNR (port of
`nerf3dtalker_tpu/utils/metrics.py`, reference Utils/Eval_utils.py):

  * SSIM — skimage `structural_similarity` on uint8 grayscale (uniform 7x7
    window, K1=0.01, K2=0.03, data range 255; Eval_utils.py:56-68);
  * PSNR — cv2.PSNR == 10 log10(255^2 / MSE) on uint8 (Eval_utils.py:104-109).

Inputs are [H, W, 3] float images in [0, 1] on any device; the statistics
are taken in float64. LPIPS-alex (Eval_utils.py:108-115) takes [B, H, W, 3]
and the converted weights of `load_lpips_alex`, a user's local file.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def to_gray_uint8(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] in [0, 1] -> uint8-valued luminance as cv2's cvtColor
    (RGB order assumed), float64."""
    u8 = torch.clamp(torch.round(img.double() * 255.0), 0, 255)
    return torch.round(0.299 * u8[..., 0] + 0.587 * u8[..., 1] + 0.114 * u8[..., 2])


def _uniform_filter7(x: torch.Tensor) -> torch.Tensor:
    """7x7 moving average with valid padding, [H, W] -> [H-6, W-6]."""
    k = torch.full((1, 1, 7, 1), 1.0 / 7.0, dtype=x.dtype, device=x.device)
    y = F.conv2d(x[None, None], k)
    return F.conv2d(y, k.transpose(2, 3))[0, 0]


def ssim_gray(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """skimage-compatible SSIM of two 2-D grayscale images (win_size 7,
    uniform filter, unbiased covariance cov_norm = NP / (NP - 1))."""
    img1, img2 = img1.double(), img2.double()
    cov_norm = 49.0 / 48.0
    ux, uy = _uniform_filter7(img1), _uniform_filter7(img2)
    uxx, uyy = _uniform_filter7(img1 * img1), _uniform_filter7(img2 * img2)
    uxy = _uniform_filter7(img1 * img2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    return torch.mean(num / den)


def ssim_rgb(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM of two [H, W, 3] images in [0, 1] through uint8 grayscale, as
    the reference evaluates (Eval_utils.py:56-68)."""
    return ssim_gray(to_gray_uint8(img1), to_gray_uint8(img2))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """cv2.PSNR of two uint8-quantized [H, W, 3] images in [0, 1]."""
    a = torch.clamp(torch.round(img1.double() * 255.0), 0, 255)
    b = torch.clamp(torch.round(img2.double() * 255.0), 0, 255)
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(255.0 ** 2 / torch.clamp(mse, min=1e-10))


# ---------------------------------------------------------------- LPIPS-alex

# (out channels, kernel, stride, padding, max-pool before) of torchvision
# AlexNet's `.features` convolutions
_ALEX_SPEC = ((64, 11, 4, 2, False), (192, 5, 1, 2, True), (384, 3, 1, 1, True),
              (256, 3, 1, 1, False), (256, 3, 1, 1, False))
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet's `.features` trunk, returning the five ReLU taps
    that LPIPS reads, NCHW."""

    def __init__(self):
        super().__init__()
        cin = 3
        convs = []
        for cout, k, s, p, _ in _ALEX_SPEC:
            convs.append(nn.Conv2d(cin, cout, k, stride=s, padding=p))
            cin = cout
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for conv, (_, _, _, _, pool) in zip(self.convs, _ALEX_SPEC):
            if pool:
                x = F.max_pool2d(x, 3, stride=2)
            x = F.relu(conv(x))
            taps.append(x)
        return taps


def lpips_alex(net: AlexNetFeatures, lin_weights: List[torch.Tensor], img1: torch.Tensor,
               img2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance [B] of [B, H, W, 3] images in [0, 1]; `lin_weights[i]`
    is the [C_i] 1x1 weight of lpips's `lin` head i."""
    def norm_input(x):
        shift = x.new_tensor(_LPIPS_SHIFT)
        scale = x.new_tensor(_LPIPS_SCALE)
        return ((x * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)

    total = 0.0
    for t1, t2, w in zip(net(norm_input(img1)), net(norm_input(img2)), lin_weights):
        n1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=1, keepdim=True), min=1e-10)
        n2 = t2 / torch.clamp(torch.linalg.vector_norm(t2, dim=1, keepdim=True), min=1e-10)
        d = (n1 - n2) ** 2
        total = total + torch.mean(torch.sum(d * w[None, :, None, None], dim=1), dim=(1, 2))
    return total


def load_lpips_alex(path: str, device=None) -> Tuple[AlexNetFeatures, List[torch.Tensor]]:
    """(AlexNet trunk, lin weights) for `lpips_alex` from the .npz that the
    JAX package's `save_lpips_alex` writes: conv{i}_kernel [k, k, in, out],
    conv{i}_bias and lin{i}, i in 0..4."""
    net = AlexNetFeatures()
    with np.load(path) as z:
        with torch.no_grad():
            for i, conv in enumerate(net.convs):
                conv.weight.copy_(torch.from_numpy(z[f"conv{i}_kernel"].transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.from_numpy(z[f"conv{i}_bias"]))
        lins = [torch.as_tensor(z[f"lin{i}"], device=device) for i in range(len(net.convs))]
    return net.to(device).eval().requires_grad_(False), lins
