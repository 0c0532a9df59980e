"""Image quality metrics for validation: SSIM and PSNR (port of
`nerf3dtalker_tpu/utils/metrics.py`, reference Utils/Eval_utils.py):

  * SSIM — skimage `structural_similarity` on uint8 grayscale (uniform 7x7
    window, K1=0.01, K2=0.03, data range 255; Eval_utils.py:56-68);
  * PSNR — cv2.PSNR == 10 log10(255^2 / MSE) on uint8 (Eval_utils.py:104-109).

Inputs are [H, W, 3] float images in [0, 1] on any device; the statistics
are taken in float64. LPIPS is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
