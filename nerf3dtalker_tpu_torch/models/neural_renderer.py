"""Neural 2D renderer: featmap -> image upsampler decoder (port of
`nerf3dtalker_tpu/models/neural_renderer.py`, reference `NeuralRenderer`,
NetWorks/neural_renderer.py:11-91, and `PixelShuffleUpsample`/`Blur`,
NetWorks/PixelShuffleUpsample.py:8-45).

Images are NHWC at the public functions, as in the JAX package, so each
1x1 conv is an `nn.Linear` over the last axis. Parameters are stored in
f32 and cast to the compute dtype at use, as flax `Dense(dtype=...)` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def blur3(x: torch.Tensor) -> torch.Tensor:
    """Separable [1,2,1]x[1,2,1]/16 blur with reflect padding, NHWC
    (kornia filter2d, normalized, border 'reflect')."""
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    x = (x[:, :-2] + 2.0 * x[:, 1:-1] + x[:, 2:]) * 0.25
    x = torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)
    return (x[:, :, :-2] + 2.0 * x[:, :, 1:-1] + x[:, :, 2:]) * 0.25


def pixel_shuffle_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC pixel shuffle, upscale 2: [B,H,W,4C] -> [B,2H,2W,C]; channel
    index c*4 + di*2 + dj, as F.pixel_shuffle on NCHW."""
    B, H, W, C4 = x.shape
    C = C4 // 4
    x = x.reshape(B, H, W, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, 2 * H, 2 * W, C)


def bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel bilinear x2 (align_corners=False), NHWC."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class PixelShuffleUpsample(nn.Module):
    """conv1x1(c->2c) -> lrelu -> conv1x1(2c->4c) -> lrelu, plus the
    channel-tiled identity, then pixel-shuffle and blur."""

    def __init__(self, features: int):
        super().__init__()
        self.layer_1 = nn.Linear(features, 2 * features)
        self.layer_2 = nn.Linear(2 * features, 4 * features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.repeat(1, 1, 1, 4)   # torch `x.repeat(1, 4, 1, 1)` on NCHW
        out = F.leaky_relu(_dense(self.layer_1, x), 0.2)
        out = F.leaky_relu(_dense(self.layer_2, out), 0.2)
        return blur3(pixel_shuffle_2x(out + y))


class NeuralRenderer(nn.Module):
    """Feature map [B, S, S, feat_nc] -> RGB image [B, img, img, 3]."""

    def __init__(self, feat_nc: int = 256, out_dim: int = 3, final_actvn: bool = True,
                 min_feat: int = 32, featmap_size: int = 32, img_size: int = 256,
                 bg_type: str = "white", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.final_actvn, self.bg_type = final_actvn, bg_type
        self.compute_dtype = compute_dtype
        self.n_blocks = int(math.log2(img_size) - math.log2(featmap_size))

        def feat(i):
            return max(feat_nc // (2 ** i), min_feat)

        self.feat_upsamples = nn.ModuleList(
            PixelShuffleUpsample(feat(i)) for i in range(self.n_blocks))
        self.feat_layers = nn.ModuleList(
            nn.Linear(feat(i), feat(i + 1)) for i in range(self.n_blocks))
        self.feat_2_rgb = nn.ModuleList(
            nn.Linear(feat(i), out_dim) for i in range(self.n_blocks + 1))
        self.bg_featmap = nn.Parameter(torch.empty(1, featmap_size, featmap_size, feat_nc))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """LeCun-normal kernels and zero biases (the flax Dense init); the
        bg featmap is ones for a white background, zeros otherwise."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, std=m.in_features ** -0.5, generator=generator)
                nn.init.zeros_(m.bias)
        nn.init.constant_(self.bg_featmap, 1.0 if self.bg_type == "white" else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        rgb = blur3(bilinear_2x(_dense(self.feat_2_rgb[0], x)))
        net = x
        for idx in range(self.n_blocks):
            hid = _dense(self.feat_layers[idx], self.feat_upsamples[idx](net))
            net = F.leaky_relu(hid, 0.2)
            rgb = rgb + _dense(self.feat_2_rgb[idx + 1], net)
            if idx < self.n_blocks - 1:
                rgb = blur3(bilinear_2x(rgb))
        rgb = rgb.float()
        return torch.sigmoid(rgb) if self.final_actvn else rgb
