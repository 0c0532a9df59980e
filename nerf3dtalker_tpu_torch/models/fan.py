"""FAN 2D facial-landmark network and heatmap decoding (port of
`nerf3dtalker_tpu/models/fan.py`: face_alignment's 2D-FAN as reference
DataProcess/Gen_Landmark.py:12-95 and genlm_loss.py:12-70 use it).

NCHW: a stacked hourglass over [B, 3, 256, 256] crops gives 68 heatmaps
[B, 68, 64, 64] (the last stack's), decoded to sub-pixel coordinates. The
module names are the flax ones (`conv2.bn1`, `hg_0.b2plus_1`, `l_0`, ...;
`utils/bridge.py:bn_net_state_dict` maps the JAX variables).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.models.bisenet import batch_norm, conv, flax_init


class ConvBlock(nn.Module):
    """FAN's residual block: three 3x3 convs to C/2, C/4, C/4 after BN and
    ReLU, concatenated, plus the skip (a 1x1 conv after BN and ReLU where
    the width changes)."""

    def __init__(self, cin: int, feats: int):
        super().__init__()
        c = feats
        self.bn1, self.conv1 = batch_norm(cin), conv(cin, c // 2, 3, 1, 1)
        self.bn2, self.conv2 = batch_norm(c // 2), conv(c // 2, c // 4, 3, 1, 1)
        self.bn3, self.conv3 = batch_norm(c // 4), conv(c // 4, c // 4, 3, 1, 1)
        if cin != c:
            self.bn4, self.down = batch_norm(cin), conv(cin, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.conv1(F.relu(self.bn1(x)))
        y2 = self.conv2(F.relu(self.bn2(y1)))
        y3 = self.conv3(F.relu(self.bn3(y2)))
        if hasattr(self, "down"):
            x = self.down(F.relu(self.bn4(x)))
        return torch.cat([y1, y2, y3], dim=1) + x


class Hourglass(nn.Module):
    def __init__(self, depth: int = 4, feats: int = 256):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            for name in ("b1", "b2", "b3"):
                setattr(self, f"{name}_{level}", ConvBlock(feats, feats))
        self.b2plus_1 = ConvBlock(feats, feats)

    def _hg(self, x: torch.Tensor, level: int) -> torch.Tensor:
        up1 = getattr(self, f"b1_{level}")(x)
        low = getattr(self, f"b2_{level}")(F.avg_pool2d(x, 2, 2))
        low = self._hg(low, level - 1) if level > 1 else self.b2plus_1(low)
        low = getattr(self, f"b3_{level}")(low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest-exact")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._hg(x, self.depth)


class FAN(nn.Module):
    """Stacked-hourglass landmark detector: [B, 3, 256, 256] -> the last
    stack's heatmaps [B, 68, 64, 64]."""

    def __init__(self, n_stacks: int = 4, n_landmarks: int = 68,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_stacks = n_stacks
        self.conv1 = conv(3, 64, 7, 2, 3, bias=True)
        self.bn1 = batch_norm(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for s in range(n_stacks):
            setattr(self, f"hg_{s}", Hourglass())
            setattr(self, f"top_{s}", ConvBlock(256, 256))
            setattr(self, f"conv_last_{s}", conv(256, 256, 1, bias=True))
            setattr(self, f"bn_end_{s}", batch_norm(256))
            setattr(self, f"l_{s}", conv(256, n_landmarks, 1, bias=True))
            if s < n_stacks - 1:
                setattr(self, f"bl_{s}", conv(256, 256, 1, bias=True))
                setattr(self, f"al_{s}", conv(n_landmarks, 256, 1, bias=True))
        flax_init(self, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.avg_pool2d(self.conv2(x), 2, 2)
        prev = self.conv4(self.conv3(x))
        for s in range(self.n_stacks):
            ll = getattr(self, f"top_{s}")(getattr(self, f"hg_{s}")(prev))
            ll = F.relu(getattr(self, f"bn_end_{s}")(getattr(self, f"conv_last_{s}")(ll)))
            hm = getattr(self, f"l_{s}")(ll)
            if s < self.n_stacks - 1:
                prev = prev + getattr(self, f"bl_{s}")(ll) + getattr(self, f"al_{s}")(hm)
        return hm


def decode_heatmaps(heatmaps: torch.Tensor, crop_size: int = 256) -> torch.Tensor:
    """[B, L, H, W] -> [B, L, 2] sub-pixel (x, y) in crop pixels
    (face_alignment's get_preds_fromhm): the first argmax, then a quarter
    pixel towards the larger neighbour along each axis (by the sign of the
    neighbours' difference; a neighbour outside the map is read at the
    border)."""
    B, L, H, W = heatmaps.shape
    idx = heatmaps.reshape(B, L, -1).argmax(dim=-1)
    yi, xi = idx // W, idx % W

    def at(y, x):
        y, x = y.clamp(0, H - 1), x.clamp(0, W - 1)
        return heatmaps.reshape(B, L, -1).gather(-1, (y * W + x)[..., None])[..., 0]

    gx = at(yi, xi + 1) - at(yi, xi - 1)
    gy = at(yi + 1, xi) - at(yi - 1, xi)
    xs = xi.to(heatmaps.dtype) + 0.25 * torch.sign(gx)
    ys = yi.to(heatmaps.dtype) + 0.25 * torch.sign(gy)
    return torch.stack([xs, ys], dim=-1) * (crop_size / W)


def landmark_heatmap_targets(lm: torch.Tensor, hw: int = 64, sigma: float = 1.0) -> torch.Tensor:
    """[B, L, 2] coordinates in heatmap pixels -> Gaussian target heatmaps
    [B, L, hw, hw] (NCHW, as FAN's output)."""
    r = torch.arange(hw, dtype=lm.dtype, device=lm.device)
    dy = r[None, None, :, None] - lm[..., 1][:, :, None, None]
    dx = r[None, None, None, :] - lm[..., 0][:, :, None, None]
    return torch.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))
