"""BiSeNet face parsing and the head-mask post-processing (port of
`nerf3dtalker_tpu/models/bisenet.py`; reference DataProcess/BiSeNet.py:
11-280 and the mask clean-up of Gen_HeadMask.py:16-181 /
correct_head_mask.py:5-90).

NCHW. The ResNet18 context path, attention refinement, feature fusion and
three output heads upsampled bilinearly with align_corners=True; the
19-class argmax gives the head and eye masks. The module names are the
flax ones (`resnet.layer1_0.conv1`, `arm32.conv.bn`, `conv_out_out`, ...),
so `utils/bridge.py:bn_net_state_dict` maps the JAX variables and
`utils/convert.py:convert_bisenet` the reference's state dict.

BatchNorm takes flax's epsilon (1e-5) and momentum (0.99, i.e. torch's
momentum 0.01); in eval mode, as preprocessing runs it, only the running
statistics are read.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.utils.device import resolve_device


def batch_norm(c: int) -> nn.BatchNorm2d:
    """BatchNorm2d with flax's defaults (epsilon 1e-5, momentum 0.99)."""
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.01)


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
         bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


def flax_init(module: nn.Module, generator: Optional[torch.Generator], device) -> nn.Module:
    """`module` at the flax defaults, drawn on the CPU from `generator`
    (LeCun-normal kernels, zero biases, BatchNorm scale 1, bias 0, running
    mean 0 and variance 1), in eval mode on `device` (default `cuda`)."""
    from nerf3dtalker_tpu_torch.models.vq.transformer import flax_init_

    dev = resolve_device(device)
    flax_init_(module, generator)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module.to(dev).eval()


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, feats: int, ks: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = conv(cin, feats, ks, stride, padding)
        self.bn = batch_norm(feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, feats: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, feats, 3, stride, 1)
        self.bn1 = batch_norm(feats)
        self.conv2 = conv(feats, feats, 3, 1, 1)
        self.bn2 = batch_norm(feats)
        if stride != 1 or cin != feats:
            self.down_conv = conv(cin, feats, 1, stride)
            self.down_bn = batch_norm(feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class ResNet18Trunk(nn.Module):
    """DataProcess/resnet.py:58-80: the 1/8, 1/16 and 1/32 features."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = batch_norm(64)
        cin = 64
        for i, (c, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            for b in range(2):
                setattr(self, f"layer{i + 1}_{b}", BasicBlock(cin, c, s if b == 0 else 1))
                cin = c

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)          # pads with -inf
        feats = []
        for i in range(4):
            for b in range(2):
                x = getattr(self, f"layer{i + 1}_{b}")(x)
            feats.append(x)
        return feats[1], feats[2], feats[3]


def _nearest_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")`: half-pixel centres."""
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


def _bilinear_ac_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear with align_corners=True (BiSeNet.py:249-251)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class AttentionRefinement(nn.Module):
    def __init__(self, cin: int, feats: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, feats)
        self.conv_atten = conv(feats, feats, 1)
        self.bn_atten = batch_norm(feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        att = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(att)


class FeatureFusion(nn.Module):
    def __init__(self, cin: int, feats: int):
        super().__init__()
        self.convblk = ConvBNReLU(cin, feats, ks=1, padding=0)
        self.conv1 = conv(feats, feats // 4, 1)
        self.conv2 = conv(feats // 4, feats, 1)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        att = F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))
        att = torch.sigmoid(self.conv2(att))
        return feat * att + feat


class BiSeNet(nn.Module):
    """19-class face parsing (BiSeNet.py:227-256; the spatial path replaced
    by the ResNet's 1/8 feature, :240-243): [B, 3, H, W] -> three
    [B, n_classes, H, W] logits (fused, 1/16 and 1/32 heads)."""

    def __init__(self, n_classes: int = 19, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resnet = ResNet18Trunk()
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.arm16 = AttentionRefinement(256, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.ffm = FeatureFusion(256, 256)
        for name, cin, mid in (("conv_out", 256, 256), ("conv_out16", 128, 64),
                               ("conv_out32", 128, 64)):
            setattr(self, f"{name}_conv", ConvBNReLU(cin, mid))
            setattr(self, f"{name}_out", conv(mid, n_classes, 1))
        flax_init(self, generator, device)

    def forward(self, x: torch.Tensor):
        H, W = x.shape[2:]
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg.expand(-1, -1, *feat32.shape[2:])
        f32_up = self.conv_head32(_nearest_resize(f32, feat16.shape[2:]))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(_nearest_resize(f16, feat8.shape[2:]))
        fuse = self.ffm(feat8, f16_up)

        def head(x, name):
            x = getattr(self, f"{name}_out")(getattr(self, f"{name}_conv")(x))
            return _bilinear_ac_resize(x, (H, W))

        return head(fuse, "conv_out"), head(f16_up, "conv_out16"), head(f32_up, "conv_out32")


# face-parsing label ids (Gen_HeadMask.py usage): head-region classes
HEAD_CLASSES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 17)  # skin..hair
EYE_CLASSES = (4, 5)


def _classes_mask(parsing: torch.Tensor, classes) -> torch.Tensor:
    return torch.isin(parsing, torch.tensor(classes, device=parsing.device)).float()


def head_mask_from_parsing(parsing: torch.Tensor) -> torch.Tensor:
    """argmax parsing [B, H, W] -> binary head mask (the union of the
    face-region classes, Gen_HeadMask.py:16-181)."""
    return _classes_mask(parsing, HEAD_CLASSES)


def eye_mask_from_parsing(parsing: torch.Tensor) -> torch.Tensor:
    return _classes_mask(parsing, EYE_CLASSES)


def correct_head_mask(mask: np.ndarray, iterations: int = 2) -> np.ndarray:
    """Morphological clean-up (DataProcess/correct_head_mask.py:5-90): close
    small holes, open once, keep the largest connected component (numpy /
    scipy, offline)."""
    from scipy import ndimage

    m = mask > 0.5
    m = ndimage.binary_closing(m, iterations=iterations)
    m = ndimage.binary_opening(m, iterations=1)
    lab, n = ndimage.label(m)
    if n > 1:
        sizes = ndimage.sum(m, lab, range(1, n + 1))
        m = lab == (1 + int(np.argmax(sizes)))
    return m.astype(np.float32)
