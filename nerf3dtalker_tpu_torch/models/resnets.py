"""The Deep3DFaceRecon coefficient regressor (port of the `Bottleneck`,
`ResNet50` and `ReconNet` of `nerf3dtalker_tpu/models/resnets.py`;
reference s_face3d/models/networks.py define_net_recon, the SadTalker
`net_recon` of CropAndExtract, talker_trainer.py:215-316).

NCHW: a torchvision ResNet50 trunk pooled to 2048 features, then one
Linear to the 257 BFM coefficients (the reference's seven 1x1 heads
stacked; `utils/convert.py:convert_recon_net`). Module names are the flax
ones (`backbone.layer1_0.conv1`, `final`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.models.bisenet import batch_norm, conv, flax_init


class Bottleneck(nn.Module):
    def __init__(self, cin: int, feats: int, stride: int = 1, expansion: int = 4):
        super().__init__()
        out = feats * expansion
        self.conv1, self.bn1 = conv(cin, feats, 1), batch_norm(feats)
        self.conv2, self.bn2 = conv(feats, feats, 3, stride, 1), batch_norm(feats)
        self.conv3, self.bn3 = conv(feats, out, 1), batch_norm(out)
        if stride != 1 or cin != out:
            self.down_conv, self.down_bn = conv(cin, out, 1, stride), batch_norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class ResNet50(nn.Module):
    """torchvision resnet50 trunk -> pooled [B, 2048]."""

    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 7, 2, 3), batch_norm(64)
        self.blocks = []
        cin = 64
        for li, (c, n, s) in enumerate([(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
            for b in range(n):
                name = f"layer{li + 1}_{b}"
                setattr(self, name, Bottleneck(cin, c, s if b == 0 else 1))
                self.blocks.append(name)
                cin = c * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


class ReconNet(nn.Module):
    """define_net_recon('resnet50', use_last_fc=False): [B, 3, 224, 224] ->
    [B, 257] BFM coefficients. The head starts at zero, as flax's."""

    def __init__(self, coeff_dim: int = 257, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = ResNet50()
        self.final = nn.Linear(2048, coeff_dim)
        flax_init(self, generator, device)
        nn.init.zeros_(self.final.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final(self.backbone(x))
