"""Per-AU binary classifiers (port of
`nerf3dtalker_tpu/models/vq/au_classifier.py`; reference `classifier_AU`,
StandardizedSpace/main/train_vq.py:60-93): a small CNN on face crops whose
256-d features feed the AU codebook (`AU_fea`, train_vq.py:278), and a
sigmoid probability head.

NCHW, as the reference: `utils/convert.py:convert_au_classifier` maps a
reference state dict with no permutation. The JAX module is NHWC and
flattens HWC, so the bridge from a flax tree permutes linear0's rows
(`utils/bridge.py:au_classifiers_state_dict`). The first Linear's width
depends on the crop: 128 * 5 * 5 = 3200 features at 112^2, 128 at 48^2.
The dropout after each Linear, off everywhere the JAX package runs the
classifier (`deterministic=True`), is left out.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.models.vq.transformer import flax_init_
from nerf3dtalker_tpu_torch.utils.device import resolve_device

# (channels, stride) of conv1..conv4, 5x5 kernels with padding 1; a 2x2
# max pool after conv2 and after conv4
_CONVS = ((16, 2), (32, 1), (64, 2), (128, 1))
_LINEARS = (1600, 512, 256, 64)


def flat_features(crop_size: int) -> int:
    """linear0's input width for square crops of `crop_size` pixels."""
    s = crop_size
    for i, (_, stride) in enumerate(_CONVS):
        s = (s + 2 - 5) // stride + 1
        if i in (1, 3):
            s //= 2
    return _CONVS[-1][0] * s * s


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d (no affine): over H, W per channel, biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


class AUClassifier(nn.Module):
    """[B, 3, S, S] crop -> (features [B, 256], probability [B, 1])."""

    def __init__(self, crop_size: int = 112, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are initialized on the CPU from `generator` (the flax
        defaults) and moved to `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        cin = 3
        for i, (ch, stride) in enumerate(_CONVS):
            self.add_module(f"conv{i + 1}", nn.Conv2d(cin, ch, 5, stride=stride, padding=1))
            cin = ch
        fin = flat_features(crop_size)
        for i, fout in enumerate(_LINEARS):
            self.add_module(f"linear{i}", nn.Linear(fin, fout))
            fin = fout
        self.linear4 = nn.Linear(fin, 1)
        flax_init_(self, generator)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(4):
            x = F.leaky_relu(_instance_norm(getattr(self, f"conv{i + 1}")(x)), 0.2)
            if i in (1, 3):
                x = F.max_pool2d(x, 2)
        x = x.flatten(1)
        for i in range(3):
            x = F.leaky_relu(getattr(self, f"linear{i}")(x), 0.2)
        feats = x
        x = F.leaky_relu(self.linear3(x), 0.2)
        return feats, torch.sigmoid(self.linear4(x))


def au_dice_loss(pred: torch.Tensor, target: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft dice for AU activations (reference main/loss.py au_dice_loss)."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    inter = (p * t).sum(-1)
    return torch.mean(1.0 - (2 * inter + smooth) / (p.sum(-1) + t.sum(-1) + smooth))


def au_bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary CE on sigmoid outputs (train_vq.py:281-302 AU loss)."""
    eps = 1e-7
    p = pred.clamp(eps, 1 - eps)
    return -torch.mean(target * torch.log(p) + (1 - target) * torch.log(1 - p))
