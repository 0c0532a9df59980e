"""VGG16 perceptual features and loss (port of
`nerf3dtalker_tpu/models/perceptual.py`, reference `VGGPerceptualLoss`,
Utils/HeadNeRFLossUtils.py:23-64).

torchvision VGG16 `.features[:23]` cut into four blocks (conv1_x .. conv4_x);
images ImageNet-normalized and resized to 224 with a linear filter that
antialiases when it shrinks (as `jax.image.resize(..., "linear")` does);
the loss is the L1 distance of the block activations, summed over blocks.
Images and activations are NHWC at the public functions, as in the JAX
package; the convolutions run NCHW inside. The conv parameters keep
torchvision's names (`features.<idx>.weight` OIHW, `.bias`), so a
torchvision `vgg16().features` state_dict loads as it is.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.utils.device import resolve_device

# torchvision vgg16.features conv indices and channels through block 4
_VGG16_CONVS = [(0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
                (17, 512), (19, 512), (21, 512)]
_POOL_BEFORE = {5, 10, 17}     # a 2x2 max pool precedes these convs
_BLOCK_ENDS = {2, 7, 14, 21}   # the block activations after these convs' ReLU

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """The four block activations used by the perceptual loss."""

    def __init__(self):
        super().__init__()
        convs, cin = {}, 3
        for idx, ch in _VGG16_CONVS:
            convs[str(idx)] = nn.Conv2d(cin, ch, 3, padding=1)
            cin = ch
        self.features = nn.ModuleDict(convs)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """LeCun-normal kernels and zero biases (the flax Conv init)."""
        for conv in self.features.values():
            fan_in = conv.weight[0].numel()
            nn.init.normal_(conv.weight, std=fan_in ** -0.5, generator=generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """x [B, H, W, 3] normalized -> four NHWC activations in the compute
        dtype (that of x unless `compute_dtype` is given)."""
        dt = compute_dtype or x.dtype
        h = x.to(dt).permute(0, 3, 1, 2)
        feats = []
        for idx, _ in _VGG16_CONVS:
            if idx in _POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            conv = self.features[str(idx)]
            h = F.relu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), padding=1))
            if idx in _BLOCK_ENDS:
                feats.append(h.permute(0, 2, 3, 1))
        return feats


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device, dtype: torch.dtype):
    """(mean, std) on `device`, made once: a copy from the host cannot run
    while a CUDA graph captures the train step."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def preprocess(img: torch.Tensor, resize: bool = True) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> normalized, 224x224 (HeadNeRFLossUtils.py:45-49)."""
    mean, std = _imagenet_stats(img.device, img.dtype)
    x = (img - mean) / std
    if resize:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(224, 224), mode="bilinear",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return x


def vgg_features(vgg: VGG16Features, img: torch.Tensor, resize: bool = True,
                 compute_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """The four block activations of [B, H, W, 3] in [0, 1], f32. With
    `compute_dtype=torch.bfloat16` the convs run in bf16."""
    return [f.float() for f in vgg(preprocess(img, resize), compute_dtype)]


def vgg_perceptual_loss(
    vgg: VGG16Features,
    pred: torch.Tensor,
    target: Optional[torch.Tensor] = None,
    feature_layers: Sequence[int] = (0, 1, 2, 3),
    resize: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    target_feats: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Sum over blocks of the mean L1 distance (HeadNeRFLossUtils.py:50-64).
    `target_feats` (`vgg_features` of the target, precomputed per frame)
    skips the target branch."""
    fx = vgg_features(vgg, pred, resize, compute_dtype)
    fy = (list(target_feats) if target_feats is not None
          else vgg_features(vgg, target, resize, compute_dtype))
    loss = 0.0
    for i in feature_layers:
        loss = loss + torch.mean(torch.abs(fx[i] - fy[i].float()))
    return loss


def load_vgg16(path: str = "", seed: int = 0,
               device: Optional[Union[str, torch.device]] = None) -> VGG16Features:
    """VGG16 features for the perceptual loss on `device` (default `cuda`):

      * `path`: a torchvision `vgg16().features.state_dict()` (.pth) or an
        .npz of the same keys, or a whole `vgg16()` state_dict (its
        `features.` entries are taken) -> the reference weights
        (HeadNeRFLossUtils.py:27-30 uses torchvision's pretrained VGG16);
      * otherwise a random init from `seed`, the stand-in the JAX package
        also takes: the loss and its gradients flow the same way.
    """
    dev = resolve_device(device)
    vgg = VGG16Features()
    if path:
        if path.endswith(".npz"):
            with np.load(path) as z:
                sd = {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in z.files}
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        if any(k.startswith("features.") for k in sd):
            sd = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
        wanted = {f"{idx}.{p}" for idx, _ in _VGG16_CONVS for p in ("weight", "bias")}
        vgg.features.load_state_dict({k: sd[k].float() for k in wanted})
    else:
        vgg.reset_parameters(torch.Generator().manual_seed(seed))
    return vgg.to(dev).requires_grad_(False)
