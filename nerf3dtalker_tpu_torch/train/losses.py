"""HeadNeRF training losses (port of `nerf3dtalker_tpu/train/losses.py`,
reference `HeadNeRFLossUtils`, Utils/HeadNeRFLossUtils.py:67-236):

  * bg loss      — MSE of the rendered background image against the bg value;
  * head loss    — MSE over head-mask pixels of merge_img against the GT;
  * nonhead loss — MSE of merge_img against the bg value outside the head;
  * vgg loss     — VGG16 perceptual L1 between merge_img and the GT with its
                   background set to the bg value (HeadNeRFLossUtils.py:148-153).

Masked selection (`res_img[mask]`) is a masked mean, as in the JAX package.
The fitting regularizers are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from nerf3dtalker_tpu_torch.models.perceptual import VGG16Features, vgg_perceptual_loss


def _masked_mse(x: torch.Tensor, y, mask: torch.Tensor) -> torch.Tensor:
    """Mean of (x - y)^2 over the mask (broadcast over channels)."""
    se = (x - y) ** 2 * mask
    denom = torch.sum(mask) * x.shape[-1]
    return torch.sum(se) / torch.clamp(denom, min=1.0)


def headnerf_losses(
    pred: Dict[str, torch.Tensor],
    gt_rgb: torch.Tensor,          # [B, H, W, 3] in [0, 1]
    head_mask: torch.Tensor,       # [B, H, W, 1] (>= 0.5 is head)
    bg_value: float = 1.0,
    vgg: Optional[VGG16Features] = None,
    vgg_compute_dtype: Optional[torch.dtype] = None,
    gt_vgg_feats: Optional[Sequence[torch.Tensor]] = None,  # vgg_features(masked GT)
) -> Dict[str, torch.Tensor]:
    """Data losses (HeadNeRFLossUtils.py:125-156) and their sum `total_loss`
    (:196-236)."""
    head = (head_mask >= 0.5).to(gt_rgb.dtype)
    nonhead = 1.0 - head
    res_img = torch.nan_to_num(pred["merge_img"])
    losses = {
        "bg_loss": torch.mean((pred["bg_img"] - bg_value) ** 2),
        "head_loss": _masked_mse(res_img, gt_rgb, head),
        "nonhead_loss": _masked_mse(res_img, bg_value, nonhead),
    }
    if vgg is not None:
        masked_gt = None if gt_vgg_feats is not None else gt_rgb * head + bg_value * nonhead
        losses["vgg"] = vgg_perceptual_loss(vgg, res_img, masked_gt,
                                            compute_dtype=vgg_compute_dtype,
                                            target_feats=gt_vgg_feats)
    losses["total_loss"] = sum(losses.values())
    return losses
