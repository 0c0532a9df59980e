"""HeadNeRF training losses (port of `nerf3dtalker_tpu/train/losses.py`,
reference `HeadNeRFLossUtils`, Utils/HeadNeRFLossUtils.py:67-236):

  * bg loss      — MSE of the rendered background image against the bg value;
  * head loss    — MSE over head-mask pixels of merge_img against the GT;
  * nonhead loss — MSE of merge_img against the bg value outside the head;
  * vgg loss     — VGG16 perceptual L1 between merge_img and the GT with its
                   background set to the bg value (HeadNeRFLossUtils.py:148-153).

Masked selection (`res_img[mask]`) is a masked mean, as in the JAX package.
The fitting objective adds the camera and code regularizers
(`cam_reg_loss`, `code_reg_loss`, weighted by `fitting_total_loss`).

Under a (data, rays) mesh each rank sees B/D frames and every loss is a mean
over the global batch: the masked means divide by the global mask count
(all-reduced over the data group), and the plain means (bg, VGG) are scaled
by B_local / B. The ranks' shares then sum to the single-rank loss, and a
plain sum of their gradients over the data group is the single-rank
gradient. The values returned are the global losses (one more all-reduce),
with the gradient of this rank's share.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from nerf3dtalker_tpu_torch.models.perceptual import VGG16Features, vgg_perceptual_loss


def _masked_mse(x: torch.Tensor, y, mask: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of (x - y)^2 over the mask (broadcast over channels); `count`,
    where given, is the mask's sum over every rank's frames."""
    se = (x - y) ** 2 * mask
    denom = (torch.sum(mask) if count is None else count) * x.shape[-1]
    return torch.sum(se) / torch.clamp(denom, min=1.0)


def _global_values(losses: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each loss with the value summed over `group` (one all-reduce) and the
    gradient of this rank's own share."""
    local = torch.stack([v.detach() for v in losses.values()])
    total = local.clone()
    dist.all_reduce(total, group=group)
    return {k: v + (total[i] - local[i]) for i, (k, v) in enumerate(losses.items())}


def headnerf_losses(
    pred: Dict[str, torch.Tensor],
    gt_rgb: torch.Tensor,          # [B, H, W, 3] in [0, 1]
    head_mask: torch.Tensor,       # [B, H, W, 1] (>= 0.5 is head)
    bg_value: float = 1.0,
    vgg: Optional[VGG16Features] = None,
    vgg_compute_dtype: Optional[torch.dtype] = None,
    gt_vgg_feats: Optional[Sequence[torch.Tensor]] = None,  # vgg_features(masked GT)
    data_group=None,               # the mesh's data group: this rank holds B/D frames
) -> Dict[str, torch.Tensor]:
    """Data losses (HeadNeRFLossUtils.py:125-156) and their sum `total_loss`
    (:196-236); global means over a mesh's data group when one is given."""
    head = (head_mask >= 0.5).to(gt_rgb.dtype)
    nonhead = 1.0 - head
    res_img = torch.nan_to_num(pred["merge_img"])
    share, counts = 1.0, (None, None)
    if data_group is not None:
        share = 1.0 / dist.get_world_size(data_group)
        total = torch.stack([head.sum(), nonhead.sum()])
        dist.all_reduce(total, group=data_group)
        counts = (total[0], total[1])
    losses = {
        "bg_loss": torch.mean((pred["bg_img"] - bg_value) ** 2) * share,
        "head_loss": _masked_mse(res_img, gt_rgb, head, counts[0]),
        "nonhead_loss": _masked_mse(res_img, bg_value, nonhead, counts[1]),
    }
    if vgg is not None:
        masked_gt = None if gt_vgg_feats is not None else gt_rgb * head + bg_value * nonhead
        losses["vgg"] = vgg_perceptual_loss(vgg, res_img, masked_gt,
                                            compute_dtype=vgg_compute_dtype,
                                            target_feats=gt_vgg_feats) * share
    losses["total_loss"] = sum(losses.values())
    return losses if data_group is None else _global_values(losses, data_group)


def cam_reg_loss(delta_euler: torch.Tensor, delta_tvec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Camera-offset regularizers of a fit (HeadNeRFLossUtils.py:88-96);
    the key keeps the reference's spelling."""
    return {"delta_eular": torch.mean(delta_euler ** 2),
            "delta_tvec": torch.mean(delta_tvec ** 2)}


def code_reg_loss(iden: torch.Tensor, expr: torch.Tensor, appea: torch.Tensor,
                  bg: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Latent-offset regularizers of a fit (HeadNeRFLossUtils.py:99-122)."""
    return {"iden_code": torch.mean(iden ** 2),
            "expr_code": torch.mean(expr ** 2),
            "appea_code": torch.mean(appea ** 2),
            "bg_code": torch.mean(bg ** 2) if bg is not None else iden.new_zeros(())}


def fitting_total_loss(data_losses: Dict[str, torch.Tensor], cam_losses: Dict[str, torch.Tensor],
                       code_losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The weighted fitting objective (HeadNeRFLossUtils.py:209-220): 0.001
    on each camera term and on the iden and appearance codes, 1.0 on expr,
    0.01 on bg."""
    total = data_losses["total_loss"]
    total = total + 0.001 * cam_losses["delta_eular"] + 0.001 * cam_losses["delta_tvec"]
    return (total + 0.001 * code_losses["iden_code"] + 1.0 * code_losses["expr_code"]
            + 0.001 * code_losses["appea_code"] + 0.01 * code_losses["bg_code"])
