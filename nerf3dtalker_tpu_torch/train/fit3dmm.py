"""Offline per-image nonlinear-3DMM fitting (port of
`nerf3dtalker_tpu/train/fit3dmm.py`; reference Fitting3DMM/FittingNL3DMM.py:
24-280 with the losses of Utils/FittingNL3DMM_LossUtils.py:6-110).

Two stages of Adam over the differentiable rasterizer: the pose alone, then
pose, identity, expression, texture and illumination together. Each stage
starts a fresh `torch.optim.Adam(lr)` (optax.adam's defaults: betas 0.9 /
0.999, eps 1e-8 added after the square root) over its free leaves; the
frozen leaves are detached, and the decoders' weights take no gradient.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from nerf3dtalker_tpu_torch.models.face3d.nl3dmm import (
    POINT_NUM,
    Linear3DMMTexture,
    NonLinear3DMM,
    render_nl3dmm,
)
from nerf3dtalker_tpu_torch.utils.rotations import euler_to_rmat


def landmark_weights(device=None) -> torch.Tensor:
    """The 68 landmark weights (FittingNL3DMM_LossUtils.py:22-27): nose
    bridge (28:31) and mouth (-8:) x20, normalized."""
    w = torch.ones(68, device=device)
    w[28:31] = 20
    w[-8:] = 20
    return w / w.sum()


def fitting_losses(render, gt_imgs, head_mask, gt_lm2d, vert_colors, skinmask,
                   iden, expr, text, gamma, lm_w: float = 0.5) -> Dict[str, torch.Tensor]:
    """The weighted total (FittingNL3DMM_LossUtils.py:81-110) and its terms."""
    mask = head_mask * render.mask[..., None]
    denom = torch.clamp_min(mask.sum() * 3, 1.0)
    img_loss = (((render.image - gt_imgs) ** 2) * mask).sum() / denom

    lmw = landmark_weights(gt_lm2d.device)
    lm_loss = (((render.lm2d - gt_lm2d) ** 2).sum(dim=-1) * lmw).sum() \
        / (gt_lm2d.shape[0] * gt_lm2d.shape[1])

    g = gamma.reshape(-1, 9, 3)
    illu_loss = ((g - g.mean(dim=2, keepdim=True)) ** 2).mean()

    code_loss = 2.5 * ((iden ** 2).mean() + (expr ** 2).mean() + (text ** 2).mean())

    sm = skinmask.reshape(1, -1, 1)
    valid = torch.clamp_min(sm.sum(), 1.0)
    cmean = (vert_colors * sm).sum(dim=1, keepdim=True) / valid
    skin_loss = (((vert_colors - cmean) ** 2) * sm).sum() / (vert_colors.shape[0] * valid)

    total = (img_loss * 10.0 + lm_loss * lm_w + illu_loss * 0.01
             + code_loss * 0.001 + skin_loss * 0.1)
    return {"img": img_loss, "lm": lm_loss, "illu": illu_loss, "code_regu": code_loss,
            "skin": skin_loss, "total_loss": total}


class Fit3DMMResult(NamedTuple):
    iden: torch.Tensor
    expr: torch.Tensor
    text: torch.Tensor
    gamma: torch.Tensor
    euler: torch.Tensor
    tvec: torch.Tensor
    losses: Dict[str, float]

    def code(self) -> torch.Tensor:
        """The 306-d code saved per image (FittingNL3DMM.py:224-259:
        iden|expr|text|illu)."""
        return torch.cat([self.iden, self.expr, self.text, self.gamma], dim=-1)

    def w2c(self):
        return euler_to_rmat(self.euler), self.tvec


POSE = ("euler", "tvec")
EVERYTHING = ("euler", "tvec", "iden", "expr", "text", "gamma")


def fit_3dmm(geo: NonLinear3DMM, tex: Linear3DMMTexture,
             gt_imgs: torch.Tensor,        # [B, H, W, 3]
             head_mask: torch.Tensor,      # [B, H, W, 1]
             gt_lm2d: torch.Tensor,        # [B, 68, 2]
             inmat: torch.Tensor,          # [B, 3, 3]
             faces: torch.Tensor, lm_index: torch.Tensor,
             skinmask: Optional[torch.Tensor] = None,
             init_euler: Optional[torch.Tensor] = None,
             init_tvec: Optional[torch.Tensor] = None,
             stage1_iters: int = 50, stage2_iters: int = 200,
             lr1: float = 0.01, lr2: float = 0.01, chunk: int = 512) -> Fit3DMMResult:
    """The two-stage fit (FittingNL3DMM.py:92-221) on the inputs' device:
    the fitted codes and camera, and the losses at the end."""
    B, H, W, _ = gt_imgs.shape
    dev = gt_imgs.device
    if skinmask is None:
        skinmask = torch.ones(POINT_NUM, device=dev)
    zeros = lambda n: torch.zeros(B, n, device=dev)   # noqa: E731
    state = {"iden": zeros(100), "expr": zeros(79), "text": zeros(100), "gamma": zeros(27),
             "euler": init_euler.detach().clone() if init_euler is not None else zeros(3),
             "tvec": init_tvec.detach().clone() if init_tvec is not None
             else torch.tensor([[0.0, 0.0, 5.0]], device=dev).repeat(B, 1)}

    def forward(s):
        render = render_nl3dmm(geo, tex, s["iden"], s["expr"], s["text"], s["gamma"],
                               euler_to_rmat(s["euler"]), s["tvec"], inmat, faces, lm_index,
                               H, W, chunk=chunk)
        return fitting_losses(render, gt_imgs, head_mask, gt_lm2d, tex(s["text"]), skinmask,
                              s["iden"], s["expr"], s["text"], s["gamma"])

    def run_stage(s, keys: Sequence[str], iters: int, lr: float):
        free = [s[k].detach().clone().requires_grad_(True) for k in keys]
        frozen = {k: v.detach() for k, v in s.items() if k not in keys}
        opt = torch.optim.Adam(free, lr=lr)
        for _ in range(iters):
            loss = forward({**frozen, **dict(zip(keys, free))})["total_loss"]
            for p, g in zip(free, torch.autograd.grad(loss, free)):
                p.grad = g
            opt.step()
        return {**frozen, **{k: p.detach() for k, p in zip(keys, free)}}

    state = run_stage(state, POSE, stage1_iters, lr1)          # FittingNL3DMM.py:107-160
    state = run_stage(state, EVERYTHING, stage2_iters, lr2)    # FittingNL3DMM.py:162-214
    with torch.no_grad():
        losses = {k: float(v) for k, v in forward(state).items()}
    return Fit3DMMResult(iden=state["iden"], expr=state["expr"], text=state["text"],
                         gamma=state["gamma"], euler=state["euler"], tvec=state["tvec"],
                         losses=losses)
