"""Single-image latent and camera fitting, the inference entry (port of
`nerf3dtalker_tpu/train/fitting.py`, reference `FittingImage`,
FittingSingleImage_new.py:620-997).

Given one image, its mask and its 3DMM codes, `fit_single_image` runs Adam
over offsets of the iden, expr and appearance codes and over camera deltas
(ΔEuler, ΔT) (perform_fitting :825-903; per-group learning rates :846-860,
decayed by 0.1^(it/iters) :862-864), minimizing the photometric losses plus
the camera and code regularizers. The model's weights stay frozen. Then
`render_novel_views` orbits the fitted subject on the 45-camera rig and
`render_morphing` interpolates between codes (save_res :918-966).

The JAX package runs the whole loop as one `lax.fori_loop` under one jit;
here it is a plain loop of `iters` steps. On the GPU a model built with
`use_fused` renders each step through the forward kernel and its backward
through the backward kernel with input gradients (the camera's gradient
reaches the rays through d_pe, d_zd and d_zv).
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.models.perceptual import VGG16Features
from nerf3dtalker_tpu_torch.train.losses import (cam_reg_loss, code_reg_loss,
                                                 fitting_total_loss, headnerf_losses)
from nerf3dtalker_tpu_torch.utils.camera import CamInfo, orbit_cams, ray_grid
from nerf3dtalker_tpu_torch.utils.rotations import euler_to_rmat


class FitVars(NamedTuple):
    """The optimized offsets (FittingSingleImage_new.py:825-840)."""

    iden_offset: torch.Tensor    # [1, 100]
    expr_offset: torch.Tensor    # [1, 79]
    appea_offset: torch.Tensor   # [1, 127]
    delta_euler: torch.Tensor    # [1, 3]
    delta_tvec: torch.Tensor     # [1, 3]


# each group's share of the initial learning rate (FittingSingleImage_new.py:846-860)
GROUP_SCALE = {"iden_offset": 1.5, "expr_offset": 1.5, "appea_offset": 1.0,
               "delta_euler": 0.1, "delta_tvec": 0.1}


def init_fit_vars(device=None) -> FitVars:
    return FitVars(*(torch.zeros((1, n), dtype=torch.float32, device=device)
                     for n in (100, 79, 127, 3, 3)))


def make_fit_optimizer(fit: FitVars, init_lr: float = 0.01, iters: int = 300):
    """(Adam over the five groups at GROUP_SCALE x init_lr, a LambdaLR that
    decays every group by 0.1^(it/iters)). Call the scheduler's `step` after
    the optimizer's: update `it` (from 0) then uses 0.1^(it/iters), as
    optax's `scale_by_schedule` counts from 0. Adam's epsilon, 1e-8, is
    added after the square root, as optax's `scale_by_adam` adds it."""
    opt = torch.optim.Adam(
        [{"params": [getattr(fit, k)], "lr": init_lr * s} for k, s in GROUP_SCALE.items()],
        betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda it: 0.1 ** (it / iters))
    return opt, sched


def apply_fit_vars(fit: FitVars, base_codes: Dict[str, torch.Tensor],
                   base_cam: Dict[str, torch.Tensor],
                   audio_exp: Optional[torch.Tensor] = None):
    """(shape_code, appea_code, Rmat, Tvec) from the base codes and camera
    plus the offsets (build_code_and_cam, FittingSingleImage_new.py:769-816):
    dR = euler_to_rmat(ΔEuler), R = dR R0, T = dR T0 + ΔT; `audio_exp`
    overwrites expr[:, :64]."""
    expr = base_codes["expr"]
    if audio_exp is not None:
        expr = torch.cat([audio_exp, expr[:, audio_exp.shape[-1]:]], dim=-1)
    shape_code = torch.cat([base_codes["iden"] + fit.iden_offset, expr + fit.expr_offset], -1)
    appea_code = torch.cat([base_codes["text"], base_codes["illu"]], -1) + fit.appea_offset
    dR = euler_to_rmat(fit.delta_euler)
    Rmat = dR @ base_cam["Rmat"]
    Tvec = (dR @ base_cam["Tvec"][..., None])[..., 0] + fit.delta_tvec
    return shape_code, appea_code, Rmat, Tvec


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _f32(a, device) -> torch.Tensor:
    """An array or tensor as an f32 tensor on `device`."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


@contextlib.contextmanager
def frozen(model: torch.nn.Module):
    """The model's parameters with requires_grad off for the block (their
    flags restored after): no weight gradient is asked for or kept."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


class FitProblem:
    """One image's fitting objective on a model: the fixed inputs on the
    model's device, and `losses(fit)` -> (total, data losses)."""

    def __init__(self, model: HeadNeRF, gt_rgb, head_mask, base_codes: Dict, base_cam: Dict,
                 audio_style, audio_exp=None, vgg: Optional[VGG16Features] = None):
        dev = _device_of(model)
        self.model, self.vgg = model, vgg
        self.xy = _f32(ray_grid(model.cfg.featmap_size)[0], dev)
        self.gt, self.mask, self.audio_style = (_f32(a, dev)
                                                for a in (gt_rgb, head_mask, audio_style))
        self.audio_exp = None if audio_exp is None else _f32(audio_exp, dev)
        self.codes = {k: _f32(v, dev) for k, v in base_codes.items()}
        self.cam = {k: _f32(v, dev) for k, v in base_cam.items()}
        self.bg_value = 1.0 if model.cfg.bg_type == "white" else 0.0

    def losses(self, fit: FitVars) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        shape_code, appea_code, Rmat, Tvec = apply_fit_vars(fit, self.codes, self.cam,
                                                            self.audio_exp)
        pred = self.model(self.xy, shape_code, appea_code, self.audio_style, Rmat, Tvec,
                          self.cam["inv_inmat"])
        data = headnerf_losses(pred, self.gt, self.mask, bg_value=self.bg_value, vgg=self.vgg)
        cam = cam_reg_loss(fit.delta_euler, fit.delta_tvec)
        code = code_reg_loss(fit.iden_offset, fit.expr_offset, fit.appea_offset)
        return fitting_total_loss(data, cam, code), data

    def gradients(self, fit: FitVars, opt_cam: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], FitVars]:
        """(total, data losses, d total / d each FitVar). Without `opt_cam`
        the camera deltas get zero gradients (reference :839-843), and the
        render is differentiated with respect to the codes alone."""
        leaves = [v.detach().requires_grad_(i < 3 or opt_cam) for i, v in enumerate(fit)]
        live = [v for v in leaves if v.requires_grad]
        with frozen(self.model):
            total, data = self.losses(FitVars(*leaves))
            grads = iter(torch.autograd.grad(total, live))
        return total.detach(), {k: v.detach() for k, v in data.items()}, FitVars(
            *(next(grads) if v.requires_grad else torch.zeros_like(v) for v in leaves))


def fit_iteration(problem: FitProblem, fit: FitVars, opt, sched, opt_cam: bool = True) -> None:
    """One Adam step of the fit: the gradients of `problem` at `fit`, then
    the optimizer and its schedule (`make_fit_optimizer`)."""
    _, _, grads = problem.gradients(fit, opt_cam)
    for v, g in zip(fit, grads):
        v.grad = g
    opt.step()
    sched.step()


def fit_single_image(
    model: HeadNeRF,
    gt_rgb,                       # [1, H, W, 3]
    head_mask,                    # [1, H, W, 1]
    base_codes: Dict,             # iden [1,100], expr [1,79], text [1,100], illu [1,27]
    base_cam: Dict,               # Rmat [1,3,3], Tvec [1,3], inv_inmat [1,3,3]
    audio_style,                  # [1, 64]
    audio_exp=None,               # [1, 64]
    iters: int = 300,
    init_lr: float = 0.01,
    vgg: Optional[VGG16Features] = None,
    opt_cam: bool = True,
) -> Tuple[FitVars, Dict[str, float]]:
    """Fit the offsets for `iters` Adam steps on the model's device, then
    one more forward: returns (the fitted FitVars, its losses as floats)."""
    problem = FitProblem(model, gt_rgb, head_mask, base_codes, base_cam, audio_style,
                         audio_exp, vgg)
    fit = init_fit_vars(_device_of(model))
    opt, sched = make_fit_optimizer(fit, init_lr, iters)
    for _ in range(iters):
        fit_iteration(problem, fit, opt, sched, opt_cam)
    with torch.no_grad():
        _, losses = problem.losses(fit)
    return FitVars(*(v.detach() for v in fit)), {k: float(v) for k, v in losses.items()}


def _render(model: HeadNeRF, shape_code, appea_code, audio_style, cam: CamInfo,
            gaze=None) -> np.ndarray:
    """One B=1 render's merge image [H, W, 3] (numpy)."""
    dev = _device_of(model)
    args = (ray_grid(model.cfg.featmap_size)[0], shape_code, appea_code, audio_style, cam.Rmat,
            cam.Tvec, cam.inv_inmat)
    out = model(*(_f32(a, dev) for a in args), gaze=None if gaze is None else _f32(gaze, dev))
    return out["merge_img"][0].float().cpu().numpy()


@torch.inference_mode()
def render_novel_views(model: HeadNeRF, shape_code, appea_code, audio_style,
                       view_num: int = 45) -> np.ndarray:
    """The orbit render (RenderUtils.py:110-128), one view at a time ->
    [V, H, W, 3]."""
    cams = orbit_cams(view_num, model.cfg.featmap_size)
    return np.stack([_render(model, shape_code, appea_code, audio_style, c) for c in cams])


@torch.inference_mode()
def render_morphing(model: HeadNeRF, code_a, code_b, appea_code, audio_style, cam: CamInfo,
                    steps: int = 15) -> np.ndarray:
    """Latent interpolation from `code_a` to `code_b` (RenderUtils.py
    morphing loop; FittingSingleImage_new.py:918-966) -> [steps, H, W, 3]."""
    a, b = np.asarray(code_a, np.float32), np.asarray(code_b, np.float32)
    return np.stack([
        _render(model, a * (np.float32(1.0) - t) + b * t, appea_code, audio_style, cam)
        for t in np.linspace(0.0, 1.0, steps).astype(np.float32)])


def gaze_angle_error(input_gaze: np.ndarray, estimated_gaze: np.ndarray):
    """(vertical, horizontal) absolute gaze angle errors
    (Utils/RenderUtils.py:158-162 calculate_angle_error)."""
    err = np.abs(np.asarray(input_gaze) - np.asarray(estimated_gaze))
    return float(err[0]), float(err[1])


@torch.inference_mode()
def render_with_gaze(model: HeadNeRF, shape_code, appea_code, audio_style, cam: CamInfo,
                     gazes: np.ndarray, scale_factor: float = 1.0) -> np.ndarray:
    """Gaze-redirected renders (Utils/RenderUtils.py:164-220
    render_face_with_gaze): each gaze (pitch, yaw), tiled to the model's
    gaze dim and scaled, is the frame's gaze input. Needs a model with
    cfg.include_gaze."""
    cfg = model.cfg
    if not cfg.include_gaze:
        raise ValueError("render_with_gaze needs a model with cfg.include_gaze")
    out = []
    for g in np.asarray(gazes, np.float32):
        feat = np.tile(g, cfg.eye_gaze_dim // len(g)) * np.float32(scale_factor)
        out.append(_render(model, shape_code, appea_code, audio_style, cam, gaze=feat[None]))
    return np.stack(out)
