"""How precise are a fit's gradients? The gradient of the fitting objective
at its first iteration, on each FitVar, through each render path, against
the plain path in f64; and K2's input gradients alone (d_pe, d_zd, d_zv on
the same output cotangents, each pushed back through the rays to the
camera) from the kernel, its plain version in bf16 and in f32, against f64
autograd through the plain forward.

The model is a seeded, untrained HeadNeRF; the target is its own render at
a camera offset, and the fit's base iden is off by 0.1. Paths: `kernels`
(K1/K2 in bf16, on the GPU), `plain_bf16` (the plain autograd path in
bf16), `plain_f32`; the reference is the plain path in f64. With
`--fit-iters N` each path also runs `fit_single_image` for N iterations,
and the camera deltas it recovers are printed beside the offset.

    python -m nerf3dtalker_tpu_torch.scripts.fit_precision --seed 1 --fit-iters 300
    python -m nerf3dtalker_tpu_torch.scripts.fit_precision --scale tiny --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from nerf3dtalker_tpu_torch.config import reso64
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.ops.compositing import CompositeResult
from nerf3dtalker_tpu_torch.ops.embedding import positional_encoding_rays
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
from nerf3dtalker_tpu_torch.ops.rays import gen_rays, sample_points, stratified_zvals
from nerf3dtalker_tpu_torch.train import fitting
from nerf3dtalker_tpu_torch.train.losses import headnerf_losses
from nerf3dtalker_tpu_torch.utils.camera import base_cam
from nerf3dtalker_tpu_torch.utils.device import resolve_device

OFFSET_EULER, OFFSET_T = (0.05, -0.05, 0.0), (0.1, 0.0, 0.0)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def model_at(cfg, dtype: torch.dtype, fused: bool, seed: int, dev) -> HeadNeRF:
    """The seeded model in `dtype` (f64: the f32 init cast, every module
    computing in f64)."""
    build = torch.float32 if dtype == torch.float64 else dtype
    model = HeadNeRF(cfg, compute_dtype=build, use_fused=fused, device=dev,
                     generator=torch.Generator().manual_seed(seed)).eval()
    if dtype == torch.float64:
        model.double()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    return model


def problem_at(model: HeadNeRF, target, codes, cam, dtype=torch.float32) -> fitting.FitProblem:
    problem = fitting.FitProblem(model, target, np.ones_like(target[..., :1]), codes, cam,
                                 np.zeros((1, model.cfg.audio_style_dims), np.float32))
    for name in ("gt", "mask", "audio_style", "xy"):
        setattr(problem, name, getattr(problem, name).to(dtype))
    problem.codes = {k: v.to(dtype) for k, v in problem.codes.items()}
    problem.cam = {k: v.to(dtype) for k, v in problem.cam.items()}
    return problem


SOURCES = ("kernel", "plain_bf16", "plain_f32", "autograd_f64")


def k2_camera_grads(model: HeadNeRF, problem: fitting.FitProblem, sources=SOURCES) -> dict:
    """K2's input gradients at the fit's first iteration and the camera
    gradients they carry, from each of `sources`: `kernel` (on the GPU),
    its plain version in bf16 or f32, or f64 autograd through the plain
    forward. All take the same output cotangents, those of K1's forward
    (its plain version on the CPU) through the decoder and the losses.
    Returns {source: (d_pe, d_zd, [d ΔEuler, d ΔT])}."""
    cfg = model.cfg
    fit = fitting.init_fit_vars(problem.xy.device)
    cam = [fit.delta_euler.requires_grad_(), fit.delta_tvec.requires_grad_()]
    with fitting.frozen(model):
        shape, appea, Rmat, Tvec = fitting.apply_fit_vars(fit, problem.codes, problem.cam)
        rays = gen_rays(problem.xy, Rmat, Tvec, problem.cam["inv_inmat"])
        sp = sample_points(rays, stratified_zvals(rays, cfg.num_sample_coarse, cfg.world_z1,
                                                  cfg.world_z2))
        pe = positional_encoding_rays(rays.origins, rays.directions, rays.lengths, sp.zvals,
                                      cfg.vp_n_freqs, cfg.vp_include_input,
                                      pad_to=fr.pe_pad_for(cfg.vp_pe_dims))
        ins = [t.detach().contiguous() for t in (pe, sp.z_dists, sp.zvals)]
        with torch.no_grad():
            packed = fr.pack_weights(dict(model.fg_CD_predictor.named_parameters()), shape,
                                     appea, problem.audio_style)
            maps = fr.fused_render_fwd(*ins, packed)
        leaves = [t.clone().requires_grad_() for t in maps]
        pred = model._render_maps(CompositeResult(*leaves, None), 1, cfg.featmap_size)
        total = headnerf_losses(pred, problem.gt, problem.mask, problem.bg_value)["total_loss"]
        cot = [torch.zeros_like(t) if g is None else g.contiguous() for g, t in
               zip(torch.autograd.grad(total, leaves, allow_unused=True), leaves)]
        out = {}
        for name in sources:
            if name == "autograd_f64":
                ins64 = [t.double().requires_grad_() for t in ins]
                outs = fr.reference_render(*ins64, {k: v.double() for k, v in packed.items()},
                                           torch.float64)
                d = torch.autograd.grad(outs, ins64, [c.double() for c in cot])
            else:
                with torch.no_grad():
                    d = (fr.fused_render_bwd(*ins, packed, *cot, input_grads=True)
                         if name == "kernel" else
                         fr.reference_render_bwd(*ins, packed, *cot, {
                             "plain_bf16": torch.bfloat16,
                             "plain_f32": torch.float32}[name], input_grads=True))[:3]
            grads = torch.autograd.grad([pe, sp.z_dists, sp.zvals], cam,
                                        [t.float() for t in d], retain_graph=True,
                                        allow_unused=True)
            out[name] = (d[0][..., :cfg.vp_pe_dims], d[1],   # the PE's padding takes none
                         [torch.zeros_like(c) if g is None else g for g, c in zip(grads, cam)])
    return out


def k2_input_grads_vs_f64(model: HeadNeRF, problem: fitting.FitProblem, on_card: bool) -> dict:
    """Relative L2 of each source's d_pe, d_zd and camera gradients against
    f64 autograd."""
    grads = k2_camera_grads(model, problem, SOURCES if on_card else SOURCES[1:])
    ref = grads.pop("autograd_f64")
    return {name: {"d_pe": rel_l2(d[0], ref[0]), "d_zd": rel_l2(d[1], ref[1]),
                   "delta_euler": rel_l2(d[2][0], ref[2][0]),
                   "delta_tvec": rel_l2(d[2][1], ref[2][1])}
            for name, d in grads.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1, help="the model's init")
    ap.add_argument("--scale", choices=["reso64", "tiny"], default="reso64",
                    help="tiny: featmap 8, image 32 (full width)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=0,
                    help="also fit this many iterations through each path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg = reso64()
    if args.scale == "tiny":
        cfg = dataclasses.replace(cfg, featmap_size=8, pred_img_size=32)
    g = torch.Generator().manual_seed(args.seed + 1)
    codes = {k: (torch.randn(1, n, generator=g) * 0.1).numpy()
             for k, n in (("iden", 100), ("expr", 79), ("text", 100), ("illu", 27))}
    cam = base_cam(cfg.featmap_size)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    f32 = model_at(cfg, torch.float32, False, args.seed, dev)
    offset = fitting.FitVars(*(torch.zeros(1, n, device=dev) for n in (100, 79, 127)),
                             torch.tensor([OFFSET_EULER], device=dev),
                             torch.tensor([OFFSET_T], device=dev))
    with torch.no_grad():
        first = problem_at(f32, np.zeros((1, cfg.pred_img_size, cfg.pred_img_size, 3),
                                         np.float32), codes, cam_d)
        shape, appea, Rmat, Tvec = fitting.apply_fit_vars(offset, first.codes, first.cam)
        out = f32(first.xy, shape, appea, first.audio_style, Rmat, Tvec,
                  first.cam["inv_inmat"])
    target = out["merge_img"].clamp(0, 1).cpu().numpy()
    base = dict(codes, iden=codes["iden"] + 0.1)
    paths = {"plain_bf16": (torch.bfloat16, False), "plain_f32": (torch.float32, False),
             "plain_f64": (torch.float64, False)}
    if on_card:
        paths = {"kernels": (torch.bfloat16, True), **paths}
    grads = {}
    for name, (dtype, fused) in paths.items():
        model = model_at(cfg, dtype, fused, args.seed, dev)
        problem = problem_at(model, target, base, cam_d,
                             torch.float64 if dtype == torch.float64 else torch.float32)
        fit = fitting.FitVars(*(v.to(problem.xy.dtype) for v in fitting.init_fit_vars(dev)))
        grads[name] = problem.gradients(fit)[2]
    ref = grads.pop("plain_f64")
    rec = {"seed": args.seed, "scale": args.scale, "device": str(dev),
           "opacity": 1.0 - float(out["bg_alpha"].mean()),
           "fit_gradient_vs_f64": {name: {k: rel_l2(a, b) for k, a, b in
                                          zip(fitting.FitVars._fields, g, ref)}
                                   for name, g in grads.items()},
           "k2_input_grads_vs_f64": k2_input_grads_vs_f64(
               model_at(cfg, torch.bfloat16, on_card, args.seed, dev),
               problem_at(f32, target, base, cam_d), on_card)}
    if on_card:
        rec["kernels_vs_plain_bf16"] = {k: rel_l2(a, b) for k, a, b in zip(
            fitting.FitVars._fields, grads["kernels"], grads["plain_bf16"])}
    if args.fit_iters:
        rec["offset"] = {"delta_euler": OFFSET_EULER, "delta_tvec": OFFSET_T, "iden": -0.1}
        rec["fits"] = {}
        for name in grads:
            dtype, fused = paths[name]
            fit, losses = fitting.fit_single_image(
                model_at(cfg, dtype, fused, args.seed, dev), target,
                np.ones_like(target[..., :1]), base, cam_d,
                np.zeros((1, cfg.audio_style_dims), np.float32), iters=args.fit_iters)
            rec["fits"][name] = {"delta_euler": fit.delta_euler[0].tolist(),
                                 "delta_tvec": fit.delta_tvec[0].tolist(),
                                 "iden_offset_mean": float(fit.iden_offset.mean()), **losses}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
