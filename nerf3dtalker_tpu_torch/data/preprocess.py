"""Offline subject preprocessing (port of
`nerf3dtalker_tpu/data/preprocess.py`; reference DataProcess/
Gen_mask_lm_3DMM.py:33-266 plus what the reference's data loader computed
per item, XGaze_utils/data_loader_xgaze_new.py:938-1066, run once ahead of
training).

Per subject:
  1. head masks           — BiSeNet parsing (models/bisenet.py)
  2. 68 landmarks         — FAN (models/fan.py)
  3. 3DMM codes + camera  — the two-stage fit (train/fit3dmm.py)
  4. per-frame mel chunks — data/mel.py
  5. audio expressions    — SadTalker's netG (models/audio.py)
  6. blink ratios         — mel.blink_ratio_sequence

into the arrays of `data.dataset.REQUIRED_KEYS` (and `lm2d`, `ratios`),
saved as one .npz a subject that `cli train --data` reads. A stage without
its applier leaves a placeholder (all-foreground masks, centred landmarks,
zero codes at the base camera, zero expressions) unless `strict=True`,
which raises instead. `build_appliers` wires the networks on a device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# frames a network applier evaluates at once
FRAMES_PER_CALL = 16


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def preprocess_subject(
    images: np.ndarray,            # [T, H, W, 3] float in [0, 1]
    wav: np.ndarray,               # [n_samples] 16 kHz audio
    bisenet_apply: Optional[Callable] = None,   # images -> parsing argmax [T, H, W]
    fan_apply: Optional[Callable] = None,       # images -> [T, 68, 2]
    netg_apply: Optional[Callable] = None,      # (mels, ref64, ratios) -> [T, 64]
    fit3dmm_fn: Optional[Callable] = None,      # (images, masks, lms) -> Fit3DMMResult
    featmap_size: int = 32,
    seed: int = 0,
    strict: bool = False,
) -> Dict[str, np.ndarray]:
    """One subject's training arrays (numpy, f32)."""
    if strict:
        missing = [n for n, fn in [("bisenet_apply", bisenet_apply), ("fan_apply", fan_apply),
                                   ("netg_apply", netg_apply), ("fit3dmm_fn", fit3dmm_fn)]
                   if fn is None]
        if missing:
            raise ValueError(f"strict preprocessing: missing model stages {missing}")
    from nerf3dtalker_tpu_torch.data.mel import blink_ratio_sequence, per_frame_mel_chunks
    from nerf3dtalker_tpu_torch.utils.camera import base_cam

    T, H, W, _ = images.shape
    rng = np.random.default_rng(seed)
    f32 = np.float32

    # 1. masks
    if bisenet_apply is not None:
        from nerf3dtalker_tpu_torch.models.bisenet import (
            correct_head_mask,
            head_mask_from_parsing,
        )

        masks = _np(head_mask_from_parsing(torch.as_tensor(_np(bisenet_apply(images)))))
        masks = np.stack([correct_head_mask(m) for m in masks])[..., None]
    else:
        masks = np.ones((T, H, W, 1), f32)

    # 2. landmarks
    lms = (_np(fan_apply(images)) if fan_apply is not None
           else np.tile(np.array([[W / 2, H / 2]], f32), (T, 68, 1)))

    # 4. mels (before 3, so that netG can run) and 6. blink ratios
    mels = per_frame_mel_chunks(wav)
    Tm = min(T, len(mels))
    mels = mels[:Tm]
    ratios = blink_ratio_sequence(Tm, rng)[:, 0]

    # 3. the 3DMM fit
    if fit3dmm_fn is not None:
        from nerf3dtalker_tpu_torch.utils.rotations import euler_to_rmat

        fit = fit3dmm_fn(images[:Tm], masks[:Tm], lms[:Tm])
        iden, expr, text, illu = (_np(v) for v in (fit.iden, fit.expr, fit.text, fit.gamma))
        Rm = _np(euler_to_rmat(torch.as_tensor(fit.euler)))
        Tv = _np(fit.tvec)
    else:
        iden, expr = np.zeros((Tm, 100), f32), np.zeros((Tm, 79), f32)
        text, illu = np.zeros((Tm, 100), f32), np.zeros((Tm, 27), f32)
        cam = base_cam(featmap_size)
        Rm = np.tile(cam.Rmat, (Tm, 1, 1))
        Tv = np.tile(cam.Tvec.reshape(1, 3), (Tm, 1))

    # 5. audio expressions (SadTalker's netG over the frame-0 reference)
    if netg_apply is not None:
        from nerf3dtalker_tpu_torch.train.audio2exp_trainer import select_expr64

        ref64 = _np(select_expr64(torch.as_tensor(expr[:1])))[0]
        audio_exp = _np(netg_apply(mels, ref64, ratios))
    else:
        audio_exp = np.zeros((Tm, 64), f32)

    cam = base_cam(featmap_size)
    return {
        "images": images[:Tm].astype(f32),
        "head_mask": masks[:Tm].astype(f32),
        "mels": mels.astype(f32),
        "audio_exp": audio_exp.astype(f32),
        "iden": iden.astype(f32),
        "expr": expr.astype(f32),
        "text": text.astype(f32),
        "illu": illu.astype(f32),
        "Rmat": Rm.astype(f32),
        "Tvec": Tv.astype(f32),
        "inv_inmat": np.tile(cam.inv_inmat, (Tm, 1, 1)).astype(f32),
        "lm2d": lms[:Tm].astype(f32),
        "ratios": ratios.astype(f32),
    }


def grid_mesh(G: int):
    """The G x G planar grid's triangles [2 (G-1)^2, 3] (int64), two a cell."""
    tri = []
    for r in range(G - 1):
        for c in range(G - 1):
            i = r * G + c
            tri += [[i, i + 1, i + G], [i + 1, i + G + 1, i + G]]
    return torch.tensor(tri, dtype=torch.int64)


def _frames_nchw(images, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(images, np.float32), device=dev).permute(0, 3, 1, 2)


def linear_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """`jax.image.resize(..., "linear")` of NCHW images: half-pixel
    centres, a triangle filter widened to antialias when it shrinks."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False, antialias=True)


def build_appliers(
    image_size: int,
    seed: int = 0,
    weights: Optional[Dict] = None,
    mesh_grid: int = 7,
    fit_iters: tuple = (50, 200),
    device=None,
) -> Dict[str, Callable]:
    """The four preprocessing stages as appliers over the port's networks
    on `device` (default `cuda`).

    `weights` may give the port's state dicts by stage ({"bisenet": ...,
    "fan": ..., "netg": ..., "nl3dmm": (geo, tex)}: converted reference
    checkpoints, `utils/convert.py`, or JAX variables through
    `utils/bridge.py`); an absent stage's network is initialized from
    `seed`, the zero-code mesh then biased to a frontal planar grid so that
    the fit starts from plausible geometry. The fit runs on a
    `mesh_grid`^2-point mesh (the grid's triangles and landmark indices)
    for `fit_iters` (stage 1, stage 2) iterations, which a call to
    `fit3dmm_fn` may replace (`iters=`);
    `models/face3d/nl3dmm.load_nl3dmm_basis` reads the reference basis."""
    from nerf3dtalker_tpu_torch.models.audio import SimpleWrapperV2, audio2exp_sequence
    from nerf3dtalker_tpu_torch.models.bisenet import BiSeNet, _nearest_resize
    from nerf3dtalker_tpu_torch.models.face3d.nl3dmm import Linear3DMMTexture, NonLinear3DMM
    from nerf3dtalker_tpu_torch.models.fan import FAN, decode_heatmaps
    from nerf3dtalker_tpu_torch.train.fit3dmm import fit_3dmm
    from nerf3dtalker_tpu_torch.utils.bridge import load_into
    from nerf3dtalker_tpu_torch.utils.device import resolve_device, uninitialized

    dev = resolve_device(device)
    weights = weights or {}
    gen = torch.Generator().manual_seed(seed)
    S = image_size
    G = mesh_grid
    PN = G * G

    def net(factory, state):
        """`factory` on `dev`: `state` loaded in, else initialized from
        `gen`; inference only."""
        if state is None:
            m = factory(device=dev, generator=gen)
        else:
            m = load_into(uninitialized(lambda d: factory(device=d), dev), state)
        return m.eval().requires_grad_(False)

    bise = net(BiSeNet, weights.get("bisenet"))
    fan = net(lambda **kw: FAN(n_stacks=1, **kw), weights.get("fan"))
    netg = net(SimpleWrapperV2, weights.get("netg"))
    geo_sd, tex_sd = weights.get("nl3dmm", (None, None))
    geo = net(lambda **kw: NonLinear3DMM(point_num=PN, code_dims=179, **kw), geo_sd)
    tex = net(lambda **kw: Linear3DMMTexture(point_num=PN, **kw), tex_sd)
    if geo_sd is None:
        xs, ys = np.meshgrid(np.linspace(-0.5, 0.5, G), np.linspace(-0.5, 0.5, G))
        grid = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1)
        geo.geo_fc3.bias.copy_(torch.as_tensor(grid.astype(np.float32)))

    @torch.no_grad()
    def bisenet_apply(images):
        parsing = []
        for t in range(0, len(images), FRAMES_PER_CALL):
            x = _frames_nchw(images[t:t + FRAMES_PER_CALL], dev)
            if S < 64:   # the trunk downsamples 32x: keep the parse grid sane
                x = linear_resize(x, (64, 64))
            p = bise(x)[0].argmax(dim=1)
            if p.shape[1] != S:
                p = _nearest_resize(p[:, None].float(), (S, S))[:, 0]
            parsing.append(p.to(torch.int64).cpu())
        return torch.cat(parsing).numpy()

    @torch.no_grad()
    def fan_apply(images):
        lms = []
        for t in range(0, len(images), FRAMES_PER_CALL):
            x = linear_resize(_frames_nchw(images[t:t + FRAMES_PER_CALL], dev), (256, 256))
            lms.append((decode_heatmaps(fan(x), crop_size=256) * (S / 256.0)).cpu())
        return torch.cat(lms).numpy()

    @torch.no_grad()
    def netg_apply(mels, ref64, ratios):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        return audio2exp_sequence(netg, t(mels), t(ref64), t(ratios)).cpu().numpy()

    faces = grid_mesh(G).to(dev)
    lm_index = (torch.arange(68) % PN).to(dev)
    f = float(S) * 1.2
    inmat = torch.tensor([[[f, 0.0, S / 2.0], [0.0, f, S / 2.0], [0.0, 0.0, 1.0]]], device=dev)

    def fit3dmm_fn(imgs, masks, lms, iters=fit_iters):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        return fit_3dmm(geo, tex, t(imgs), t(masks), t(lms), inmat.repeat(len(imgs), 1, 1),
                        faces, lm_index, skinmask=torch.ones(PN, device=dev),
                        stage1_iters=iters[0], stage2_iters=iters[1], chunk=min(512, S * S))

    return {"bisenet_apply": bisenet_apply, "fan_apply": fan_apply, "netg_apply": netg_apply,
            "fit3dmm_fn": fit3dmm_fn}


def save_subject(path: str, arrays: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **arrays)


def load_subject(path: str, featmap_size: int = 32):
    """A saved subject .npz -> FrameDataset."""
    from nerf3dtalker_tpu_torch.data.dataset import REQUIRED_KEYS, FrameDataset
    from nerf3dtalker_tpu_torch.utils.camera import ray_grid

    with np.load(path) as z:
        arrays = {k: z[k] for k in REQUIRED_KEYS}
    xy, _ = ray_grid(featmap_size)
    return FrameDataset(arrays, xy)
