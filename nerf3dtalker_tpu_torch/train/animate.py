"""End-to-end audio-driven talking-head synthesis (port of
`nerf3dtalker_tpu/train/animate.py`).

A fitted subject (latent codes + camera) is re-rendered once per audio
frame with the per-frame 64-d audio style (and optionally a per-frame
expression coefficient, e.g. SadTalker's audio2exp output) driving the
NeRF. Frames render
in fixed-size chunks through the batch dimension of `HeadNeRF`, so T frames
cost ceil(T/chunk) kernel launches; the last chunk is padded to the same
shape.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nerf3dtalker_tpu_torch.models.audio import Audio2Style
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.utils.camera import ray_grid


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


@torch.inference_mode()
def animate_sequence(
    model: HeadNeRF,
    shape_code: np.ndarray,       # [1, 179] fitted iden+expr
    appea_code: np.ndarray,       # [1, 127]
    audio_styles: np.ndarray,     # [T, 64] per-frame style vectors
    cam: Dict[str, np.ndarray],   # Rmat [1,3,3], Tvec [1,3], inv_inmat [1,3,3]
    expr_seq: Optional[np.ndarray] = None,   # [T, e] override of the expr slice
    chunk: int = 4,
) -> np.ndarray:
    """Render T frames on the model's device; returns [T, H, W, 3] float32
    in [0, 1]. Row t of `expr_seq` overwrites frame t's
    shape_code[iden_code_dims : iden_code_dims + e]."""
    dev = _device_of(model)

    def tile(a, *reps):
        return torch.as_tensor(np.tile(np.asarray(a, np.float32), reps), device=dev)

    T = audio_styles.shape[0]
    xy, _ = ray_grid(model.cfg.featmap_size)
    xy_b = tile(xy, chunk, 1, 1)
    Rmat, Tvec = tile(cam["Rmat"], chunk, 1, 1), tile(cam["Tvec"], chunk, 1)
    inv_inmat = tile(cam["inv_inmat"], chunk, 1, 1)
    shape_b, appea_b = tile(shape_code, chunk, 1), tile(appea_code, chunk, 1)
    iden = model.cfg.iden_code_dims
    styles = torch.as_tensor(np.asarray(audio_styles, np.float32), device=dev)
    frames = []
    for start in range(0, T, chunk):
        n = min(chunk, T - start)
        aud = torch.zeros((chunk, styles.shape[1]), dtype=torch.float32, device=dev)
        aud[:n] = styles[start:start + n]
        codes = shape_b
        if expr_seq is not None:
            e = torch.as_tensor(np.asarray(expr_seq[start:start + n], np.float32), device=dev)
            codes = shape_b.clone()
            codes[:n, iden:iden + e.shape[1]] = e
        out = model(xy_b, codes, appea_b, aud, Rmat, Tvec, inv_inmat)
        frames.append(torch.clamp(out["merge_img"][:n], 0.0, 1.0).float().cpu())
    return torch.cat(frames).numpy()


@torch.inference_mode()
def styles_from_mels(a2s: Audio2Style, mels: np.ndarray) -> np.ndarray:
    """Audio2Style over the whole frame sequence [T, 80, 16] -> [T, 64]."""
    x = torch.as_tensor(np.asarray(mels, np.float32), device=_device_of(a2s))
    return a2s(x).float().cpu().numpy()
