"""CropAndExtract: image -> aligned crop -> BFM coefficients -> expression
(port of `nerf3dtalker_tpu/data/crop_extract.py`; the reference's
`CropAndExtract`, talker_trainer.py:188-316, XGaze_utils/
data_loader_xgaze_new.py:437-564 and s_utils/preprocess.py:46+).

Align the face to the 5-point template from its 68 landmarks (given, or
from a `fan_apply`), regress the 257 coefficients with `recon_apply`
(`recon_applier` wraps the port's `ReconNet`), split them; the 64-d `exp`
slice drives the NeRF's expression code.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def recon_applier(net, device=None) -> Callable:
    """`recon_apply` of a `models.resnets.ReconNet`: aligned [B, S, S, 3]
    numpy in [0, 1] -> [B, 257] numpy, evaluated without gradient on the
    net's device."""
    dev = device or next(net.parameters()).device

    @torch.no_grad()
    def apply(aligned):
        x = torch.as_tensor(np.asarray(aligned, np.float32), device=dev).permute(0, 3, 1, 2)
        return net(x).cpu().numpy()

    return apply


def crop_and_extract(
    image: np.ndarray,               # [H, W, 3] float in [0, 1]
    recon_apply: Callable,           # aligned [1, 224, 224, 3] -> [1, 257]
    landmarks: Optional[np.ndarray] = None,   # [68, 2]; else fan_apply's
    fan_apply: Optional[Callable] = None,
    crop_size: int = 224,
) -> Dict[str, np.ndarray]:
    """The split coefficients (id / exp / tex / angle / gamma / trans)."""
    from nerf3dtalker_tpu_torch.data.align import align_face
    from nerf3dtalker_tpu_torch.models.face3d.bfm import split_coeff

    if landmarks is None:
        if fan_apply is None:
            raise ValueError("need landmarks or a fan_apply")
        landmarks = np.asarray(fan_apply(image[None]))[0]
    aligned, _ = align_face(image, landmarks, out_size=crop_size)
    coeffs = torch.as_tensor(np.asarray(recon_apply(aligned[None]), np.float32))
    return {k: v[0].numpy() for k, v in split_coeff(coeffs).items()}


def extract_exp_sequence(
    images: np.ndarray,              # [T, H, W, 3]
    recon_apply: Callable,
    landmarks: Optional[np.ndarray] = None,   # [T, 68, 2]
    fan_apply: Optional[Callable] = None,
) -> np.ndarray:
    """Per-frame `exp` [T, 64] (the sad_exp / wav_gen targets the reference
    recomputes inside __getitem__)."""
    return np.stack([
        crop_and_extract(images[t], recon_apply,
                         landmarks[t] if landmarks is not None else None, fan_apply)["exp"]
        for t in range(len(images))])
