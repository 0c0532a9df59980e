"""Standardized-Space evaluation (port of `nerf3dtalker_tpu/train/vq_eval.py`'s
`reconstruct_split`; reference StandardizedSpace/main/test_vq.py:52-150).
Stage-2's `frame_vq_apply` and `eval_stage2` are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from nerf3dtalker_tpu_torch.models.vq.stage1 import VQAutoEncoder
from nerf3dtalker_tpu_torch.train.vq_trainer import au_forward, to_batch
from nerf3dtalker_tpu_torch.utils.video import write_png


@torch.no_grad()
def reconstruct_batch(vq: VQAutoEncoder, au: nn.ModuleList, gen_img: torch.Tensor,
                      crops: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The refined frames [B, H, W, 3]: the classifiers' features on the
    crops condition the autoencoder; the background is reset to white
    through the head mask (test_vq.py:137)."""
    feats, _ = au_forward(au, crops)
    recon = vq(gen_img, feats).recon
    return torch.where(mask >= 0.5, recon, torch.ones_like(recon))


def reconstruct_split(vq: VQAutoEncoder, au: nn.ModuleList, data: Mapping[str, np.ndarray],
                      out_dir: Optional[str] = None, batch_size: int = 8) -> Dict[str, float]:
    """Reconstruct every frame of a split (test_vq.py test()).

    data: gen_img [N, H, W, 3], mask [N, H, W, 1], crops [N, n_au, S, S, 3]
    (+ optional gt_img for the metrics), numpy. Writes `{idx}.png` into
    out_dir, the reference's `/gen+/` directory of refined frames, and
    returns num_frames and, with gt_img, the mean per-frame rec_l1 and
    rec_psnr."""
    dev = next(vq.parameters()).device
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    n = len(data["gen_img"])
    l1s, psnrs = [], []
    for s in range(0, n, batch_size):
        sl = slice(s, min(s + batch_size, n))
        b = to_batch({k: data[k] for k in ("gen_img", "crops", "mask")}, dev, sl)
        rec = reconstruct_batch(vq, au, b["gen_img"], b["crops"], b["mask"]).cpu().numpy()
        for j, img in enumerate(rec):
            idx = s + j
            if out_dir:
                write_png(os.path.join(out_dir, f"{idx}.png"), img)
            if "gt_img" in data:
                gt = data["gt_img"][idx]
                l1s.append(float(np.mean(np.abs(img - gt))))
                mse = float(np.mean((img - gt) ** 2))
                psnrs.append(10.0 * np.log10(1.0 / max(mse, 1e-10)))
    out = {"num_frames": float(n)}
    if l1s:
        out["rec_l1"] = float(np.mean(l1s))
        out["rec_psnr"] = float(np.mean(psnrs))
    return out
