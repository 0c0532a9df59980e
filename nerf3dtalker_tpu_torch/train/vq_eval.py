"""Standardized-Space evaluation (port of `nerf3dtalker_tpu/train/vq_eval.py`):

  * `reconstruct_split` — StandardizedSpace/main/test_vq.py:52-150: the
    AU-conditioned stage-1 reconstruction of a split, `gen+` PNGs, metrics;
  * `frame_vq_apply` — the frozen stage-1 autoencoder as stage 2's
    get_gt_quant / quantize / decode over frame sequences;
  * `eval_stage2` — main/test_pred.py + cal_metric.py:7-80: CodeTalker's
    autoregressive prediction scored by LVE / FDD.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from nerf3dtalker_tpu_torch.models.vq.stage1 import VQAutoEncoder
from nerf3dtalker_tpu_torch.train.vq_trainer import au_forward, to_batch
from nerf3dtalker_tpu_torch.utils.mesh_metrics import fdd, lip_vertex_error
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


def frame_vq_apply(vq: VQAutoEncoder) -> Dict:
    """The stage-1 autoencoder, frozen (its parameters no longer require
    gradients), as stage 2's `vq_apply` over frame sequences: each "motion"
    frame is one image flattened to V3 = H * W * 3, encoded to
    `codes_per_frame` codes (read from the encoder's output on one frame).
    The reference composes CodeTalker with the same stage-1 model
    (stage2.py:43-46); as in JAX, the decode passes zero AU codes (the
    reference's predict() feeds only the face codes, stage2.py:141-152).

      get_gt_quant(motion [B, T, V3]) -> [B, T * L, e] (no gradient)
      quantize(codes [B, N, e]) -> (straight-through codes, indices)
      decode(quant [B, T * L, e]) -> [B, T, V3]
    """
    cfg = vq.cfg
    vq.requires_grad_(False)
    H = W = cfg.img_size
    V3 = H * W * 3
    dev = next(vq.parameters()).device
    with torch.no_grad():
        h = vq.encoder(torch.zeros(1, H, W, 3, device=dev))
    codes_per_frame = h.numel() // cfg.embed_dim

    @torch.no_grad()
    def get_gt_quant(motion):
        B, T, _ = motion.shape
        q = vq.encode(motion.reshape(B * T, H, W, 3))
        return q.quantized.reshape(B, -1, cfg.embed_dim)

    def quantize(codes):
        out = vq.quantize(codes)
        return out.quantized, out.indices

    def decode(quant):
        B = quant.shape[0]
        qi = quant.reshape(-1, codes_per_frame, cfg.embed_dim)
        qa = torch.zeros(qi.shape[0], cfg.n_au, cfg.embed_dim, dtype=quant.dtype,
                         device=quant.device)
        return vq.decode(qi, qa).reshape(B, -1, V3)

    return {"get_gt_quant": get_gt_quant, "quantize": quantize, "decode": decode,
            "codes_per_frame": codes_per_frame, "vertice_dim": V3}


def eval_stage2(predict_fn, model, audio_feats: torch.Tensor, onehot: torch.Tensor,
                num_frames: int, verts_gt: Optional[np.ndarray] = None,
                template: Optional[np.ndarray] = None,
                mouth_map: Optional[Sequence[int]] = None,
                upper_map: Optional[Sequence[int]] = None,
                out_path: Optional[str] = None) -> Dict[str, float]:
    """test_pred's driver: `predict_fn` (`build_stage2_step`'s predict) of
    `num_frames` frames, saved to `out_path` (.npy, [B, T, V3]) when given;
    with `verts_gt` [T, V, 3] the LVE over `mouth_map` (default every
    vertex) and, with `template` [V, 3], the FDD over `upper_map`."""
    pred = predict_fn(model, audio_feats, onehot, num_frames).cpu().numpy()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.save(out_path, pred)
    metrics: Dict[str, float] = {"num_frames": float(num_frames)}
    if verts_gt is not None:
        vp = pred[0].reshape(num_frames, -1, 3)
        mouth = mouth_map if mouth_map is not None else range(vp.shape[1])
        metrics["LVE"] = lip_vertex_error(verts_gt, vp, list(mouth))
        if template is not None:
            upper = upper_map if upper_map is not None else range(vp.shape[1])
            metrics["FDD"] = fdd(verts_gt, vp, template, list(upper))
    return metrics
