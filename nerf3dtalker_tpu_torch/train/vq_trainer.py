"""Standardized-Space (VQ) stage-1 training (port of
`nerf3dtalker_tpu/train/vq_trainer.py`; reference
StandardizedSpace/main/train_vq.py:26-426). Per batch the five AU
classifiers give features and probabilities from face crops (:268-278),
the AU BCE and dice losses supervise them (:281-302), the VQ autoencoder
reconstructs the NeRF-rendered frame conditioned on the AU features, their
gradient kept (:308), and the masked L1 plus the quantization losses train
it (:310-324, metrics/loss.py:6-11 `calc_vq_loss`). One AdamW steps both
modules' parameters. The JAX step's data-sharded `mesh` variant is not
ported yet.

Batches are dicts of f32 tensors on the modules' device, channels-last as
in the JAX step: gen_img, gt_img [B, H, W, 3], mask [B, H, W, 1], crops
[B, n_au, S, S, 3], au_labels [B, n_au].
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.models.vq.au_classifier import (
    AUClassifier,
    au_bce_loss,
    au_dice_loss,
)
from nerf3dtalker_tpu_torch.models.vq.stage1 import VQAutoEncoder, VQForwardResult
from nerf3dtalker_tpu_torch.utils.device import resolve_device

BATCH_KEYS = ("gen_img", "gt_img", "mask", "crops", "au_labels")


@dataclasses.dataclass
class VQTrainState:
    vq: VQAutoEncoder
    au: nn.ModuleList           # the n_au classifiers
    opt: torch.optim.Optimizer
    step: int = 0


def to_batch(arrays: Mapping[str, np.ndarray], device, idx=None) -> Dict[str, torch.Tensor]:
    """numpy arrays (rows `idx`, else all) -> f32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v if idx is None else v[idx]), dtype=torch.float32,
                               device=device) for k, v in arrays.items()}


def calc_vq_loss(recon: torch.Tensor, gt: torch.Tensor, quant_loss: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, quant_w: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L1 recon, masked when a mask is given, + quant_w * quant_loss; the
    L1) (metrics/loss.py:6-11; masking per train_vq.py:310-324)."""
    diff = (recon - gt).abs()
    if mask is not None:
        rec = (diff * mask).sum() / (mask.sum() * gt.shape[-1]).clamp_min(1.0)
    else:
        rec = diff.mean()
    return rec + quant_w * quant_loss, rec


def init_modules(cfg: VQConfig, crop_size: int, device,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[VQAutoEncoder, nn.ModuleList]:
    """The autoencoder, then n_au classifiers for crops of `crop_size` that
    start identical (one init, copied, as the JAX init stacks one init n_au
    times), drawn from `generator`, on `device`."""
    vq = VQAutoEncoder(cfg, device=device, generator=generator)
    one = AUClassifier(crop_size, device="cpu", generator=generator)
    return vq, nn.ModuleList(copy.deepcopy(one) for _ in range(cfg.n_au)).to(device)


def au_forward(au: nn.ModuleList, crops: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """crops [B, n_au, S, S, 3] -> (features [B, n_au, 256], probabilities
    [B, n_au]): classifier i on crop i (train_vq.py:127-160)."""
    outs = [clf(crops[:, i].permute(0, 3, 1, 2)) for i, clf in enumerate(au)]
    return (torch.stack([f for f, _ in outs], 1),
            torch.stack([p[:, 0] for _, p in outs], 1))


def norm_fed_convs(vq: VQAutoEncoder, au: nn.ModuleList) -> Dict[str, nn.Module]:
    """{name of a conv's bias (`vq.<parameter>` of the autoencoder,
    `au.<i>.<parameter>` of the classifiers): that conv} for the convs whose
    output an instance norm follows: straight, the classifiers' four;
    through a leaky ReLU, the squasher's and the expander's. The norm takes
    each channel's mean out, so such a bias's gradient is a sum over the
    positions that cancels: to 0 in exact arithmetic for the classifiers,
    and to what the ReLU's knee leaves for the other two (0 too for a
    channel whose positions all sit on one side of the knee). Its rounding
    error scales with the terms' mass (`bias_term_mass`), not with the sum."""
    convs = {"vq.encoder.squasher.conv.bias": vq.encoder.squasher.conv,
             "vq.decoder.expander.conv.bias": vq.decoder.expander.conv}
    for i, clf in enumerate(au):
        convs.update({f"au.{i}.conv{j}.bias": getattr(clf, f"conv{j}") for j in range(1, 5)})
    return convs


@contextlib.contextmanager
def bias_term_mass(convs: Mapping[str, nn.Module]):
    """Yields a dict that each backward run inside the block fills: for each
    `convs` entry, the sum over the batch and the positions of |dL/d(the
    conv's output)|, per channel. The bias's gradient is the same sum
    without the absolute value."""
    mass: Dict[str, torch.Tensor] = {}

    def watch(name):
        def add(g):
            m = g.detach().abs().transpose(0, 1).flatten(1).sum(1)
            mass[name] = mass[name] + m if name in mass else m

        def hook(_module, _inputs, out):
            out.register_hook(add)

        return hook

    hooks = [conv.register_forward_hook(watch(name)) for name, conv in convs.items()]
    try:
        yield mass
    finally:
        for h in hooks:
            h.remove()


def vq_loss(vq: VQAutoEncoder, au: nn.ModuleList, batch: Mapping[str, torch.Tensor],
            au_loss_weight: float = 1.0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], VQForwardResult]:
    """(total loss, metrics, the autoencoder's output) of one batch; the
    gradient reaches both modules, the classifiers also through the AU
    features."""
    feats, probs = au_forward(au, batch["crops"])
    au_loss = au_bce_loss(probs, batch["au_labels"]) + au_dice_loss(probs, batch["au_labels"])
    out = vq(batch["gen_img"], feats)
    total, rec = calc_vq_loss(out.recon, batch["gt_img"], out.quant_loss, batch.get("mask"))
    total = total + au_loss_weight * au_loss
    return total, {"rec_loss": rec, "quant_loss": out.quant_loss, "au_loss": au_loss,
                   "perplexity": out.perplexity, "total_loss": total}, out


def build_vq_step(cfg: VQConfig, lr: float = 1e-4, weight_decay: float = 2e-3,
                  au_loss_weight: float = 1.0,
                  device: Optional[Union[str, torch.device]] = None):
    """(init, train_step, eval_step), as the JAX `build_vq_step`:

      init(generator, batch) -> VQTrainState: `init_modules` (the
        classifiers sized to batch["crops"]) on `device` (default `cuda`),
        and AdamW over both (betas 0.9/0.999, eps 1e-8, decay on every
        parameter as optax applies it, codebooks and biases included);
      train_step(state, batch) -> (state, metrics), one optimizer step;
      eval_step(state, batch) -> metrics, no gradient.
    Metrics are 0-d tensors on the device."""
    dev = resolve_device(device)

    def init(generator: Optional[torch.Generator], batch: Mapping[str, torch.Tensor]
             ) -> VQTrainState:
        vq, au = init_modules(cfg, int(batch["crops"].shape[2]), dev, generator)
        params = list(vq.parameters()) + list(au.parameters())
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, fused=dev.type == "cuda")
        return VQTrainState(vq, au, opt)

    def train_step(state: VQTrainState, batch: Mapping[str, torch.Tensor]):
        state.opt.zero_grad(set_to_none=True)
        total, metrics, _ = vq_loss(state.vq, state.au, batch, au_loss_weight)
        total.backward()
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(state: VQTrainState, batch: Mapping[str, torch.Tensor]):
        return vq_loss(state.vq, state.au, batch, au_loss_weight)[1]

    return init, train_step, eval_step
