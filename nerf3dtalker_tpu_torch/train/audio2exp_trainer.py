"""Audio-to-expression regressor training (port of
`nerf3dtalker_tpu/train/audio2exp_trainer.py`; reference
train_au_exp.py:224-590): SadTalker's `SimpleWrapperV2` netG learns the
fitted 3DMM expression (its 64 of 79 dims, `BIAN`, :529) of each frame from
(mel chunk, frame-0 expression, blink ratio) by L1 (:573), with Adam at
the reference's lr 1e-7 (:576-580).

As in JAX, the netG's BatchNorms use their running statistics in training
too (the JAX step applies the model with `train=False`; the port's
`ConvBN` always does), so no batch moves them. But the JAX step takes
the gradient of the whole variable tree, `batch_stats` included, and Adam
steps every leaf: so here too Adam steps the running means and variances
with the parameters (`audio2exp_variables`).

Batches are dicts of f32 tensors on the model's device: mels [B, T, 80,
16], expr79 [B, T, 79] (the targets), expr79_0 [B, 79] (the ref input),
ratios [B, T].
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import numpy as np
import torch

from nerf3dtalker_tpu_torch.models.audio import SimpleWrapperV2
from nerf3dtalker_tpu_torch.utils.device import resolve_device

# train_au_exp.py:529: the nl3dmm expression dims used as SadTalker's 64
BIAN = np.array(
    [0, 1, 2, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
     22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
     39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 59, 61, 63, 64, 66, 68, 69, 73, 77], np.int64,
)


def select_expr64(expr79: torch.Tensor) -> torch.Tensor:
    """[.., 79] -> [.., 64] through the BIAN index map."""
    return expr79[..., torch.as_tensor(BIAN, device=expr79.device)]


@dataclasses.dataclass
class A2ETrainState:
    netg: SimpleWrapperV2
    opt: torch.optim.Optimizer
    step: int = 0


def audio2exp_variables(netg: SimpleWrapperV2) -> list:
    """What the audio2exp step trains: the parameters, then every
    BatchNorm's running mean and variance, which are set to require
    gradients (JAX's flax variables, `params` and `batch_stats`)."""
    stats = [b for n, b in netg.named_buffers() if n.endswith(("running_mean", "running_var"))]
    return list(netg.parameters()) + [b.requires_grad_(True) for b in stats]


def build_audio2exp_step(lr: float = 1e-7, device: Optional[Union[str, torch.device]] = None):
    """(init, train_step, forward), as the JAX `build_audio2exp_step`:

      init(generator, batch) -> A2ETrainState: a SimpleWrapperV2 on `device`
        (default `cuda`) from `generator`, Adam (betas 0.9/0.999, eps 1e-8)
        over `audio2exp_variables`;
      train_step(state, batch) -> (state, {"exp_loss"}), one Adam step;
      forward(netg, batch) -> predicted exp [B, T, 64].
    """
    dev = resolve_device(device)

    def forward(netg: SimpleWrapperV2, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        B, T = batch["mels"].shape[:2]
        ref = select_expr64(batch["expr79_0"]).repeat_interleave(T, dim=0)
        pred = netg(batch["mels"].reshape(B * T, 1, 80, 16), ref,
                    batch["ratios"].reshape(B * T, 1))
        return pred.reshape(B, T, 64)

    def init(generator: Optional[torch.Generator], batch: Mapping[str, torch.Tensor]
             ) -> A2ETrainState:
        netg = SimpleWrapperV2(device=dev, generator=generator)
        opt = torch.optim.Adam(audio2exp_variables(netg), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               fused=dev.type == "cuda")
        return A2ETrainState(netg, opt)

    def train_step(state: A2ETrainState, batch: Mapping[str, torch.Tensor]):
        state.opt.zero_grad(set_to_none=True)
        loss = torch.mean(torch.abs(forward(state.netg, batch) - select_expr64(batch["expr79"])))
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"exp_loss": loss.detach()}

    return init, train_step, forward
