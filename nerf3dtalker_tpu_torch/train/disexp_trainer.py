"""Style-fusion disentanglement training, the disexp variant (port of
`nerf3dtalker_tpu/train/disexp_trainer.py`; reference
talker_trainer_disexp.py:568-1300, active path :1036-1107): `fus =
FusAudio2Style(audio style, SadTalker exp of the lip-synced frame)` learns
by L1 the SadTalker exp of the ground-truth frame. Only the fusion head
steps (:1101-1104); Audio2Style is frozen, and both run without dropout.

Batches are dicts of f32 tensors on the models' device: mels [T, 80, 16],
auds_exp [T, 64], sad_exp [T, 64] (the target).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch

from nerf3dtalker_tpu_torch.models.audio import Audio2Style, FusAudio2Style
from nerf3dtalker_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DisexpTrainState:
    fus: FusAudio2Style
    audio: Audio2Style          # frozen
    opt: torch.optim.Optimizer
    step: int = 0


def build_disexp_step(lr: float = 1e-4, device: Optional[Union[str, torch.device]] = None):
    """(init, train_step), as the JAX `build_disexp_step`:

      init(generator, batch) -> DisexpTrainState: Audio2Style, then
        FusAudio2Style, on `device` (default `cuda`) from `generator`; the
        style model frozen, Adam (betas 0.9/0.999, eps 1e-8) over the fusion
        head;
      train_step(state, batch) -> (state, {"exp_loss"}), one Adam step.
    """
    dev = resolve_device(device)

    def init(generator: Optional[torch.Generator], batch: Mapping[str, torch.Tensor]
             ) -> DisexpTrainState:
        audio = Audio2Style(device=dev, generator=generator).requires_grad_(False)
        fus = FusAudio2Style(device=dev, generator=generator)
        opt = torch.optim.Adam(fus.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               fused=dev.type == "cuda")
        return DisexpTrainState(fus, audio, opt)

    def train_step(state: DisexpTrainState, batch: Mapping[str, torch.Tensor]):
        state.opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            style = state.audio(batch["mels"])
        fused = state.fus(style, batch["auds_exp"])
        loss = torch.mean(torch.abs(fused - batch["sad_exp"]))
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"exp_loss": loss.detach()}

    return init, train_step
