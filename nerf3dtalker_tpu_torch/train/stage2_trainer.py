"""CodeTalker stage-2 training and inference (port of
`nerf3dtalker_tpu/train/stage2_trainer.py`; reference
StandardizedSpace/main/train_pred.py:1-246): teacher forcing against the
frozen stage-1 codebook, motion MSE through the frozen decoder plus code
regression MSE (stage2.py:93-100), AdamW over CodeTalker alone.

Batches are dicts of f32 tensors on the model's device: audio_feats
[B, S, audio_dim] (wav2vec2 states), motion [B, T, V3], onehot
[B, n_subjects].
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch

from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.models.vq.stage2 import CodeTalker, stage2_loss
from nerf3dtalker_tpu_torch.utils.device import resolve_device, uninitialized


def stage2_step_loss(model: CodeTalker, vq_apply: Mapping, batch: Mapping[str, torch.Tensor]):
    """(total loss, metrics, the predicted codes' indices) of one teacher-
    forced batch: motion MSE through the frozen decoder + code regression
    MSE; the gradient reaches CodeTalker through the quantizer's straight-
    through codes."""
    pred_codes = model(batch["audio_feats"], batch["motion"], batch["onehot"])
    gt_quant = vq_apply["get_gt_quant"](batch["motion"])
    quantized, indices = vq_apply["quantize"](pred_codes)
    recon = vq_apply["decode"](quantized)
    total, (lm, lr_) = stage2_loss(pred_codes, gt_quant, recon, batch["motion"])
    return total, {"loss_motion": lm, "loss_reg": lr_, "total_loss": total}, indices


def codetalker_payload(model: CodeTalker) -> dict:
    """What a stage-2 checkpoint holds (`utils/checkpoints.py:
    save_checkpoint`): the VQConfig, CodeTalker's dims and its state."""
    return {"vq_config": dataclasses.asdict(model.cfg), "dims": dict(model.dims),
            "codetalker": model.state_dict()}


def codetalker_from_payload(payload: Mapping, device: Optional[Union[str, torch.device]] = None
                            ) -> CodeTalker:
    """The CodeTalker of a stage-2 checkpoint's payload, on `device`
    (default `cuda`)."""
    cfg = VQConfig(**payload["vq_config"])
    model = uninitialized(lambda d: CodeTalker(cfg, **payload["dims"], device=d), device)
    model.load_state_dict(payload["codetalker"])
    return model


@dataclasses.dataclass
class Stage2TrainState:
    model: CodeTalker
    opt: torch.optim.Optimizer
    step: int = 0


def build_stage2_step(cfg: VQConfig, vq_apply: Mapping, vertice_dim: int, lr: float = 1e-4,
                      weight_decay: float = 2e-3, feature_dim: int = 64, n_subjects: int = 8,
                      audio_dim: int = 768,
                      device: Optional[Union[str, torch.device]] = None):
    """(init, train_step, predict), as the JAX `build_stage2_step`.
    `vq_apply` is `train/vq_eval.py:frame_vq_apply`'s (quantize, decode,
    get_gt_quant); `cfg.face_quan_num` its codes_per_frame.

      init(generator, batch) -> Stage2TrainState: CodeTalker on `device`
        (default `cuda`) from `generator`, AdamW over it (betas 0.9/0.999,
        eps 1e-8, the decay on every parameter, as optax.adamw);
      train_step(state, batch) -> (state, metrics): one AdamW step, metrics
        loss_motion, loss_reg, total_loss (0-d tensors on the device);
      predict(model, audio_feats, onehot, T, onehot2=None,
        style_weight=None) -> [B, T, V3], the autoregressive recurrence.
    """
    dev = resolve_device(device)

    def init(generator: Optional[torch.Generator], batch: Mapping[str, torch.Tensor]
             ) -> Stage2TrainState:
        model = CodeTalker(cfg, feature_dim=feature_dim, n_subjects=n_subjects,
                           vertice_dim=vertice_dim, audio_dim=audio_dim, device=dev,
                           generator=generator)
        opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, fused=dev.type == "cuda")
        return Stage2TrainState(model, opt)

    def train_step(state: Stage2TrainState, batch: Mapping[str, torch.Tensor]):
        state.opt.zero_grad(set_to_none=True)
        total, metrics, _ = stage2_step_loss(state.model, vq_apply, batch)
        total.backward()
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def predict(model: CodeTalker, audio_feats: torch.Tensor, onehot: torch.Tensor, T: int,
                onehot2: Optional[torch.Tensor] = None,
                style_weight: Optional[float] = None) -> torch.Tensor:
        """Autoregressive inference (stage2.py:102-155), with the optional
        two-subject style blend (:108-114). As in JAX, each step runs the
        teacher-forced forward over a zero-padded T-frame buffer: the causal
        mask and the one-frame input shift make frame t's codes depend on
        frames < t only. The stage-1 decode is frame-wise, so decoding frame
        t's codes alone gives the frame JAX's whole-buffer re-decode gives."""
        Q = cfg.face_quan_num
        buf = torch.zeros(audio_feats.shape[0], T, vertice_dim, dtype=audio_feats.dtype,
                          device=audio_feats.device)
        for t in range(T):
            codes = model(audio_feats, buf, onehot, subject_onehot2=onehot2,
                          style_weight=style_weight)
            quantized, _ = vq_apply["quantize"](codes[:, t * Q:(t + 1) * Q])
            buf[:, t] = vq_apply["decode"](quantized)[:, 0]
        return buf

    return init, train_step, predict

