"""Training and eval steps of the HeadNeRF + Audio2Style pair (port of
`nerf3dtalker_tpu/train/step.py`, single device).

Mirrors the reference training loop (talker_trainer.py:960-1085): two Adam
optimizers, one on the NeRF with a StepLR decay (gamma 0.1 every 100
epochs) and one on the audio encoder at a constant rate
(talker_trainer.py:665,722-727), stepping together on the total loss. A
step with a non-finite gradient keeps the params, both Adam states and
their step counts, decided on the device (no host sync).

On the GPU HeadNeRF computes in bf16 through the fused render kernels
(forward K1, backward K2); on the CPU in f32 through the plain path. The
stratified jitter and the Audio2Style dropout are drawn from the generator
the caller passes to `train_step`; `deterministic=True` turns both off.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
from nerf3dtalker_tpu_torch.models.audio import Audio2Style
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.models.perceptual import VGG16Features
from nerf3dtalker_tpu_torch.train.losses import headnerf_losses
from nerf3dtalker_tpu_torch.utils.device import resolve_device
from nerf3dtalker_tpu_torch.utils.guards import all_finite


def make_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """StepLR as a function of Adam's step count (a tensor):
    lr * gamma^(count // (step_lr_every * steps_per_epoch))
    (talker_trainer.py:722-727; optax.exponential_decay with staircase)."""
    every = cfg.step_lr_every * max(steps_per_epoch, 1)
    return lambda count: cfg.lr * cfg.step_lr_gamma ** torch.floor(count / every)


def make_optimizer(params: Dict[str, List[torch.Tensor]], cfg: TrainConfig) -> torch.optim.Adam:
    """torch's fused Adam over two groups, "nerf" then "audio" (b1 0.9, b2
    0.999, eps 1e-8: optax.adam's update rule). The audio group keeps
    `lr_audio`; `apply_update` sets the NeRF group's rate before each step."""
    dev = params["nerf"][0].device
    return torch.optim.Adam([{"params": params["nerf"], "lr": torch.tensor(cfg.lr, device=dev)},
                             {"params": params["audio"], "lr": cfg.lr_audio}], fused=True)


@dataclasses.dataclass
class TrainState:
    nerf: HeadNeRF
    audio: Audio2Style
    opt: torch.optim.Adam
    nerf_lr: Callable[[torch.Tensor], torch.Tensor]   # of the NeRF group's step count
    step: int = 0

    def params(self) -> Dict[str, List[torch.Tensor]]:
        return {"nerf": trainable(self.nerf), "audio": trainable(self.audio)}


def trainable(module: torch.nn.Module) -> List[torch.Tensor]:
    return [p for p in module.parameters() if p.requires_grad]


@dataclasses.dataclass(frozen=True)
class StepFns:
    """The step functions of one model configuration on one device."""

    init: Callable[[int], TrainState]
    loss_and_grads: Callable
    train_step: Callable
    eval_step: Callable
    render: Callable
    compute_dtype: torch.dtype


def apply_update(state: TrainState, grads: Dict[str, List[torch.Tensor]],
                 ok: torch.Tensor) -> None:
    """One Adam step of both groups, the NeRF group at the rate of its own
    step count. Where `ok` (a 0-d bool tensor) is false the fused update is
    skipped as a whole: params, moments and step counts stay (Adam's
    `found_inf`, decided on the device)."""
    opt = state.opt
    for group, gs in zip(opt.param_groups, (grads["nerf"], grads["audio"])):
        for p, g in zip(group["params"], gs):
            p.grad = g
    nerf = opt.param_groups[0]
    st = opt.state.get(nerf["params"][0])
    nerf["lr"] = state.nerf_lr(st["step"] if st else torch.zeros((), device=ok.device))
    opt.found_inf = (~ok).float()
    opt.step()
    opt.zero_grad(set_to_none=True)


def assemble_codes(batch: Dict[str, torch.Tensor], audio_exp: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape and appearance codes; the audio-predicted expression overwrites
    expr[:64] (talker_trainer.py:853)."""
    expr = batch["expr"]
    if audio_exp is not None:
        expr = torch.cat([audio_exp, expr[:, 64:]], dim=-1)
    return (torch.cat([batch["iden"], expr], dim=-1),
            torch.cat([batch["text"], batch["illu"]], dim=-1))


def build_step_fns(
    nerf_cfg: NeRFConfig,
    train_cfg: TrainConfig,
    steps_per_epoch: int = 1,
    vgg: Optional[VGG16Features] = None,
    device: Optional[Union[str, torch.device]] = None,
    use_fused: Optional[bool] = None,
) -> StepFns:
    """Step functions on `device` (default `cuda`). `use_fused` defaults to
    the GPU; the compute dtype is bf16 on the GPU and f32 on the CPU.

    Batch layout (tensors on the device): mels [B, 80, 16], gt_rgb
    [B, H, W, 3], head_mask [B, H, W, 1], iden/expr/text/illu, audio_exp
    [B, 64], Rmat [B, 3, 3], Tvec [B, 3], inv_inmat [B, 3, 3], xy [B, N_r, 2],
    and with a `vgg` vgg_f0..vgg_f3 (the masked-GT VGG planes,
    `FrameDataset.precompute_gt_vgg`)."""
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    if use_fused is None:
        use_fused = on_gpu
    cdt = torch.bfloat16 if on_gpu else torch.float32
    vgg_cdt = cdt if cdt == torch.bfloat16 else None
    bg_value = 1.0 if nerf_cfg.bg_type == "white" else 0.0
    sched = make_schedule(train_cfg, steps_per_epoch)

    def init(seed: int) -> TrainState:
        """Models from seeded CPU generators (NeRF `seed`, audio `seed + 1`),
        moved to the device, and a fresh optimizer."""
        nerf = HeadNeRF(nerf_cfg, compute_dtype=cdt, use_fused=use_fused, device=dev,
                        generator=torch.Generator().manual_seed(seed))
        audio = Audio2Style(device=dev, generator=torch.Generator().manual_seed(seed + 1))
        opt = make_optimizer({"nerf": trainable(nerf), "audio": trainable(audio)}, train_cfg)
        return TrainState(nerf, audio, opt, sched)

    def forward(state: TrainState, batch, generator: Optional[torch.Generator]):
        audio_style = state.audio(batch["mels"], generator)
        shape_code, appea_code = assemble_codes(batch, batch.get("audio_exp"))
        xy = batch["xy"]
        noise = None
        if generator is not None:
            noise = torch.rand(xy.shape[0], xy.shape[1], nerf_cfg.num_sample_coarse + 1,
                               generator=generator, device=dev)
        return state.nerf(xy, shape_code, appea_code, audio_style, batch["Rmat"],
                          batch["Tvec"], batch["inv_inmat"], noise=noise)

    def losses_of(pred, batch):
        gt_feats = [batch[f"vgg_f{i}"] for i in range(4)] if vgg is not None else None
        return headnerf_losses(pred, batch["gt_rgb"], batch["head_mask"], bg_value,
                               vgg=vgg, vgg_compute_dtype=vgg_cdt, gt_vgg_feats=gt_feats)

    def loss_and_grads(state: TrainState, batch, generator=None):
        """(losses, grads {"nerf": [...], "audio": [...]}) of one batch, in
        the order of `state.params()`; no update."""
        params = state.params()
        losses = losses_of(forward(state, batch, generator), batch)
        flat = torch.autograd.grad(losses["total_loss"], params["nerf"] + params["audio"])
        n = len(params["nerf"])
        return losses, {"nerf": list(flat[:n]), "audio": list(flat[n:])}

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
                   deterministic: bool = False) -> Dict[str, torch.Tensor]:
        """One guarded two-group Adam step; returns the losses as 0-d device
        tensors with `finite_step` (1 or 0). Jitter and dropout come from
        `generator` (on the device) unless `deterministic`."""
        if not deterministic and generator is None:
            raise ValueError("train_step needs a generator unless deterministic")
        losses, grads = loss_and_grads(state, batch, None if deterministic else generator)
        ok = all_finite(grads["nerf"] + grads["audio"])
        apply_update(state, grads, ok)
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["finite_step"] = ok.float()
        return out

    @torch.no_grad()
    def render(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        return forward(state, batch, None)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        pred = forward(state, batch, None)
        return pred["merge_img"], losses_of(pred, batch)

    return StepFns(init=init, loss_and_grads=loss_and_grads, train_step=train_step,
                   eval_step=eval_step, render=render, compute_dtype=cdt)
