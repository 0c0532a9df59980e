"""Training and eval steps of the HeadNeRF + Audio2Style pair (port of
`nerf3dtalker_tpu/train/step.py`, on one device or on one rank of a
(data, rays) mesh).

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

A step syncs nothing with the host (the guard, Adam's `found_inf` and the
StepLR rate are device tensors; Adam is fused), so `device_step`, the step
without its host-side count, can be captured whole into a CUDA graph
(`train/trainer.py:StepGraph`).

With a `mesh` (the JAX mesh branch, step.py:211-258) each rank holds its
shard of the batch (`parallel.mesh.shard_batch`) and the same params:

  * Audio2Style runs over all B frames of the global batch as one sequence
    (every rank holds the batch's mels) with dropout from the same
    generator on every rank, and each rank takes its rows of the styles;
  * the stratified jitter is drawn for the global [B, R, NS+1] and sliced
    to this rank's rows and rays, so a mesh step draws what the
    single-rank step draws;
  * HeadNeRF renders the ray shard through K4 (weight gradients summed over
    the rays group there) and gathers the maps over the rays group;
  * the losses are global means (`headnerf_losses(data_group=...)`);
  * after the backward, one all-reduce (sum) over every rank of every
    trainable leaf, flattened into one buffer, divided by the rays axis's
    size. The sum over the data axis is the batch's gradient. The ranks of
    a rays group hold the same data-local gradient (K4 summed the ray
    shards, and the decoder, the losses and Audio2Style run replicated
    there), but only up to the bits: on the GPU the decoder's backward does
    not give the same bits twice (atomics), so a sum over the data group
    alone lets the rays columns drift apart. Averaging the rays copies in
    the same all-reduce gives every rank the same bits, so the non-finite
    guard and the update agree everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
from nerf3dtalker_tpu_torch.models.audio import Audio2Style
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.models.perceptual import VGG16Features
from nerf3dtalker_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, sync_params
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
    device_step: Callable
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


def load_optimizer_state(opt: torch.optim.Optimizer, state_dict: dict) -> None:
    """`opt.load_state_dict(state_dict)` into the tensors `opt` already
    holds: `load_state_dict` puts new moment and step tensors in place of
    the old ones, which a CUDA graph captured before would go on reading.
    The values are copied into the old tensors (a state the checkpoint does
    not have is zeroed: Adam's fresh state), and each group keeps its own
    `fused` and `capturable` flags."""
    flags = [{k: g[k] for k in ("fused", "capturable") if k in g} for g in opt.param_groups]
    live = {p: dict(opt.state[p]) for g in opt.param_groups for p in g["params"]
            if p in opt.state}
    opt.load_state_dict(state_dict)
    for group, kept in zip(opt.param_groups, flags):
        group.update(kept)
    for p, old in live.items():
        new = opt.state[p]
        for k, t in old.items():
            if k in new:
                t.copy_(new[k])
            else:
                t.zero_()
            new[k] = t


def assemble_codes(batch: Dict[str, torch.Tensor], audio_exp: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape and appearance codes; the audio-predicted expression overwrites
    expr[:64] (talker_trainer.py:853)."""
    expr = batch["expr"]
    if audio_exp is not None:
        expr = torch.cat([audio_exp, expr[:, 64:]], dim=-1)
    return (torch.cat([batch["iden"], expr], dim=-1),
            torch.cat([batch["text"], batch["illu"]], dim=-1))


def audio_style_rows(audio: Audio2Style, mels: torch.Tensor, rows: slice,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Audio2Style over the whole frame sequence `mels` [B, 80, 16], then
    the styles of `rows`: a rank of a mesh's data axis computes what the
    single-rank step computes for its frames (the BiLSTM reads every frame,
    the dropout draws [B, ...] from `generator`)."""
    return audio(mels, generator)[rows]


def build_step_fns(
    nerf_cfg: NeRFConfig,
    train_cfg: TrainConfig,
    steps_per_epoch: int = 1,
    vgg: Optional[VGG16Features] = None,
    device: Optional[Union[str, torch.device]] = None,
    use_fused: Optional[bool] = None,
    mesh: Optional[Mesh] = None,
    compute_dtype: Optional[torch.dtype] = None,
    precomputed_vgg: bool = True,
) -> StepFns:
    """Step functions on `device` (default `cuda`), or on the device of this
    rank of `mesh`. `use_fused` defaults to the GPU, and is always on under a
    mesh (K4: the kernels on the GPU, their plain versions on the CPU);
    `compute_dtype` defaults to bf16 on the GPU (the kernels' only one; with
    `train_cfg.bf16_compute` False and the kernels on, it raises) and f32 on
    the CPU. `precomputed_vgg`: the batches carry the GT's VGG planes
    (`TrainConfig.vgg_precompute_gt`); otherwise each step computes them.

    Batch layout (tensors on the device): mels [B, 80, 16], gt_rgb
    [B, H, W, 3], head_mask [B, H, W, 1], iden/expr/text/illu, audio_exp
    [B, 64], Rmat [B, 3, 3], Tvec [B, 3], inv_inmat [B, 3, 3], xy [B, N_r, 2],
    and with a `vgg` vgg_f0..vgg_f3 (the masked-GT VGG planes,
    `FrameDataset.precompute_gt_vgg`). Under a mesh: this rank's shard, and
    the global batch's mels."""
    dev = resolve_device(device if mesh is None else mesh.device)
    on_gpu = dev.type == "cuda"
    if use_fused is None:
        use_fused = on_gpu or mesh is not None
    if compute_dtype is None and on_gpu and not train_cfg.bf16_compute and use_fused:
        raise ValueError("bf16_compute=False on the GPU: the fused render kernels compute in "
                         "bfloat16 only; build the step with use_fused=False for f32")
    cdt = compute_dtype or (torch.bfloat16 if on_gpu and train_cfg.bf16_compute
                            else torch.float32)
    vgg_cdt = cdt if cdt == torch.bfloat16 else None
    bg_value = 1.0 if nerf_cfg.bg_type == "white" else 0.0
    sched = make_schedule(train_cfg, steps_per_epoch)

    def init(seed: int) -> TrainState:
        """Models from seeded CPU generators (NeRF `seed`, audio `seed + 1`),
        moved to the device, and a fresh optimizer."""
        nerf = HeadNeRF(nerf_cfg, compute_dtype=cdt, use_fused=use_fused, device=dev,
                        generator=torch.Generator().manual_seed(seed), mesh=mesh)
        audio = Audio2Style(device=dev, generator=torch.Generator().manual_seed(seed + 1))
        if mesh is not None:   # the same seeds on every rank; rank 0's values, checked
            sync_params(list(nerf.parameters()) + list(audio.parameters()), mesh)
        opt = make_optimizer({"nerf": trainable(nerf), "audio": trainable(audio)}, train_cfg)
        return TrainState(nerf, audio, opt, sched)

    def forward(state: TrainState, batch, generator: Optional[torch.Generator]):
        xy = batch["xy"]
        B, R = xy.shape[:2]
        rows, rays = slice(None), slice(None)
        if mesh is not None:    # this rank's part of the global batch and draws
            B, R = batch["mels"].shape[0], R * mesh.rays
            rows, rays = mesh.rows(B), mesh.ray_range(R)
        audio_style = audio_style_rows(state.audio, batch["mels"], rows, generator)
        shape_code, appea_code = assemble_codes(batch, batch.get("audio_exp"))
        noise = None
        if generator is not None:
            noise = torch.rand(B, R, nerf_cfg.num_sample_coarse + 1,
                               generator=generator, device=dev)[rows, rays]
        return state.nerf(xy, shape_code, appea_code, audio_style, batch["Rmat"],
                          batch["Tvec"], batch["inv_inmat"], noise=noise)

    def losses_of(pred, batch):
        gt_feats = ([batch[f"vgg_f{i}"] for i in range(4)] if vgg is not None and precomputed_vgg
                    else None)
        return headnerf_losses(pred, batch["gt_rgb"], batch["head_mask"], bg_value,
                               vgg=vgg, vgg_compute_dtype=vgg_cdt, gt_vgg_feats=gt_feats,
                               data_group=None if mesh is None else mesh.data_group)

    def loss_and_grads(state: TrainState, batch, generator=None):
        """(losses, grads {"nerf": [...], "audio": [...]}) of one batch, in
        the order of `state.params()`; no update. Under a mesh the losses
        and the gradients are the global batch's, the same on every rank."""
        params = state.params()
        losses = losses_of(forward(state, batch, generator), batch)
        flat = torch.autograd.grad(losses["total_loss"], params["nerf"] + params["audio"])
        if mesh is not None:
            flat = all_reduce_sum(flat, scale=1.0 / mesh.rays)
        n = len(params["nerf"])
        return losses, {"nerf": list(flat[:n]), "audio": list(flat[n:])}

    def device_step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
                    deterministic: bool = False, skip: bool = False) -> Dict[str, torch.Tensor]:
        """One guarded two-group Adam step, all of it on the device; returns
        the losses as 0-d device tensors with `finite_step` (1 or 0). Jitter
        and dropout come from `generator` (on the device) unless
        `deterministic`. `skip` takes the update's non-finite branch whatever
        the gradients: nothing moves and Adam's step counts stay, but its
        state exists afterwards (a CUDA graph's warm-up). `state.step` is
        the caller's to count."""
        if not deterministic and generator is None:
            raise ValueError("train_step needs a generator unless deterministic")
        losses, grads = loss_and_grads(state, batch, None if deterministic else generator)
        ok = all_finite(grads["nerf"] + grads["audio"])
        apply_update(state, grads, torch.zeros_like(ok) if skip else ok)
        out = {k: v.detach() for k, v in losses.items()}
        out["finite_step"] = ok.float()
        return out

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
                   deterministic: bool = False) -> Dict[str, torch.Tensor]:
        """`device_step`, counted in `state.step`."""
        out = device_step(state, batch, generator, deterministic)
        state.step += 1
        return out

    @torch.no_grad()
    def render(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        return forward(state, batch, None)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        pred = forward(state, batch, None)
        return pred["merge_img"], losses_of(pred, batch)

    return StepFns(init=init, loss_and_grads=loss_and_grads, device_step=device_step,
                   train_step=train_step, eval_step=eval_step, render=render, compute_dtype=cdt)
