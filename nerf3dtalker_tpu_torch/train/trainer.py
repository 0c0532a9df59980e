"""Epoch-level training loop (port of `nerf3dtalker_tpu/train/trainer.py`,
reference `Trainer`, talker_trainer.py:568-1241): epochs over the frame
dataset; every `val_every` epochs and after the last, validation with SSIM,
PSNR and (given LPIPS-alex weights) LPIPS, GT|render strips of the
validation frames under `log_dir/temp_image/epoch{e}/`, the same metrics as
TRAIN_* over an optional train-split eval set, and a checkpoint stamped
with them; resume, `from_checkpoint` (the configs rebuilt from the
checkpoint), and the non-finite-step guard.

Losses accumulate on the device and reach the host once per epoch. The
per-step seed of the jitter and dropout generator is
`(seed + epoch) * 100003 + step_in_epoch`, as the JAX trainer derives its
step keys, so a resumed run draws what the uninterrupted one would.

With a `mesh` (`parallel.mesh`) every rank draws the same global batch
order and trains on its shard of each batch (`shard_batch`); validation runs
in batches of the data axis's size (frames that do not divide are skipped,
with a warning) and every rank reports the same SSIM and PSNR. Only rank 0
writes checkpoints and metrics.jsonl; every rank loads on resume. The
kernel launches of the train steps and of validation are counted on every
rank (`kernel_launches`, `mesh_report`); rank 0 writes the validation strips of
its own frames.

Not ported yet: whole epochs as one device program (`_cached_epoch`), the
native prefetcher, TensorBoard and the profiler trace.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
from nerf3dtalker_tpu_torch.data.dataset import FrameDataset, to_tensors
from nerf3dtalker_tpu_torch.models.misc import draw_side_by_side
from nerf3dtalker_tpu_torch.models.perceptual import load_vgg16
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
from nerf3dtalker_tpu_torch.parallel.mesh import Mesh, checksums_agree, shard_batch
from nerf3dtalker_tpu_torch.train.step import TrainState, build_step_fns
from nerf3dtalker_tpu_torch.utils import checkpoints as ckpt
from nerf3dtalker_tpu_torch.utils.device import resolve_device
from nerf3dtalker_tpu_torch.utils.guards import StepGuard
from nerf3dtalker_tpu_torch.utils.metrics import AlexNetFeatures, lpips_alex, psnr, ssim_rgb
from nerf3dtalker_tpu_torch.utils.video import write_png

log = logging.getLogger("nerf3dtalker_tpu_torch")

# a frame set (with its VGG planes) up to this size lives on the device and
# batches are gathered there; a larger one goes up batch by batch
DEVICE_CACHE_BYTES = 6 * 1024**3


def step_seed(seed: int, epoch: int, i: int) -> int:
    return ((seed + epoch) * 100003 + i) & 0xFFFFFFFF


class Trainer:
    def __init__(
        self,
        nerf_cfg: NeRFConfig,
        train_cfg: TrainConfig,
        train_data: FrameDataset,
        val_data: Optional[FrameDataset] = None,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Mesh] = None,
        lpips: Optional[Tuple[AlexNetFeatures, List[torch.Tensor]]] = None,
        train_eval_data: Optional[FrameDataset] = None,
    ):
        """`lpips`: (AlexNet trunk, lin weights) of `utils.metrics.
        load_lpips_alex` on this device, for LPIPS in validation.
        `train_eval_data`: frames of the train split whose metrics
        validation reports as TRAIN_SSIM, TRAIN_PSNR (and TRAIN_LPIPS)."""
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh
        self.nerf_cfg, self.train_cfg = nerf_cfg, train_cfg
        self.train_data, self.val_data = train_data, val_data
        self.train_eval_data, self.lpips = train_eval_data, lpips
        # a 1-frame subject still trains under the B=2 default
        self.batch_size = max(1, min(train_cfg.batch_size, len(train_data)))
        if self.batch_size != train_cfg.batch_size:
            log.warning("batch_size %d > dataset size %d; training with B=%d",
                        train_cfg.batch_size, len(train_data), self.batch_size)
        if mesh is not None and self.batch_size % mesh.data:
            raise ValueError(f"batch {self.batch_size} does not divide over the mesh's "
                             f"data axis {mesh.data}")
        if len(train_data) % self.batch_size:
            log.warning("dataset size %d not divisible by batch %d: %d frame(s) dropped "
                        "from each epoch", len(train_data), self.batch_size,
                        len(train_data) % self.batch_size)
        vgg = (load_vgg16(train_cfg.vgg_weights, seed=0, device=self.device)
               if train_cfg.use_vgg_loss else None)
        self.steps_per_epoch = max(1, len(train_data) // self.batch_size)
        self.fns = build_step_fns(nerf_cfg, train_cfg, self.steps_per_epoch, vgg=vgg,
                                  device=self.device, mesh=mesh)
        if vgg is not None:
            vgg_cdt = self.fns.compute_dtype if self.fns.compute_dtype == torch.bfloat16 else None
            bg = 1.0 if nerf_cfg.bg_type == "white" else 0.0
            # recompute planes made with other weights, background or dtype
            fp = (float(next(vgg.parameters()).abs().sum()), bg, str(vgg_cdt))
            for ds in (train_data, val_data, train_eval_data):
                if ds is not None and getattr(ds, "vgg_fingerprint", None) != fp:
                    ds.precompute_gt_vgg(vgg, bg_value=bg, compute_dtype=vgg_cdt)
                    ds.vgg_fingerprint = fp
        self.guard = StepGuard(policy=train_cfg.guard_policy)
        self.use_device_cache = train_data.nbytes() <= DEVICE_CACHE_BYTES
        if self.use_device_cache:
            train_data.to_device(self.batch_size, self.device)
        self.state: Optional[TrainState] = None
        self.history: list = []
        self.start_epoch = 0
        self.generator = torch.Generator(device=self.device)
        # K1 and K2 launches on this rank, inside the train steps and validation
        self.kernel_launches = {"train_steps": [0, 0], "validation": [0, 0]}
        self.is_writer = mesh is None or mesh.rank == 0

    # ------------------------------------------------------------- lifecycle

    def init(self, seed: Optional[int] = None) -> None:
        self.state = self.fns.init(self.train_cfg.seed if seed is None else seed)

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        train_data: FrameDataset,
        val_data: Optional[FrameDataset] = None,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Mesh] = None,
        lpips: Optional[Tuple[AlexNetFeatures, List[torch.Tensor]]] = None,
        train_eval_data: Optional[FrameDataset] = None,
        **cfg_overrides,
    ) -> "Trainer":
        """A trainer rebuilt from the newest checkpoint under `path` alone:
        both configs from the ones it embeds (the reference's `para`,
        train.py:18-22), `cfg_overrides` applied over the TrainConfig (e.g.
        `epochs=60` to extend a run), then `init` and the checkpoint's
        state. Later saves and rollbacks go to `path` unless `ckpt_dir` is
        overridden."""
        payload = ckpt.load_checkpoint(path, map_location="cpu")
        cfgd = payload.get("config", {})
        if "nerf" not in cfgd:
            raise ValueError(f"checkpoint under {path} has no embedded config; "
                             "pass the configs and use resume() instead")

        def build(cls_, d):
            fields = {f.name for f in dataclasses.fields(cls_)}
            return cls_(**{k: v for k, v in d.items() if k in fields})

        cfg_overrides.setdefault("ckpt_dir", path)
        t = cls(build(NeRFConfig, cfgd["nerf"]),
                build(TrainConfig, {**cfgd.get("train", {}), **cfg_overrides}),
                train_data, val_data, device=device, mesh=mesh, lpips=lpips,
                train_eval_data=train_eval_data)
        t.init()
        t._load(payload)
        return t

    def resume(self, ckpt_dir: str) -> int:
        """Load the newest checkpoint under `ckpt_dir` into the state (call
        `init` first); training goes on at the epoch of its step."""
        return self._load(ckpt.load_checkpoint(ckpt_dir, map_location=self.device))

    def _load(self, payload: dict) -> int:
        self.state.nerf.load_state_dict(payload["nerf"])
        self.state.audio.load_state_dict(payload["audio"])
        self.state.opt.load_state_dict(payload["opt"])
        self.state.step = int(payload["step"])
        self.start_epoch = self.state.step // self.steps_per_epoch
        return self.state.step

    def save(self, metrics: Optional[Dict] = None) -> None:
        """Rank 0 writes the checkpoint; under a mesh every rank then waits
        for it, so a rollback never reads a half-written one."""
        if not self.train_cfg.ckpt_dir:
            return
        if self.is_writer:
            ckpt.save_checkpoint(self.train_cfg.ckpt_dir, {
                "nerf": self.state.nerf.state_dict(),
                "audio": self.state.audio.state_dict(),
                "opt": self.state.opt.state_dict(),
                "config": {"nerf": dataclasses.asdict(self.nerf_cfg),
                           "train": dataclasses.asdict(self.train_cfg)},
                "metrics": metrics or {},
            }, step=self.state.step)
        if self.mesh is not None:
            self.mesh.barrier()

    # ------------------------------------------------------------- training

    def _batches(self, epoch: int):
        order = np.arange(len(self.train_data))
        np.random.default_rng(self.train_cfg.seed + epoch).shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order) - len(order) % bs, bs):
            idx = order[i:i + bs]
            if self.use_device_cache:
                batch = self.train_data.device_batch(idx)
            else:
                batch = to_tensors(self.train_data.batch(idx), self.device)
            yield batch if self.mesh is None else shard_batch(batch, self.mesh)

    def _count_launches(self, path: str, before) -> None:
        counts = self.kernel_launches[path]
        counts[0] += fr.fused_render_fwd.launches - before[0]
        counts[1] += fr.fused_render_bwd.launches - before[1]

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        t0 = time.perf_counter()
        before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
        for i, batch in enumerate(self._batches(epoch)):
            self.generator.manual_seed(step_seed(self.train_cfg.seed, epoch, i))
            losses = self.fns.train_step(self.state, batch, self.generator)
            for k, v in losses.items():
                totals[k] = totals[k] + v if k in totals else v
            n += 1
        self._count_launches("train_steps", before)
        avg = {k: float(v) / max(n, 1) for k, v in totals.items()}   # the epoch's one sync
        avg["sec_per_step"] = (time.perf_counter() - t0) / max(n, 1)
        avg["rays_per_s"] = self.batch_size * self.nerf_cfg.n_rays / max(avg["sec_per_step"], 1e-9)
        self._last_epoch_steps = n
        return avg

    def validate(self, dump_dir: Optional[str] = None, epoch: int = 0) -> Dict[str, float]:
        """The validation split's metrics, and the train-eval split's as
        TRAIN_*; the validation frames' GT|render strips go under
        `dump_dir/epoch{epoch}/`."""
        before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
        out = self._eval_split(self.val_data, dump_dir=dump_dir, epoch=epoch)
        if self.train_eval_data is not None:
            out.update({f"TRAIN_{k}": v for k, v in self._eval_split(self.train_eval_data).items()})
        self._count_launches("validation", before)
        return out

    @torch.no_grad()
    def _eval_split(self, data: Optional[FrameDataset], dump_dir: Optional[str] = None,
                    epoch: int = 0) -> Dict[str, float]:
        """Mean SSIM, PSNR (and LPIPS) over a split, one frame per render;
        under a mesh one frame per data rank, summed over the ranks so that
        every rank reports the same means."""
        if data is None:
            return {}
        bs = 1 if self.mesh is None else self.mesh.data
        rows = slice(0, 1) if self.mesh is None else self.mesh.rows(bs)
        dump = os.path.join(dump_dir, f"epoch{epoch}") if dump_dir and self.is_writer else None
        if dump:
            os.makedirs(dump, exist_ok=True)
        # SSIM, PSNR, LPIPS, frames
        sums = torch.zeros(4, dtype=torch.float64, device=self.device)
        for first, batch in zip(range(0, len(data), bs),
                                data.epoch(bs, rng=None, drop_last=bs > 1)):
            tb = to_tensors(batch, self.device)
            if self.mesh is not None:
                tb = shard_batch(tb, self.mesh)
            imgs, _ = self.fns.eval_step(self.state, tb)
            for j in range(imgs.shape[0]):
                pred, gt = imgs[j], tb["gt_rgb"][j]
                lp = sums.new_zeros(())
                if self.lpips is not None:
                    lp = lpips_alex(*self.lpips, pred[None].float(), gt[None])[0].double()
                sums += torch.stack([ssim_rgb(pred, gt).double(), psnr(pred, gt).double(), lp,
                                     sums.new_ones(())])
                if dump:
                    write_png(os.path.join(dump, f"val_{first + rows.start + j:04d}.png"),
                              draw_side_by_side(gt.cpu().numpy(), pred.float().cpu().numpy()))
        if self.mesh is not None:
            skipped = len(data) % bs
            if skipped:
                log.warning("validate: %d val frame(s) skipped (val set not divisible by the "
                            "mesh data axis %d)", skipped, bs)
            dist.all_reduce(sums)          # every rank's frames; each rays group
            sums /= self.mesh.rays          # saw its frames Rr times
        if not sums[3]:
            return {}
        out = {"SSIM": float(sums[0] / sums[3]), "PSNR": float(sums[1] / sums[3])}
        if self.lpips is not None:
            out["LPIPS"] = float(sums[2] / sums[3])
        return out

    def mesh_report(self) -> Dict:
        """Every rank's kernel launches ([K1, K2] in the train steps, then in
        validation) and whether every rank holds bit-identical parameters.
        Collectives over the whole layout: every rank calls it."""
        n = dist.get_world_size()
        counts = torch.zeros(n, 4, dtype=torch.int64, device=self.device)
        counts[self.mesh.rank] = torch.tensor(self.kernel_launches["train_steps"]
                                              + self.kernel_launches["validation"])
        dist.all_reduce(counts)
        params = [p for ps in self.state.params().values() for p in ps]
        return {"launches_by_rank": counts.tolist(), "params_identical": checksums_agree(params)}

    def train(self, epochs: Optional[int] = None) -> list:
        if self.state is None:
            self.init()
        epochs = epochs or self.train_cfg.epochs
        every = max(self.train_cfg.val_every, 1)
        dump_dir = (os.path.join(self.train_cfg.log_dir, "temp_image")
                    if self.train_cfg.log_dir else None)
        mlog = None
        if self.train_cfg.log_dir and self.is_writer:
            os.makedirs(self.train_cfg.log_dir, exist_ok=True)
            mlog = open(os.path.join(self.train_cfg.log_dir, "metrics.jsonl"), "a")
        try:
            for e in range(self.start_epoch, epochs):
                rec = {"epoch": e, **self.train_one_epoch(e)}
                n = self._last_epoch_steps
                n_bad = int(round(n * (1.0 - rec.get("finite_step", 1.0))))
                if self.guard.epoch_check(n_bad, n, e) == "rollback":
                    if self.train_cfg.ckpt_dir and ckpt.has_checkpoint(self.train_cfg.ckpt_dir):
                        step = self.resume(self.train_cfg.ckpt_dir)
                        log.warning("StepGuard: rolled back to checkpoint step %d after %d "
                                    "non-finite step(s) in epoch %d", step, n_bad, e)
                    else:
                        log.warning("StepGuard: rollback requested but no checkpoint exists "
                                    "yet; continuing with guarded params")
                    rec["rollback"] = 1.0     # neither validated nor saved
                elif (e + 1) % every == 0 or e == epochs - 1:
                    val = self.validate(dump_dir=dump_dir, epoch=e)
                    rec.update(val)
                    self.save(metrics=val)
                self.history.append(rec)
                log.info("epoch %d: %s", e, rec)
                if mlog is not None:
                    mlog.write(json.dumps({"step": self.state.step, "time": time.time(),
                                           **rec}) + "\n")
                    mlog.flush()
        finally:
            if mlog is not None:
                mlog.close()
        return self.history
