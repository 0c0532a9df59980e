"""Epoch-level training loop (port of `nerf3dtalker_tpu/train/trainer.py`,
reference `Trainer`, talker_trainer.py:568-1241): epochs over the frame
dataset; every `val_every` epochs and after the last, validation with SSIM,
PSNR and (given LPIPS-alex weights) LPIPS, GT|render strips of the
validation frames under `log_dir/temp_image/epoch{e}/`, the same metrics as
TRAIN_* over an optional train-split eval set, and a checkpoint stamped
with them; resume, `from_checkpoint` (the configs rebuilt from the
checkpoint), the non-finite-step guard, `metrics.jsonl` (and TensorBoard)
through `utils/observability.MetricLogger`, and a profiler trace of the
first epoch's steps 1..`trace_steps`.

With the frame set on the device (`device_cache`) and no mesh, `train`
runs the epochs up to each validation as one group (`train_epoch_group`,
the JAX `_cached_epoch` program): the group's shuffle orders go to the
device at once, losses accumulate there, and the host syncs once per
group. On the GPU each step of a group is one replay of a CUDA graph of
the whole step (`StepGraph`: the batch gathered from the cache by a static
index buffer, forward through K1, backward through K2, the guarded Adam
update), captured at the first group after two warm-up steps that move
nothing; on the CPU the same steps run eagerly (the plain version). The
per-step seed of the jitter and dropout generator is
`(seed + epoch) * 100003 + step_in_epoch`, as the JAX trainer derives its
step keys, so a graph replay, an eager step and a resumed run draw alike.
A checkpoint loads into the tensors the graph reads (`load_optimizer_state`),
so a rollback or resume keeps it valid; `train` frees the graph and its
memory pool when it returns.

Without the device cache the batches come from the host, or with
`native_prefetch` from the C++ prefetcher (`data/native.FramePrefetcher`).

With a `mesh` (`parallel.mesh`) every rank draws the same global batch
order and trains on its shard of each batch (`shard_batch`), epoch by epoch
and eagerly; validation runs in batches of the data axis's size (frames
that do not divide are skipped, with a warning) and every rank reports the
same SSIM and PSNR. Only rank 0 writes checkpoints and metrics.jsonl; every
rank loads on resume. The kernel launches of the train steps, of a graph's
warm-up and of validation are counted on every rank (`kernel_launches`,
`mesh_report`); rank 0 writes the validation strips of its own frames.
"""

from __future__ import annotations

import dataclasses
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
from nerf3dtalker_tpu_torch.train.step import (StepFns, TrainState, build_step_fns,
                                               load_optimizer_state)
from nerf3dtalker_tpu_torch.utils import checkpoints as ckpt
from nerf3dtalker_tpu_torch.utils import observability as obs
from nerf3dtalker_tpu_torch.utils.device import resolve_device
from nerf3dtalker_tpu_torch.utils.guards import StepGuard
from nerf3dtalker_tpu_torch.utils.metrics import AlexNetFeatures, lpips_alex, psnr, ssim_rgb
from nerf3dtalker_tpu_torch.utils.video import write_png

log = logging.getLogger("nerf3dtalker_tpu_torch")

# steps run before a capture, with the update skipped (they move nothing):
# lazy initialisation (Adam's state, cuBLAS and cuDNN handles and
# workspaces) happens outside the graph
GRAPH_WARMUP_STEPS = 2


def step_seed(seed: int, epoch: int, i: int) -> int:
    return ((seed + epoch) * 100003 + i) & 0xFFFFFFFF


def epoch_order(num_frames: int, seed: int, epoch: int) -> np.ndarray:
    """The frames of `epoch` in their shuffled order (numpy seed + epoch)."""
    order = np.arange(num_frames)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


class StepGraph:
    """The train step captured as one CUDA graph over a device-cached frame
    set: the batch gathered by the static index buffer `idx`, the guarded
    two-group Adam step (`StepFns.device_step`) with its jitter and dropout
    drawn from `generator` (registered with the graph, so a replay after
    `manual_seed(s)` draws what an eager step seeded `s` draws), and the
    losses added into `acc` on the device.

    The capture follows GRAPH_WARMUP_STEPS skipped steps on a side stream.
    Its records: `warmup_s`, `capture_s` (host seconds), `pool_bytes` (the
    device memory the capture reserved: its private pool) and `launches`
    (the K1/K2 launches each replay makes). The graph reads the state's
    tensors where they were at capture: load into them in place
    (`load_optimizer_state`, `load_state_dict` of the modules)."""

    def __init__(self, fns: StepFns, state: TrainState, data: FrameDataset, batch_size: int,
                 generator: torch.Generator):
        dev = data._dev_xy.device
        self.state, self.generator = state, generator
        self.idx = torch.arange(batch_size, dtype=torch.int64, device=dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            for _ in range(GRAPH_WARMUP_STEPS):
                out = fns.device_step(state, data.device_batch(self.idx), generator, skip=True)
        stream.synchronize()
        self.warmup_s = time.perf_counter() - t0
        self.keys = list(out)
        self.acc = torch.zeros(len(self.keys), device=dev)
        for group in state.opt.param_groups:
            group["capturable"] = True
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        t0 = time.perf_counter()
        with fr.record_launches() as launches, torch.cuda.graph(self.graph, stream=stream):
            out = fns.device_step(state, data.device_batch(self.idx), generator)
            self.acc += torch.stack([out[k] for k in self.keys])
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = launches

    def step(self, idx: torch.Tensor, seed: int) -> None:
        """One train step: the frames `idx` (on the device), jitter and
        dropout seeded `seed`."""
        self.idx.copy_(idx)
        self.generator.manual_seed(seed)
        fr.replay(self.graph, self.launches)
        self.state.step += 1

    def take(self, out: torch.Tensor) -> None:
        """The losses summed since the last take, into `out` [len(keys)]."""
        out.copy_(self.acc)
        self.acc.zero_()

    def release(self) -> None:
        self.graph.reset()
        del self.graph, self.acc, self.idx


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
        precomputed_vgg = vgg is not None and train_cfg.vgg_precompute_gt
        self.fns = build_step_fns(nerf_cfg, train_cfg, self.steps_per_epoch, vgg=vgg,
                                  device=self.device, mesh=mesh,
                                  precomputed_vgg=precomputed_vgg)
        if precomputed_vgg:
            vgg_cdt = self.fns.compute_dtype if self.fns.compute_dtype == torch.bfloat16 else None
            bg = 1.0 if nerf_cfg.bg_type == "white" else 0.0
            # recompute planes made with other weights, background or dtype
            fp = (float(next(vgg.parameters()).abs().sum()), bg, str(vgg_cdt))
            for ds in (train_data, val_data, train_eval_data):
                if ds is not None and getattr(ds, "vgg_fingerprint", None) != fp:
                    ds.precompute_gt_vgg(vgg, bg_value=bg, compute_dtype=vgg_cdt)
                    ds.vgg_fingerprint = fp
        self.guard = StepGuard(max_bad=train_cfg.guard_max_bad, policy=train_cfg.guard_policy)
        self.use_device_cache = (train_cfg.device_cache
                                 and train_data.nbytes() <= train_cfg.device_cache_bytes)
        if self.use_device_cache:
            train_data.to_device(self.batch_size, self.device)
        # a group's steps replay one CUDA graph (set False for eager steps)
        self.use_graph = self.device.type == "cuda" and self.use_device_cache and mesh is None
        self._graph: Optional[StepGraph] = None
        self.graph_records: List[Dict] = []   # each capture's warmup_s, capture_s, pool_bytes
        self._prefetcher = None
        if train_cfg.native_prefetch and not self.use_device_cache:
            from nerf3dtalker_tpu_torch.data.native import FramePrefetcher

            self._prefetcher = FramePrefetcher(train_data, self.batch_size, seed=train_cfg.seed,
                                               device=self.device)
        self._trace_pending = bool(train_cfg.trace_dir)
        self.state: Optional[TrainState] = None
        self.history: list = []
        self.start_epoch = 0
        self.generator = torch.Generator(device=self.device)
        # K1 and K2 launches on this rank: in the train steps, in the steps
        # before a graph's capture, and in validation
        self.kernel_launches = {"train_steps": [0, 0], "graph_warmup": [0, 0],
                                "validation": [0, 0]}
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
        """The checkpoint's state, copied into the tensors the state holds
        (a captured graph reads them)."""
        self.state.nerf.load_state_dict(payload["nerf"])
        self.state.audio.load_state_dict(payload["audio"])
        load_optimizer_state(self.state.opt, payload["opt"])
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

    def close(self) -> None:
        """Free the step's CUDA graph and its pool, and stop the prefetcher."""
        self.release_graph()
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def release_graph(self) -> None:
        if self._graph is not None:
            self._graph.release()
            self._graph = None
            torch.cuda.empty_cache()

    def group_orders(self, start_epoch: int, n_epochs: int) -> Tuple[np.ndarray, np.ndarray]:
        """The frames of each step and each step's seed for epochs
        `start_epoch ..`: ([E, steps * B] int64, [E, steps]), the JAX
        `train_epoch_group`'s orders and keys (its seed_base + i)."""
        bs, n = self.batch_size, len(self.train_data) // self.batch_size
        orders = np.stack([epoch_order(len(self.train_data), self.train_cfg.seed, e)[:n * bs]
                           for e in range(start_epoch, start_epoch + n_epochs)])
        seeds = np.array([[step_seed(self.train_cfg.seed, e, i) for i in range(n)]
                          for e in range(start_epoch, start_epoch + n_epochs)], np.int64)
        return orders, seeds

    def _batches(self, epoch: int):
        bs = self.batch_size
        if self.use_device_cache:
            order = epoch_order(len(self.train_data), self.train_cfg.seed, epoch)
            batches = (self.train_data.device_batch(order[i:i + bs])
                       for i in range(0, len(order) - len(order) % bs, bs))
        elif self._prefetcher is not None:
            batches = (self._prefetcher.next() for _ in range(self._prefetcher.steps_per_epoch))
        else:
            batches = (to_tensors(b, self.device) for b in self.train_data.epoch(
                bs, np.random.default_rng(self.train_cfg.seed + epoch)))
        for batch in batches:
            yield batch if self.mesh is None else shard_batch(batch, self.mesh)

    def _launch_counts(self):
        return fr.fused_render_fwd.launches, fr.fused_render_bwd.launches

    def _count_launches(self, path: str, before) -> None:
        counts = self.kernel_launches[path]
        counts[0] += fr.fused_render_fwd.launches - before[0]
        counts[1] += fr.fused_render_bwd.launches - before[1]

    def _step_graph(self) -> StepGraph:
        if self._graph is None:
            before = self._launch_counts()
            self._graph = StepGraph(self.fns, self.state, self.train_data, self.batch_size,
                                    self.generator)
            self._count_launches("graph_warmup", before)
            g = self._graph
            self.graph_records.append({"warmup_s": g.warmup_s, "capture_s": g.capture_s,
                                       "pool_bytes": g.pool_bytes, "launches": dict(g.launches)})
            log.info("train step captured as a CUDA graph: %s", self.graph_records[-1])
        return self._graph

    def train_epoch_group(self, start_epoch: int, n_epochs: int) -> List[Dict[str, float]]:
        """`n_epochs` epochs from `start_epoch` on the device cache (no
        mesh), one averaged-metrics dict an epoch, with one host sync for
        the group. Orders and seeds are those of per-epoch calls
        (`group_orders`). On the GPU (`use_graph`) each step replays the
        step's CUDA graph (captured at the first call); otherwise the steps
        run eagerly."""
        if not self.use_device_cache or self.mesh is not None:
            raise ValueError("train_epoch_group runs on the device cache (device_cache, and a "
                             "frame set of at most device_cache_bytes) without a mesh")
        if self.state is None:
            self.init()
        bs = self.batch_size
        t0 = time.perf_counter()
        graph = self._step_graph() if self.use_graph else None   # its warm-up counted apart
        before = self._launch_counts()
        if graph is not None:
            orders, seeds = self.group_orders(start_epoch, n_epochs)
            keys, n = graph.keys, seeds.shape[1]
            totals = torch.zeros(n_epochs, len(keys), device=self.device)
            orders = torch.as_tensor(orders, device=self.device)
            for j in range(n_epochs):
                for i in range(n):
                    graph.step(orders[j, i * bs:(i + 1) * bs], int(seeds[j, i]))
                graph.take(totals[j])
        else:
            epochs = [self._eager_epoch(e) for e in range(start_epoch, start_epoch + n_epochs)]
            keys, n = list(epochs[0][0]), epochs[0][1]
            totals = torch.stack([torch.stack([sums[k] for k in keys]) for sums, _ in epochs])
        self._count_launches("train_steps", before)
        totals = totals.cpu()   # the group's one sync
        sec_per_step = (time.perf_counter() - t0) / max(n * n_epochs, 1)
        self._last_epoch_steps = n
        out = []
        for j in range(n_epochs):
            avg = {k: float(totals[j, c]) / max(n, 1) for c, k in enumerate(keys)}
            avg["sec_per_step"] = sec_per_step
            avg["rays_per_s"] = bs * self.nerf_cfg.n_rays / max(sec_per_step, 1e-9)
            out.append(avg)
        return out

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch: a group of one on the device cache (no mesh), else
        step by step (the mesh, the host loader or the prefetcher, and the
        first epoch while a trace is pending: steps 1..trace_steps traced)."""
        if self.use_device_cache and self.mesh is None and not self._trace_pending:
            return self.train_epoch_group(epoch, 1)[0]
        if self.state is None:
            self.init()
        t0 = time.perf_counter()
        before = self._launch_counts()
        totals, n = self._eager_epoch(epoch)
        self._count_launches("train_steps", before)
        avg = {k: float(v) / max(n, 1) for k, v in totals.items()}   # the epoch's one sync
        avg["sec_per_step"] = (time.perf_counter() - t0) / max(n, 1)
        avg["rays_per_s"] = self.batch_size * self.nerf_cfg.n_rays / max(avg["sec_per_step"], 1e-9)
        self._last_epoch_steps = n
        return avg

    def _eager_epoch(self, epoch: int) -> Tuple[Dict[str, torch.Tensor], int]:
        """An epoch's steps, eagerly: the losses summed on the device, and
        the steps. While a trace is pending, steps 1..trace_steps are
        traced (step 0 pays the first calls' set-up)."""
        totals: Dict[str, torch.Tensor] = {}
        n, tracing = 0, False
        for i, batch in enumerate(self._batches(epoch)):
            self.generator.manual_seed(step_seed(self.train_cfg.seed, epoch, i))
            losses = self.fns.train_step(self.state, batch, self.generator)
            if self._trace_pending:
                if i == 0:
                    self._sync()
                    obs.start_trace(self.train_cfg.trace_dir)
                    tracing = True
                elif tracing and i >= self.train_cfg.trace_steps:
                    self._sync()
                    self._stop_trace()
                    tracing = False
            for k, v in losses.items():
                totals[k] = totals[k] + v if k in totals else v
            n += 1
        if tracing:   # an epoch shorter than trace_steps
            self._sync()
            self._stop_trace()
        return totals, n

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stop_trace(self) -> None:
        path = obs.stop_trace()
        self._trace_pending = False
        log.info("profiler trace written to %s", path)

    def validate(self, dump_dir: Optional[str] = None, epoch: int = 0) -> Dict[str, float]:
        """The validation split's metrics, and the train-eval split's as
        TRAIN_*; the validation frames' GT|render strips go under
        `dump_dir/epoch{epoch}/`."""
        before = self._launch_counts()
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
        """Epochs `start_epoch .. epochs - 1`, grouped up to each validation
        on the device cache (JAX `Trainer.train`, trainer.py:548-620): the
        guard reads each epoch's finite share, and a rollback ends the group
        (its later epochs are dropped, training goes on at the next epoch
        from the checkpoint's state); a group's last epoch validates and
        saves on the `val_every` cadence and at the last epoch. Each epoch's
        `metrics.jsonl` line carries the step it ended at. The step's CUDA
        graph is freed on return."""
        if self.state is None:
            self.init()
        epochs = epochs or self.train_cfg.epochs
        ve = max(self.train_cfg.val_every, 1)
        dump_dir = (os.path.join(self.train_cfg.log_dir, "temp_image")
                    if self.train_cfg.log_dir else None)
        mlog = None
        if self.train_cfg.log_dir and self.train_cfg.metric_log and self.is_writer:
            mlog = obs.MetricLogger(self.train_cfg.log_dir,
                                    use_tensorboard=self.train_cfg.use_tensorboard)
        try:
            epoch = self.start_epoch
            while epoch < epochs:
                if self.use_device_cache and self.mesh is None and not self._trace_pending:
                    group = min(epochs - epoch, ve - (epoch % ve))
                    metrics_list = self.train_epoch_group(epoch, group)
                else:
                    metrics_list = [self.train_one_epoch(epoch)]
                rolled_back = False
                for j, train_metrics in enumerate(metrics_list):
                    e = epoch + j
                    n = self._last_epoch_steps
                    n_bad = int(round(n * (1.0 - train_metrics.get("finite_step", 1.0))))
                    if self.guard.epoch_check(n_bad, n, e) == "rollback":
                        if self.train_cfg.ckpt_dir and ckpt.has_checkpoint(self.train_cfg.ckpt_dir):
                            step = self.resume(self.train_cfg.ckpt_dir)
                            log.warning("StepGuard: rolled back to checkpoint step %d after %d "
                                        "non-finite step(s) in epoch %d", step, n_bad, e)
                        else:
                            log.warning("StepGuard: rollback requested but no checkpoint "
                                        "exists yet; continuing with guarded params")
                        rec = {"epoch": e, **train_metrics, "rollback": 1.0}
                        self.history.append(rec)
                        if mlog is not None:
                            mlog.log(self.state.step, rec)
                        rolled_back = True
                        epoch = e + 1
                        break     # the group's later epochs are neither validated nor saved
                    do_val = ((e + 1) % ve == 0 or e == epochs - 1) and j == len(metrics_list) - 1
                    val = self.validate(dump_dir=dump_dir, epoch=e) if do_val else {}
                    rec = {"epoch": e, **train_metrics, **val}
                    self.history.append(rec)
                    log.info("epoch %d: %s", e, rec)
                    if mlog is not None:    # the step this epoch of the group ended at
                        mlog.log(self.state.step - n * (len(metrics_list) - 1 - j),
                                 {k: v for k, v in rec.items() if k != "epoch"})
                    if do_val:
                        self.save(metrics=val)
                if not rolled_back:
                    epoch += len(metrics_list)
        finally:
            if mlog is not None:
                mlog.close()
            self.release_graph()
        return self.history
