"""Rank-side checks of the mesh path. `start` spawns one process per rank
(gloo or NCCL as `init_ranks` chooses, rendezvous through a file) and each
runs `run_rank` on a job the caller wrote; every rank saves what it saw, and
the caller compares it with a single-rank or JAX reference. The port's tests
run it on the CPU and `chip_smoke.py` on the card. It imports torch and the
port only, so the ranks never import JAX.

A job is a dict (`torch.save`d by `start`):

  device    "cpu" or "cuda"
  meshes    [(data, rays), ...], each over the same `world` ranks
  step      optional: one deterministic step on each mesh. nerf_cfg and
            train_cfg (dicts of the configs' fields), seed, steps_per_epoch,
            vgg (bool: the seeded VGG16 of `load_vgg16(seed=0)`), batch (the
            global batch, CPU tensors), state (optional {"nerf", "audio"}
            numpy state dicts, `utils.bridge` layout, loaded over the seeded
            init), adam (also take the
            guarded Adam step), save (rank 0 saves losses, gradients and,
            with adam, the params after the step)
  checks    optional, on the first mesh: k4 (global K4 inputs, packed
            weights and output cotangents: every rank saves its shard's
            outputs and weight gradients), gather ([B, R, C] global tensor
            and weights of a loss: the gathered value and the shard's
            gradient), losses (global pred / gt / mask: the mesh losses and
            the gradient on this rank's rows of merge_img), audio (mels and
            a dropout seed: this rank's rows of the styles)
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from nerf3dtalker_tpu_torch.parallel.mesh import (Mesh, checksums_agree, gather_rays, init_ranks,
                                                   make_mesh, shard_batch)


def start(job: Dict, world: int, workdir: str) -> Callable[[], List[Dict]]:
    """Start `job` on `world` spawned ranks and return a function that waits
    for them and returns each rank's results, in rank order. A rank that
    fails makes that function raise."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="mesh-check-", dir=workdir)
    job_path = os.path.join(d, "job.pt")
    torch.save(job, job_path)
    ctx = mp.spawn(run_rank, args=(world, job_path, f"file://{os.path.join(d, 'store')}", d),
                   nprocs=world, join=False)

    def results() -> List[Dict]:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(d, f"rank{k}.pt"), weights_only=False)
                for k in range(world)]

    return results


def _launches():
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    return (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches,
            fr.fused_render_spmd.launches)


def _step(spec: Dict, mesh: Mesh) -> Dict:
    from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
    from nerf3dtalker_tpu_torch.models.perceptual import load_vgg16
    from nerf3dtalker_tpu_torch.train.step import build_step_fns
    from nerf3dtalker_tpu_torch.utils import bridge

    dev = mesh.device
    vgg = load_vgg16(seed=0, device=dev) if spec.get("vgg") else None
    fns = build_step_fns(NeRFConfig(**spec["nerf_cfg"]), TrainConfig(**spec["train_cfg"]),
                         spec.get("steps_per_epoch", 1), vgg=vgg, mesh=mesh)
    state = fns.init(spec.get("seed", 0))
    if spec.get("state"):
        bridge.load_into(state.nerf, spec["state"]["nerf"])
        bridge.load_into(state.audio, spec["state"]["audio"])
    batch = shard_batch({k: v.to(dev) for k, v in spec["batch"].items()}, mesh)
    before = _launches()
    losses, grads = fns.loss_and_grads(state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    after = _launches()
    flat = grads["nerf"] + grads["audio"]
    out = {"losses": {k: float(v.detach()) for k, v in losses.items()},
           "grads_identical": checksums_agree(flat),
           "launches": {"fused_render_fwd": after[0] - before[0],
                        "fused_render_bwd": after[1] - before[1],
                        "fused_render_spmd": after[2] - before[2]}}
    save = spec.get("save") and mesh.rank == 0
    if save:
        out["grads"] = {g: [t.cpu() for t in v] for g, v in grads.items()}
    if spec.get("adam"):
        res = fns.train_step(state, batch, deterministic=True)
        out["finite_step"] = float(res["finite_step"])
        out["params_identical"] = checksums_agree(
            [p for ps in state.params().values() for p in ps])
        if save:
            out["params"] = {"nerf": {k: v.cpu() for k, v in state.nerf.state_dict().items()},
                             "audio": {k: v.cpu() for k, v in state.audio.state_dict().items()}}
    return out


def _k4(spec: Dict, mesh: Mesh) -> Dict:
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    dev = mesh.device
    B, R = spec["pe"].shape[:2]
    rows, rays = mesh.rows(B), mesh.ray_range(R)
    local = {k: spec[k][rows, rays].contiguous().to(dev)
             for k in ("pe", "zd", "zv", "g_feat", "g_bg", "g_depth")}
    packed = {k: (v[rows] if k in ("b0", "b5", "br1") else v).to(dev).requires_grad_()
              for k, v in spec["packed"].items()}
    outs = fr.fused_render_spmd(local["pe"], local["zd"], local["zv"], packed, mesh,
                                spec.get("compute_dtype", torch.float32))
    torch.autograd.backward(outs, (local["g_feat"], local["g_bg"], local["g_depth"]))
    return {"outs": [o.detach().cpu() for o in outs],
            "grads": {k: v.grad.cpu() for k, v in packed.items()}}


def _gather(spec: Dict, mesh: Mesh) -> Dict:
    x, w = spec["x"].to(mesh.device), spec["w"].to(mesh.device)
    rows, rays = mesh.rows(x.shape[0]), mesh.ray_range(x.shape[1])
    shard = x[rows, rays].clone().requires_grad_()
    y = gather_rays(shard, mesh)
    (y * w[rows]).sum().backward()
    return {"value_err": float((y.detach() - x[rows]).abs().max()),
            "grad_err": float((shard.grad - w[rows, rays]).abs().max())}


def _losses(spec: Dict, mesh: Mesh) -> Dict:
    from nerf3dtalker_tpu_torch.train.losses import headnerf_losses

    dev = mesh.device
    rows = mesh.rows(spec["merge_img"].shape[0])
    merge = spec["merge_img"][rows].clone().to(dev).requires_grad_()
    losses = headnerf_losses({"merge_img": merge, "bg_img": spec["bg_img"].to(dev)},
                             spec["gt_rgb"][rows].to(dev), spec["head_mask"][rows].to(dev),
                             spec.get("bg_value", 1.0), data_group=mesh.data_group)
    losses["total_loss"].backward()
    return {"losses": {k: float(v.detach()) for k, v in losses.items()},
            "grad_rows": merge.grad.cpu(), "rows": rows}


def _audio(spec: Dict, mesh: Mesh) -> Dict:
    from nerf3dtalker_tpu_torch.models.audio import Audio2Style
    from nerf3dtalker_tpu_torch.train.step import audio_style_rows

    dev = mesh.device
    audio = Audio2Style(device=dev, generator=torch.Generator().manual_seed(spec["init_seed"]))
    mels = spec["mels"].to(dev)
    gen = torch.Generator(device=dev).manual_seed(spec["dropout_seed"])
    rows = mesh.rows(mels.shape[0])
    with torch.no_grad():
        return {"rows": rows, "styles": audio_style_rows(audio, mels, rows, gen).cpu()}


_CHECKS = {"k4": _k4, "gather": _gather, "losses": _losses, "audio": _audio}


def run_rank(local_rank: int, world: int, job_path: str, init_method: str, out_dir: str) -> None:
    """One rank of `start`: rank = local_rank on this host."""
    job = torch.load(job_path, weights_only=False)   # written by `start` of this package
    dev = init_ranks(local_rank, world, local_rank, world, job["device"], init_method)
    try:
        results = {}
        for i, (data, rays) in enumerate(job["meshes"]):
            mesh = make_mesh(data, rays, device=dev)
            res = {"coords": (mesh.d, mesh.r)}
            if job.get("step"):
                res["step"] = _step(job["step"], mesh)
            if i == 0:
                for name, spec in job.get("checks", {}).items():
                    res[name] = _CHECKS[name](spec, mesh)
            results[(data, rays)] = res
        torch.save(results, os.path.join(out_dir, f"rank{local_rank}.pt"))
    finally:
        dist.destroy_process_group()
