"""Data × rays layouts of `torch.distributed` ranks (port of
`nerf3dtalker_tpu/parallel/mesh.py`: `make_mesh` :28, `replicated` :43,
`batch_sharding` :47, `batch_ray_sharding` :52, `shard_batch` :57).

The JAX package lays its devices out as a `(data, rays)` mesh and lets XLA
place arrays and insert the collectives. Here every rank is one process
with one device, and the collectives are written out:

  * axis "data": the frames of a batch (the DDP axis). Rank (d, r) holds
    rows d·b .. d·b + b - 1 of a global batch of B = D·b frames;
  * axis "rays": the NeRF rays of a frame. R = S·S rays in row-major pixel
    order, so rays shard r holds a contiguous band of image rows.

Rank = d·R + r. Each rank belongs to one rays group (the ranks of its data
row, which see the same frames) and one data group (the ranks of its rays
column). Parameters are replicated; `sync_params` makes them so.

`init_ranks` starts a rank: it picks the device and the backend from the
layout (NCCL when every rank has a card of its own, gloo when ranks share a
card or run on the CPU), prints them and joins the default group. A
failure to start or to run a collective raises; nothing retries on another
backend or device. The PartialFC `model` axis of the JAX mesh belongs to the
ArcFace trainer, which is not ported: `make_mesh(model > 1)` raises.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist


def choose_backend(device_type: str, local_world_size: int, device_count: int) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo
    (ranks sharing a card, or on the CPU)."""
    if device_type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def init_ranks(rank: int, world_size: int, local_rank: int, local_world_size: int,
               device: str = "cuda", init_method: str = "env://") -> torch.device:
    """Join the default process group as `rank` of `world_size` and return
    this rank's device: `cuda:(local_rank % device_count)`, or the CPU when
    `device` is "cpu" (then each rank computes on one torch thread, so that
    ranks sharing the host do not oversubscribe its cores). A rank that asks
    for CUDA and finds no card raises."""
    if device == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        backend = choose_backend("cpu", local_world_size, 0)
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: CUDA is not available")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
        backend = choose_backend("cuda", local_world_size, count)
    else:
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if rank == 0:
        share = (f"{local_world_size} ranks share {torch.cuda.device_count()} card(s)"
                 if dev.type == "cuda" and backend == "gloo" else "one device per rank")
        print(f"ranks: {world_size}, backend {backend} ({share}); local rank k -> "
              f"{'cpu' if dev.type == 'cpu' else 'cuda:(k % device_count)'}", flush=True)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, rays) layout of the default group."""

    data: int
    rays: int
    rank: int
    device: torch.device
    rays_group: object   # the ranks of this rank's data row
    data_group: object   # the ranks of this rank's rays column

    @property
    def d(self) -> int:
        return self.rank // self.rays

    @property
    def r(self) -> int:
        return self.rank % self.rays

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` frames."""
        b = batch // self.data
        return slice(self.d * b, (self.d + 1) * b)

    def ray_range(self, rays: int) -> slice:
        """This rank's rays of `rays` per frame."""
        n = rays // self.rays
        return slice(self.r * n, (self.r + 1) * n)

    def barrier(self) -> None:
        """Every rank of the layout reaches this point (one all-reduce on
        the rank's device, the same call on both backends)."""
        dist.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(data: int = 1, rays: int = 1, model: int = 1,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """This rank's `Mesh` over the default group, which must hold
    `data · rays` ranks. Every rank calls it with the same arguments (each
    process group is created by all ranks, in the same order). `device`
    defaults to the current CUDA device."""
    if model > 1:
        raise NotImplementedError("the model axis (PartialFC, ArcFace trainer) is not ported")
    if data < 1 or rays < 1:
        raise ValueError(f"data and rays must be >= 1, got {data} x {rays}")
    world = dist.get_world_size()
    if world != data * rays:
        raise ValueError(f"a {data} x {rays} mesh needs {data * rays} ranks, the group has {world}")
    rank = dist.get_rank()
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    rays_groups = [dist.new_group([d * rays + r for r in range(rays)]) for d in range(data)]
    data_groups = [dist.new_group([d * rays + r for d in range(data)]) for r in range(rays)]
    return Mesh(data, rays, rank, dev, rays_groups[rank // rays], data_groups[rank % rays])


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch: its rows of every per-frame
    array and its ray range of `xy` ([B/D, R/Rr, 2]). `mels` stays whole:
    Audio2Style runs its BiLSTM over the batch's frames as one sequence, so
    every rank reads all of them (`train.step`)."""
    B, R = batch["xy"].shape[:2]
    if B % mesh.data or R % mesh.rays:
        raise ValueError(f"a batch of {B} frames x {R} rays does not divide over a "
                         f"{mesh.data} x {mesh.rays} mesh")
    rows, rays = mesh.rows(B), mesh.ray_range(R)
    out = {}
    for k, v in batch.items():
        if k == "mels":
            out[k] = v
        elif k == "xy":
            out[k] = v[rows, rays]
        else:
            out[k] = v[rows]
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None,
                   scale: float = 1.0) -> List[torch.Tensor]:
    """The sums over `group` (default: every rank) of same-dtype tensors,
    times `scale`, as one flattened buffer and one all-reduce (DDP's
    bucket, written out). Every rank receives the same bits."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class GatherRays(torch.autograd.Function):
    """[b, R/Rr, C] ray shards -> [b, R, C] over the rays group, in ray
    order. Everything downstream (decoder, losses) runs replicated over the
    rays group, so every rays rank already holds the whole gradient: the
    backward returns this rank's slice of it, with no sum (a reduce-scatter,
    as in `torch.distributed.nn.functional.all_gather`, would count it Rr
    times)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh, ctx.n = mesh, x.shape[1]
        b, n, c = x.shape
        parts = x.new_empty((mesh.rays, b, n, c))   # the rays ranks' shards, in rank order
        with warnings.catch_warnings():   # deprecated after torch 2.11, the card's version
            warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*")
            dist.all_gather_into_tensor(parts.view(mesh.rays * b, n, c), x.contiguous(),
                                        group=mesh.rays_group)
        return parts.permute(1, 0, 2, 3).reshape(b, mesh.rays * n, c)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.r, ctx.n
        return g[:, r * n:(r + 1) * n].contiguous(), None


def gather_rays(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return GatherRays.apply(x, mesh)


@torch.no_grad()
def sync_params(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast rank 0's values of the f32 `tensors` (in place, one buffer) and
    check once that this rank's own seeded values already were the same.
    Every rank learns the outcome, so a mismatch raises on all of them."""
    tensors = list(tensors)
    mine = torch.cat([t.reshape(-1) for t in tensors])
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    differ = (mine != ref).sum().float().reshape(1)
    dist.all_reduce(differ)
    if differ.item():
        raise RuntimeError(f"{int(differ.item())} parameter values differ between ranks "
                           "after the seeded init")
    for t, v in zip(tensors, ref.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


@torch.no_grad()
def checksums_agree(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether every rank holds bit-identical `tensors` (f32): an exact
    integer checksum of their bits, all-reduced as its max and min."""
    s = torch.zeros((), dtype=torch.int64, device=tensors[0].device)
    for t in tensors:
        bits = t.detach().float().reshape(-1).view(torch.int32).to(torch.int64)
        s += (bits * (torch.arange(bits.numel(), device=bits.device) % 65521 + 1)).sum()
    both = torch.stack([s, -s])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    return bool(both[0] == -both[1])
