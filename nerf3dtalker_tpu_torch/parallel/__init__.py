"""Multi-rank training over a (data, rays) layout of torch.distributed ranks."""

from nerf3dtalker_tpu_torch.parallel.mesh import Mesh, gather_rays, make_mesh, shard_batch

__all__ = ["Mesh", "gather_rays", "make_mesh", "shard_batch"]
