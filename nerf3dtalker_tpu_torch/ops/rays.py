"""Ray generation and depth sampling (port of `nerf3dtalker_tpu/ops/rays.py`,
reference `GenSamplePoints`, NetWorks/utils.py:55-161).

Channels-last: rays are `[B, N_r, 3]`, sample points `[B, N_r, N_s, 3]`.
Depth is parameterized by world-space z planes (z1=2.5, z2=-3.5) with
`ray_l = -1/dz`, so `o + d * l * t` has z == o_z - t.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Rays(NamedTuple):
    origins: torch.Tensor      # [B, N_r, 3]
    directions: torch.Tensor   # [B, N_r, 3] unit-norm
    lengths: torch.Tensor      # [B, N_r, 1] == -1/dz


class SamplePoints(NamedTuple):
    pts: torch.Tensor       # [B, N_r, N_s, 3]
    dirs: torch.Tensor      # [B, N_r, N_s, 3]
    zvals: torch.Tensor     # [B, N_r, N_s]
    z_dists: torch.Tensor   # [B, N_r, N_s]


def gen_rays(
    xy: torch.Tensor,          # [B, N_r, 2] pixel coordinates
    Rmat: torch.Tensor,        # [B, 3, 3] cam-to-world rotation
    Tvec: torch.Tensor,        # [B, 3] or [B, 3, 1] camera origin
    inv_inmat: torch.Tensor,   # [B, 3, 3] inverse intrinsics
) -> Rays:
    """Pixel grid -> world rays (reference utils.py:147-161). The 3-wide
    contractions are broadcast-multiply-sums, as in the JAX package."""
    ones = torch.ones(xy.shape[:-1] + (1,), dtype=xy.dtype, device=xy.device)
    xyz = torch.cat([xy, ones], dim=-1)                           # [B, N_r, 3]
    d = torch.sum(inv_inmat[:, None, :, :] * xyz[:, :, None, :], dim=-1)
    d = torch.sum(Rmat[:, None, :, :] * d[:, :, None, :], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    lengths = -1.0 / d[..., 2:3]
    o = Tvec.reshape(Tvec.shape[0], 1, 3).expand(d.shape)
    return Rays(origins=o, directions=d, lengths=lengths)


def stratified_zvals(
    rays: Rays,
    n_samples: int,
    world_z1: float,
    world_z2: float,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratified z-plane parameter values, [B, N_r, N_s + 1]
    (reference utils.py:118-145). `noise`, uniform in [0, 1) and shaped like
    the result, jitters each sample within its stratum (the reference's
    `disturb` branch); serving passes none."""
    oz = rays.origins[..., 2]
    rela_z1 = oz - world_z1
    rela_z2 = oz - world_z2
    t = torch.linspace(0.0, 1.0, n_samples + 1, dtype=oz.dtype, device=oz.device)
    zvals = rela_z1[..., None] * (1.0 - t) + rela_z2[..., None] * t
    if noise is not None:
        mids = 0.5 * (zvals[..., 1:] + zvals[..., :-1])
        upper = torch.cat([mids, zvals[..., -1:]], dim=-1)
        lower = torch.cat([zvals[..., :1], mids], dim=-1)
        zvals = lower + (upper - lower) * noise
    return zvals


def sample_points(rays: Rays, zvals: torch.Tensor) -> SamplePoints:
    """Sample positions for boundary zvals [B, N_r, N_s+1]
    (reference utils.py:64-116)."""
    z_dists = (zvals[..., 1:] - zvals[..., :-1]) * rays.lengths
    z = zvals[..., :-1]
    pts = (
        rays.origins[..., None, :]
        + rays.directions[..., None, :] * rays.lengths[..., None, :] * z[..., None]
    )
    dirs = rays.directions[..., None, :].expand(pts.shape)
    return SamplePoints(pts=pts, dirs=dirs, zvals=z, z_dists=z_dists)


def fine_zvals(
    weights: torch.Tensor,        # [B, N_r, N_c] coarse compositing weights
    coarse_zvals: torch.Tensor,   # [B, N_r, N_c] coarse sample parameters (post-trim)
    n_fine: int,
    u: Optional[torch.Tensor] = None,   # [B, N_r, n_fine] uniform in [0, 1)
) -> torch.Tensor:
    """Hierarchical inverse-CDF importance sampling (reference
    utils.py:215-256). `n_fine` follows the reference's +1 boundary
    convention (`num_sample_fine + 1`, utils.py:167). The weights are
    detached. Without `u` the samples sit at `linspace(0, 1, n_fine)` of the
    CDF; training passes its own uniform draws. Returns the sorted union of
    coarse and fine values, [B, N_r, N_c + n_fine], for `sample_points`."""
    B, N_r, N_c = weights.shape
    w = weights[..., 1:-1].detach()
    pdf = w / torch.sum(w + 1e-5, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)     # [B, N_r, N_c - 1]
    if u is None:
        u = torch.linspace(0.0, 1.0, n_fine, dtype=weights.dtype, device=weights.device)
        u = u.expand(B, N_r, n_fine)
    # searchsorted(side="right"): the count of CDF entries <= u, as the JAX
    # package's compare-and-count
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=N_c - 2)
    bins = 0.5 * (coarse_zvals[..., 1:] + coarse_zvals[..., :-1])      # [B, N_r, N_c - 1]
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bin_b, bin_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    fine = bin_b + t * (bin_a - bin_b)
    return torch.sort(torch.cat([coarse_zvals, fine], dim=-1), dim=-1).values
