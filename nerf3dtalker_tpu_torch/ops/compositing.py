"""Volume-rendering alpha compositing (port of
`nerf3dtalker_tpu/ops/compositing.py`, reference `CalcRayColor`,
NetWorks/utils.py:268-308)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CompositeResult(NamedTuple):
    features: torch.Tensor            # [B, N_r, C]  Σ w_i f_i
    bg_alpha: torch.Tensor            # [B, N_r]     1 - Σ w_i
    depth: torch.Tensor               # [B, N_r]     Σ w_i z_i
    weights: Optional[torch.Tensor]   # [B, N_r, N_s]


def alpha_composite(
    features: torch.Tensor,   # [B, N_r, N_s, C]
    density: torch.Tensor,    # [B, N_r, N_s]
    z_dists: torch.Tensor,    # [B, N_r, N_s]
    zvals: torch.Tensor,      # [B, N_r, N_s]
) -> CompositeResult:
    """α_i = 1 - exp(-σ_i δ_i); T_i = Π_{j<i}(1-α_j+1e-10); w_i = α_i T_i,
    accumulated in f32."""
    alpha = 1.0 - torch.exp(-density * z_dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans
    feat = torch.einsum("brs,brsc->brc", weights.float(), features.float())
    depth = torch.sum(weights * zvals, dim=-1)
    acc = torch.sum(weights, dim=-1)
    return CompositeResult(features=feat, bg_alpha=1.0 - acc, depth=depth, weights=weights)
