"""NeRF sinusoidal positional encoding (port of
`nerf3dtalker_tpu/ops/embedding.py`, reference `Embedder`,
NetWorks/utils.py:6-51).

Channel order matches the reference: [x, sin(2^0 x), cos(2^0 x),
sin(2^1 x), cos(2^1 x), ...], each block over all D input dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def positional_encoding(
    x: torch.Tensor, n_freqs: int, include_input: bool = True
) -> torch.Tensor:
    """[..., D] -> [..., D * (2*n_freqs + include_input)]."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xf = (x[..., None] * freqs).transpose(-1, -2)          # [..., F, D]
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, D]
    flat = sc.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])
    if include_input:
        flat = torch.cat([x, flat], dim=-1)
    return flat


def positional_encoding_rays(
    origins: torch.Tensor,      # [B, N_r, 3]
    directions: torch.Tensor,   # [B, N_r, 3]
    lengths: torch.Tensor,      # [B, N_r, 1]
    zvals: torch.Tensor,        # [B, N_r, N_s] (post-trim sample parameters)
    n_freqs: int,
    include_input: bool = True,
    pad_to: int = 0,
) -> torch.Tensor:
    """PE of the ray sample points, [B, N_r, N_s, max(pad_to, K)], zero
    padded on the right (63 -> 64 for the kernel).

    The JAX version contracts single-entry power-of-two columns in a
    HIGHEST-precision matmul; here the same values come from exact
    elementwise products (a power-of-two scale is exact in f32), so no
    TF32 matmul can touch them. Points are `o + (d*l) * z`, the operation
    order of `ops.rays.sample_points`."""
    pts = origins[:, :, None, :] + (directions * lengths)[:, :, None, :] * zvals[..., None]
    pe = positional_encoding(pts, n_freqs, include_input)
    k_out = pe.shape[-1]
    if pad_to > k_out:
        pe = F.pad(pe, (0, pad_to - k_out))
    return pe
