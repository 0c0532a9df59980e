"""Transformer building blocks of the Standardized Space (port of
`nerf3dtalker_tpu/models/vq/transformer.py`; reference
`models/lib/base_models.py:9-327`): self-attention, the GELU MLP, pre-LN
blocks x += attn(LN(x)); x += mlp(LN(x)), their stack, the linear embedding,
the sin/cos position table, and stage 2's cross-modal attention and biased
causal mask.

Parameters carry the flax module names (`to_qkv`, `to_out`, `l1`, `l2`,
`norm1`, `norm2`, `proj`; block i of a stack is `blocks.{i}`), so
`utils/bridge.py:vq_state_dict` maps a flax tree by name. `flax_init_`
draws the flax defaults: LeCun-normal kernels (a normal truncated at two
standard deviations, rescaled to variance 1/fan_in), zero biases, unit
LayerNorm scales.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def _trunc_normal_(w: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    """N(0, std^2) truncated to +-2 std, by redrawing the values outside
    (in index order, until none is left; only the redrawn are tested
    again). A meta tensor holds no values: it is left as it is."""
    if w.is_meta:
        return
    w.normal_(0.0, std, generator=generator)
    flat = w.view(-1)
    idx = (flat.abs() > 2 * std).nonzero().squeeze(1)
    while idx.numel():
        flat[idx] = torch.randn(idx.numel(), generator=generator) * std
        idx = idx[flat[idx].abs() > 2 * std]


def flax_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Every Linear / Conv1d / Conv2d / LayerNorm under `module` at the flax
    defaults, drawn from `generator` in `module.modules()` order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            _trunc_normal_(m.weight, m.weight[0].numel() ** -0.5 / _TRUNC_STD, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class Attention(nn.Module):
    """Multi-head self-attention: q, k, v from one bias-free projection,
    scores scaled by the FULL width's dim^-0.5 (as the reference and JAX
    scale them), an optional additive mask, the out projection."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, _ = x.shape
        q, k, v = (t.reshape(B, N, self.heads, self.dim // self.heads).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        dots = (q @ k.transpose(-1, -2)) * self.dim ** -0.5
        if mask is not None:
            dots = dots + mask
        out = torch.softmax(dots, dim=-1) @ v
        return self.to_out(out.transpose(1, 2).reshape(B, N, self.dim))


class CrossModalAttention(nn.Module):
    """q from modality a, k and v from modality b (base_models.py:63-105);
    the scores scaled by the FULL width's dim^-0.5, as in Attention."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_kv = nn.Linear(dim, dim * 2, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, Na, _ = x_a.shape

        def heads_first(t):
            return t.reshape(B, t.shape[1], self.heads, self.dim // self.heads).transpose(1, 2)

        q = heads_first(self.to_q(x_a))
        k, v = map(heads_first, self.to_kv(x_b).chunk(2, dim=-1))
        dots = (q @ k.transpose(-1, -2)) * self.dim ** -0.5
        if mask is not None:
            dots = dots + mask
        out = torch.softmax(dots, dim=-1) @ v
        return self.to_out(out.transpose(1, 2).reshape(B, Na, self.dim))


class MLP(nn.Module):
    """Linear-GELU(exact)-Linear (base_models.py:43-59)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.l1 = nn.Linear(dim, hidden)
        self.l2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(F.gelu(self.l1(x)))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim, mlp_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask)
        return x + self.mlp(self.norm2(x))


class Transformer(nn.Module):
    """Stack of pre-LN blocks (base_models.py Transformer)."""

    def __init__(self, dim: int, num_layers: int, heads: int, mlp_hidden: int):
        super().__init__()
        self.blocks = nn.ModuleList(TransformerBlock(dim, heads, mlp_hidden)
                                    for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, mask)
        return x


class LinearEmbedding(nn.Module):
    def __init__(self, dim_in: int, dim: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


def sinusoidal_positions(n: int, dim: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Classic sin/cos positional table [n, dim] (base_models.py
    PositionalEncoding)."""
    pos = torch.arange(n, device=device, dtype=dtype)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, device=device, dtype=dtype)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(n, dim, device=device, dtype=dtype)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def biased_causal_mask(n: int, period: int = 1, device=None) -> torch.Tensor:
    """ALiBi-style biased causal mask [n, n] (reference models/stage2.py
    :27-29): -inf above the diagonal plus -|floor((i - j) / period)|."""
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    causal = torch.where(j > i, float("-inf"), 0.0)
    return causal - torch.div(i - j, max(period, 1), rounding_mode="floor").abs().float()
