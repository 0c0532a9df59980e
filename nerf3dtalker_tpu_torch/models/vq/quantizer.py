"""VQ-VAE vector quantizer (port of `nerf3dtalker_tpu/models/vq/quantizer.py`,
reference `VectorQuantizer`, StandardizedSpace/models/lib/quantizer.py:14-91):
nearest-codebook lookup, commitment loss with beta, straight-through
estimator, codebook-usage perplexity.

The distances are ||z||^2 + ||e||^2 - 2 z.e in f32, summed in that order as
the JAX module sums them, and the argmin takes the first of equal values.
Near a tie the argmin can pick another code than JAX does: the codebook
entries are ~1/n_embed in size, next to ||z||^2 of O(10-100).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn


class QuantizeResult(NamedTuple):
    quantized: torch.Tensor    # [..., D] straight-through codes
    loss: torch.Tensor         # commitment + codebook loss
    perplexity: torch.Tensor   # exp(entropy of code usage)
    indices: torch.Tensor      # [...] int64 code ids


class VectorQuantizer(nn.Module):
    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.embedding = nn.Parameter(torch.empty(n_embed, embed_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Uniform in ±1/n_embed (the JAX init)."""
        nn.init.uniform_(self.embedding, -1.0 / self.n_embed, 1.0 / self.n_embed,
                         generator=generator)

    def _flat_distances(self, flat: torch.Tensor) -> torch.Tensor:
        emb = self.embedding
        return ((flat ** 2).sum(1, keepdim=True) + (emb ** 2).sum(1)
                - 2.0 * flat @ emb.t())

    def forward(self, z: torch.Tensor) -> QuantizeResult:
        """z: [..., embed_dim]."""
        flat = z.reshape(-1, self.embed_dim)
        with torch.no_grad():
            idx = self._flat_distances(flat).argmin(1)
        z_q = self.embedding[idx].reshape(z.shape)
        loss = (self.beta * torch.mean((z_q.detach() - z) ** 2)
                + torch.mean((z_q - z.detach()) ** 2))
        z_st = z + (z_q - z).detach()          # straight-through (quantizer.py:58-59)
        usage = torch.bincount(idx, minlength=self.n_embed).to(z.dtype) / idx.shape[0]
        perplexity = torch.exp(-torch.sum(usage * torch.log(usage + 1e-10)))
        return QuantizeResult(z_st, loss, perplexity, idx.reshape(z.shape[:-1]))

    def codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Code ids -> embedding vectors (quantizer.py:78-91)."""
        return self.embedding[indices]

    def distances(self, z: torch.Tensor) -> torch.Tensor:
        """Full [..., n_embed] distance matrix (quantizer.py:66-76)."""
        return self._flat_distances(z.reshape(-1, self.embed_dim)).reshape(
            z.shape[:-1] + (self.n_embed,))
