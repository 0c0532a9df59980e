"""Stage-1 Standardized Space: the dual-codebook VQ autoencoder over images
(port of `nerf3dtalker_tpu/models/vq/stage1.py`; reference `VQAutoEncoder`,
StandardizedSpace/models/stage1_vocaset.py:11-128). It refines
NeRF-rendered frames toward ground truth, conditioned on facial
Action-Unit features through a second (AU) codebook:

  image -> conv stem (3->64->1 ch) -> row tokens, Linear(W -> hidden)
        -> Conv1d squasher over the token axis -> transformer encoder
        -> split into embed_dim sub-codes -> image codebook (n_embed)
  AU features -> Linear(au_dim -> embed_dim) -> AU codebook (n_embed_au)
  [image tokens | AU tokens tiled to hidden] -> expander -> transformer
        decoder -> the first img_size rows -> Linear(hidden -> W)
        -> conv head (1->64->3)

Images enter and leave channels-last, [B, H, W, 3], as in the JAX module;
the convolutions run NCHW inside. The token tensors are channels-last
[B, N, C] in both, so the sub-code split `h.reshape(B, -1, embed_dim)` and
its inverse take the elements in the same order as JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.models.vq.quantizer import QuantizeResult, VectorQuantizer
from nerf3dtalker_tpu_torch.models.vq.transformer import (
    LinearEmbedding,
    Transformer,
    flax_init_,
    sinusoidal_positions,
)
from nerf3dtalker_tpu_torch.utils.device import resolve_device


class VQForwardResult(NamedTuple):
    recon: torch.Tensor        # [B, H, W, 3]
    quant_loss: torch.Tensor
    perplexity: torch.Tensor
    indices: torch.Tensor      # image-codebook ids


class ConvSquasher(nn.Module):
    """Replicate pad 2, Conv1d(k=5, VALID), LeakyReLU(0.2), then
    InstanceNorm over the token axis (biased variance, eps 1e-5, no affine)
    (stage1_vocaset.py:206-212, quant_factor=0 -> stride 1). [B, N, C]."""

    def __init__(self, dim: int, neg_slope: float = 0.2):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 5)
        self.neg_slope = neg_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), (2, 2), mode="replicate")
        x = F.leaky_relu(self.conv(x), self.neg_slope).transpose(1, 2)
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5)


class VQEncoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        c = cfg
        self.stem0 = nn.Conv2d(c.in_dim, 64, 3, padding=1)
        self.stem1 = nn.Conv2d(64, 1, 3, padding=1)
        self.row_embed = nn.Linear(c.img_size, c.hidden_size)
        self.squasher = ConvSquasher(c.hidden_size)
        self.lin_embed = LinearEmbedding(c.hidden_size, c.hidden_size)
        self.transformer = Transformer(c.hidden_size, c.num_hidden_layers,
                                       c.num_attention_heads, c.intermediate_size)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> tokens [B, H, hidden]."""
        x = self.stem1(F.relu(self.stem0(img.permute(0, 3, 1, 2))))[:, 0]   # [B, H, W]
        x = self.lin_embed(self.squasher(self.row_embed(x)))
        x = x + sinusoidal_positions(x.shape[1], x.shape[2], x.device, x.dtype)
        return self.transformer(x)


class VQDecoder(nn.Module):
    def __init__(self, cfg: VQConfig, out_width: int):
        super().__init__()
        c = cfg
        self.img_size = c.img_size
        self.expander = ConvSquasher(c.hidden_size)
        self.lin_embed = LinearEmbedding(c.hidden_size, c.hidden_size)
        self.transformer = Transformer(c.hidden_size, c.num_hidden_layers,
                                       c.num_attention_heads, c.intermediate_size)
        self.row_unembed = nn.Linear(c.hidden_size, out_width)
        self.head0 = nn.Conv2d(1, 64, 3, padding=1)
        self.head1 = nn.Conv2d(64, 3, 3, padding=1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, N, hidden] -> [B, img_size, W, 3]: the first img_size tokens
        carry image content; the AU tokens after them are context."""
        x = self.lin_embed(self.expander(tokens))
        x = x + sinusoidal_positions(x.shape[1], x.shape[2], x.device, x.dtype)
        x = self.transformer(x)[:, : self.img_size]
        x = self.row_unembed(x)[:, None]                       # [B, 1, H, W]
        return self.head1(F.relu(self.head0(x))).permute(0, 2, 3, 1)


class VQAutoEncoder(nn.Module):
    def __init__(self, cfg: VQConfig, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are initialized on the CPU from `generator` and moved
        to `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        c = self.cfg = cfg
        self.encoder = VQEncoder(c)
        self.decoder = VQDecoder(c, out_width=c.img_size)
        self.quantize = VectorQuantizer(c.n_embed, c.embed_dim, c.beta)
        self.quantize_au = VectorQuantizer(c.n_embed_au, c.embed_dim, c.beta)
        self.au_proj = nn.Linear(c.au_dim, c.embed_dim)
        self.reset_parameters(generator)
        self.to(dev)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)
        self.quantize.reset_parameters(generator)
        self.quantize_au.reset_parameters(generator)

    def encode(self, img: torch.Tensor) -> QuantizeResult:
        """image -> quantized codes (stage1_vocaset.py:28-37)."""
        h = self.encoder(img)                                   # [B, H, hid]
        return self.quantize(h.reshape(h.shape[0], -1, self.cfg.embed_dim))

    def encode_au(self, au_fea: torch.Tensor) -> QuantizeResult:
        """AU features [B, n_au, au_dim] -> quantized AU codes
        (stage1_vocaset.py:39-46)."""
        return self.quantize_au(self.au_proj(au_fea))

    def decode(self, quant_img: torch.Tensor, quant_au: torch.Tensor) -> torch.Tensor:
        """Both quantized streams, concatenated, through the decoder
        (stage1_vocaset.py:48-70)."""
        c = self.cfg
        B = quant_img.shape[0]
        img_tokens = quant_img.reshape(B, -1, c.hidden_size)
        au_tokens = quant_au.reshape(B, -1, c.embed_dim).repeat(1, 1, c.hidden_size // c.embed_dim)
        return self.decoder(torch.cat([img_tokens, au_tokens], dim=1))

    def forward(self, img: torch.Tensor, au_fea: torch.Tensor) -> VQForwardResult:
        q = self.encode(img)
        qa = self.encode_au(au_fea)
        recon = self.decode(q.quantized, qa.quantized)
        return VQForwardResult(recon, q.loss + qa.loss, q.perplexity, q.indices)

    def decode_from_indices(self, indices: torch.Tensor, au_indices: torch.Tensor) -> torch.Tensor:
        """Code ids -> image (stage1_vocaset.py:110-117)."""
        return self.decode(self.quantize.codebook_entry(indices),
                           self.quantize_au.codebook_entry(au_indices))

    def decode_logit(self, logits: torch.Tensor, au_indices: torch.Tensor) -> torch.Tensor:
        """Code logits [B, L, n_embed] (or ids [B, L]) -> image
        (stage1_vocaset.py:120-128): the top-1 code, through the codebook."""
        ix = logits.argmax(-1) if logits.ndim == 3 else logits
        return self.decode_from_indices(ix, au_indices)


def sample_code_logits(logits: torch.Tensor, sample: bool = True, temperature: float = 0.7,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Code ids from logits (stage1_vocaset.py:130-149 get_logit):
    temperature-scaled categorical sampling from `generator` when `sample`,
    else top-1. Returns (ids [B, L], probs [B, L, n_embed])."""
    probs = torch.softmax(logits / temperature, dim=-1)
    if not sample:
        return probs.argmax(-1), probs
    ix = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return ix.reshape(probs.shape[:-1]), probs
