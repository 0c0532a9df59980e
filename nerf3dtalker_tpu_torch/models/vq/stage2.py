"""CodeTalker stage 2: autoregressive speech-to-motion over the frozen
stage-1 codebook (port of `nerf3dtalker_tpu/models/vq/stage2.py`; reference
StandardizedSpace/models/stage2.py:8-140).

wav2vec2 features are resampled to the frame rate and mapped to the
feature width; a per-subject style embedding (optionally a blend of two
subjects) is added to the one-frame-shifted motion's embedding; a periodic
positional encoding, a biased causal self-attention mask and an enc-dec
alignment mask feed post-LN decoder layers; a zero-initialized code head
gives face_quan_num codes of embed_dim per frame, which the caller
quantizes and decodes through the frozen stage-1 autoencoder.

Modules carry the flax names (`audio_feature_map`, `style_emb`,
`vertice_map`, `dec_{i}.self_q`, ..., `feat_map`); `utils/bridge.py:
codetalker_state_dict` maps a JAX tree. Attention is plain `torch.matmul`
and softmax, as JAX computes it with einsums.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.models.vq.transformer import flax_init_
from nerf3dtalker_tpu_torch.models.vq.wav2vec import resample_frames_aligned
from nerf3dtalker_tpu_torch.utils.device import resolve_device

_EPS = 1e-6   # flax LayerNorm default


def resample_frames(features: torch.Tensor, target_len: int) -> torch.Tensor:
    """wav2vec2 features to the video frame rate (align_corners=True)."""
    return resample_frames_aligned(features, target_len)


def periodic_positional_encoding(x: torch.Tensor, period: int = 25,
                                 max_len: int = 600) -> torch.Tensor:
    """x [B, T, d] plus a sin/cos table of `period` rows tiled over time
    (models/utils.py PeriodicPositionalEncoding)."""
    d = x.shape[-1]
    pos = torch.arange(period, dtype=x.dtype, device=x.device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=x.dtype, device=x.device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(period, d, dtype=x.dtype, device=x.device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    table = pe.repeat((max_len + period - 1) // period, 1)
    return x + table[: x.shape[1]]


def _alibi_slopes(n: int) -> list:
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n).is_integer():
        return pow2(n)
    closest = 2 ** math.floor(math.log2(n))
    return pow2(closest) + _alibi_slopes(2 * closest)[0::2][: n - closest]


def init_biased_mask(n_head: int, max_seq_len: int, period: int, device=None) -> torch.Tensor:
    """ALiBi-style biased causal mask [H, T, T] (models/utils.py
    init_biased_mask): per-head geometric slopes times -floor((i - j) /
    period), -inf above the diagonal. Its [:, :n, :n] corner is the mask of
    n frames."""
    slopes = torch.tensor(_alibi_slopes(n_head), device=device)
    i = torch.arange(max_seq_len, device=device)
    dist = torch.div(i[:, None] - i[None, :], period, rounding_mode="floor")
    causal = torch.where(i[None, :] > i[:, None], float("-inf"), 0.0)
    return slopes[:, None, None] * (-dist.float())[None] + causal[None]


def enc_dec_mask(T: int, S: int, dataset: str = "vocaset", device=None) -> torch.Tensor:
    """Alignment mask [T, S] (models/utils.py enc_dec_mask): frame t attends
    to audio frame t (vocaset), or to frames 2t and 2t + 1, clipped to
    S - 1 (BIWI); -inf elsewhere."""
    m = torch.full((T, S), float("-inf"), device=device)
    i = torch.arange(min(T, S), device=device)
    if dataset == "BIWI":
        m[i, torch.clamp(2 * i, max=S - 1)] = 0.0
        m[i, torch.clamp(2 * i + 1, max=S - 1)] = 0.0
    else:
        m[i, i] = 0.0
    return m


class DecoderLayer(nn.Module):
    """Post-LN decoder layer as torch nn.TransformerDecoderLayer computes it
    (self-attention, cross-attention, ReLU FFN of 2 dim), scores over
    sqrt(head dim)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        for kind in ("self", "cross"):
            for p in ("q", "k", "v", "out"):
                setattr(self, f"{kind}_{p}", nn.Linear(dim, dim))
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=_EPS)
        self.ff1 = nn.Linear(dim, 2 * dim)
        self.ff2 = nn.Linear(2 * dim, dim)

    def _mha(self, q, kv, mask, kind):
        B, N, _ = q.shape
        hd = self.dim // self.heads

        def split(t):
            return t.reshape(B, t.shape[1], self.heads, hd).transpose(1, 2)

        proj = lambda p, t: getattr(self, f"{kind}_{p}")(t)   # noqa: E731
        dots = split(proj("q", q)) @ split(proj("k", kv)).transpose(-1, -2) / math.sqrt(hd)
        if mask is not None:
            dots = dots + mask
        out = torch.softmax(dots, dim=-1) @ split(proj("v", kv))
        return proj("out", out.transpose(1, 2).reshape(B, N, self.dim))

    def forward(self, x, memory, tgt_mask=None, mem_mask=None):
        x = self.norm1(x + self._mha(x, x, tgt_mask, "self"))
        x = self.norm2(x + self._mha(x, memory, mem_mask, "cross"))
        return self.norm3(x + self.ff2(F.relu(self.ff1(x))))


class CodeTalker(nn.Module):
    """Speech -> motion-code predictor (stage2.py:8-100). The stage-1
    autoencoder is applied frozen by the caller (`train/vq_eval.py:
    frame_vq_apply`)."""

    def __init__(self, cfg: VQConfig, feature_dim: int = 64, n_head: int = 4,
                 num_layers: int = 1, period: int = 25, n_subjects: int = 8,
                 vertice_dim: int = 15069, max_seq_len: int = 600, audio_dim: int = 768,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """`audio_dim` is the wav2vec2 width (flax infers it from the input).
        Parameters are initialized on the CPU from `generator` at the flax
        defaults (the style embedding N(0, 1/feature_dim), the code head
        zero) and moved to `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # the constructor's arguments but cfg, which a checkpoint keeps
        self.dims = dict(feature_dim=feature_dim, n_head=n_head, num_layers=num_layers,
                         period=period, n_subjects=n_subjects, vertice_dim=vertice_dim,
                         max_seq_len=max_seq_len, audio_dim=audio_dim)
        self.n_head, self.num_layers = n_head, num_layers
        self.period, self.max_seq_len = period, max_seq_len
        self.audio_feature_map = nn.Linear(audio_dim, feature_dim)
        self.style_emb = nn.Embedding(n_subjects, feature_dim)
        self.vertice_map = nn.Linear(vertice_dim, feature_dim)
        for i in range(num_layers):
            setattr(self, f"dec_{i}", DecoderLayer(feature_dim, n_head))
        self.feat_map = nn.Linear(feature_dim, cfg.face_quan_num * cfg.embed_dim, bias=False)
        flax_init_(self, generator)
        with torch.no_grad():
            self.style_emb.weight.normal_(0.0, feature_dim ** -0.5, generator=generator)
            self.feat_map.weight.zero_()           # zero-init code head (stage2.py:35)
        self.to(dev)

    def forward(self, audio_feats: torch.Tensor, motion_gt: torch.Tensor,
                subject_onehot: torch.Tensor, dataset: str = "vocaset",
                subject_onehot2: Optional[torch.Tensor] = None,
                style_weight: Optional[float] = None) -> torch.Tensor:
        """audio_feats [B, S, audio_dim], motion_gt [B, T, vertice_dim],
        subject_onehot [B, n_subjects] -> teacher-forced codes
        [B, T * face_quan_num, embed_dim]. `subject_onehot2` with
        `style_weight` blends two subjects' styles (stage2.py:108-114)."""
        T = motion_gt.shape[1]
        if T > self.max_seq_len:
            raise ValueError(f"{T} frames exceed max_seq_len {self.max_seq_len}")
        dev = motion_gt.device
        hidden = self.audio_feature_map(resample_frames(audio_feats, T))
        style = self.style_emb(subject_onehot.argmax(1))[:, None]
        if subject_onehot2 is not None and style_weight is not None:
            style2 = self.style_emb(subject_onehot2.argmax(1))[:, None]
            style = style * style_weight + style2 * (1.0 - style_weight)
        shifted = torch.cat([torch.zeros_like(motion_gt[:, :1]), motion_gt[:, :-1]], dim=1)
        x = periodic_positional_encoding(self.vertice_map(shifted) + style, self.period,
                                         self.max_seq_len)
        tgt_mask = init_biased_mask(self.n_head, T, self.period, dev)[None]
        mem_mask = enc_dec_mask(T, hidden.shape[1], dataset, dev)[None, None]
        for i in range(self.num_layers):
            x = getattr(self, f"dec_{i}")(x, hidden, tgt_mask, mem_mask)
        feat = self.feat_map(x)
        return feat.reshape(feat.shape[0], T * self.cfg.face_quan_num, self.cfg.embed_dim)


def stage2_loss(codetalker_out: torch.Tensor, gt_quant: torch.Tensor, recon: torch.Tensor,
                vertice_gt: torch.Tensor, motion_weight: float = 1.0, reg_weight: float = 1.0):
    """(motion MSE + code regression MSE against the detached gt codes,
    (loss_motion, loss_reg)) (stage2.py:93-100)."""
    loss_motion = torch.mean((recon - vertice_gt) ** 2)
    loss_reg = torch.mean((codetalker_out - gt_quant.detach()) ** 2)
    return motion_weight * loss_motion + reg_weight * loss_reg, (loss_motion, loss_reg)
