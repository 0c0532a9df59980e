"""wav2vec 2.0 speech encoder for CodeTalker stage 2 (port of
`nerf3dtalker_tpu/models/vq/wav2vec.py`; reference
StandardizedSpace/models/lib/wav2vec.py:1-125, which wraps the HF
`Wav2Vec2Model` and adds frame-rate resampling): raw waveform -> conv
feature extractor (group norm after conv 0, exact GELU) -> feature
projection (LayerNorm + Linear) -> a grouped-conv relative position
embedding -> post-norm transformer encoder -> [B, S, hidden], then linear
resampling to the video frame rate with align_corners=True.

As in JAX, every LayerNorm and the GroupNorm take eps 1e-6 (flax's
default; HF's own model uses 1e-5). Modules carry the flax names
(`feature_extractor.conv{i}`, `group_norm`, `fp_layer_norm`,
`fp_projection`, `pos_conv`, `enc_layer_norm`, `layer{i}.q_proj`, ...), so
`utils/bridge.py:vq_state_dict` maps a JAX tree by name. The convolutions
run NCW inside; the encoder's tokens are [B, S, C] as in JAX.

`load_hf_wav2vec2` reads a local HF model directory (config.json and
pytorch_model.bin or model.safetensors) without `transformers`; the
weight-normed position conv resolves to its effective kernel.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.models.vq.transformer import flax_init_
from nerf3dtalker_tpu_torch.utils.device import resolve_device, uninitialized

_EPS = 1e-6   # flax LayerNorm / GroupNorm default


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The JAX `Wav2Vec2Encoder`'s fields; the defaults are wav2vec2-base."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16


class FeatureEncoder(nn.Module):
    """Conv waveform feature extractor (HF Wav2Vec2FeatureEncoder with
    feat_extract_norm='group': a per-channel GroupNorm after conv 0 only)."""

    def __init__(self, conv_dim, conv_kernel, conv_stride, conv_bias: bool = False):
        super().__init__()
        self.n = len(conv_dim)
        cin = 1
        for i, (d, k, s) in enumerate(zip(conv_dim, conv_kernel, conv_stride)):
            setattr(self, f"conv{i}", nn.Conv1d(cin, d, k, stride=s, bias=conv_bias))
            cin = d
        self.group_norm = nn.GroupNorm(conv_dim[0], conv_dim[0], eps=_EPS)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, N] -> [B, S, C]."""
        x = wav[:, None]
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x)
            if i == 0:
                x = self.group_norm(x)
            x = F.gelu(x)
        return x.transpose(1, 2)


class EncoderLayer(nn.Module):
    """Post-norm transformer layer (HF Wav2Vec2EncoderLayer,
    do_stable_layer_norm=False); q is scaled by head_dim^-0.5 after its
    bias."""

    def __init__(self, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(hidden, hidden))
        self.layer_norm = nn.LayerNorm(hidden, eps=_EPS)
        self.intermediate_dense = nn.Linear(hidden, intermediate)
        self.output_dense = nn.Linear(intermediate, hidden)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd ** -0.5)
        att = torch.softmax(q @ split(self.k_proj(x)).transpose(-1, -2), dim=-1)
        out = (att @ split(self.v_proj(x))).transpose(1, 2).reshape(B, T, C)
        x = self.layer_norm(x + self.out_proj(out))
        x = x + self.output_dense(F.gelu(self.intermediate_dense(x)))
        return self.final_layer_norm(x)


class Wav2Vec2Encoder(nn.Module):
    """wav [B, N] -> hidden states [B, S, hidden]."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are initialized on the CPU from `generator` at the flax
        defaults and moved to `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        c = self.cfg = cfg
        self.feature_extractor = FeatureEncoder(c.conv_dim, c.conv_kernel, c.conv_stride,
                                                c.conv_bias)
        self.fp_layer_norm = nn.LayerNorm(c.conv_dim[-1], eps=_EPS)
        self.fp_projection = nn.Linear(c.conv_dim[-1], c.hidden_size)
        k = c.num_conv_pos_embeddings
        self.pos_conv = nn.Conv1d(c.hidden_size, c.hidden_size, k, padding=k // 2,
                                  groups=c.num_conv_pos_embedding_groups)
        self.enc_layer_norm = nn.LayerNorm(c.hidden_size, eps=_EPS)
        for i in range(c.num_layers):
            setattr(self, f"layer{i}", EncoderLayer(c.hidden_size, c.num_heads,
                                                    c.intermediate_size))
        flax_init_(self, generator)
        self.to(dev)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.fp_projection(self.fp_layer_norm(self.feature_extractor(wav)))
        pos = self.pos_conv(x.transpose(1, 2)).transpose(1, 2)
        if self.cfg.num_conv_pos_embeddings % 2 == 0:     # Wav2Vec2SamePadLayer
            pos = pos[:, :-1]
        x = self.enc_layer_norm(x + F.gelu(pos))
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return x


def resample_frames_aligned(features: torch.Tensor, target_len: int) -> torch.Tensor:
    """[B, T, C] -> [B, target_len, C] by linear interpolation with
    align_corners=True (the reference's `linear_interpolation`,
    wav2vec.py:61-67); the sample positions in f64 on the host."""
    B, T, C = features.shape
    if target_len == T:
        return features
    if target_len == 1 or T == 1:
        return features[:, :1].expand(B, target_len, C)
    pos = np.linspace(0.0, T - 1.0, target_len)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    w = torch.as_tensor(pos - lo, dtype=features.dtype, device=features.device)[None, :, None]
    lo, hi = (torch.as_tensor(i, device=features.device) for i in (lo, hi))
    return features[:, lo] * (1.0 - w) + features[:, hi] * w


def encode_audio(model: Wav2Vec2Encoder, wav: torch.Tensor, frame_num: Optional[int],
                 input_fps: float = 50.0, output_fps: float = 30.0) -> torch.Tensor:
    """wav [B, N] -> frame-aligned features [B, frame_num, hidden] (the
    reference's vocaset path: the encoder, then 50 -> 30 fps resampling to
    `frame_num`, wav2vec.py:95-100)."""
    h = model(wav)
    if frame_num is None:
        frame_num = int(h.shape[1] / input_fps * output_fps)
    return resample_frames_aligned(h, frame_num)


def normalize_wav(wav: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Per-utterance zero mean, unit variance over the last axis (the HF
    feature extractor's do_normalize=True, which the pretrained base
    checkpoints expect)."""
    mean = wav.mean(-1, keepdim=True)
    var = wav.var(-1, unbiased=False, keepdim=True)
    return (wav - mean) / torch.sqrt(var + eps)


def check_hf_arch(config: Mapping) -> None:
    """Refuse the HF variants this encoder does not implement: a 'layer'
    feature-extractor norm or the stable-layer-norm (pre-norm) encoder of
    the large models."""
    norm = config.get("feat_extract_norm", "group")
    if norm != "group":
        raise NotImplementedError("Wav2Vec2Encoder supports feat_extract_norm='group' "
                                  f"(base models); got {norm!r}")
    if config.get("do_stable_layer_norm", False):
        raise NotImplementedError("Wav2Vec2Encoder implements the post-norm (base) layer "
                                  "ordering; do_stable_layer_norm=True models are unsupported")


def config_from_hf(config: Mapping) -> Wav2Vec2Config:
    """An HF `Wav2Vec2Config` (the dict of its config.json) -> the encoder's."""
    check_hf_arch(config)
    c = Wav2Vec2Config()
    return Wav2Vec2Config(
        conv_dim=tuple(config.get("conv_dim", c.conv_dim)),
        conv_kernel=tuple(config.get("conv_kernel", c.conv_kernel)),
        conv_stride=tuple(config.get("conv_stride", c.conv_stride)),
        conv_bias=bool(config.get("conv_bias", c.conv_bias)),
        hidden_size=config.get("hidden_size", c.hidden_size),
        num_layers=config.get("num_hidden_layers", c.num_layers),
        num_heads=config.get("num_attention_heads", c.num_heads),
        intermediate_size=config.get("intermediate_size", c.intermediate_size),
        num_conv_pos_embeddings=config.get("num_conv_pos_embeddings",
                                           c.num_conv_pos_embeddings),
        num_conv_pos_embedding_groups=config.get("num_conv_pos_embedding_groups",
                                                 c.num_conv_pos_embedding_groups))


def _pos_conv_weight(sd: Mapping[str, np.ndarray], base: str) -> np.ndarray:
    """The position conv's effective kernel [out, in/g, k]: weight_norm over
    dim 2 stores g [1, 1, k] and v, w = g v / |v| with the norm over dims 0
    and 1 at each tap (`weight_g`/`weight_v`, or the newer
    `parametrizations.weight.original0/1`)."""
    if f"{base}.weight" in sd:
        return sd[f"{base}.weight"]
    for g_key, v_key in (("weight_g", "weight_v"),
                         ("parametrizations.weight.original0",
                          "parametrizations.weight.original1")):
        if f"{base}.{g_key}" in sd:
            g = sd[f"{base}.{g_key}"].astype(np.float64)
            v = sd[f"{base}.{v_key}"].astype(np.float64)
            return g * v / np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    raise KeyError(f"no weight of {base} in the state dict")


HF_POS_CONV = "encoder.pos_conv_embed.conv"


def hf_names(cfg: Wav2Vec2Config) -> dict:
    """{the port's state-dict key: the HF `Wav2Vec2Model` key} of every
    tensor but the position conv's weight (`HF_POS_CONV`, weight-normed
    there). The HF modules are torch modules in the same layouts, so only
    the names differ."""
    pairs = [(f"feature_extractor.conv_layers.{i}.conv", f"feature_extractor.conv{i}",
              cfg.conv_bias) for i in range(len(cfg.conv_dim))]
    pairs += [("feature_extractor.conv_layers.0.layer_norm", "feature_extractor.group_norm", True),
              ("feature_projection.layer_norm", "fp_layer_norm", True),
              ("feature_projection.projection", "fp_projection", True),
              ("encoder.layer_norm", "enc_layer_norm", True)]
    for i in range(cfg.num_layers):
        src = f"encoder.layers.{i}"
        pairs += [(f"{src}.attention.{n}", f"layer{i}.{n}", True)
                  for n in ("q_proj", "k_proj", "v_proj", "out_proj")]
        pairs += [(f"{src}.{n}", f"layer{i}.{n.split('.')[-1]}", True)
                  for n in ("layer_norm", "feed_forward.intermediate_dense",
                            "feed_forward.output_dense", "final_layer_norm")]
    names = {"pos_conv.bias": f"{HF_POS_CONV}.bias"}
    for src, dst, bias in pairs:
        names[f"{dst}.weight"] = f"{src}.weight"
        if bias:
            names[f"{dst}.bias"] = f"{src}.bias"
    return names


def convert_hf_wav2vec2(sd: Mapping[str, np.ndarray], cfg: Wav2Vec2Config):
    """An HF `Wav2Vec2Model` state dict (numpy; a `wav2vec2.` prefix, as in
    the pre-training and CTC checkpoints, is stripped and the keys of other
    heads, and the training-only `masked_spec_embed`, are left out) -> the
    port Wav2Vec2Encoder's state dict (f32)."""
    sd = {k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k: np.asarray(v)
          for k, v in sd.items()}
    out = {port: sd[hf] for port, hf in hf_names(cfg).items()}
    out["pos_conv.weight"] = _pos_conv_weight(sd, HF_POS_CONV)
    return {k: v.astype(np.float32) for k, v in out.items()}


def read_hf_state_dict(directory: str) -> dict:
    """The numpy state dict of a local HF model directory: `model.safetensors`
    (read by `data/ingest.py`), else `pytorch_model.bin` (`torch.load`
    with weights_only=True)."""
    from nerf3dtalker_tpu_torch.data.ingest import read_safetensors

    st = os.path.join(directory, "model.safetensors")
    if os.path.isfile(st):
        return read_safetensors(st)
    sd = torch.load(os.path.join(directory, "pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def load_hf_wav2vec2(directory: str, device: Optional[Union[str, torch.device]] = None
                     ) -> Wav2Vec2Encoder:
    """Wav2Vec2Encoder on `device` (default `cuda`) from a local HF
    `Wav2Vec2Model` directory (config.json + weights); no init, every
    weight comes from the file."""
    from nerf3dtalker_tpu_torch.utils.bridge import load_into

    with open(os.path.join(directory, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    sd = convert_hf_wav2vec2(read_hf_state_dict(directory), cfg)
    enc = uninitialized(lambda d: Wav2Vec2Encoder(cfg, device=d), device)
    return load_into(enc, sd).eval()
