"""The audio models (port of `nerf3dtalker_tpu/models/audio.py`):

  * `BiLSTM` / `Audio2Style` — mel chunks -> 64-d style vectors (reference
    `RNNModel`/`Audio2style`, talker_trainer.py:408-473);
  * `FusAudio2Style` — cat(style 64, SadTalker exp 64) -> fused 64
    (talker_trainer_disexp.py:471-501);
  * `SimpleWrapperV2` — SadTalker's audio -> expression netG
    (s_audio2exp_models/networks.py:26-74), NCHW as the reference;
  * `audio2exp_sequence` — netG over a frame sequence
    (s_audio2exp_models/audio2exp.py:13-41).

In Audio2Style, per-frame 80x16 mel chunks are flattened and the whole frame sequence runs
through a 2-layer bidirectional LSTM as ONE sequence ([T, 80, 16] ->
[1, T, 1280]), then three Linear+LeakyReLU(0.2) heads squeeze to 64, each
followed by dropout 0.5 in training. The dropout masks are drawn from the
`generator` the caller passes (flax `nn.Dropout`: keep with probability 0.5
and scale by 2); without one the model is deterministic, as at inference.
`torch.nn.LSTM` uses the flax gate order
(i, f, g, o); the flax cell has one bias per gate on the hidden projection,
so the param bridge sets `bias_ih = 0` and `bias_hh` to the flax biases,
and `bias_ih` is kept out of training.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf3dtalker_tpu_torch.utils.device import resolve_device


class BiLSTM(nn.Module):
    """2-layer bidirectional LSTM over [B, T, D] -> [B, T, 2h]."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2):
        super().__init__()
        self.rnn = nn.LSTM(input_size, hidden_size, num_layers=num_layers,
                           bidirectional=True, batch_first=True)
        # the flax cell has one bias per gate: bias_hh carries it, bias_ih
        # stays zero and out of training (else the sum would move twice)
        for name, p in self.rnn.named_parameters():
            if name.startswith("bias_ih"):
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)[0]


class Audio2Style(nn.Module):
    """Mel chunks [T, 80, 16] (one frame sequence) -> style vectors [T, 64]."""

    dropout_rate = 0.5

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are initialized on the CPU from `generator` and moved
        to `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        self.rnn = BiLSTM(80 * 16, 40 * 16)
        self.linear1 = nn.Linear(2 * 40 * 16, 40 * 16)
        self.linear2 = nn.Linear(40 * 16, 20 * 16)
        self.linear3 = nn.Linear(20 * 16, 64)
        self.reset_parameters(generator)
        self.to(dev)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """LSTM weights uniform in ±1/sqrt(h) with zero biases; LeCun-normal
        linear kernels with zero biases."""
        bound = self.rnn.rnn.hidden_size ** -0.5
        for name, p in self.rnn.named_parameters():
            if "weight" in name:
                nn.init.uniform_(p, -bound, bound, generator=generator)
            else:
                nn.init.zeros_(p)
        for lin in (self.linear1, self.linear2, self.linear3):
            nn.init.normal_(lin.weight, std=lin.in_features ** -0.5, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, mels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` (on the device of `mels`) turns the dropout on."""
        T = mels.shape[0]
        x = self.rnn(mels.reshape(T, 80 * 16)[None])[0]
        keep = 1.0 - self.dropout_rate
        for lin in (self.linear1, self.linear2, self.linear3):
            x = F.leaky_relu(lin(x), 0.2)
            if generator is not None:
                u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
                x = torch.where(u < keep, x / keep, torch.zeros_like(x))
        return x


class FusAudio2Style(nn.Module):
    """cat(audio style [.., 64], SadTalker exp [.., 64]) -> [.., 64]: two
    Linear + LeakyReLU(0.2) heads (talker_trainer_disexp.py:494-501). The
    reference's dropout after each head is left out: no caller trains with
    it (the disexp step runs the head deterministic, as JAX's does)."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are initialized on the CPU from `generator` at the flax
        defaults and moved to `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        self.linear1 = nn.Linear(128, 64)
        self.linear2 = nn.Linear(64, 64)
        _flax_init(self, generator)
        self.to(dev)

    def forward(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.linear1(torch.cat([f1, f2], dim=-1)), 0.2)
        return F.leaky_relu(self.linear2(x), 0.2)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm2d (+ the input, for a residual block) + ReLU: the
    wav2lip `Conv2d` block of networks.py:5-24, its modules named as there
    (`conv_block.0`, `conv_block.1`). The norm always uses the running
    statistics (JAX applies the model with train=False everywhere), written
    out so that a caller may differentiate through them (the audio2exp step
    does, as JAX's does)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride, padding: int,
                 residual: bool = False):
        super().__init__()
        self.conv_block = nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, padding),
                                        nn.BatchNorm2d(cout))
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.conv_block
        scale = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = (conv(x) - bn.running_mean[:, None, None]) * scale[:, None, None] \
            + bn.bias[:, None, None]
        return F.relu(y + x if self.residual else y)


# (cout, kernel, stride, padding, residual) of the 13 blocks (networks.py:29-44)
_SIMPLE_WRAPPER_V2 = (
    (32, 3, (1, 1), 1, False), (32, 3, (1, 1), 1, True), (32, 3, (1, 1), 1, True),
    (64, 3, (3, 1), 1, False), (64, 3, (1, 1), 1, True), (64, 3, (1, 1), 1, True),
    (128, 3, (3, 3), 1, False), (128, 3, (1, 1), 1, True), (128, 3, (1, 1), 1, True),
    (256, 3, (3, 2), 1, False), (256, 3, (1, 1), 1, True),
    (512, 3, (1, 1), 0, False), (512, 1, (1, 1), 0, False),
)


class SimpleWrapperV2(nn.Module):
    """SadTalker's audio -> exp regressor netG: 13 conv blocks over the
    80 x 16 mel chunk down to 512 x 1 x 1, then Linear(512 + 64 + 1 -> 64) on
    [audio, ref exp, blink ratio]. Module names are the reference's
    (`audio_encoder.{i}.conv_block.{0,1}`, `mapping1`), so a SadTalker state
    dict loads as it is (`utils/convert.py:convert_simple_wrapper_v2`).
    The BatchNorms use their running statistics (`ConvBN`)."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are initialized on the CPU from `generator` at the flax
        defaults (LeCun-normal kernels, zero biases, unit BN scales, running
        mean 0 and variance 1) and moved to `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        blocks, cin = [], 1
        for cout, k, stride, pad, res in _SIMPLE_WRAPPER_V2:
            blocks.append(ConvBN(cin, cout, k, stride, pad, res))
            cin = cout
        self.audio_encoder = nn.Sequential(*blocks)
        self.mapping1 = nn.Linear(512 + 64 + 1, 64)
        _flax_init(self, generator)
        self.to(dev)

    def forward(self, mel: torch.Tensor, ref: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
        """mel [B, 1, 80, 16]; ref [B, 64]; ratio [B, 1] -> exp [B, 64]."""
        B = mel.shape[0]
        x = self.audio_encoder(mel).reshape(B, -1)
        return self.mapping1(torch.cat([x, ref.reshape(B, -1), ratio.reshape(B, -1)], dim=1))


def audio2exp_sequence(netg: SimpleWrapperV2, indiv_mels: torch.Tensor, ref_exp: torch.Tensor,
                       ratios: torch.Tensor) -> torch.Tensor:
    """netG frame by frame over a sequence, as one batch (audio2exp.py:21-41):
    indiv_mels [T, 80, 16], ref_exp [64] (the frame-0 exp), ratios [T] ->
    [T, 64]."""
    T = indiv_mels.shape[0]
    return netg(indiv_mels[:, None], ref_exp[None].expand(T, -1), ratios.reshape(T, 1))


def _flax_init(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """The flax defaults: LeCun-normal kernels (truncated at 2 sigma) and
    zero biases (`models/vq/transformer.py:flax_init_`), BatchNorm scale 1,
    bias 0, running mean 0 and variance 1."""
    from nerf3dtalker_tpu_torch.models.vq.transformer import flax_init_

    flax_init_(module, generator)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
