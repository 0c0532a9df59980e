"""Audio2Style: mel chunks -> 64-d style vectors (port of
`nerf3dtalker_tpu/models/audio.py` `BiLSTM` and `Audio2Style`, reference
`RNNModel`/`Audio2style`, talker_trainer.py:408-473).

Per-frame 80x16 mel chunks are flattened and the whole frame sequence runs
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
