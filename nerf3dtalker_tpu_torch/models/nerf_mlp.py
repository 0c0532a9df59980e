"""The NeRF point MLP (port of `nerf3dtalker_tpu/models/nerf_mlp.py`,
reference `MLPforNeRF`, NetWorks/models.py:13-87).

Parameters keep the flax names and layout (`fea_{i}_kernel` [in, out],
`fea_{i}_bias`, `density_*`, `rgb_{0,1,2}_*`) so the param bridge is a
rename-free copy and `pack_weights` reads them as the JAX one does. The
per-batch codes are folded into per-batch biases by splitting the kernels:
cat([pe, code]) @ W == pe @ W_pe + code @ W_code.

Topology (h=384): fea_0 [vp+64 -> h]; fea_1..7 [h -> h] except the skip
layer fea_5 [h+vp -> h]; density [h -> 1]; rgb_0 [h -> h] (no activation);
rgb_1 [h+vd -> h//2]; rgb_2 [h//2 -> out]. With view-direction
conditioning (HeadNeRFNet.py:56-60, include_vd) `vd_pe` carries the
per-point direction encoding and rgb_1's rows are [hidden | vd_pe | appea],
the reference's cat([x, cat([vd_embed, appea])]).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class NeRFMLP(nn.Module):
    def __init__(self, vp_channels: int, vd_channels: int, audio_channels: int = 64,
                 n_layers: int = 8, hidden: int = 384, out_features: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vp_channels, self.vd_channels = vp_channels, vd_channels
        self.audio_channels, self.n_layers = audio_channels, n_layers
        self.hidden, self.out_features = hidden, out_features
        self.compute_dtype = compute_dtype
        h, A = hidden, audio_channels
        shapes = {"fea_0": (vp_channels + A, h)}
        for i in range(1, n_layers):
            shapes[f"fea_{i}"] = (vp_channels + h if i == n_layers // 2 + 1 else h, h)
        shapes.update(density=(h, 1), rgb_0=(h, h), rgb_1=(h + vd_channels, h // 2),
                      rgb_2=(h // 2, out_features))
        for name, (cin, cout) in shapes.items():
            self.register_parameter(f"{name}_kernel", nn.Parameter(torch.empty(cin, cout)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(cout)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform kernels and zero biases (the flax init)."""
        for name, p in self.named_parameters():
            if name.endswith("_kernel"):
                nn.init.xavier_uniform_(p, generator=generator)
            else:
                nn.init.zeros_(p)

    def forward(self, pe: torch.Tensor, shape_code: torch.Tensor,
                vd_code: torch.Tensor, audio_style: torch.Tensor,
                vd_pe: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pe [B, ..., P] -> (features [B, ..., out] f32, density [B, ..., 1] f32);
        codes are [B, C] and broadcast over the point dims; `vd_pe`
        [B, ..., Dv] is the view-direction encoding when it is on."""
        P, S = pe.shape[-1], shape_code.shape[-1]
        if P + S != self.vp_channels:
            raise ValueError(f"pe ({P}) + shape code ({S}) != vp_channels {self.vp_channels}")
        cdt = self.compute_dtype
        p = {k: v.to(cdt) for k, v in self.named_parameters()}
        h = self.hidden
        pe = pe.to(cdt)
        bc = (slice(None),) + (None,) * (pe.dim() - 2)

        k0 = p["fea_0_kernel"]
        cb0 = shape_code.to(cdt) @ k0[P:P + S] + audio_style.to(cdt) @ k0[P + S:] + p["fea_0_bias"]
        x = torch.relu(pe @ k0[:P] + cb0[bc])
        skip = self.n_layers // 2
        for i in range(1, self.n_layers):
            ki, bi = p[f"fea_{i}_kernel"], p[f"fea_{i}_bias"]
            if i == skip + 1:
                cb = shape_code.to(cdt) @ ki[P:P + S] + bi
                x = pe @ ki[:P] + x @ ki[P + S:] + cb[bc]
            else:
                x = x @ ki + bi
            x = torch.relu(x)

        density = x @ p["density_kernel"] + p["density_bias"]
        x = x @ p["rgb_0_kernel"] + p["rgb_0_bias"]
        k_r1 = p["rgb_1_kernel"]
        dv = 0 if vd_pe is None else vd_pe.shape[-1]
        cb1 = vd_code.to(cdt) @ k_r1[h + dv:] + p["rgb_1_bias"]
        x = x @ k_r1[:h] + cb1[bc]
        if vd_pe is not None:
            x = x + vd_pe.to(cdt) @ k_r1[h:h + dv]
        x = torch.relu(x)
        rgb = x @ p["rgb_2_kernel"] + p["rgb_2_bias"]
        density = torch.relu(density)
        if self.out_features == 3:
            rgb = torch.sigmoid(rgb)
        return rgb.float(), density.float()
