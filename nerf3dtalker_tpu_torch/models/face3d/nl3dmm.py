"""Nonlinear 3DMM decoder, SH lighting and the differentiable mesh render
(port of `nerf3dtalker_tpu/models/face3d/nl3dmm.py`; reference
Fitting3DMM/FaceModels.py:8-126 and NL3DMMRenderer.py:16-379).

`NonLinear3DMM` decodes iden(100)+expr(79) to vertices through
Linear(179, 1024) -> ReLU -> Linear(1024, 3V); `Linear3DMMTexture` is the
PCA texture over the same V points. The module names are the flax ones
(`geo_fc2`, `geo_fc3`; `b_tex`, `mu_tex`, `sig_tex`), so
`utils/bridge.py:nl3dmm_state_dict` maps the JAX variables one to one. The
mesh size is read off the weights, so a reduced mesh (the preprocess
default, tests) needs nothing else.

The basis (`ConfigModels/nl3dmm_dict.pkl`) is not part of the repository:
`load_nl3dmm_basis` reads a local copy that the caller names.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from nerf3dtalker_tpu_torch.models.face3d.rasterizer import (
    project_perspective,
    render_mesh,
    vertex_normals,
)
from nerf3dtalker_tpu_torch.utils.device import resolve_device

POINT_NUM = 34650   # FaceModels.py:33


class NonLinear3DMM(nn.Module):
    """iden [B, 100] + expr [B, 79] -> vertices [B, V, 3] (FaceModels.py:24-62)."""

    def __init__(self, point_num: int = POINT_NUM, code_dims: int = 179,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Initialized on the CPU from `generator` at the flax Dense defaults
        (LeCun-normal kernels, zero biases), then moved to `device`
        (default `cuda`)."""
        from nerf3dtalker_tpu_torch.models.vq.transformer import flax_init_

        super().__init__()
        dev = resolve_device(device)
        self.geo_fc2 = nn.Linear(code_dims, 1024)
        self.geo_fc3 = nn.Linear(1024, 3 * point_num)
        flax_init_(self, generator)
        self.to(dev)

    @property
    def point_num(self) -> int:
        return self.geo_fc3.out_features // 3

    def forward(self, iden_code: torch.Tensor, expr_code: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
        x = torch.relu(self.geo_fc2(torch.cat([iden_code, expr_code], dim=-1)))
        return self.geo_fc3(x).reshape(-1, self.point_num, 3) * scale


class Linear3DMMTexture(nn.Module):
    """PCA texture: tex = (norm_code * sig_tex) @ b_tex + mu_tex
    (FaceModels.py:77-126) -> [B, V, 3]."""

    def __init__(self, point_num: int = POINT_NUM, tex_dims: int = 100,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """b_tex N(0, 0.01^2) from `generator`, mu_tex 0.5, sig_tex 1 (the
        flax init), on `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        b_tex = torch.empty(tex_dims, 3 * point_num)
        if not b_tex.is_meta:
            b_tex.normal_(0.0, 0.01, generator=generator)
        self.b_tex = nn.Parameter(b_tex)
        self.mu_tex = nn.Parameter(torch.full((3 * point_num,), 0.5))
        self.sig_tex = nn.Parameter(torch.ones(tex_dims))
        self.to(dev)

    @property
    def point_num(self) -> int:
        return self.mu_tex.shape[-1] // 3

    def forward(self, norm_tex_code: torch.Tensor) -> torch.Tensor:
        tex = (norm_tex_code * self.sig_tex) @ self.b_tex + self.mu_tex
        return tex.reshape(-1, self.point_num, 3)


# SH band constants (NL3DMMRenderer.py:71-92 a0..d0)
_A0 = np.pi
_A1 = 2 * np.pi / np.sqrt(3.0)
_A2 = 2 * np.pi / np.sqrt(8.0)
_C0 = 1.0 / np.sqrt(4 * np.pi)
_C1 = np.sqrt(3.0) / np.sqrt(4 * np.pi)
_C2 = 3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)
_D0 = 0.5 / np.sqrt(3.0)


def sh_lighting(vcolor: torch.Tensor, normals: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """9-band SH shading (NL3DMMRenderer.py build_color :94-128): vcolor
    [B or 1, V, 3]; normals [B, V, 3]; gamma [B, 27] -> [B, V, 3]."""
    g = gamma.reshape(-1, 9, 3)
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    Y = torch.stack([
        torch.ones_like(nx) * float(_A0) * float(_C0),
        float(-_A1 * _C1) * ny,
        float(_A1 * _C1) * nz,
        float(-_A1 * _C1) * nx,
        float(_A2 * _C2) * nx * ny,
        float(-_A2 * _C2) * ny * nz,
        float(_A2 * _C2 * _D0) * (3 * nz ** 2 - 1),
        float(-_A2 * _C2) * nx * nz,
        float(_A2 * _C2 * 0.5) * (nx ** 2 - ny ** 2),
    ], dim=-1)                                              # [B, V, 9]
    return vcolor * torch.einsum("bvk,bkc->bvc", Y, g)


class NL3DMMRenderResult(NamedTuple):
    image: torch.Tensor      # [B, H, W, 3]
    mask: torch.Tensor       # [B, H, W]
    lm2d: torch.Tensor       # [B, L, 2] projected landmarks
    verts_cam: torch.Tensor  # [B, V, 3]


def render_nl3dmm(geo: NonLinear3DMM, tex: Linear3DMMTexture,
                  iden_code, expr_code, text_code, gamma,
                  w2c_Rmat, w2c_Tvec, inmat, faces: torch.Tensor, lm_index: torch.Tensor,
                  H: int, W: int, chunk: int = 512) -> NL3DMMRenderResult:
    """The differentiable 3DMM render (NL3DMMRenderer.forward :216-379):
    decode geometry and texture, world -> camera, SH shading, rasterize,
    project the landmarks."""
    verts = geo(iden_code, expr_code)
    verts_cam = torch.einsum("bij,bvj->bvi", w2c_Rmat, verts) + w2c_Tvec[:, None, :]
    colors = sh_lighting(tex(text_code), vertex_normals(verts_cam, faces), gamma)
    img, mask = render_mesh(verts_cam, faces, colors, inmat, H, W, chunk=chunk)
    screen = project_perspective(verts_cam, inmat)
    lm2d = screen[:, lm_index.to(device=screen.device, dtype=torch.int64), :2]
    return NL3DMMRenderResult(image=img, mask=mask, lm2d=lm2d, verts_cam=verts_cam)


def load_nl3dmm_basis(pkl_path: str, net_dict: Optional[dict] = None
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """The reference basis pickle (`ConfigModels/nl3dmm_dict.pkl`,
    FaceModels.py:9-21), and optionally the decoder's state dict
    (`nl3dmm_net_dict.pth`, torch layout), as the state dicts of the port's
    modules: {"geo": NonLinear3DMM's, "tex": Linear3DMMTexture's} (numpy;
    `utils/bridge.py:load_into` copies them in).

    geo_fc3 starts as FaceModels.py:37-43 sets it: bias = mu, kernel rows
    0:179 = b ([179, 3V]), rows 179:500 = 0.001, the rest N(0, 1e-4^2)
    (numpy seed 0); geo_fc2 N(0, 0.02^2) (seed 1) and zero bias. Weights in
    `net_dict` replace them."""
    import pickle

    with open(pkl_path, "rb") as f:
        d = pickle.load(f)
    mu = np.asarray(d["mu"], np.float32)
    b = np.asarray(d["b"], np.float32)
    if b.shape[0] != 179:
        b = b.T
    k3 = np.random.default_rng(0).normal(0, 1e-4, (1024, mu.shape[0])).astype(np.float32)
    k3[:179] = b
    k3[179:500] = 1e-3
    w2 = np.random.default_rng(1).normal(0, 0.02, (179, 1024)).astype(np.float32).T
    b2 = np.zeros((1024,), np.float32)
    w3 = k3.T
    if net_dict is not None:   # converted torch weights win
        if "geo_fc2.weight" in net_dict:
            w2 = np.asarray(net_dict["geo_fc2.weight"], np.float32)
            b2 = np.asarray(net_dict["geo_fc2.bias"], np.float32)
        if "geo_fc3.weight" in net_dict:
            w3 = np.asarray(net_dict["geo_fc3.weight"], np.float32)
            mu = np.asarray(net_dict["geo_fc3.bias"], np.float32)
    geo = {"geo_fc2.weight": np.ascontiguousarray(w2), "geo_fc2.bias": b2,
           "geo_fc3.weight": np.ascontiguousarray(w3), "geo_fc3.bias": mu}
    tex = {k: np.asarray(d[k], np.float32) for k in ("b_tex", "mu_tex", "sig_tex")}
    return {"geo": geo, "tex": tex}
