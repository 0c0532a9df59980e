"""BFM09 parametric face model (port of
`nerf3dtalker_tpu/models/face3d/bfm.py`; reference s_face3d/models/bfm.py:
26-330 ParametricFaceModel).

PCA shape / expression / texture bases, vertex normals through the
per-vertex face list, 3-band SH colour, the transposed Euler rotation
(points are row vectors, `pts @ R`), the fixed-distance camera, the
perspective projection, 68 keypoints and the 257-coefficient split
(id80|exp64|tex80|angle3|gamma27|trans3, bfm.py:253-274; the `exp` slice is
what SadTalker and NeRF-3DTalker feed to the NeRF's expression code).

The bases come from a BFM `.mat` that the caller names (`load_bfm`); the
repository holds none. `synthetic_bfm` draws a small one from a numpy seed.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch


class BFM(NamedTuple):
    mean_shape: torch.Tensor   # [3N]
    id_base: torch.Tensor      # [3N, 80]
    exp_base: torch.Tensor     # [3N, 64]
    mean_tex: torch.Tensor     # [3N]
    tex_base: torch.Tensor     # [3N, 80]
    faces: torch.Tensor        # [F, 3] int64 (face_buf)
    point_buf: torch.Tensor    # [N, 8] faces adjacent to each vertex
    keypoints: torch.Tensor    # [68] vertex ids
    camera_distance: float = 10.0
    focal: float = 1015.0
    center: float = 112.0


# SH constants (bfm.py SH class)
_SH_A = (np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0))
_SH_C = (1 / np.sqrt(4 * np.pi), np.sqrt(3.0) / np.sqrt(4 * np.pi),
         3 * np.sqrt(5.0) / np.sqrt(12 * np.pi))
_INIT_LIT = (0.8, 0, 0, 0, 0, 0, 0, 0, 0)


def split_coeff(coeffs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B, 257] -> dict (bfm.py:253-274)."""
    return {"id": coeffs[:, :80], "exp": coeffs[:, 80:144], "tex": coeffs[:, 144:224],
            "angle": coeffs[:, 224:227], "gamma": coeffs[:, 227:254],
            "trans": coeffs[:, 254:257]}


def compute_shape(bfm: BFM, id_coeff: torch.Tensor, exp_coeff: torch.Tensor) -> torch.Tensor:
    """[B, 80], [B, 64] -> [B, N, 3] (bfm.py:87-101)."""
    s = (torch.einsum("ij,aj->ai", bfm.id_base, id_coeff)
         + torch.einsum("ij,aj->ai", bfm.exp_base, exp_coeff) + bfm.mean_shape)
    return s.reshape(id_coeff.shape[0], -1, 3)


def compute_texture(bfm: BFM, tex_coeff: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    t = torch.einsum("ij,aj->ai", bfm.tex_base, tex_coeff) + bfm.mean_tex
    if normalize:
        t = t / 255.0
    return t.reshape(tex_coeff.shape[0], -1, 3)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


def compute_norm(bfm: BFM, face_shape: torch.Tensor) -> torch.Tensor:
    """Vertex normals through the per-vertex face list (bfm.py:118-139);
    point_buf entries equal to F read an appended zero normal."""
    v1, v2, v3 = (face_shape[:, bfm.faces[:, k]] for k in range(3))
    fn = _unit(torch.linalg.cross(v1 - v2, v2 - v3, dim=-1))
    fn = torch.cat([fn, torch.zeros_like(fn[:, :1])], dim=1)
    return _unit(fn[:, bfm.point_buf].sum(dim=2))


def compute_color(face_texture: torch.Tensor, face_norm: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """3 x 9 SH shading (bfm.py:141-173): gamma [B, 27] laid out [3 channels
    x 9]."""
    B = gamma.shape[0]
    g = gamma.reshape(B, 3, 9) + torch.tensor(_INIT_LIT, dtype=gamma.dtype, device=gamma.device)
    g = g.permute(0, 2, 1)                                    # [B, 9, 3]
    a, c, n = _SH_A, _SH_C, face_norm
    ones = torch.ones_like(n[..., :1])
    Y = torch.cat([
        float(a[0] * c[0]) * ones,
        float(-a[1] * c[1]) * n[..., 1:2],
        float(a[1] * c[1]) * n[..., 2:],
        float(-a[1] * c[1]) * n[..., :1],
        float(a[2] * c[2]) * n[..., :1] * n[..., 1:2],
        float(-a[2] * c[2]) * n[..., 1:2] * n[..., 2:],
        float(0.5 * a[2] * c[2] / np.sqrt(3.0)) * (3 * n[..., 2:] ** 2 - 1),
        float(-a[2] * c[2]) * n[..., :1] * n[..., 2:],
        float(0.5 * a[2] * c[2]) * (n[..., :1] ** 2 - n[..., 1:2] ** 2),
    ], dim=-1)                                                # [B, N, 9]
    return torch.einsum("bnk,bkc->bnc", Y, g) * face_texture


def compute_rotation(angles: torch.Tensor) -> torch.Tensor:
    """[B, 3] radians -> [B, 3, 3], transposed (points are row vectors:
    pts @ R; bfm.py:175-208)."""
    x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
    o, zr = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([o, zr, zr, zr, x.cos(), -x.sin(), zr, x.sin(), x.cos()], 1).reshape(-1, 3, 3)
    ry = torch.stack([y.cos(), zr, y.sin(), zr, o, zr, -y.sin(), zr, y.cos()], 1).reshape(-1, 3, 3)
    rz = torch.stack([z.cos(), -z.sin(), zr, z.sin(), z.cos(), zr, zr, zr, o], 1).reshape(-1, 3, 3)
    return (rz @ ry @ rx).transpose(1, 2)


def to_camera(bfm: BFM, face_shape: torch.Tensor) -> torch.Tensor:
    """z -> camera_distance - z (bfm.py:211-213)."""
    return torch.cat([face_shape[..., :2], bfm.camera_distance - face_shape[..., 2:]], dim=-1)


def to_image(bfm: BFM, face_shape: torch.Tensor) -> torch.Tensor:
    """Perspective projection with focal / center (bfm.py:215-226)."""
    proj = torch.tensor([[bfm.focal, 0, bfm.center], [0, bfm.focal, bfm.center], [0, 0, 1]],
                        dtype=face_shape.dtype, device=face_shape.device).T
    p = face_shape @ proj
    return p[..., :2] / p[..., 2:]


def compute_for_render(bfm: BFM, coeffs: torch.Tensor):
    """The full decode (bfm.py:275-300): (verts_cam, texture, color,
    landmarks68)."""
    c = split_coeff(coeffs)
    shape = compute_shape(bfm, c["id"], c["exp"])
    rot = compute_rotation(c["angle"])
    verts_cam = to_camera(bfm, shape @ rot + c["trans"][:, None])
    lm = to_image(bfm, verts_cam)[:, bfm.keypoints]
    tex = compute_texture(bfm, c["tex"])
    color = compute_color(tex, compute_norm(bfm, shape) @ rot, c["gamma"])
    return verts_cam, tex, color, lm


def _bfm_of(arrays: dict, device) -> BFM:
    f32 = {k: torch.as_tensor(np.asarray(arrays[k], np.float32), device=device)
           for k in ("mean_shape", "id_base", "exp_base", "mean_tex", "tex_base")}
    i64 = {k: torch.as_tensor(np.asarray(arrays[k], np.int64), device=device)
           for k in ("faces", "point_buf", "keypoints")}
    return BFM(**f32, **i64)


def load_bfm(mat_path: str, device: Optional[Union[str, torch.device]] = None) -> BFM:
    """The BFM09 arrays of Deep3DFaceRecon's `BFM_model_front.mat`
    (s_face3d/util/load_mats.py), read from the local file the caller names,
    on `device` (default `cuda`)."""
    from scipy.io import loadmat

    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    m = loadmat(mat_path)
    return _bfm_of({
        "mean_shape": m["meanshape"].reshape(-1), "id_base": m["idBase"],
        "exp_base": m["exBase"], "mean_tex": m["meantex"].reshape(-1),
        "tex_base": m["texBase"], "faces": m["tri"].astype(np.int64).reshape(-1, 3) - 1,
        "point_buf": m["point_buf"].astype(np.int64) - 1,
        "keypoints": np.squeeze(m["keypoints"]).astype(np.int64) - 1,
    }, resolve_device(device))


def synthetic_bfm(n_verts: int = 64, n_faces: int = 100, seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None) -> BFM:
    """A small random BFM (the JAX `synthetic_bfm`'s values: the same numpy
    draws in the same order), on `device` (default `cuda`)."""
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    rng = np.random.default_rng(seed)
    faces = rng.integers(0, n_verts, (n_faces, 3))
    point_buf = rng.integers(0, n_faces, (n_verts, 8))
    return _bfm_of({
        "mean_shape": rng.standard_normal(3 * n_verts).astype(np.float32),
        "id_base": rng.standard_normal((3 * n_verts, 80)).astype(np.float32) * 0.01,
        "exp_base": rng.standard_normal((3 * n_verts, 64)).astype(np.float32) * 0.01,
        "mean_tex": np.full(3 * n_verts, 128.0, np.float32),
        "tex_base": rng.standard_normal((3 * n_verts, 80)).astype(np.float32),
        "faces": faces, "point_buf": point_buf,
        "keypoints": rng.integers(0, n_verts, 68),
    }, resolve_device(device))
