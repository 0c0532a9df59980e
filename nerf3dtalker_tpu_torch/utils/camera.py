"""Camera rigs and pixel-grid helpers (numpy; copy of
`nerf3dtalker_tpu/utils/camera.py`'s `ray_grid`, `default_inv_inmat`,
`base_cam` and `orbit_cams`, reference Utils/RenderUtils.py:31-107)."""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np


class CamInfo(NamedTuple):
    Rmat: np.ndarray       # [1, 3, 3]
    Tvec: np.ndarray       # [1, 3]
    inv_inmat: np.ndarray  # [1, 3, 3]


def ray_grid(featmap_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pixel (xy) and normalized (uv) ray grids, [1, S*S, 2]."""
    idx = np.arange(featmap_size * featmap_size)
    x = (idx % featmap_size).astype(np.float32)
    y = (idx // featmap_size).astype(np.float32)
    xy = np.stack([x, y], axis=-1)[None]
    uv = np.stack([x / featmap_size, y / featmap_size], axis=-1)[None]
    return xy, uv


def default_inv_inmat(
    featmap_size: int, base_inv_inmat_32: Optional[np.ndarray] = None
) -> np.ndarray:
    """Inverse intrinsics for a featmap size: the 32x32-calibrated inverse
    intrinsics (default: a pinhole with focal 75 px and the principal point
    at the grid centre) with `inv[:2, :2] /= featmap_size / 32`."""
    if base_inv_inmat_32 is None:
        f = 75.0
        c = 16.0
        inmat = np.array(
            [[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]], dtype=np.float32
        )
        base_inv_inmat_32 = np.linalg.inv(inmat)
    inv = base_inv_inmat_32.copy().astype(np.float32)
    inv[:2, :2] /= featmap_size / 32.0
    return inv[None]


def base_cam(featmap_size: int, inv_inmat: Optional[np.ndarray] = None) -> CamInfo:
    """Frontal camera (RenderUtils.py:96-107): R = diag(1,-1,-1), T=(0,0,12)."""
    rmat = np.eye(3, dtype=np.float32)
    rmat[1:, :] *= -1
    tvec = np.array([0.0, 0.0, 12.0], dtype=np.float32)
    if inv_inmat is None:
        inv_inmat = default_inv_inmat(featmap_size)
    return CamInfo(rmat[None], tvec[None], inv_inmat)


def orbit_cams(
    view_num: int, featmap_size: int, inv_inmat: Optional[np.ndarray] = None
) -> List[CamInfo]:
    """The 45-view orbit rig used for novel-view GIFs
    (RenderUtils.py:53-93): cameras on a circle of radius sqrt(tv_x^2) at
    height tv_z looking at the origin, up = -y."""
    tv_z = 12.0
    tv_x = 5.3
    center = np.zeros(3)
    radius = math.sqrt(tv_x ** 2)
    up_ref = np.array([0.0, -1.0, 0.0])
    if inv_inmat is None:
        inv_inmat = default_inv_inmat(featmap_size)

    cams = []
    for angle in np.linspace(0.0, 360.0, view_num):
        th = angle / 180.0 * math.pi
        vp = np.array([math.cos(th) * radius, math.sin(th) * radius, tv_z])
        d1 = center - vp
        d2 = np.cross(up_ref, d1)
        d3 = np.cross(d1, d2)
        d1, d2, d3 = (v / np.linalg.norm(v) for v in (d1, d2, d3))
        rmat = np.stack([d2, d3, d1], axis=1).astype(np.float32)
        cams.append(CamInfo(rmat[None], vp.astype(np.float32)[None], inv_inmat))
    return cams
