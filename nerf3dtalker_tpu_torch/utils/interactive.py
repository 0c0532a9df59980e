"""Headless interactive-viewer helpers: arcball camera control + axis gizmo
(numpy; copy of `nerf3dtalker_tpu/utils/interactive.py`).

Stand-in for the reference's OpenGL/Qt GUI stack
(`Utils/ArcBall.py:5-160` mouse-arcball rotations, `Utils/AxisUtils.py:7-111`
xyz-axis overlay, `Utils/CustomWidgets.py` Qt sliders): the math lives here
as pure numpy so any front-end (notebook widget, web canvas, CLI video) can
drive the render loop; no GL context or Qt dependency.

Conventions match `Utils/HeadNeRFUtils.py:13-213` / `Utils/RenderUtils.py`:
world-to-cam `base_rmat = diag(1,-1,-1)`, camera at `Tvec = (0, 0, 12)`
scaled by 0.5+11.5 (AxisUtils.py:41-49), intrinsics from the 32x32 cam json
scaled to the viewport (AxisUtils.py:16-30).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


def _quat_to_rmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion [x, y, z, w] -> rotation matrix (row-major)."""
    x, y, z, w = q / max(np.linalg.norm(q), 1e-12)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


@dataclass
class ArcBall:
    """Map mouse drags on a viewport to incremental rotations.

    Usage: `click((px, py))` on mouse-down, then `drag((px, py))` per move —
    each drag returns the rotation matrix from the click point to the
    current point (reference ArcBall.py:23-50 returns the quaternion; the
    matrix form feeds `Rmat` directly).
    """

    width: float
    height: float
    _start: np.ndarray = field(default=None, repr=False)

    def _to_sphere(self, pt: Tuple[float, float]) -> np.ndarray:
        # scale viewport coords to [-1, 1] and project onto the unit ball
        # (ArcBall.py:52-76)
        x = pt[0] * (2.0 / max(self.width - 1.0, 1e-6)) - 1.0
        y = 1.0 - pt[1] * (2.0 / max(self.height - 1.0, 1e-6))
        r2 = x * x + y * y
        if r2 > 1.0:
            s = 1.0 / np.sqrt(r2)
            return np.array([x * s, y * s, 0.0], np.float32)
        return np.array([x, y, np.sqrt(1.0 - r2)], np.float32)

    def click(self, pt: Tuple[float, float]) -> None:
        self._start = self._to_sphere(pt)

    def drag(self, pt: Tuple[float, float]) -> np.ndarray:
        """Rotation matrix for the arc start -> pt (identity if no click)."""
        if self._start is None:
            return np.eye(3, dtype=np.float32)
        end = self._to_sphere(pt)
        perp = np.cross(self._start, end)
        if np.linalg.norm(perp) < 1e-5:
            return np.eye(3, dtype=np.float32)
        quat = np.array([*perp, float(np.dot(self._start, end))], np.float32)
        return _quat_to_rmat(quat)


@dataclass
class ViewerCamera:
    """Accumulated viewer state: arcball rotations + zoom/pan, producing the
    (Rmat, Tvec) pair the render step consumes (HeadNeRFUtils camera gen)."""

    img_size: int = 512
    base_tz: float = 12.0     # 0.5 + 11.5 (AxisUtils.py:46)
    rmat: np.ndarray = None
    tvec: np.ndarray = None

    def __post_init__(self):
        base = np.eye(3, dtype=np.float32)
        base[1:] *= -1.0      # AxisUtils.py:43-44
        self.base_rmat = base
        self.reset()

    def reset(self) -> None:
        self.rmat = self.base_rmat.copy()
        self.tvec = np.array([0.0, 0.0, self.base_tz], np.float32)

    def rotate(self, delta_rmat: np.ndarray) -> None:
        """Apply an arcball increment in world space (pre-multiply)."""
        self.rmat = (self.rmat @ delta_rmat).astype(np.float32)

    def zoom(self, factor: float) -> None:
        self.tvec[2] = float(np.clip(self.tvec[2] * factor, 1.0, 100.0))

    def pan(self, dx: float, dy: float) -> None:
        self.tvec[0] += dx
        self.tvec[1] += dy

    def w2c(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.rmat.copy(), self.tvec.copy()


def project_points(
    pts: np.ndarray, rmat: np.ndarray, tvec: np.ndarray, inmat: np.ndarray
) -> np.ndarray:
    """World points [N, 3] -> pixel coords [N, 2] (AxisUtils.py:57-63)."""
    cam = pts @ rmat.T + tvec[None]
    z = np.maximum(cam[:, 2:3], 1e-6)
    uv = cam[:, :2] / z
    return uv * np.array([inmat[0, 0], inmat[1, 1]]) + np.array(
        [inmat[0, 2], inmat[1, 2]]
    )


def _draw_line(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color) -> None:
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip((p0[0] + (p1[0] - p0[0]) * ts).round().astype(int), 0, img.shape[1] - 1)
    ys = np.clip((p0[1] + (p1[1] - p0[1]) * ts).round().astype(int), 0, img.shape[0] - 1)
    img[ys, xs] = color


def draw_axis_gizmo(
    img: np.ndarray,
    rmat: np.ndarray,
    tvec: np.ndarray,
    inmat: Optional[np.ndarray] = None,
    length: float = 0.75,
) -> np.ndarray:
    """Overlay the world xyz axes on a rendered frame (AxisUtils gizmo:
    x red, y green, z blue from the origin, length 0.75 — AxisUtils.py:34-38).
    `img` is uint8 or float [H, W, 3]; returns a drawn copy."""
    out = img.copy()
    H = img.shape[0]
    if inmat is None:
        # the 32x32 reference intrinsics scaled to the viewport
        # (AxisUtils.py:21-27; ConfigFiles/cam_inmat_info_32x32.json)
        s = H / 32.0
        inmat = np.array(
            [[60.0 * s, 0.0, 16.0 * s], [0.0, 60.0 * s, 16.0 * s], [0, 0, 1]],
            np.float32,
        )
    pts = np.array(
        [[0, 0, 0], [length, 0, 0], [0, length, 0], [0, 0, length]], np.float32
    )
    uv = project_points(pts, rmat, tvec, inmat)
    hi = 255 if img.dtype == np.uint8 else 1.0
    colors = [(hi, 0, 0), (0, hi, 0), (0, 0, hi)]
    for i, c in enumerate(colors):
        _draw_line(out, uv[0], uv[i + 1], c)
    return out
