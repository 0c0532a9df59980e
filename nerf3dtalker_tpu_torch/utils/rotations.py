"""Rotation algebra: Euler / quaternion / SO(3) / 6D conversions (port of
`nerf3dtalker_tpu/utils/rotations.py`, reference `Utils/D6_rotation.py:8-199`
and the fitting code's Euler composition, FittingSingleImage_new.py:736-766:
R = Rz @ Ry @ Rx).

Batched torch tensors, differentiable: the camera gradient of a fit runs
through `euler_to_rmat`.
"""

from __future__ import annotations

import torch


def euler_to_rmat(angles: torch.Tensor) -> torch.Tensor:
    """[B, 3] (x, y, z) Euler angles -> [B, 3, 3], R = Rz Ry Rx."""
    sx, sy, sz = (torch.sin(angles[:, i]) for i in range(3))
    cx, cy, cz = (torch.cos(angles[:, i]) for i in range(3))
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    Rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx], dim=-1).reshape(-1, 3, 3)
    Ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], dim=-1).reshape(-1, 3, 3)
    Rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o], dim=-1).reshape(-1, 3, 3)
    return Rz @ Ry @ Rx


def quat_to_rmat(q: torch.Tensor) -> torch.Tensor:
    """[B, 4] (w, x, y, z) -> [B, 3, 3] (D6_rotation.py:24-45)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        1 - 2 * y ** 2 - 2 * z ** 2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
        2 * x * y + 2 * z * w, 1 - 2 * x ** 2 - 2 * z ** 2, 2 * y * z - 2 * x * w,
        2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x ** 2 - 2 * y ** 2,
    ], dim=-1).reshape(-1, 3, 3)


def rmat_to_d6(R: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] -> [B, 6]: the first two columns (D6_rotation.py:48-50)."""
    return torch.cat([R[:, :, 0], R[:, :, 1]], dim=-1)


def d6_to_rmat(d6: torch.Tensor) -> torch.Tensor:
    """[B, 6] -> [B, 3, 3] by Gram-Schmidt (Zhou et al. 1812.07035, eq. 15)."""
    a1, a2 = d6[:, :3], d6[:, 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def quat_to_d6(q: torch.Tensor) -> torch.Tensor:
    return rmat_to_d6(quat_to_rmat(q))


def rpy_to_rmat(roll, pitch, yaw) -> torch.Tensor:
    """Scalar roll / pitch / yaw -> [3, 3], R = yaw @ pitch @ roll
    (D6_rotation.py:160-188)."""
    angles = (roll, pitch, yaw)
    dev = next((v.device for v in angles if isinstance(v, torch.Tensor)), None)
    a = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev) for v in angles])
    return euler_to_rmat(a[None])[0]


def gaze_to_d6(face_gaze: torch.Tensor) -> torch.Tensor:
    """[2] (pitch, yaw) normalized gaze -> [6] rotation representation
    (D6_rotation.py:192-199)."""
    R = rpy_to_rmat(0.0, face_gaze[0], face_gaze[1])
    return rmat_to_d6(R[None])[0]
