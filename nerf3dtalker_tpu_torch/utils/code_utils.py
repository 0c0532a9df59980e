"""Latent-code generation / interpolation helpers (port of
`nerf3dtalker_tpu/utils/code_utils.py`; numpy, with the port's
`euler_to_rmat`).

Equivalent of reference `Utils/HeadNeRFUtils.py:13-213` (the GUI helper's
code gen/interp and Euler-angle camera generation, minus the OpenGL
widgets): random code sampling around the latent prior, slerp/lerp code
interpolation paths, and Euler-parameterized camera orbits.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from nerf3dtalker_tpu_torch.utils.rotations import euler_to_rmat


def random_codes(
    rng: np.random.Generator, scale: float = 0.3,
    dims: Dict[str, int] | None = None,
) -> Dict[str, np.ndarray]:
    """Sample a full latent set (iden/expr/text/illu) ~ N(0, scale)."""
    dims = dims or {"iden": 100, "expr": 79, "text": 100, "illu": 27}
    return {
        k: (rng.standard_normal((1, d)) * scale).astype(np.float32)
        for k, d in dims.items()
    }


def lerp_codes(a: np.ndarray, b: np.ndarray, steps: int) -> np.ndarray:
    """[1, D] x2 -> [steps, D] linear interpolation path."""
    t = np.linspace(0.0, 1.0, steps, dtype=np.float32)[:, None]
    return a * (1 - t) + b * t


def slerp_codes(a: np.ndarray, b: np.ndarray, steps: int) -> np.ndarray:
    """Spherical interpolation (for gaussian latents; HeadNeRFUtils-style
    smooth morphs)."""
    a0, b0 = a[0], b[0]
    na, nb = np.linalg.norm(a0), np.linalg.norm(b0)
    omega = np.arccos(np.clip(np.dot(a0 / na, b0 / nb), -1, 1))
    ts = np.linspace(0.0, 1.0, steps)
    if omega < 1e-6:
        return lerp_codes(a, b, steps)
    out = [
        (np.sin((1 - t) * omega) * a0 + np.sin(t * omega) * b0) / np.sin(omega)
        for t in ts
    ]
    return np.stack(out).astype(np.float32)


def euler_orbit_cams(
    pitch_range: float = 0.3, yaw_range: float = 0.6, steps: int = 30,
    tvec_z: float = 12.0,
) -> List[Dict[str, np.ndarray]]:
    """Euler-angle camera sweep (HeadNeRFUtils.py camera gen): a figure-8
    style pitch/yaw path at fixed distance."""
    cams = []
    for i in range(steps):
        t = 2 * np.pi * i / steps
        pitch = pitch_range * np.sin(t)
        yaw = yaw_range * np.sin(2 * t)
        R = euler_to_rmat(torch.tensor([[pitch, yaw, 0.0]], dtype=torch.float32))[0].numpy()
        base = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        cams.append({
            "Rmat": (R @ base)[None].astype(np.float32),
            "Tvec": np.array([[0.0, 0.0, tvec_z]], np.float32),
        })
    return cams
