"""Vertex-error metrics of mesh sequences, LVE and FDD (numpy copy of
`nerf3dtalker_tpu/utils/mesh_metrics.py`; reference
StandardizedSpace/main/cal_metric.py:7-80):

  * LVE, the lip vertex error: the mean over frames of the largest squared
    L2 vertex error over the mouth region;
  * FDD, the upper-face dynamics deviation: the ground truth's per-vertex
    motion std minus the prediction's, over the upper-face region, averaged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def lip_vertex_error(verts_gt: np.ndarray, verts_pred: np.ndarray,
                     mouth_map: Sequence[int]) -> float:
    """verts [T, V, 3] (cal_metric.py:69-75)."""
    d = np.square(verts_gt[:, mouth_map] - verts_pred[:, mouth_map]).sum(-1)
    return float(np.mean(np.max(d, axis=1)))


def _motion_std(motion: np.ndarray, region: Sequence[int]) -> float:
    d = np.square(motion[:, region]).sum(-1)     # [T, |region|]
    return float(np.mean(np.std(d, axis=0)))


def fdd(verts_gt: np.ndarray, verts_pred: np.ndarray, template: np.ndarray,
        upper_map: Sequence[int]) -> float:
    """verts [T, V, 3], template [V, 3] (cal_metric.py:50-62)."""
    return (_motion_std(verts_gt - template[None], upper_map)
            - _motion_std(verts_pred - template[None], upper_map))
