"""SadTalker's pose path (part of the port of
`nerf3dtalker_tpu/models/audio2pose.py`): the Savitzky-Golay smoothing that
the reference applies to reference poses (s_test_audio2coeff.py). The pose
CVAE and its discriminator are not ported yet."""

from __future__ import annotations

import numpy as np


def savgol_smooth_pose(poses, window: int = 13, order: int = 2) -> np.ndarray:
    """[T, 6] poses smoothed over time: a window of at most `window` frames
    (and odd), unsmoothed when that leaves no more than `order` frames."""
    from scipy.signal import savgol_filter

    poses = np.asarray(poses)
    window = min(window, len(poses) if len(poses) % 2 else len(poses) - 1)
    if window <= order:
        return poses
    return savgol_filter(poses, window, order, axis=0)
