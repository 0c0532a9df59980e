"""Face alignment / cropping preprocessing (numpy, offline; a copy of
`nerf3dtalker_tpu/data/align.py`).

Equivalents of reference `s_face3d/util/preprocess.py` (umeyama similarity
alignment to the 5-point template + `align_img`) and `s_utils/croper.py:19-180`
(FFHQ-style quad crop from 68 landmarks). These run in the offline dataset
preparation stage (SURVEY.md §7: 'Precompute, don't inline').
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# standard 5-point template (preprocess.py POS/ffhq template, 112x112 space)
TEMPLATE_5PT = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    np.float32,
)


def umeyama(src: np.ndarray, dst: np.ndarray, estimate_scale: bool = True) -> np.ndarray:
    """Least-squares similarity transform (Umeyama 1991; the
    `skimage.transform.SimilarityTransform` the reference preprocess uses).
    Returns 3x3 homogeneous matrix mapping src -> dst."""
    n, m = src.shape
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_d = src - src_mean
    dst_d = dst - dst_mean
    A = dst_d.T @ src_d / n
    d = np.ones(m)
    if np.linalg.det(A) < 0:
        d[-1] = -1
    T = np.eye(m + 1)
    U, S, Vt = np.linalg.svd(A)
    rank = np.linalg.matrix_rank(A)
    if rank == 0:
        return T * np.nan
    elif rank == m - 1:
        if np.linalg.det(U) * np.linalg.det(Vt) > 0:
            T[:m, :m] = U @ Vt
        else:
            s = d[m - 1]
            d[m - 1] = -1
            T[:m, :m] = U @ np.diag(d) @ Vt
            d[m - 1] = s
    else:
        T[:m, :m] = U @ np.diag(d) @ Vt
    scale = 1.0
    if estimate_scale:
        scale = 1.0 / src_d.var(0).sum() * (S @ d)
    T[:m, m] = dst_mean - scale * (T[:m, :m] @ src_mean)
    T[:m, :m] *= scale
    return T


def landmarks68_to_5(lm68: np.ndarray) -> np.ndarray:
    """68 -> 5 points (eye centers, nose tip, mouth corners;
    extract_5p in preprocess.py)."""
    lm_idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    five = np.stack(
        [
            lm68[lm_idx[1:3]].mean(0),   # left eye
            lm68[lm_idx[3:5]].mean(0),   # right eye
            lm68[lm_idx[0]],             # nose
            lm68[lm_idx[5]],             # left mouth
            lm68[lm_idx[6]],             # right mouth
        ]
    )
    return five.astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, out_hw: Tuple[int, int],
                fill: float = 0.0) -> np.ndarray:
    """Inverse-mapped bilinear affine warp (replaces cv2.warpAffine for the
    offline align path). M maps src -> dst (3x3 homogeneous)."""
    H, W = out_hw
    Minv = np.linalg.inv(M)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    coords = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Minv.T
    sx, sy = coords[..., 0], coords[..., 1]
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    wx = sx - x0
    wy = sy - y0
    valid = (x0 >= 0) & (x0 < img.shape[1] - 1) & (y0 >= 0) & (y0 < img.shape[0] - 1)
    x0c = np.clip(x0, 0, img.shape[1] - 2)
    y0c = np.clip(y0, 0, img.shape[0] - 2)

    def g(dy, dx):
        return img[y0c + dy, x0c + dx]

    wxe = wx[..., None] if img.ndim == 3 else wx
    wye = wy[..., None] if img.ndim == 3 else wy
    out = (
        g(0, 0) * (1 - wxe) * (1 - wye)
        + g(0, 1) * wxe * (1 - wye)
        + g(1, 0) * (1 - wxe) * wye
        + g(1, 1) * wxe * wye
    )
    mask = valid[..., None] if img.ndim == 3 else valid
    return np.where(mask, out, fill).astype(img.dtype)


def align_face(
    img: np.ndarray, lm68: np.ndarray, out_size: int = 112
) -> Tuple[np.ndarray, np.ndarray]:
    """Align a face image to the 5-point template.

    Returns (aligned image [out, out, C], the 3x3 transform used).
    """
    five = landmarks68_to_5(lm68)
    tmpl = TEMPLATE_5PT * (out_size / 112.0)
    M = umeyama(five, tmpl)
    return warp_affine(img, M, (out_size, out_size)), M


def ffhq_quad_crop(lm68: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """FFHQ-style crop quad from 68 landmarks (croper.py:19-90): oriented
    rectangle from eye/mouth geometry. Returns [4, 2] quad corners."""
    lm_eye_left = lm68[36:42]
    lm_eye_right = lm68[42:48]
    lm_mouth_outer = lm68[48:60]

    eye_left = lm_eye_left.mean(0)
    eye_right = lm_eye_right.mean(0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm_mouth_outer[0] + lm_mouth_outer[6]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8) * scale
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    return np.stack([c - x - y, c - x + y, c + x + y, c + x - y]).astype(np.float32)
