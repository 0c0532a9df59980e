"""Small model-side helpers (port of the part of
`nerf3dtalker_tpu/models/misc.py` that the trainer uses):
`draw_side_by_side`, the GT|render comparison strips of the validation
dumps (talker_trainer.py:1203-1216 temp_image, tool_funcs.draw_res_img)."""

from __future__ import annotations

import numpy as np


def draw_side_by_side(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """[H,W,3] pair in [0, 1] -> [H, 2W, 3] uint8 comparison strip."""
    def u8(x):
        return np.clip(np.asarray(x) * 255, 0, 255).astype(np.uint8)

    return np.concatenate([u8(gt), u8(pred)], axis=1)
