"""Audio to per-frame coefficients, SadTalker's Audio2Coeff (port of
`nerf3dtalker_tpu/models/audio2coeff.py`; reference
s_test_audio2coeff.py:25-130): the netG expression regressor loaded from
a SadTalker safetensors checkpoint (the `audio2exp` tensors), per-frame
expression prediction, and Savitzky-Golay smoothing of the reference
poses. The pose CVAE is bypassed at inference, as in the reference
(:36-54) and in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from nerf3dtalker_tpu_torch.models.audio import SimpleWrapperV2, audio2exp_sequence
from nerf3dtalker_tpu_torch.models.audio2pose import savgol_smooth_pose
from nerf3dtalker_tpu_torch.utils.device import uninitialized


class Audio2Coeff:
    def __init__(self, netg: Optional[SimpleWrapperV2] = None):
        """`netg` None: the expression is zero (the JAX class's smoke mode)."""
        self.netg = netg

    @classmethod
    def from_safetensors(cls, path: str,
                         device: Optional[Union[str, torch.device]] = None) -> "Audio2Coeff":
        """netG on `device` (default `cuda`) from the `audio2exp.*` tensors of
        a SadTalker safetensors file, the `audio2exp_model.netG.` or `netG.`
        wrapper prefix stripped (s_test_audio2coeff.py:63-65)."""
        from nerf3dtalker_tpu_torch.data.ingest import load_safetensors_prefix
        from nerf3dtalker_tpu_torch.utils.bridge import load_into
        from nerf3dtalker_tpu_torch.utils.convert import convert_simple_wrapper_v2

        sd = load_safetensors_prefix(path, "audio2exp")
        if not sd:
            raise ValueError(f"no 'audio2exp.*' tensors found in {path}")
        inner = {}
        for k, v in sd.items():
            for pre in ("audio2exp_model.netG.", "netG.", ""):
                if k.startswith(pre):
                    inner[k[len(pre):]] = v
                    break
        netg = uninitialized(lambda d: SimpleWrapperV2(device=d), device)
        return cls(load_into(netg, convert_simple_wrapper_v2(inner)))

    @torch.no_grad()
    def generate(self, mels: np.ndarray, ref_exp64: np.ndarray, ratios: np.ndarray,
                 ref_pose: Optional[np.ndarray] = None,
                 smooth_pose: bool = True) -> Dict[str, np.ndarray]:
        """mels [T, 80, 16], ref_exp64 [64], ratios [T] (or [T, 1]) ->
        {'exp': [T, 64]} and, with `ref_pose` [T, 6], 'pose' (smoothed)."""
        if self.netg is None:
            exp = np.zeros((len(mels), 64), np.float32)
        else:
            dev = next(self.netg.parameters()).device
            t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
            exp = audio2exp_sequence(self.netg, t(mels), t(ref_exp64),
                                     t(ratios).reshape(-1)).cpu().numpy()
        out = {"exp": exp}
        if ref_pose is not None:
            pose = np.asarray(ref_pose, np.float32)
            out["pose"] = savgol_smooth_pose(pose) if smooth_pose else pose
        return out
