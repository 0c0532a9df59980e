"""Array-based training dataset (port of `nerf3dtalker_tpu/data/dataset.py`).

Every per-frame input of the reference's data loader
(XGaze_utils/data_loader_xgaze_new.py:845-1239) is precomputed offline into
arrays; training input is array slicing.

Schema per subject (numpy, frame-major):
  images     [T, H, W, 3] float32 in [0, 1]
  head_mask  [T, H, W, 1] float32
  mels       [T, 80, 16]            per-frame mel chunks
  audio_exp  [T, 64]                SadTalker exp of the lip-synced frame
  iden/text/illu [T, ...]           3DMM codes
  expr       [T, 79]
  Rmat [T, 3, 3], Tvec [T, 3], inv_inmat [T, 3, 3]
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

REQUIRED_KEYS = (
    "images", "head_mask", "mels", "audio_exp",
    "iden", "expr", "text", "illu", "Rmat", "Tvec", "inv_inmat",
)

# (train-batch key, dataset array key)
BATCH_FIELDS = (
    ("gt_rgb", "images"), ("head_mask", "head_mask"), ("mels", "mels"),
    ("audio_exp", "audio_exp"), ("iden", "iden"), ("expr", "expr"),
    ("text", "text"), ("illu", "illu"), ("Rmat", "Rmat"),
    ("Tvec", "Tvec"), ("inv_inmat", "inv_inmat"),
)
VGG_KEYS = tuple(f"vgg_f{i}" for i in range(4))


def to_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on `device`; VGG planes stay float16."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class FrameDataset:
    """In-memory per-frame dataset with batching and an optional copy
    resident on the device."""

    def __init__(self, arrays: Dict[str, np.ndarray], xy: np.ndarray):
        missing = [k for k in REQUIRED_KEYS if k not in arrays]
        if missing:
            raise ValueError(f"missing dataset keys: {missing}")
        T = arrays["images"].shape[0]
        for k, v in arrays.items():
            if v.shape[0] != T:
                raise ValueError(f"{k} has {v.shape[0]} frames, expected {T}")
        self.arrays = arrays
        self.xy = xy  # [1, N_r, 2]
        self.num_frames = T
        self._dev: Optional[Dict[str, torch.Tensor]] = None

    def __len__(self) -> int:
        return self.num_frames

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        b = {out: self.arrays[src][idx] for out, src in BATCH_FIELDS}
        for k in VGG_KEYS:
            if k in self.arrays:   # precomputed masked-GT VGG activations
                b[k] = self.arrays[k][idx]
        b["xy"] = np.tile(self.xy, (len(idx), 1, 1))
        return b

    @torch.no_grad()
    def precompute_gt_vgg(self, vgg, bg_value: float = 1.0,
                          compute_dtype: Optional[torch.dtype] = None, batch: int = 4,
                          store_dtype=np.float16) -> None:
        """The masked-GT VGG block activations of every frame, on the VGG's
        device, stored (float16 by default, ~12 MB a frame) as arrays
        vgg_f0..vgg_f3. They do not depend on parameters (the target branch
        of the perceptual loss, HeadNeRFLossUtils.py:148-153), so each step
        runs only the prediction branch."""
        from nerf3dtalker_tpu_torch.models.perceptual import vgg_features

        dev = next(vgg.parameters()).device
        outs = [[] for _ in VGG_KEYS]
        for s in range(0, self.num_frames, batch):
            gt = torch.as_tensor(self.arrays["images"][s:s + batch], device=dev)
            head = (torch.as_tensor(self.arrays["head_mask"][s:s + batch], device=dev)
                    >= 0.5).to(gt.dtype)
            masked = gt * head + bg_value * (1.0 - head)
            for i, f in enumerate(vgg_features(vgg, masked, compute_dtype=compute_dtype)):
                outs[i].append(f.cpu().numpy().astype(store_dtype))
        for k, o in zip(VGG_KEYS, outs):
            self.arrays[k] = np.concatenate(o, axis=0)
        self._dev = None

    def epoch(self, batch_size: int, rng: Optional[np.random.Generator] = None,
              drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.num_frames)
        if rng is not None:
            rng.shuffle(order)
        end = self.num_frames - (self.num_frames % batch_size) if drop_last else self.num_frames
        for i in range(0, end, batch_size):
            yield self.batch(order[i:i + batch_size])

    # ------------------------------------------------------- device cache

    def nbytes(self) -> int:
        return sum(int(np.asarray(v).nbytes) for v in self.arrays.values())

    def to_device(self, batch_size: int, device: Union[str, torch.device]) -> None:
        """Put every per-frame array (with the VGG planes) on the device
        once; `device_batch` then gathers batches there, so a step sends
        only frame indices."""
        self._dev = {k: torch.as_tensor(v, device=device) for k, v in self.arrays.items()}
        self._dev_xy = torch.as_tensor(np.tile(self.xy, (batch_size, 1, 1)), device=device)

    def device_batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """A batch gathered on the device (requires `to_device`)."""
        d = self._dev
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self._dev_xy.device)
        b = {out: d[src].index_select(0, i) for out, src in BATCH_FIELDS}
        for k in VGG_KEYS:
            if k in d:
                b[k] = d[k].index_select(0, i)
        b["xy"] = self._dev_xy[:len(idx)]
        return b


def synthetic_dataset(cfg, num_frames: int = 8, seed: int = 0) -> FrameDataset:
    """Random dataset at a NeRFConfig's scale, for tests and benchmarks:
    per-pixel i.i.d. noise, deliberately unlearnable (it exercises the
    machinery: step shapes, throughput, resume). The same arrays as the JAX
    package's `synthetic_dataset` for the same seed."""
    rng = np.random.default_rng(seed)
    xy, _ = ray_grid(cfg.featmap_size)
    cam = base_cam(cfg.featmap_size)
    T, S = num_frames, cfg.pred_img_size
    f32 = np.float32
    arrays = {
        "images": rng.uniform(0, 1, (T, S, S, 3)).astype(f32),
        "head_mask": (rng.uniform(0, 1, (T, S, S, 1)) > 0.4).astype(f32),
        "mels": rng.standard_normal((T, 80, 16)).astype(f32),
        "audio_exp": rng.standard_normal((T, 64)).astype(f32) * 0.1,
        "iden": rng.standard_normal((T, 100)).astype(f32) * 0.1,
        "expr": rng.standard_normal((T, 79)).astype(f32) * 0.1,
        "text": rng.standard_normal((T, 100)).astype(f32) * 0.1,
        "illu": rng.standard_normal((T, 27)).astype(f32) * 0.1,
        "Rmat": np.tile(cam.Rmat, (T, 1, 1)).astype(f32),
        "Tvec": np.tile(cam.Tvec.reshape(1, 3), (T, 1)).astype(f32),
        "inv_inmat": np.tile(cam.inv_inmat, (T, 1, 1)).astype(f32),
    }
    return FrameDataset(arrays, xy)
