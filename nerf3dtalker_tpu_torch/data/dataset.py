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

    def device_batch(self, idx: Union[np.ndarray, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A batch gathered on the device (requires `to_device`). `idx` may
        be an int64 tensor on that device: the gather then copies nothing
        from the host (a CUDA graph's static index buffer)."""
        d = self._dev
        i = (idx if isinstance(idx, torch.Tensor)
             else torch.as_tensor(np.asarray(idx, np.int64), device=self._dev_xy.device))
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


def _soft_ellipse(xx, yy, cx, cy, rx, ry, edge):
    """Anti-aliased inside-ness of an axis-aligned ellipse in [0,1]."""
    d = np.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
    # smoothstep from 1 (inside) to 0 (outside) across ~edge in d units
    t = np.clip((d - 1.0) / edge + 0.5, 0.0, 1.0)
    return (1.0 - t * t * (3.0 - 2.0 * t)).astype(np.float32)


def talking_signals(num_frames: int, t0: int = 0):
    """The two smooth, independent per-frame drivers of the synthetic
    talking head: ``a`` (mouth openness, [0,1]) and ``b`` (brow raise,
    [-1,1]). Deterministic functions of the absolute frame index, so
    train/val splits drawn from different index ranges share the same
    underlying 'performance'."""
    t = np.arange(t0, t0 + num_frames, dtype=np.float64)
    a = 0.5 + 0.5 * np.sin(2.0 * np.pi * t / 14.0 + 0.7)
    b = np.sin(2.0 * np.pi * t / 9.0 + 1.9)
    return a.astype(np.float32), b.astype(np.float32)


def render_talking_frame(S: int, a: float, b: float):
    """One frame of the procedural talking head: a smooth face pattern on a
    white background whose mouth aperture is ``a`` and brow height is
    ``b``. Returns (image [S,S,3], head_mask [S,S,1]); every shape is
    analytic and anti-aliased (the kind of smooth conditional image set the
    reference fits per subject, talker_trainer.py:704-714)."""
    ys, xs = np.mgrid[0:S, 0:S].astype(np.float32)
    xx, yy = (xs + 0.5) / S, (ys + 0.5) / S
    e = 2.0 / S  # AA edge width in normalized ellipse-distance units
    img = np.ones((S, S, 3), np.float32)

    # head: shaded ellipse
    head = _soft_ellipse(xx, yy, 0.5, 0.52, 0.30, 0.38, e)
    r2 = ((xx - 0.5) / 0.30) ** 2 + ((yy - 0.52) / 0.38) ** 2
    shade = (1.0 - 0.25 * np.clip(r2, 0, 1)).astype(np.float32)
    skin = np.stack([0.85 * shade, 0.68 * shade, 0.58 * shade], -1)
    img = img * (1 - head[..., None]) + skin * head[..., None]

    def paint(alpha, color):
        nonlocal img
        img = img * (1 - alpha[..., None]) + np.asarray(color, np.float32) * alpha[..., None]

    # eyes (static)
    for sx in (-1.0, 1.0):
        paint(_soft_ellipse(xx, yy, 0.5 + 0.12 * sx, 0.42, 0.042, 0.030, e), (0.13, 0.18, 0.40))
    # brows: vertical position rides only on b (the audio_exp channel)
    by = 0.345 - 0.040 * float(b)
    for sx in (-1.0, 1.0):
        paint(_soft_ellipse(xx, yy, 0.5 + 0.12 * sx, by, 0.062, 0.016, e), (0.22, 0.13, 0.08))
    # nose (static)
    paint(_soft_ellipse(xx, yy, 0.5, 0.55, 0.030, 0.055, e), (0.75, 0.55, 0.47))
    # mouth: vertical aperture rides only on a (the mel channel)
    ry = 0.015 + 0.065 * float(a)
    paint(_soft_ellipse(xx, yy, 0.5, 0.70, 0.095, ry, e), (0.38, 0.10, 0.13))
    return img, head[..., None].astype(np.float32)


def talking_mels(a: np.ndarray, seed: int = 7) -> np.ndarray:
    """Deterministic mel-like chunks [T, 80, 16] whose band structure
    encodes mouth openness ``a``: energy moves from a low band (closed) to a
    high band (open) over a fixed smooth background spectrum. Audio2Style
    must decode ``a`` from these; nothing else in the batch carries it."""
    rng = np.random.default_rng(seed)
    mel_axis = np.arange(80, dtype=np.float32)
    low = np.exp(-0.5 * ((mel_axis - 18.0) / 6.0) ** 2)
    high = np.exp(-0.5 * ((mel_axis - 52.0) / 7.0) ** 2)
    base = rng.standard_normal((80,)).astype(np.float32)
    base = np.convolve(base, np.ones(9) / 9.0, mode="same")  # smooth
    tramp = np.linspace(0.8, 1.2, 16, dtype=np.float32)[None, :]
    out = []
    for av in np.asarray(a, np.float32):
        spec = 0.25 * base + (1.0 - av) * low + av * high   # [80]
        out.append(spec[:, None] * tramp)                    # [80, 16]
    return np.stack(out).astype(np.float32)


def coherent_subject(cfg, num_frames: int = 40, seed: int = 0, t0: int = 0) -> FrameDataset:
    """A learnable synthetic subject: smooth, frame-consistent face images
    whose per-frame variation rides only on the audio inputs, the mouth
    aperture on the mel chunks (through Audio2Style) and the brow height on
    ``audio_exp`` (the slot that overwrites expr[:64], talker_trainer.py:853).
    Every 3DMM code and the camera are constant, so shuffling the mels or
    zeroing audio_exp removes the only signal that explains the moving
    regions. ``t0`` offsets the frame indices, so a val split holds unseen
    (mouth, brow) pairs of the same performance. The same arrays as the JAX
    package's `coherent_subject` for the same arguments."""
    rng = np.random.default_rng(seed + 101)
    xy, _ = ray_grid(cfg.featmap_size)
    cam = base_cam(cfg.featmap_size)
    T, S = num_frames, cfg.pred_img_size
    f32 = np.float32
    a, b = talking_signals(T, t0=t0)
    imgs = np.empty((T, S, S, 3), f32)
    masks = np.empty((T, S, S, 1), f32)
    for i in range(T):
        imgs[i], masks[i] = render_talking_frame(S, a[i], b[i])
    # audio_exp: the brow signal along a fixed direction + a constant offset
    u = rng.standard_normal(64).astype(f32)
    u /= np.linalg.norm(u)
    w = rng.standard_normal(64).astype(f32) * 0.05
    audio_exp = b[:, None] * u[None, :] * 0.5 + w[None, :]

    def const(d, s=0.1):
        return np.tile((rng.standard_normal(d) * s).astype(f32)[None], (T, 1))

    arrays = {
        "images": imgs,
        "head_mask": masks,
        "mels": talking_mels(a),
        "audio_exp": audio_exp.astype(f32),
        "iden": const(100),
        "expr": const(79),
        "text": const(100),
        "illu": const(27),
        "Rmat": np.tile(cam.Rmat, (T, 1, 1)).astype(f32),
        "Tvec": np.tile(cam.Tvec.reshape(1, 3), (T, 1)).astype(f32),
        "inv_inmat": np.tile(cam.inv_inmat, (T, 1, 1)).astype(f32),
    }
    return FrameDataset(arrays, xy)
