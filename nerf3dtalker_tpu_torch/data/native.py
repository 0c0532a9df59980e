"""ctypes binding of the native CPU runtime, `native/nerf3dt_native.cpp`
(port of `nerf3dtalker_tpu/data/native.py`; the C++ source is shared):

  * `melspectrogram_native` — the C++ mel front end (`data/mel.py`'s
    contract);
  * `NativePrefetcher` — a C++ thread that shuffles, gathers and queues
    batches of an [N, D] f32 matrix;
  * `FramePrefetcher` — a FrameDataset's training batches through it, as
    tensors on the trainer's device.

The library is compiled at first use with `g++ -O3 -shared -fPIC
-std=c++17 ... -lpthread` into `build/native/libnerf3dt_native-<hash>.so`
at the checkout's root (the hash of the source and the flags names it).
A failed build or a library that does not load raises; there is no Python
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from nerf3dtalker_tpu_torch.data.dataset import BATCH_FIELDS, VGG_KEYS

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "nerf3dt_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libnerf3dt_native-{digest}.so"


def build() -> Path:
    """Compile the runtime unless it is built already; its path. Each
    process that builds writes a file of its own and renames it into
    place, so processes that build at once never load a half-written
    library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the native runtime failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building the native runtime failed: {' '.join(cmd)}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The runtime, built and bound at the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.n3d_mel_frames.restype = ctypes.c_int
        lib.n3d_mel_frames.argtypes = [ctypes.c_int] * 3
        lib.n3d_melspectrogram.restype = ctypes.c_int
        lib.n3d_melspectrogram.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ]
        lib.n3d_prefetcher_create.restype = ctypes.c_void_p
        lib.n3d_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64,
        ]
        lib.n3d_prefetcher_next.restype = None
        lib.n3d_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.n3d_prefetcher_destroy.restype = None
        lib.n3d_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def melspectrogram_native(
    wav: np.ndarray,
    sr: int = 16000, n_fft: int = 800, hop: int = 200, win: int = 800,
    n_mels: int = 80, fmin: float = 55.0, fmax: float = 7600.0,
    preemph: float = 0.97, ref_level_db: float = 20.0,
    min_level_db: float = -100.0, max_abs_value: float = 4.0,
) -> np.ndarray:
    """The C++ mel pipeline: [n_mels, frames] f32, `data.mel.melspectrogram`'s
    contract."""
    lib = load()
    wav = np.ascontiguousarray(wav, np.float32)
    frames = lib.n3d_mel_frames(len(wav), n_fft, hop)
    out = np.empty((n_mels, frames), np.float32)
    got = lib.n3d_melspectrogram(_fptr(wav), len(wav), _fptr(out), sr, n_fft, hop, win, n_mels,
                                 fmin, fmax, preemph, ref_level_db, min_level_db, max_abs_value)
    if got != frames:
        raise RuntimeError(f"n3d_melspectrogram wrote {got} frames, expected {frames}")
    return out


class NativePrefetcher:
    """Shuffled batches of an in-memory [N, D] f32 matrix, gathered and
    queued by a C++ thread (the reference's num_workers DataLoader
    processes). Each pass over the rows is shuffled by std::mt19937_64 of
    `seed`, `seed + 1`, ...; a batch can span two passes."""

    def __init__(self, data: np.ndarray, batch: int, seed: int = 0):
        self._h = None
        self._lib = load()
        self._data = np.ascontiguousarray(data, np.float32)   # the thread reads it
        n, d = self._data.shape
        self.batch = batch
        self.item_size = d
        self._h = self._lib.n3d_prefetcher_create(_fptr(self._data), n, d, batch, seed)

    def next(self) -> np.ndarray:
        """The next [batch, D] rows (blocks until the thread has them)."""
        if not self._h:
            raise RuntimeError("the prefetcher is closed")
        out = np.empty((self.batch, self.item_size), np.float32)
        self._lib.n3d_prefetcher_next(self._h, _fptr(out))
        return out

    def close(self) -> None:
        """Stop and join the thread."""
        if self._h:
            self._lib.n3d_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class FramePrefetcher:
    """A FrameDataset's training batches through `NativePrefetcher` (the
    reference's loader workers, data_loader_xgaze_new.py:780-808).

    Every per-frame field (`BATCH_FIELDS`, and the VGG planes where the
    dataset has them) and the frame's index are packed once into one flat
    [T, D] f32 matrix; each batch is split back into the train-step batch
    dict, each field in its dataset dtype (f32 holds the float16 VGG planes
    exactly), as tensors on `device`, with the ray grid tiled once.
    `last_indices` are the frames of the batch `next` returned last."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 device: Union[str, torch.device] = "cpu"):
        T = dataset.num_frames
        self.device = torch.device(device)
        self._fields = list(BATCH_FIELDS) + [(k, k) for k in VGG_KEYS if k in dataset.arrays]
        self._shapes, self._dtypes, cols = {}, {}, []
        for out_key, key in self._fields:
            a = np.asarray(dataset.arrays[key])
            self._shapes[out_key], self._dtypes[out_key] = a.shape[1:], a.dtype
            cols.append(a.reshape(T, -1).astype(np.float32))
        cols.append(np.arange(T, dtype=np.float32)[:, None])   # exact below 2^24 frames
        self._pf = NativePrefetcher(np.concatenate(cols, axis=1), batch_size, seed)
        self._xy = torch.as_tensor(np.tile(dataset.xy, (batch_size, 1, 1)), device=self.device)
        self.steps_per_epoch = max(1, T // batch_size)
        self.last_indices: Optional[np.ndarray] = None

    def next(self) -> Dict[str, torch.Tensor]:
        rows = self._pf.next()
        out, o = {}, 0
        for out_key, _ in self._fields:
            shp = self._shapes[out_key]
            n = int(np.prod(shp))
            a = rows[:, o:o + n].reshape((rows.shape[0],) + shp).astype(self._dtypes[out_key])
            out[out_key] = torch.as_tensor(a, device=self.device)
            o += n
        self.last_indices = rows[:, o].astype(np.int64)
        out["xy"] = self._xy
        return out

    def close(self) -> None:
        self._pf.close()
