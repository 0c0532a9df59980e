"""Video output and frame enhancers on the host, numpy and the ffmpeg CLI
(port of `nerf3dtalker_tpu/utils/video.py`: `write_video`, `write_png` and
the enhancer interface of the reference's s_utils/face_enhancer.py:26-123,
with the identity and unsharp enhancers; the GFPGAN enhancer is not ported
yet).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import warnings
from typing import Callable, Optional, Sequence

import numpy as np


def write_png(path: str, img01: np.ndarray) -> None:
    """Write a [H, W, 3] float image in [0, 1] (or a uint8 one) as a PNG;
    without PIL, the array goes to `<path>.npy` instead."""
    arr = np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", img01)
        return
    Image.fromarray(arr).save(path)


def write_video(frames: Sequence[np.ndarray], path: str, fps: int = 25,
                audio_path: Optional[str] = None) -> None:
    """Pipe raw frames ([H, W, 3] in [0, 1], or uint8) to ffmpeg as an
    H.264 video, with `audio_path` muxed in (videoio.py's
    save_video_with_watermark without the watermark). Without ffmpeg on the
    PATH the frames go to `<path minus extension>_frames/` as PNGs, the
    audio is copied beside them, and a warning says so."""
    h, w = frames[0].shape[:2]
    cmd = ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
           "-r", str(fps), "-i", "-"]
    if audio_path:
        cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
    cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", path]
    try:
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stderr=subprocess.DEVNULL)
    except FileNotFoundError:
        d = os.path.splitext(path)[0] + "_frames"
        os.makedirs(d, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(d, f"{i:05d}.png"),
                      f.astype(np.float32) / 255.0 if f.dtype == np.uint8 else f)
        msg = f"ffmpeg not found; wrote {len(frames)} PNGs to {d}"
        if audio_path:
            dst = os.path.join(d, os.path.basename(audio_path))
            try:
                shutil.copy(audio_path, dst)
                msg += f"; audio track not muxed, copied to {dst}"
            except OSError:
                msg += f"; audio track {audio_path} not muxed (copy failed)"
        warnings.warn(msg)
        return
    try:
        for f in frames:
            u8 = np.clip(f * 255 if f.dtype != np.uint8 else f, 0, 255).astype(np.uint8)
            proc.stdin.write(u8.tobytes())
    finally:
        proc.stdin.close()
        rc = proc.wait()
    if rc:
        raise RuntimeError(f"ffmpeg exited with {rc} writing {path}")


def identity_enhancer(frames: np.ndarray) -> np.ndarray:
    """The default enhancer: frames unchanged."""
    return frames


def unsharp_enhancer(frames: np.ndarray, amount: float = 0.5) -> np.ndarray:
    """Unsharp masking with a Gaussian of sigma 1 over each frame's rows and
    columns, clipped to [0, 1]."""
    from scipy.ndimage import gaussian_filter

    out = []
    for f in frames:
        blur = gaussian_filter(f, sigma=(1, 1, 0))
        out.append(np.clip(f + amount * (f - blur), 0, 1))
    return np.stack(out)


def enhance_frames(frames: np.ndarray,
                   enhancer: Callable[[np.ndarray], np.ndarray] = identity_enhancer
                   ) -> np.ndarray:
    """Frames [T, H, W, 3] through an enhancer (face_enhancer.py's
    interface)."""
    return enhancer(frames)
