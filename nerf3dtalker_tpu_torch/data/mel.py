"""Mel-spectrogram pipeline, numpy/scipy only (copy of
`nerf3dtalker_tpu/data/mel.py`: `read_wav_mono`, `per_frame_mel_chunks`,
`blink_ratio_sequence` and their helpers).

Reference s_utils/audio.py:9-124 with hparams.py:15-60: 16 kHz, n_fft 800,
hop 200, win 800, 80 Slaney mels in [55, 7600] Hz, preemphasis 0.97,
dB-normalized to [-4, 4]; per-frame 16-step chunks at 25 fps
(XGaze_utils/data_loader_xgaze_new.py:614-682).
"""

from __future__ import annotations

import wave

import numpy as np
from scipy import signal as sps


def _hz_to_mel_slaney(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_step = np.log(6.4) / 27.0
    above = f >= 1000.0
    return np.where(above, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step, mel)


def _mel_to_hz_slaney(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_step = np.log(6.4) / 27.0
    above = m >= 15.0
    return np.where(above, 1000.0 * np.exp(log_step * (m - 15.0)), f)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] Slaney-normalized triangular filterbank."""
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def stft(y: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """Centered STFT as librosa.stft: hann(win), reflect padding of
    n_fft//2; returns complex [1+n_fft//2, frames]."""
    window = sps.get_window("hann", win, fftbins=True)
    if win < n_fft:
        pad = (n_fft - win) // 2
        window = np.pad(window, (pad, n_fft - win - pad))
    y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * window
    return np.fft.rfft(frames, n=n_fft, axis=-1).T


def preemphasis(wav: np.ndarray, k: float = 0.97) -> np.ndarray:
    return sps.lfilter([1, -k], [1], wav)


def melspectrogram(
    wav: np.ndarray,
    sr: int = 16000,
    n_fft: int = 800,
    hop: int = 200,
    win: int = 800,
    n_mels: int = 80,
    fmin: float = 55.0,
    fmax: float = 7600.0,
    preemph: float = 0.97,
    ref_level_db: float = 20.0,
    min_level_db: float = -100.0,
    max_abs_value: float = 4.0,
) -> np.ndarray:
    """wav -> normalized mel [80, frames]."""
    D = stft(preemphasis(wav, preemph), n_fft, hop, win)
    basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    S = basis @ np.abs(D)
    min_level = np.exp(min_level_db / 20 * np.log(10))
    S = 20 * np.log10(np.maximum(min_level, S)) - ref_level_db
    S = np.clip(
        (2 * max_abs_value) * ((S - min_level_db) / (-min_level_db)) - max_abs_value,
        -max_abs_value,
        max_abs_value,
    )
    return S.astype(np.float32)


def parse_audio_length(audio_len: int, sr: int, fps: int):
    """(cropped length, number of video frames)."""
    num_frames = int(audio_len / sr * fps)
    audio_len = int(num_frames / fps * sr)
    return audio_len, num_frames


def crop_pad_audio(wav: np.ndarray, length: int) -> np.ndarray:
    if len(wav) > length:
        return wav[:length]
    return np.pad(wav, (0, length - len(wav)))


def per_frame_mel_chunks(
    wav: np.ndarray, sr: int = 16000, fps: int = 25, mel_step: int = 16
) -> np.ndarray:
    """Full wav -> per-video-frame mel chunks [T, 80, 16]; chunk i starts
    at mel index 80*(i-2)/fps, clamped to the valid range."""
    wav_length, num_frames = parse_audio_length(len(wav), sr, fps)
    wav = crop_pad_audio(wav, wav_length)
    mel = melspectrogram(wav).T
    chunks = []
    for i in range(num_frames):
        start = int(80.0 * ((i - 2) / float(fps)))
        seq = np.clip(np.arange(start, start + mel_step), 0, mel.shape[0] - 1)
        chunks.append(mel[seq].T)
    return np.stack(chunks).astype(np.float32)


def blink_ratio_sequence(num_frames: int, rng: np.random.Generator) -> np.ndarray:
    """Random eye-blink ratio curve [T, 1] from `rng`, the JAX function's
    draws (data_loader_xgaze_new.py:600-612): none under 21 frames; else
    5-frame blinks (0.5, 0.9, 1, 0.9, 0.5) at random gaps."""
    ratio = np.zeros((num_frames, 1), np.float32)
    if num_frames <= 20:
        return ratio
    frame_id = 0
    while frame_id < num_frames:
        start = int(rng.integers(min(10, num_frames), min(num_frames // 2, 70)))
        if frame_id + start + 5 <= num_frames - 1:
            ratio[frame_id + start : frame_id + start + 5, 0] = [0.5, 0.9, 1.0, 0.9, 0.5]
            frame_id = frame_id + start + 5
        else:
            break
    return ratio


def read_wav_mono(path: str, target_sr: int = 16000):
    """Read a wav file to mono float32 in [-1, 1] at `target_sr`
    (channels averaged, 8/16/32-bit PCM scaled, off-rate files linearly
    resampled). Returns (wav, target_sr)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        pcm = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        pcm = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    if nch > 1:
        pcm = pcm.reshape(-1, nch).mean(axis=1)
    if sr != target_sr:
        n_out = int(round(len(pcm) * target_sr / sr))
        pos = np.linspace(0.0, len(pcm) - 1.0, n_out)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, len(pcm) - 1)
        w = (pos - lo).astype(np.float32)
        pcm = pcm[lo] * (1.0 - w) + pcm[hi] * w
    return pcm.astype(np.float32), target_sr
