"""Text-to-speech input of the drivers (copy of `nerf3dtalker_tpu/data/tts.py`;
reference s_utils/text2speech.py:1-20).

The reference's `TTSTalker` runs the coqui `TTS` package, which is not a
dependency here: `TTSTalker` uses it when it is importable and raises
otherwise. `synthesize_placeholder` writes a deterministic speech-like wav
(one formant burst a word), so that the audio path (mel chunks ->
audio2exp -> render) runs without the external model; it writes the JAX
function's bytes.
"""

from __future__ import annotations

import tempfile
import wave
import zlib
from typing import Optional

import numpy as np

from nerf3dtalker_tpu_torch.config import AudioConfig


class TTSTalker:
    """Text -> wav file path (reference TTSTalker.test)."""

    def __init__(self) -> None:
        try:
            from TTS.api import TTS  # optional external dependency
        except ImportError as e:
            raise ImportError(
                "coqui-tts is not installed; use synthesize_placeholder() "
                "for pipeline tests or install TTS for real synthesis"
            ) from e
        self._tts = TTS(TTS().list_models()[0])

    def synthesize(self, text: str, language: str = "en") -> str:
        tmp = tempfile.NamedTemporaryFile(delete=False, suffix=".wav")
        self._tts.tts_to_file(text, speaker=self._tts.speakers[0], language=language,
                              file_path=tmp.name)
        return tmp.name


def synthesize_placeholder(text: str, path: Optional[str] = None,
                           sample_rate: Optional[int] = None,
                           words_per_second: float = 2.5) -> str:
    """Deterministic speech-like wav: one vowel-like formant burst a word,
    its pitch and formants hashed from the word, so the same text gives the
    same audio. Returns the wav path (16 kHz mono s16 by default; a
    temporary file without `path`)."""
    sr = sample_rate or AudioConfig().sample_rate
    words = text.split() or ["."]
    dur = max(len(words) / words_per_second, 0.4)
    n = int(dur * sr)
    t = np.arange(n) / sr
    sig = np.zeros(n, np.float64)
    seg = n // len(words)
    for i, wd in enumerate(words):
        h = zlib.crc32(wd.encode()) % 10_000        # stable across processes
        f0 = 90.0 + (h % 80)                        # pitch
        f1, f2 = 350.0 + (h % 400), 1200.0 + (h % 1200)   # formants
        sl = slice(i * seg, (i + 1) * seg if i + 1 < len(words) else n)
        tt = t[sl]
        env = np.sin(np.pi * np.linspace(0, 1, tt.size)) ** 2
        sig[sl] = env * (0.5 * np.sin(2 * np.pi * f0 * tt) + 0.3 * np.sin(2 * np.pi * f1 * tt)
                         + 0.2 * np.sin(2 * np.pi * f2 * tt))
    data = (np.clip(sig * 0.6, -1, 1) * 32767).astype(np.int16)
    if path is None:
        with tempfile.NamedTemporaryFile(delete=False, suffix=".wav") as tmp:
            path = tmp.name
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(data.tobytes())
    return path
