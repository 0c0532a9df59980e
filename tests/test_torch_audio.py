"""Port parity of the audio path: the copied mel pipeline against
`nerf3dtalker_tpu/data/mel.py` (same numpy code, so exact to 1e-6), and
`Audio2Style` (params bridged from the JAX init) against the JAX fused
BiLSTM at T=5, f32 on the CPU, atol 1e-5 (the LSTM sums over 1280 inputs
in another order than XLA)."""

import wave

import jax.numpy as jnp
import numpy as np
import torch
from _jax_reference import audio2style as jax_audio2style

from nerf3dtalker_tpu.data import mel as jmel
from nerf3dtalker_tpu_torch.data import mel
from nerf3dtalker_tpu_torch.models.audio import Audio2Style
from nerf3dtalker_tpu_torch.utils import bridge


def test_mel_copy_matches_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    pcm = np.clip(rng.standard_normal(2 * 8000 + 50) * 0.2, -1, 1)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes((pcm * 32767).astype(np.int16).tobytes())
    wav, sr = mel.read_wav_mono(path)
    jwav, jsr = jmel.read_wav_mono(path)
    np.testing.assert_array_equal(wav, jwav)
    assert sr == jsr == 16000
    np.testing.assert_allclose(mel.per_frame_mel_chunks(wav, sr),
                               jmel.per_frame_mel_chunks(jwav, jsr), atol=1e-6)


def test_audio2style_matches_jax():
    mels = np.random.default_rng(1).standard_normal((5, 80, 16)).astype(np.float32)
    _, params, japply = jax_audio2style()
    ref = np.asarray(japply(params, jnp.asarray(mels)))
    tmod = Audio2Style(device="cpu")
    bridge.load_into(tmod, bridge.audio2style_state_dict(params))
    tmod.eval()
    with torch.no_grad():
        out = tmod(torch.from_numpy(mels)).numpy()
    assert out.shape == (5, 64)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
