"""The serving slice as a whole against the JAX package, f32 on the CPU:
`styles_from_mels` + `animate_sequence` at T=5 with chunk 2 (so the last
chunk is padded), and the `cli animate` entry point with a `--params` npz
written from the JAX params and a `--latents` npz read by both CLIs' rule. Params are the JAX init's, carried over by
`utils/bridge.py`. Tolerances: styles atol 1e-5 (LSTM sums in another
order), frames atol 1e-4 (MLP and decoder sums in another order)."""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import audio2style as jax_audio2style
from _jax_reference import headnerf as jax_headnerf

from nerf3dtalker_tpu.data.mel import per_frame_mel_chunks as jmels
from nerf3dtalker_tpu.train import animate as janimate
from nerf3dtalker_tpu.utils.checkpoints import save_pytree_npz
from nerf3dtalker_tpu_torch import cli
from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.models.audio import Audio2Style
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.train import animate
from nerf3dtalker_tpu_torch.utils import bridge
from nerf3dtalker_tpu_torch.utils.camera import base_cam

TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=16,
            mlp_hidden=64)


def _jax_models(cfg_kw, seed=0):
    model, nerf, cam = jax_headnerf(seed, **cfg_kw)
    a2s, audio, a2s_apply = jax_audio2style()
    return model, nerf, a2s_apply, audio, cam


def _port_models(cfg_kw, nerf, audio):
    model = HeadNeRF(NeRFConfig(**cfg_kw), device="cpu")
    bridge.load_into(model, bridge.headnerf_state_dict(nerf))
    a2s = Audio2Style(device="cpu")
    bridge.load_into(a2s, bridge.audio2style_state_dict(audio))
    return model.eval(), a2s.eval()


def test_styles_and_animate_sequence_match_jax():
    rng = np.random.default_rng(0)
    mels = rng.standard_normal((5, 80, 16)).astype(np.float32)
    shape = (rng.standard_normal((1, 179)) * 0.3).astype(np.float32)
    appea = (rng.standard_normal((1, 127)) * 0.3).astype(np.float32)
    jmodel, nerf, ja2s, audio, cam = _jax_models(TINY)
    jstyles = janimate.styles_from_mels(ja2s, audio, mels)
    jframes = janimate.animate_sequence(jmodel, nerf, shape, appea, jstyles, cam, chunk=2)

    model, a2s = _port_models(TINY, nerf, audio)
    styles = animate.styles_from_mels(a2s, mels)
    np.testing.assert_allclose(styles, jstyles, rtol=1e-5, atol=1e-5)
    frames = animate.animate_sequence(model, shape, appea, styles, cam, chunk=2)
    assert frames.shape == (5, 32, 32, 3) and frames.dtype == np.float32
    np.testing.assert_allclose(frames, jframes, rtol=1e-4, atol=1e-4)


@pytest.fixture
def wav_path(tmp_path):
    sr = 16000
    n = 3 * sr // 25 + 100                      # 3 frames at 25 fps
    t = np.arange(n) / sr
    pcm = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    path = str(tmp_path / "speech.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((pcm * 32767).astype(np.int16).tobytes())
    return path


def test_cli_animate_with_bridged_params_matches_jax(tmp_path, wav_path):
    from nerf3dtalker_tpu.cli import _codes_from_latents
    from nerf3dtalker_tpu.data.mel import read_wav_mono

    rng = np.random.default_rng(4)
    latents = str(tmp_path / "fitted.npz")
    np.savez(latents, **{k: (rng.standard_normal((1, n)) * 0.3).astype(np.float32)
                         for k, n in (("iden", 100), ("expr", 79), ("text", 100),
                                      ("illu", 27), ("expr_offset", 79))})
    shape, appea, _ = _codes_from_latents(latents)
    cfg_kw = dict(featmap_size=8, pred_img_size=32)
    jmodel, nerf, ja2s, audio, cam = _jax_models(cfg_kw, seed=3)
    mels = jmels(*read_wav_mono(wav_path))
    jstyles = janimate.styles_from_mels(ja2s, audio, mels)
    jframes = janimate.animate_sequence(jmodel, nerf, shape, appea, jstyles, cam, chunk=2)
    params = str(tmp_path / "params.npz")
    save_pytree_npz(params, {"nerf": jax.tree_util.tree_map(np.asarray, nerf),
                             "audio": jax.tree_util.tree_map(np.asarray, audio)})
    out = str(tmp_path / "frames.npy")
    rec = cli.main(["animate", "--wav", wav_path, "--featmap-size", "8", "--img-size", "32",
                    "--chunk", "2", "--params", params, "--latents", latents, "--device", "cpu",
                    "--out", out])
    assert rec["frames"] == 3 and rec["size"] == [32, 32]
    np.testing.assert_allclose(np.load(out), jframes, rtol=1e-4, atol=1e-4)


def test_cli_animate_rejects_params_of_another_layout(tmp_path, wav_path):
    """Only the `nerf/...` + `audio/...` layout of `save_pytree_npz` loads;
    a bare HeadNeRF tree raises."""
    params = str(tmp_path / "bare.npz")
    np.savez(params, **{"params/fg_CD_predictor/fea_0_bias": np.zeros(64, np.float32)})
    with pytest.raises(ValueError, match="nerf and audio"):
        cli.main(["animate", "--wav", wav_path, "--featmap-size", "8", "--img-size", "32",
                  "--params", params, "--device", "cpu", "--out", str(tmp_path / "f.npy")])


def test_animate_sequence_runs_no_kernel_on_cpu():
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    model = HeadNeRF(NeRFConfig(**TINY), use_fused=True, device="cpu",
                     generator=torch.Generator().manual_seed(0)).eval()
    cam = base_cam(8)
    before = fr.fused_render_fwd.launches
    frames = animate.animate_sequence(
        model, np.zeros((1, 179), np.float32), np.zeros((1, 127), np.float32),
        np.zeros((3, 64), np.float32),
        {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}, chunk=2)
    assert frames.shape == (3, 32, 32, 3)
    assert np.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1
    assert fr.fused_render_fwd.launches == before
