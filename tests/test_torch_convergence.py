"""The train-then-serve slice of the port on the CPU, at a tiny config
(f32, plain path): the trainer's `val_every` cadence with the train-split
metrics, LPIPS and the validation dumps; `Trainer.from_checkpoint` (a 2 + 1
epoch run ends bit-identical to a 3-epoch run); `cli train --resume`
forwarding only the flags set on its command line; `cli animate --ckpt`
serving the trained subject (frames bit-identical to `animate_sequence` on
the trainer's own model); `write_video` without ffmpeg; and the r05
convergence script end to end (its JSON holds every key of the JAX
script's `TRAIN_r05.json`)."""

import dataclasses
import json
import os
import pathlib
import shutil
import wave

import numpy as np
import pytest
import torch
import _jax_reference  # noqa: F401  (each xdist worker's share of torch threads)

from nerf3dtalker_tpu_torch import cli
from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
from nerf3dtalker_tpu_torch.data.dataset import coherent_subject
from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
from nerf3dtalker_tpu_torch.train.trainer import Trainer
from nerf3dtalker_tpu_torch.utils import checkpoints, metrics, video
from nerf3dtalker_tpu_torch.utils.camera import base_cam

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = NeRFConfig(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=8,
                  mlp_hidden=32)


def _config(tmp, **kw):
    return TrainConfig(**{"batch_size": 2, "use_vgg_loss": False, "lr": 2e-4,
                          "ckpt_dir": str(tmp / "ckpt"), "log_dir": str(tmp / "logs"), **kw})


def _data():
    """2 train frames (one step an epoch), 1 val and 1 train-eval frame."""
    return (coherent_subject(TINY, 2), coherent_subject(TINY, 1, t0=2),
            coherent_subject(TINY, 1))


def _seeded_lpips():
    net = metrics.AlexNetFeatures()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return net.eval(), [torch.rand(c.out_channels, generator=g) for c in net.convs]


def test_validation_every_n_epochs_with_train_metrics(tmp_path, monkeypatch):
    """7 epochs at val_every=3: epochs 2, 5 and 6 (the last) validate, with
    the train-split and LPIPS rows, dump their strips and save. Epoch 3's
    steps are made to report non-finite: under the rollback guard it goes
    back to epoch 2's checkpoint and is neither validated nor saved."""
    train, val, train_eval = _data()
    t = Trainer(TINY, _config(tmp_path, epochs=7, val_every=3, guard_policy="rollback"), train,
                val, device="cpu", lpips=_seeded_lpips(), train_eval_data=train_eval)
    clean = t.train_epoch_group     # train() groups the epochs up to each validation
    monkeypatch.setattr(t, "train_epoch_group", lambda e0, n: [
        {**m, **({"finite_step": 0.0} if e0 + j == 3 else {})} for j, m in enumerate(clean(e0, n))])
    hist = t.train()
    assert [h["epoch"] for h in hist] == list(range(7))
    keys = {"SSIM", "PSNR", "LPIPS", "TRAIN_SSIM", "TRAIN_PSNR", "TRAIN_LPIPS"}
    assert [h["epoch"] for h in hist if keys <= set(h)] == [2, 5, 6]
    assert all(not keys & set(h) for h in hist if h["epoch"] not in (2, 5, 6))
    assert all(np.isfinite(h[k]) and h["LPIPS"] > 0 for h in hist if "PSNR" in h for k in keys)
    assert [h["epoch"] for h in hist if "rollback" in h] == [3]
    # one step an epoch; epoch 3's step was undone, so epoch 5 ends at step 5
    assert checkpoints._steps(str(tmp_path / "ckpt")) == [3, 5, 6]
    assert checkpoints.load_checkpoint(str(tmp_path / "ckpt"))["metrics"] == {
        k: hist[6][k] for k in keys}
    # the validation frame's GT|render strip, per validated epoch
    dumps = sorted(str(p.relative_to(tmp_path / "logs" / "temp_image"))
                   for p in (tmp_path / "logs" / "temp_image").rglob("val_*"))
    assert dumps == [f"epoch{e}/val_0000.png" for e in (2, 5, 6)]
    from PIL import Image

    assert np.asarray(Image.open(tmp_path / "logs/temp_image/epoch6/val_0000.png")).shape == (
        32, 64, 3)
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 7
    shutil.rmtree(tmp_path / "ckpt")


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """A trainer after 2 epochs (2 steps) with its checkpoint."""
    tmp = tmp_path_factory.mktemp("two_epochs")
    train, val, _ = _data()
    t = Trainer(TINY, _config(tmp, epochs=2, val_every=2), train, val, device="cpu")
    t.train()
    yield t, tmp
    shutil.rmtree(tmp / "ckpt", ignore_errors=True)


def test_from_checkpoint_rebuilds_and_resumes_bit_identically(two_epochs):
    t2, tmp = two_epochs
    train, val, _ = _data()
    straight = Trainer(TINY, _config(tmp, epochs=3, val_every=3, ckpt_dir=""), train, val,
                       device="cpu")
    straight.train()
    t = Trainer.from_checkpoint(str(tmp / "ckpt"), train, val, device="cpu", epochs=3,
                                val_every=3, ckpt_dir="")
    assert t.nerf_cfg == TINY
    assert t.train_cfg == dataclasses.replace(t2.train_cfg, epochs=3, val_every=3, ckpt_dir="")
    assert t.start_epoch == 2 and t.state.step == 2
    rec = t.train()[-1]
    assert rec["epoch"] == 2 and rec["total_loss"] == straight.history[-1]["total_loss"]
    assert rec["PSNR"] == straight.history[-1]["PSNR"]
    for group in ("nerf", "audio"):
        for (name, a), b in zip(getattr(t.state, group).named_parameters(),
                                getattr(straight.state, group).parameters()):
            assert torch.equal(a, b), f"{group}.{name}"
    by_default = Trainer.from_checkpoint(str(tmp / "ckpt"), train, device="cpu")
    assert by_default.train_cfg.ckpt_dir == str(tmp / "ckpt")


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    sr = 16000
    n = 3 * sr // 25 + 100                      # 3 frames at 25 fps
    t = np.arange(n) / sr
    pcm = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    path = str(tmp_path_factory.mktemp("wav") / "speech.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((pcm * 32767).astype(np.int16).tobytes())
    return path


def test_cli_animate_serves_the_trained_checkpoint(two_epochs, wav_path, tmp_path):
    t, tmp = two_epochs
    out = str(tmp_path / "frames.npy")
    rec = cli.main(["animate", "--wav", wav_path, "--ckpt", str(tmp / "ckpt"), "--chunk", "2",
                    "--device", "cpu", "--out", out])
    assert rec["frames"] == 3 and rec["size"] == [32, 32]     # the checkpoint's config
    styles = styles_from_mels(t.state.audio.eval(), per_frame_mel_chunks(*read_wav_mono(wav_path)))
    cam = base_cam(TINY.featmap_size)
    want = animate_sequence(t.state.nerf.eval(), np.zeros((1, 179), np.float32),
                            np.zeros((1, 127), np.float32), styles,
                            {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat},
                            chunk=2)
    np.testing.assert_array_equal(np.load(out), want)
    with pytest.raises(SystemExit, match="--ckpt and --params"):
        cli.main(["animate", "--wav", wav_path, "--ckpt", str(tmp / "ckpt"), "--params",
                  str(tmp_path / "p.npz"), "--device", "cpu", "--out", out])
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["animate", "--wav", wav_path, "--enhancer", "gfpgan", "--device", "cpu"])


def test_write_video_without_ffmpeg_writes_pngs_and_the_wav(tmp_path, wav_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    frames = np.random.default_rng(0).uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    with pytest.warns(UserWarning, match="ffmpeg not found"):
        video.write_video(frames, str(tmp_path / "clip.mp4"), audio_path=wav_path)
    d = tmp_path / "clip_frames"
    assert sorted(os.listdir(d)) == ["00000.png", "00001.png", "00002.png", "speech.wav"]
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(d / "00001.png")),
                                  np.clip(frames[1] * 255, 0, 255).astype(np.uint8))


def test_cli_train_resume_forwards_only_explicit_flags(tmp_path, capsys):
    arrays = coherent_subject(TINY, 3).arrays          # 2 train frames, 1 val frame
    data = str(tmp_path / "subject.npz")
    np.savez(data, **arrays)
    args = ["train", "--device", "cpu", "--featmap-size", "8", "--img-size", "32", "--no-vgg",
            "--data", data, "--ckpt-dir", str(tmp_path / "ckpt")]
    cli.main(args + ["--epochs", "1", "--lr", "3e-4", "--guard-policy", "rollback",
                     "--log-dir", str(tmp_path / "logs")])
    capsys.readouterr()
    rec = cli.main(args + ["--epochs", "2", "--resume", "--seed", "5"])
    out = capsys.readouterr().out
    assert "resumed from step 1 (epoch 1)" in out
    assert "['seed', 'use_vgg_loss']" in out
    assert rec["epoch"] == 1
    cfg = checkpoints.load_checkpoint(str(tmp_path / "ckpt"))["config"]["train"]
    # kept from the checkpoint (the flags were left at their defaults here)
    assert (cfg["lr"], cfg["guard_policy"], cfg["log_dir"]) == (3e-4, "rollback",
                                                                str(tmp_path / "logs"))
    assert (cfg["seed"], cfg["epochs"], cfg["use_vgg_loss"]) == (5, 2, False)
    # the subject that cli train trained, served from its checkpoint
    wav = str(tmp_path / "speech.wav")
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(np.zeros(2 * 16000 // 25 + 100, np.int16).tobytes())
    rec = cli.main(["animate", "--wav", wav, "--ckpt", str(tmp_path / "ckpt"), "--device", "cpu",
                    "--out", str(tmp_path / "served.npy")])
    frames = np.load(tmp_path / "served.npy")
    assert rec["frames"] == 2 and frames.shape == (2, 32, 32, 3)
    assert np.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1
    shutil.rmtree(tmp_path / "ckpt")


def test_train_r05_script_runs_at_tiny_scale(tmp_path):
    from nerf3dtalker_tpu_torch.scripts import train_r05

    out = str(tmp_path / "r05.json")
    rec = train_r05.main(["--scale", "tiny", "--device", "cpu", "--frames", "4",
                          "--val-frames", "2", "--epochs", "2", "--max-epochs", "2",
                          "--val-every", "1", "--workdir", str(tmp_path / "wd"), "--out", out])
    with open(ROOT / "TRAIN_r05.json") as f:
        want = json.load(f)
    with open(out) as f:
        got = json.load(f)
    assert set(want) <= set(got) and got == json.loads(json.dumps(rec))
    for k in ("final_train", "final_val", "targets", "ablations"):
        assert set(want[k]) <= set(got[k]), k
    assert got["platform"] == "cpu" and got["total_steps"] == 4 and got["epochs"] == 2
    assert got["seed"] == 0 and 0 <= got["opacity"]["init"] <= 1
    assert [h["epoch"] for h in got["history"] if "TRAIN_PSNR" in h] == [0, 1]
    with np.load(tmp_path / "wd" / "renders.npz") as z:
        assert z["train_render"].shape == (4, 64, 64, 3)
        assert z["val_degraded"].shape == (2, 64, 64, 3)
    shutil.rmtree(tmp_path / "wd")


def test_subject_paths_script_agrees_across_paths_on_cpu():
    """On the CPU the `kernels` path is K3 over the kernels' plain versions:
    its losses and opacity equal the plain autograd path's within f32
    rounding (1e-5 relative)."""
    from nerf3dtalker_tpu_torch.scripts import subject_paths

    recs = subject_paths.main(["--scale", "tiny", "--device", "cpu", "--frames", "2",
                               "--epochs", "1", "--seeds", "0", "--paths", "kernels,plain"])
    assert [(r["seed"], r["path"]) for r in recs] == [(0, "kernels"), (0, "plain")]
    a, b = (dict(r["epochs"][0], init=r["init_opacity"]) for r in recs)
    assert a.keys() == b.keys() and 0 < b["init"] < 1
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
