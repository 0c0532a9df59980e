"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch
import _jax_reference  # noqa: F401  (each xdist worker's share of torch threads)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf3dtalker_tpu", "transformers",
             "safetensors")


def _port_sources():
    return sorted((ROOT / "nerf3dtalker_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_rule_covers_the_mesh_and_the_probe():
    """The rule above reaches the multi-rank modules and the probe's wrapper."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"nerf3dtalker_tpu_torch/parallel/__init__.py",
            "nerf3dtalker_tpu_torch/parallel/mesh.py",
            "nerf3dtalker_tpu_torch/parallel/selfcheck.py",
            "nerf3dtalker_tpu_torch/ops/kernels/probe_xtg.py"} <= names


def test_import_rule_covers_the_standardized_space_and_the_converters():
    """The rule above reaches stage 1's modules, its trainer and evaluation,
    the r05 VQ script and the reference-checkpoint converters."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    port = "nerf3dtalker_tpu_torch/"
    assert {port + f for f in ("models/vq/__init__.py", "models/vq/quantizer.py",
                               "models/vq/transformer.py", "models/vq/stage1.py",
                               "models/vq/au_classifier.py", "train/vq_trainer.py",
                               "train/vq_eval.py", "utils/convert.py",
                               "scripts/vq_run.py")} <= names


def test_import_rule_covers_stage2_and_the_sadtalker_path():
    """The rule above (which also forbids `transformers` and `safetensors`)
    reaches stage 2's modules, its trainer and the SadTalker path."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    port = "nerf3dtalker_tpu_torch/"
    assert {port + f for f in ("models/vq/wav2vec.py", "models/vq/stage2.py",
                               "train/stage2_trainer.py", "utils/mesh_metrics.py",
                               "models/audio.py", "models/audio2coeff.py",
                               "models/audio2pose.py", "data/ingest.py", "data/tts.py",
                               "train/audio2exp_trainer.py", "train/disexp_trainer.py")} <= names


def test_import_rule_covers_the_preprocessing_path():
    """The rule above reaches the face3d modules, the preprocessing networks,
    the 3DMM fit, the preprocessing orchestrator and the crop-and-extract
    path."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    port = "nerf3dtalker_tpu_torch/"
    assert {port + f for f in ("models/face3d/__init__.py", "models/face3d/rasterizer.py",
                               "models/face3d/nl3dmm.py", "models/face3d/bfm.py",
                               "models/bisenet.py", "models/fan.py", "models/resnets.py",
                               "train/fit3dmm.py", "data/preprocess.py", "data/align.py",
                               "data/crop_extract.py")} <= names


def test_kernel_source_is_in_the_package():
    from nerf3dtalker_tpu_torch.ops.kernels import build

    assert build.sources() == ["fused_render_bwd", "fused_render_fwd", "fused_upsampler_bwd",
                               "fused_upsampler_fwd", "probe_xtg"]
    for name in build.sources():
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build.library_path(name).parent == build.BUILD_DIR
    # the shared headers: the staged X^T G core (the weight gradients of K2
    # and K5-bwd, and the probe), the fused upsampler's common code and its
    # tile kernel (K5-fwd, and K5-bwd's recompute pass), and the Hopper
    # helpers (wgmma, mbarriers, bulk copies)
    assert sorted(p.name for p in build.CSRC.glob("*.cuh")) == [
        "fused_upsampler_common.cuh", "fused_upsampler_tile.cuh", "hopper.cuh", "xtg_core.cuh"]


def test_a_header_edit_rebuilds_every_kernel(tmp_path, monkeypatch):
    """The library name hashes the shared headers too: an edited
    `xtg_core.cuh` gives every kernel a new library, so a stale build of
    K2 or the probe is never loaded."""
    import shutil

    from nerf3dtalker_tpu_torch.ops.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.sources()}
    (csrc / "xtg_core.cuh").write_text((csrc / "xtg_core.cuh").read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.sources()}
    assert all(before[n] != after[n] for n in before)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_cuda_raise(no_cuda, tmp_path):
    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import NeRFConfig
    from nerf3dtalker_tpu_torch.models.audio import Audio2Style
    from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeadNeRF(NeRFConfig(featmap_size=8, pred_img_size=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Audio2Style()
    wav = tmp_path / "silence.wav"
    import wave

    with wave.open(str(wav), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(np.zeros(4000, np.int16).tobytes())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["animate", "--wav", str(wav), "--out", str(tmp_path / "f.npy")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fit", "--iters", "1", "--out", str(tmp_path / "fitted.npz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["render", "--views", "1", "--out", str(tmp_path / "views.npy")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train-vq", "--epochs", "1", "--ckpt-dir", str(tmp_path / "vq_ckpt")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval-vq", "--out", str(tmp_path / "gen+")])
    from nerf3dtalker_tpu_torch.config import VQConfig
    from nerf3dtalker_tpu_torch.models.vq import AUClassifier, VQAutoEncoder

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VQAutoEncoder(VQConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AUClassifier()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer-stage2", "--wav", str(wav), "--out", str(tmp_path / "s2.npy")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer-coeff", "--wav", str(wav), "--out", str(tmp_path / "c.npz")])
    from nerf3dtalker_tpu_torch.models.audio import FusAudio2Style, SimpleWrapperV2
    from nerf3dtalker_tpu_torch.models.vq.stage2 import CodeTalker
    from nerf3dtalker_tpu_torch.models.vq.wav2vec import Wav2Vec2Encoder

    for make in (Wav2Vec2Encoder, lambda: CodeTalker(VQConfig()), SimpleWrapperV2,
                 FusAudio2Style):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert not list(tmp_path.glob("fitted.npz")) and not list(tmp_path.glob("views.npy"))
    assert not list(tmp_path.glob("vq_ckpt")) and not list(tmp_path.glob("gen+"))
    assert not list(tmp_path.glob("s2.npy")) and not list(tmp_path.glob("c.npz"))


def test_preprocessing_without_cuda_raises(no_cuda, tmp_path):
    """`cli preprocess` (strict or not), `build_appliers` and the networks
    default to the card and refuse to fall back to the CPU."""
    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.data.preprocess import build_appliers
    from nerf3dtalker_tpu_torch.models.bisenet import BiSeNet
    from nerf3dtalker_tpu_torch.models.face3d.bfm import synthetic_bfm
    from nerf3dtalker_tpu_torch.models.face3d.nl3dmm import Linear3DMMTexture, NonLinear3DMM
    from nerf3dtalker_tpu_torch.models.fan import FAN
    from nerf3dtalker_tpu_torch.models.resnets import ReconNet

    frames = tmp_path / "frames.npy"
    np.save(frames, np.zeros((2, 16, 16, 3), np.float32))
    for strict in ([], ["--strict"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["preprocess", "--frames", str(frames), "--wav", "unread.wav",
                      "--out", str(tmp_path / "subject.npz"), *strict])
    for make in (BiSeNet, FAN, ReconNet, lambda: NonLinear3DMM(point_num=4),
                 lambda: Linear3DMMTexture(point_num=4), synthetic_bfm,
                 lambda: build_appliers(16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert not list(tmp_path.glob("subject.npz"))


def test_cpu_tensor_runs_plain_version_cuda_request_raises(no_cuda):
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
