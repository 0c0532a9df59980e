"""Model, audio and training configuration (copy of
`nerf3dtalker_tpu/config.py`'s `NeRFConfig`, `reso32`, `reso64`,
`AudioConfig`, `TrainConfig` and `VQConfig`).

Frozen dataclasses; field semantics mirror the reference HeadNeRF options
(HeadNeRFOptions.py:5-34) and the audio hparams (hparams.py:15-60).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Hyperparameters of the audio-conditioned HeadNeRF core; defaults are
    the published Reso32 scale. Use :func:`reso32` / :func:`reso64`."""

    bg_type: str = "white"

    iden_code_dims: int = 100
    expr_code_dims: int = 79
    text_code_dims: int = 100
    illu_code_dims: int = 27

    num_sample_coarse: int = 64
    num_sample_fine: int = 128

    world_z1: float = 2.5
    world_z2: float = -3.5
    mlp_hidden: int = 384

    featmap_size: int = 32
    featmap_nc: int = 256
    pred_img_size: int = 256

    # positional encoding (HeadNeRFNet.py:27-31)
    vp_n_freqs: int = 10
    vp_include_input: bool = True
    vd_n_freqs: int = 4
    vd_include_input: bool = True

    include_vd: bool = False
    hier_sampling: bool = False

    audio_style_dims: int = 64

    include_gaze: bool = False
    eye_gaze_dim: int = 2

    @property
    def shape_code_dims(self) -> int:
        """iden + expr (HeadNeRFNet.py:38)."""
        return self.iden_code_dims + self.expr_code_dims

    @property
    def appea_code_dims(self) -> int:
        """text + illu (HeadNeRFNet.py:39)."""
        return self.text_code_dims + self.illu_code_dims

    @property
    def vp_pe_dims(self) -> int:
        d = self.vp_n_freqs * 6
        return d + 3 if self.vp_include_input else d

    @property
    def vd_pe_dims(self) -> int:
        d = self.vd_n_freqs * 6
        return d + 3 if self.vd_include_input else d

    @property
    def vp_channels(self) -> int:
        """MLP position-branch input channels excluding the audio style:
        PE(63) + shape(179) [+ gaze]."""
        c = self.shape_code_dims + self.vp_pe_dims
        if self.include_gaze:
            c += self.eye_gaze_dim
        return c

    @property
    def vd_channels(self) -> int:
        """View/appearance-branch channels (HeadNeRFNet.py:56-62)."""
        c = self.appea_code_dims
        if self.include_vd:
            c += self.vd_pe_dims
        return c

    @property
    def n_rays(self) -> int:
        return self.featmap_size * self.featmap_size

    @property
    def n_upsample_blocks(self) -> int:
        return int(math.log2(self.pred_img_size) - math.log2(self.featmap_size))


def reso32() -> NeRFConfig:
    return NeRFConfig(featmap_size=32, featmap_nc=256, pred_img_size=256)


def reso64() -> NeRFConfig:
    return NeRFConfig(featmap_size=64, featmap_nc=256, pred_img_size=512)


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Mel-spectrogram pipeline parameters (reference hparams.py:15-60)."""

    sample_rate: int = 16000
    n_fft: int = 800
    hop_size: int = 200
    win_size: int = 800
    num_mels: int = 80
    fmin: float = 55.0
    fmax: float = 7600.0
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    preemphasis: float = 0.97
    preemphasize: bool = True
    signal_normalization: bool = True
    allow_clipping_in_normalization: bool = True
    symmetric_mels: bool = True
    max_abs_value: float = 4.0
    fps: int = 25
    mel_step_size: int = 16


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (HeadNeRFOptions.py:77-88 +
    talker_trainer.py:665,722-727), the JAX `TrainConfig`'s fields with its
    names and defaults."""

    # frame batch per optimizer step (the reference trains B=1; the JAX
    # package's default is 2)
    batch_size: int = 2
    epochs: int = 30
    lr: float = 1e-4
    lr_audio: float = 1e-4
    step_lr_every: int = 100      # StepLR: lr * gamma^(epoch // step_lr_every)
    step_lr_gamma: float = 0.1
    use_vgg_loss: bool = True
    # torchvision `vgg16().features` state_dict (.pth) or an .npz of the same
    # keys; empty -> a seeded random VGG16 (models/perceptual.py:load_vgg16)
    vgg_weights: str = ""
    # precompute the masked-GT VGG activations of every frame once, so that
    # a step runs only the prediction's branch of the perceptual loss
    vgg_precompute_gt: bool = True
    seed: int = 0
    # batches from the C++ threaded prefetcher (native/nerf3dt_native.cpp,
    # `data/native.py`) where the device cache is off; a failed build raises
    native_prefetch: bool = False
    # the frame set (with its VGG planes) on the device up to this many
    # bytes, batches gathered there; on the GPU without a mesh each step is
    # then a replay of one CUDA graph (`train/trainer.py`)
    device_cache: bool = True
    device_cache_bytes: int = 6 * 1024**3
    # the HeadNeRF and the VGG compute in bf16 where the kernels run (the
    # GPU; False raises there, the kernels have no other dtype); the CPU's
    # plain path computes in f32 either way
    bf16_compute: bool = True
    ckpt_dir: str = "./logs/ckpt"
    log_dir: str = "./logs"
    # per-epoch metrics.jsonl under log_dir (`utils/observability.py`)
    metric_log: bool = True
    # the same scalars to TensorBoard (torch.utils.tensorboard; raises
    # before training when the tensorboard package is missing)
    use_tensorboard: bool = False
    # a torch.profiler trace (Chrome / Perfetto JSON) of steps
    # 1..trace_steps of the first epoch, written under trace_dir
    trace_dir: str = ""
    trace_steps: int = 5
    # on an epoch with non-finite steps: "warn" (the step already kept the
    # params), "rollback" to the last checkpoint, or "abort" once a run of
    # guard_max_bad bad steps is reached (utils/guards.py StepGuard)
    guard_policy: str = "warn"
    guard_max_bad: int = 10
    # validate and checkpoint every k-th epoch and after the last one
    val_every: int = 1


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """Standardized-Space VQ-VAE (copy of the JAX `VQConfig`; reference
    stage1_vocaset.py:11-27 + config/vocaset/stage1.yaml)."""

    in_dim: int = 3
    hidden_size: int = 512
    embed_dim: int = 64
    n_embed: int = 8192          # image codebook
    n_embed_au: int = 500        # AU codebook
    num_hidden_layers: int = 6
    num_attention_heads: int = 8
    intermediate_size: int = 1536
    beta: float = 0.25
    img_size: int = 256
    quant_factor: int = 0        # temporal squash factor of the conv squasher
    face_quan_num: int = 8       # codes per face token group
    au_dim: int = 256            # AU classifier feature width fed to codebook
    n_au: int = 5                # AU10/14/20/25/26
