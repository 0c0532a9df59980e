"""Standardized Space stage-1 (port of `nerf3dtalker_tpu/models/vq`): the
dual-codebook VQ autoencoder and the per-AU classifiers."""

from nerf3dtalker_tpu_torch.models.vq.au_classifier import AUClassifier
from nerf3dtalker_tpu_torch.models.vq.quantizer import VectorQuantizer
from nerf3dtalker_tpu_torch.models.vq.stage1 import VQAutoEncoder, VQForwardResult

__all__ = ["AUClassifier", "VectorQuantizer", "VQAutoEncoder", "VQForwardResult"]
