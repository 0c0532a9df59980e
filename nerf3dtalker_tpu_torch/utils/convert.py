"""Reference (PyTorch) checkpoint converters (port of
`nerf3dtalker_tpu/utils/convert.py`'s HeadNeRF, Audio2Style and AU
classifier converters, and of `data/ingest.py:torch_state_dict_to_numpy`).

Each maps a reference `torch.save` state dict straight onto the state dict
of the port's module, numpy arrays that `utils/bridge.py:load_into` copies
in:

  * HeadNeRF (`net`): `fg_CD_predictor.FeaExt_module_{i}`, `density_module`,
    `RGB_layer_{0,1,2}` (NetWorks/models.py:32-59; Conv2d 1x1
    [out, in, 1, 1]) -> the port NeRFMLP's flax-named [in, out] kernels
    `fea_{i}_kernel`, ...; `neural_render.feat_upsample_list.{i}.layer_{1,2}`,
    `feat_layers.{i}`, `feat_2_rgb_list.{i}` -> nn.Linear's [out, in]
    `feat_upsamples.{i}.layer_{1,2}`, `feat_layers.{i}`, `feat_2_rgb.{i}`;
    `bg_featmap` NCHW -> the port's NHWC (neural_renderer.py:49-69).
  * Audio2Style (`audio2style`): `rnn.rnn.{weight,bias}_{ih,hh}_l{k}[_reverse]`
    keep their names and torch's gate order (i, f, g, o); the port keeps
    `bias_ih` at 0, so `bias_hh` takes b_ih + b_hh (talker_trainer.py:408-473);
    `linear{1..3}.0` -> `linear{1..3}`.
  * AU classifier (`classifier_AU`, train_vq.py:60-93): NCHW like the
    port's, so no permutation: `conv{i}.0` -> `conv{i}`, `linear{0..3}.0`
    -> `linear{0..3}`, `linear4` the same.
  * SadTalker's audio2exp netG (s_audio2exp_models/networks.py:26-74, the
    `audio2exp` safetensors tensors with their prefixes stripped): the port
    SimpleWrapperV2 keeps the reference's names and NCHW layout, so
    `audio_encoder.{i}.conv_block.{0,1}` (Conv2d, BatchNorm2d with its
    running statistics) and `mapping1` carry over as they are.
  * BiSeNet face parsing (DataProcess/BiSeNet.py:227-256): the context
    path `cp.*` flattens to the top level, a ResNet block's
    `layer{l}.{b}` -> `layer{l}_{b}` and its `downsample.{0,1}` ->
    `down_conv` / `down_bn`, an output head `conv_out{,16,32}.{conv,
    conv_out}` -> `conv_out{,16,32}_{conv,out}`; the tensors as they are.
  * Deep3DFaceRecon's ReconNetWrapper (s_face3d/models/networks.py:69-104):
    the ResNet50 `backbone.*` renamed as BiSeNet's trunk; the seven 1x1
    coefficient heads `final_layers.{0..6}` (id80 / exp64 / tex80 / angle3
    / gamma27 / txy2 / tz1) stacked into the one Linear `final` [257, 2048].

The other converters of the JAX module come with their models.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def torch_state_dict_to_numpy(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict (or its `state_dict` entry) as numpy
    arrays, loaded on the CPU with `weights_only=True`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _np(v) for k, v in sd.items()}


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _weight(sd: Mapping, key: str) -> np.ndarray:
    """A Conv2d 1x1 or Linear weight as [out, in], f32."""
    w = _np(sd[f"{key}.weight"]).astype(np.float32)
    return w[:, :, 0, 0] if w.ndim == 4 else w


def _bias(sd: Mapping, key: str) -> np.ndarray:
    return _np(sd[f"{key}.bias"]).astype(np.float32)


def _linear(sd: Mapping, key: str, name: str) -> Dict[str, np.ndarray]:
    return {f"{name}.weight": _weight(sd, key), f"{name}.bias": _bias(sd, key)}


def convert_nerf_mlp(sd: Mapping, prefix: str = "fg_CD_predictor") -> Dict[str, np.ndarray]:
    """state dict -> the port NeRFMLP's state dict ([in, out] kernels)."""
    names = {f"fea_{i}": f"FeaExt_module_{i}" for i in range(8)}
    names["density"] = "density_module"
    names.update({f"rgb_{i}": f"RGB_layer_{i}" for i in range(3)})
    out = {}
    for name, ref in names.items():
        out[f"{name}_kernel"] = np.ascontiguousarray(_weight(sd, f"{prefix}.{ref}").T)
        out[f"{name}_bias"] = _bias(sd, f"{prefix}.{ref}")
    return out


def convert_neural_renderer(sd: Mapping, n_blocks: int,
                            prefix: str = "neural_render") -> Dict[str, np.ndarray]:
    """state dict -> the port NeuralRenderer's state dict."""
    out = {}
    for i in range(n_blocks):
        for li in (1, 2):
            out.update(_linear(sd, f"{prefix}.feat_upsample_list.{i}.layer_{li}",
                               f"feat_upsamples.{i}.layer_{li}"))
        out.update(_linear(sd, f"{prefix}.feat_layers.{i}", f"feat_layers.{i}"))
    for i in range(n_blocks + 1):
        out.update(_linear(sd, f"{prefix}.feat_2_rgb_list.{i}", f"feat_2_rgb.{i}"))
    bg = _np(sd[f"{prefix}.bg_featmap"]).astype(np.float32)         # [1, C, H, W]
    out["bg_featmap"] = np.ascontiguousarray(bg.transpose(0, 2, 3, 1))
    return out


def convert_headnerf(sd: Mapping, n_blocks: int = 3) -> Dict[str, np.ndarray]:
    """The reference `net` state dict -> the port HeadNeRF's state dict."""
    out = {f"fg_CD_predictor.{k}": v for k, v in convert_nerf_mlp(sd).items()}
    out.update({f"neural_render.{k}": v
                for k, v in convert_neural_renderer(sd, n_blocks).items()})
    return out


def _lstm_cell(sd: Mapping, prefix: str, layer: int, reverse: bool) -> Dict[str, np.ndarray]:
    """One direction of one torch LSTM layer: the weights as they are,
    bias_ih 0 and bias_hh = b_ih + b_hh (the port's invariant)."""
    suf = f"_l{layer}" + ("_reverse" if reverse else "")
    b = (_np(sd[f"{prefix}.bias_ih{suf}"]).astype(np.float32)
         + _np(sd[f"{prefix}.bias_hh{suf}"]).astype(np.float32))
    return {f"rnn.rnn.weight_ih{suf}": _np(sd[f"{prefix}.weight_ih{suf}"]).astype(np.float32),
            f"rnn.rnn.weight_hh{suf}": _np(sd[f"{prefix}.weight_hh{suf}"]).astype(np.float32),
            f"rnn.rnn.bias_ih{suf}": np.zeros_like(b), f"rnn.rnn.bias_hh{suf}": b}


def convert_audio2style(sd: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """`audio2style` state dict -> the port Audio2Style's state dict."""
    p = (prefix + ".") if prefix else ""
    out = {}
    for layer in range(2):
        for reverse in (False, True):
            out.update(_lstm_cell(sd, f"{p}rnn.rnn", layer, reverse))
    for i in (1, 2, 3):
        out.update(_linear(sd, f"{p}linear{i}.0", f"linear{i}"))
    return out


def convert_au_classifier(sd: Mapping) -> Dict[str, np.ndarray]:
    """`classifier_AU` state dict -> the port AUClassifier's state dict."""
    out = {}
    for i in range(1, 5):
        out[f"conv{i}.weight"] = _np(sd[f"conv{i}.0.weight"]).astype(np.float32)
        out[f"conv{i}.bias"] = _bias(sd, f"conv{i}.0")
    for i in range(4):
        out.update(_linear(sd, f"linear{i}.0", f"linear{i}"))
    out.update(_linear(sd, "linear4", "linear4"))
    return out


def convert_simple_wrapper_v2(sd: Mapping) -> Dict[str, np.ndarray]:
    """SadTalker netG state dict -> the port SimpleWrapperV2's state dict
    (f32; a BatchNorm's `num_batches_tracked` as stored, else 0)."""
    out = {}
    for i in range(13):
        conv, bn = f"audio_encoder.{i}.conv_block.0", f"audio_encoder.{i}.conv_block.1"
        out[f"{conv}.weight"] = _np(sd[f"{conv}.weight"]).astype(np.float32)
        out[f"{conv}.bias"] = _bias(sd, conv)
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{name}"] = _np(sd[f"{bn}.{name}"]).astype(np.float32)
        out[f"{bn}.num_batches_tracked"] = np.asarray(
            _np(sd.get(f"{bn}.num_batches_tracked", 0)), np.int64).reshape(())
    out.update(_linear(sd, "mapping1", "mapping1"))
    return out


def _port_keys(factory):
    """The state-dict keys of the port module `factory(device=...)` builds
    (on the meta device: no storage, no init)."""
    with torch.device("meta"):
        return list(factory(device="meta").state_dict())


def _renamed(sd: Mapping, keys, ref_key) -> Dict[str, np.ndarray]:
    """{port key: sd[ref_key(port key)]}, f32; a BatchNorm's
    `num_batches_tracked` as stored, else 0."""
    out = {}
    for k in keys:
        ref = ref_key(k)
        if k.endswith("num_batches_tracked"):
            out[k] = np.asarray(_np(sd.get(ref, 0)), np.int64).reshape(())
        else:
            out[k] = _np(sd[ref]).astype(np.float32)
    return out


def _resnet_ref_key(k: str) -> str:
    """A port ResNet trunk key -> torchvision's."""
    k = re.sub(r"layer(\d)_(\d+)\.", r"layer\1.\2.", k)
    return k.replace("down_conv", "downsample.0").replace("down_bn", "downsample.1")


def _bisenet_ref_key(k: str) -> str:
    head = re.match(r"(conv_out(?:16|32)?)_(conv|out)\.(.*)", k)
    if head:
        name, part, rest = head.groups()
        return f"{name}.{'conv' if part == 'conv' else 'conv_out'}.{rest}"
    return k if k.startswith("ffm.") else "cp." + _resnet_ref_key(k)


def convert_bisenet(sd: Mapping) -> Dict[str, np.ndarray]:
    """BiSeNet state dict -> the port BiSeNet's state dict."""
    from nerf3dtalker_tpu_torch.models.bisenet import BiSeNet

    return _renamed(sd, _port_keys(BiSeNet), _bisenet_ref_key)


def convert_recon_net(sd: Mapping) -> Dict[str, np.ndarray]:
    """ReconNetWrapper state dict -> the port ReconNet's state dict."""
    from nerf3dtalker_tpu_torch.models.resnets import ReconNet

    keys = [k for k in _port_keys(ReconNet) if k.startswith("backbone.")]
    out = _renamed(sd, keys, _resnet_ref_key)
    out["final.weight"] = np.concatenate([_weight(sd, f"final_layers.{i}") for i in range(7)])
    out["final.bias"] = np.concatenate([_bias(sd, f"final_layers.{i}") for i in range(7)])
    return out


def convert_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """A reference `*_ckpt.pth.tar` -> (the port HeadNeRF's state dict,
    meta). The checkpoint is `{epoch, net, audio2style, ..., para}`
    (talker_trainer.py:913-937); `para` holds the featmap and image sizes,
    which give the decoder's block count. meta: `para`, `audio2style` (the
    port Audio2Style's state dict, or None) and `epoch`. The file is read
    with `torch.load(weights_only=True)`: a checkpoint holding other types
    than tensors and plain containers is refused, not unpickled."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    para = ck.get("para", {})
    n_blocks = int(math.log2(para.get("pred_img_size", 256))
                   - math.log2(para.get("featmap_size", 32)))
    audio: Optional[Dict[str, np.ndarray]] = None
    if "audio2style" in ck:
        audio = convert_audio2style(ck["audio2style"])
    return convert_headnerf(ck["net"], n_blocks), {"para": para, "audio2style": audio,
                                                   "epoch": ck.get("epoch")}
