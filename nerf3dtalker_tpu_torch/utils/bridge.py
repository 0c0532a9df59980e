"""Flax param trees -> the port's modules.

A flax tree is the variables dict `{"params": {...}}` of numpy arrays that
`model.init(...)` gives, or the `/`-joined `.npz` that
`nerf3dtalker_tpu/utils/checkpoints.py:save_pytree_npz` writes of it
(`load_npz_tree` reads it back). This inverts the torch->flax maps of
`nerf3dtalker_tpu/utils/convert.py`:

  HeadNeRF     fg_CD_predictor/{fea_i,density,rgb_i}_{kernel,bias}  same names
               (and fine_fg_CD_predictor/... with hier_sampling; gaze and vd
               widen fea_0 / fea_5 and rgb_1, read at the tree's shapes)
               neural_render/feat_upsample_{i}/layer_{1,2}/{kernel,bias}
                                               -> feat_upsamples.{i}.layer_{1,2}
               neural_render/feat_layer_{i}    -> feat_layers.{i}
               neural_render/feat_2_rgb_{i}    -> feat_2_rgb.{i}
               neural_render/bg_featmap        [1, S, S, C] NHWC, same
  Audio2Style  rnn/l{k}_{fwd,bwd}/i{i,f,g,o}/kernel       -> weight_ih_l{k}[_reverse]
               rnn/l{k}_{fwd,bwd}/h{i,f,g,o}/{kernel,bias} -> weight_hh, bias_hh
               (bias_ih = 0); linear{1,2,3}/{kernel,bias}  -> linear{1,2,3}
  VGG16        conv{idx}/{kernel,bias}          -> features.{idx}.{weight,bias}
  VQAutoEncoder  the same module paths, block_{i} -> blocks.{i}; LayerNorm
               scale -> weight; quantize{,_au}/embedding the same
  AUClassifier stacked [n_au, ...] leaves -> classifier i of the ModuleList;
               linear0's rows from the NHWC flatten to the NCHW one
  Wav2Vec2Encoder, FusAudio2Style  the same module paths, as VQAutoEncoder
  CodeTalker   the same module paths; style_emb/embedding -> style_emb.weight
  SimpleWrapperV2  enc_{i}/conv -> audio_encoder.{i}.conv_block.0, enc_{i}/bn
               (scale, bias; batch_stats mean, var) -> conv_block.1 (weight,
               bias, running_mean, running_var), mapping1 the same
Dense kernels are [in, out]; torch Linear weights are [out, in]. Conv
kernels are HWIO (WIO in 1-d); torch Conv2d weights are OIHW (Conv1d OIW).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GATES = ("i", "f", "g", "o")


def load_npz_tree(path: str) -> dict:
    """`/`-joined .npz -> nested dict of numpy arrays."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key])
    return out


def _inner(tree: Mapping) -> Mapping:
    if set(tree) != {"params"}:
        raise KeyError(f"expected flax variables {{'params': ...}}, got keys {sorted(tree)}")
    return tree["params"]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(d: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": _np(d["kernel"]).T, f"{prefix}.bias": _np(d["bias"])}


def headnerf_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """HeadNeRF flax params -> the port HeadNeRF's state_dict (numpy)."""
    p = _inner(tree)
    sd = {f"{mlp}.{k}": _np(v) for mlp in ("fg_CD_predictor", "fine_fg_CD_predictor")
          if mlp in p for k, v in p[mlp].items()}
    nr = p["neural_render"]
    n_blocks = sum(1 for k in nr if k.startswith("feat_layer_"))
    for i in range(n_blocks):
        for li in (1, 2):
            sd.update(_linear(nr[f"feat_upsample_{i}"][f"layer_{li}"],
                              f"neural_render.feat_upsamples.{i}.layer_{li}"))
        sd.update(_linear(nr[f"feat_layer_{i}"], f"neural_render.feat_layers.{i}"))
    for i in range(n_blocks + 1):
        sd.update(_linear(nr[f"feat_2_rgb_{i}"], f"neural_render.feat_2_rgb.{i}"))
    sd["neural_render.bg_featmap"] = _np(nr["bg_featmap"])
    return sd


def audio2style_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """Audio2Style flax params -> the port Audio2Style's state_dict (numpy)."""
    p = _inner(tree)
    sd = {}
    for layer in range(2):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            cell = p["rnn"][f"l{layer}_{direction}"]
            wi = np.concatenate([_np(cell[f"i{g}"]["kernel"]) for g in _GATES], axis=1)
            wh = np.concatenate([_np(cell[f"h{g}"]["kernel"]) for g in _GATES], axis=1)
            bh = np.concatenate([_np(cell[f"h{g}"]["bias"]) for g in _GATES])
            key = f"rnn.rnn.{{}}_l{layer}{suffix}"
            sd[key.format("weight_ih")] = wi.T
            sd[key.format("weight_hh")] = wh.T
            sd[key.format("bias_ih")] = np.zeros_like(bh)
            sd[key.format("bias_hh")] = bh
    for i in (1, 2, 3):
        sd.update(_linear(p[f"linear{i}"], f"linear{i}"))
    return sd


def vgg16_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """VGG16Features flax params -> the port VGG16Features' state_dict."""
    sd = {}
    for name, conv in _inner(tree).items():
        idx = name[len("conv"):]
        sd[f"features.{idx}.weight"] = np.transpose(_np(conv["kernel"]), (3, 2, 0, 1))
        sd[f"features.{idx}.bias"] = _np(conv["bias"])
    return sd


def _torch_leaf(name: str, x) -> tuple:
    """(torch name, value) of a flax leaf: kernels of a Dense [in, out],
    Conv1d [k, in, out] or Conv2d [kh, kw, in, out] in torch's layout;
    LayerNorm's scale as weight."""
    x = _np(x)
    if name == "kernel":
        return "weight", np.transpose(x, {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[x.ndim])
    return ("weight" if name == "scale" else name), x


def _flat_state_dict(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    sd = {}
    for name, node in tree.items():
        if isinstance(node, Mapping):
            part = f"blocks.{name[len('block_'):]}" if name.startswith("block_") else name
            sd.update(_flat_state_dict(node, f"{prefix}{part}."))
        else:
            key, value = _torch_leaf(name, node)
            sd[prefix + key] = value
    return sd


def vq_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """Flax params of a port module that keeps the flax module names
    (VQAutoEncoder; also Wav2Vec2Encoder, FusAudio2Style) -> its state_dict."""
    return _flat_state_dict(_inner(tree))


def codetalker_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """CodeTalker flax params -> the port CodeTalker's state_dict."""
    sd = _flat_state_dict(_inner(tree))
    sd["style_emb.weight"] = sd.pop("style_emb.embedding")
    return sd


def simple_wrapper_v2_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """SimpleWrapperV2 flax variables {params, batch_stats} -> the port
    SimpleWrapperV2's state_dict (num_batches_tracked 0)."""
    p, stats = variables["params"], variables["batch_stats"]
    sd = _linear(p["mapping1"], "mapping1")
    for i in range(13):
        conv, bn = f"audio_encoder.{i}.conv_block.0", f"audio_encoder.{i}.conv_block.1"
        sd.update({f"{conv}.{k}": v for k, v in
                   (_torch_leaf(n, x) for n, x in p[f"enc_{i}"]["conv"].items())})
        sd[f"{bn}.weight"] = _np(p[f"enc_{i}"]["bn"]["scale"])
        sd[f"{bn}.bias"] = _np(p[f"enc_{i}"]["bn"]["bias"])
        sd[f"{bn}.running_mean"] = _np(stats[f"enc_{i}"]["bn"]["mean"])
        sd[f"{bn}.running_var"] = _np(stats[f"enc_{i}"]["bn"]["var"])
        sd[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def bn_net_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax variables {params, batch_stats} of a conv net that keeps the flax
    module names (the port's BiSeNet, FAN, ReconNet) -> its state_dict."""
    sd = {}

    def walk(params: Mapping, stats: Mapping, prefix: str) -> None:
        for name, node in params.items():
            if "scale" in node:                       # a BatchNorm
                sd.update({f"{prefix}{name}.weight": _np(node["scale"]),
                           f"{prefix}{name}.bias": _np(node["bias"]),
                           f"{prefix}{name}.running_mean": _np(stats[name]["mean"]),
                           f"{prefix}{name}.running_var": _np(stats[name]["var"]),
                           f"{prefix}{name}.num_batches_tracked": np.zeros((), np.int64)})
            elif "kernel" in node:                    # a Conv or a Dense
                sd.update({f"{prefix}{name}.{k}": v for k, v in
                           (_torch_leaf(n, x) for n, x in node.items())})
            else:
                walk(node, stats.get(name, {}), f"{prefix}{name}.")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return sd


def nl3dmm_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """NonLinear3DMM or Linear3DMMTexture flax params -> the port module's
    state_dict."""
    return _flat_state_dict(_inner(tree))


def au_classifiers_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """The JAX step's stacked AUClassifier params ([n_au, ...] leaves) ->
    the state_dict of the port's ModuleList of n_au classifiers. linear0's
    rows go from the NHWC flatten (h, w, c) to the NCHW one (c, h, w): the
    inverse of `nerf3dtalker_tpu/utils/convert.py:convert_au_classifier`."""
    p = _inner(tree)
    n_au = len(p["linear0"]["kernel"])
    sd = {}
    for i in range(n_au):
        one = {mod: {k: _np(v)[i] for k, v in leaves.items()} for mod, leaves in p.items()}
        k0 = one["linear0"]["kernel"]                    # [h * w * c, out]
        c = _np(p["conv4"]["kernel"]).shape[-1]
        side = int(round((k0.shape[0] // c) ** 0.5))
        one["linear0"]["kernel"] = (k0.reshape(side, side, c, -1).transpose(2, 0, 1, 3)
                                    .reshape(k0.shape[0], -1))
        sd.update(_flat_state_dict(one, f"{i}."))
    return sd


def load_into(module: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a numpy state_dict into `module` on its own device; every key
    must match in name and shape."""
    own = module.state_dict()
    if set(own) != set(state):
        raise KeyError(f"missing {sorted(set(own) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(own))}")
    with torch.no_grad():
        for k, v in state.items():
            if tuple(own[k].shape) != v.shape:
                raise ValueError(f"{k}: shape {v.shape} != {tuple(own[k].shape)}")
            own[k].copy_(torch.from_numpy(np.array(v, dtype=np.float32)))
    return module
