"""The port's wav2vec2 encoder (`models/vq/wav2vec.py`) against the JAX
package's, at a tiny topology (`_jax_reference.W2V_TINY`: convs 16/16,
kernels 10/3, strides 5/2, hidden 32, 2 layers, 4 heads, pos conv 16 in 4
groups): the encoder on the same weights, the frame resampling, the audio
encoding, the normalization, the local HF-directory loader (both weight-norm
spellings, .bin and .safetensors) and the refusals of other HF topologies.
"""

import functools
import json
import types

import numpy as np
import pytest
import torch
from _jax_reference import W2V_TINY, fast_jit, wav2vec_tiny

from nerf3dtalker_tpu.models.vq import wav2vec as jw2v
from nerf3dtalker_tpu_torch.models.vq import wav2vec as w2v
from nerf3dtalker_tpu_torch.utils import bridge

# f32 on both sides, sums in other orders through 2 convs, 2 encoder layers
# and 5 norms (measured up to 6e-7 of max|ref|)
ENC_RTOL = 1e-5
# the port takes the resampling's positions in f64, JAX's linspace in f32: a
# position off by an f32 ulp of T moves the value by that times the step
# between two frames (measured 1.8e-6 at T=10; 1.2e-5 of max|ref| for the
# encoder's 159 frames to 95)
RESAMPLE_ATOL = 1e-5
RESAMPLED_RTOL = 5e-5
CFG = w2v.Wav2Vec2Config(**W2V_TINY)


def _wav(B=2, N=1600, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 16000
    return (0.4 * np.sin(2 * np.pi * rng.uniform(100, 300, (B, 1)) * t)
            + 0.05 * rng.standard_normal((B, N))).astype(np.float32)


def _port(params):
    enc = w2v.Wav2Vec2Encoder(CFG, device="cpu")
    return bridge.load_into(enc, bridge.vq_state_dict(params)).eval()


def _close(out, ref, rtol=ENC_RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= rtol, err


def test_encoder_matches_jax():
    _, params, apply = wav2vec_tiny()
    wav = _wav()
    ref = apply(params, wav)
    with torch.no_grad():
        out = _port(params)(torch.as_tensor(wav))
    assert out.shape == (2, 159, 32)
    _close(out, ref)


@pytest.mark.parametrize("T,target", [(7, 12), (12, 7), (5, 5), (1, 4), (6, 1), (10, 30)])
def test_resample_frames_aligned_matches_jax(T, target):
    x = np.random.default_rng(T * 100 + target).standard_normal((2, T, 3)).astype(np.float32)
    ref = fast_jit(functools.partial(jw2v.resample_frames_aligned, target_len=target))(x)
    out = w2v.resample_frames_aligned(torch.as_tensor(x), target)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=RESAMPLE_ATOL)


@functools.lru_cache(maxsize=None)
def _jax_encoded():
    """(wav, JAX normalize_wav, {frames: JAX encode_audio}) in one compile."""
    mod, params, _ = wav2vec_tiny()
    wav = 3.0 * _wav(seed=1) + 0.2
    jn, *enc = fast_jit(lambda p, w: (jw2v.normalize_wav(w), *(jw2v.encode_audio(
        p, jw2v.normalize_wav(w), f, model=mod) for f in (None, 20))))(params, wav)
    return wav, jn, dict(zip((None, 20), enc))


@pytest.mark.parametrize("frames", [None, 20])
def test_encode_audio_and_normalize_wav_match_jax(frames):
    _, params, _ = wav2vec_tiny()
    wav, jn, enc = _jax_encoded()
    ref = enc[frames]
    pn = w2v.normalize_wav(torch.as_tensor(wav))
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=0, atol=1e-5)
    with torch.no_grad():
        out = w2v.encode_audio(_port(params), pn, frames)
    assert out.shape[1] == (frames or int(159 / 50 * 30))
    _close(out, ref, RESAMPLED_RTOL)


def _hf_layout(params, spelling):
    """The JAX encoder's weights in an HF Wav2Vec2Model state dict (numpy,
    `wav2vec2.` prefixed as in a pre-training checkpoint, with one key of
    another head), the position conv weight-normed in `spelling`. Returns
    (state dict, the effective position kernel in flax layout)."""
    p = params["params"]
    conv = lambda k: np.transpose(k, (2, 1, 0))          # noqa: E731 (flax WIO -> OIW)
    sd = {"masked_spec_embed": np.zeros(32, np.float32), "quantizer.codevectors": np.ones(3)}
    for i in range(2):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = conv(
            p["feature_extractor"][f"conv{i}"]["kernel"])
    gn = p["feature_extractor"]["group_norm"]
    sd["feature_extractor.conv_layers.0.layer_norm.weight"] = gn["scale"]
    sd["feature_extractor.conv_layers.0.layer_norm.bias"] = gn["bias"]

    def lin(dst, d):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = d["kernel"].T, d["bias"]

    def ln(dst, d):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = d["scale"], d["bias"]

    ln("feature_projection.layer_norm", p["fp_layer_norm"])
    lin("feature_projection.projection", p["fp_projection"])
    ln("encoder.layer_norm", p["enc_layer_norm"])
    for i in range(2):
        lp, base = p[f"layer{i}"], f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{base}.attention.{n}", lp[n])
        ln(f"{base}.layer_norm", lp["layer_norm"])
        lin(f"{base}.feed_forward.intermediate_dense", lp["intermediate_dense"])
        lin(f"{base}.feed_forward.output_dense", lp["output_dense"])
        ln(f"{base}.final_layer_norm", lp["final_layer_norm"])
    rng = np.random.default_rng(5)
    v = rng.standard_normal((32, 8, 16)).astype(np.float32)        # [out, in/g, k]
    g = rng.uniform(0.5, 2.0, (1, 1, 16)).astype(np.float32)
    g_key, v_key = {"old": ("weight_g", "weight_v"),
                    "new": ("parametrizations.weight.original0",
                            "parametrizations.weight.original1")}[spelling]
    sd[f"encoder.pos_conv_embed.conv.{g_key}"] = g
    sd[f"encoder.pos_conv_embed.conv.{v_key}"] = v
    sd["encoder.pos_conv_embed.conv.bias"] = p["pos_conv"]["bias"]
    # the effective kernel, computed here: the norm over dims 0 and 1 per tap
    w = g * v / np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    return ({f"wav2vec2.{k}": np.ascontiguousarray(a, np.float32) for k, a in sd.items()},
            conv(w))


def _hf_config(**over):
    return {"architectures": ["Wav2Vec2Model"], "conv_dim": [16, 16], "conv_kernel": [10, 3],
            "conv_stride": [5, 2], "conv_bias": False, "hidden_size": 32,
            "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
            "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
            "feat_extract_norm": "group", "do_stable_layer_norm": False, **over}


@pytest.mark.parametrize("spelling,fmt", [("old", "bin"), ("new", "safetensors")])
def test_hf_directory_loader_matches_jax(tmp_path, spelling, fmt):
    from safetensors.numpy import save_file

    mod, params, apply = wav2vec_tiny()
    sd, w_eff = _hf_layout(params, spelling)
    (tmp_path / "config.json").write_text(json.dumps(_hf_config()))
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / "pytorch_model.bin")
    else:
        save_file(sd, str(tmp_path / "model.safetensors"))
    ref_params = {"params": {**params["params"],
                             "pos_conv": {**params["params"]["pos_conv"], "kernel": w_eff}}}
    wav = _wav(seed=2)
    ref = apply(ref_params, wav)
    enc = w2v.load_hf_wav2vec2(str(tmp_path), device="cpu")
    assert enc.cfg == CFG
    with torch.no_grad():
        _close(enc(torch.as_tensor(wav)), ref)


@pytest.mark.parametrize("over,match", [({"feat_extract_norm": "layer"}, "feat_extract_norm"),
                                        ({"do_stable_layer_norm": True}, "do_stable_layer_norm")])
def test_other_hf_topologies_are_refused(tmp_path, over, match):
    cfg = _hf_config(**over)
    with pytest.raises(NotImplementedError, match=match):
        jw2v._check_hf_arch(types.SimpleNamespace(**cfg))
    with pytest.raises(NotImplementedError, match=match):
        w2v.check_hf_arch(cfg)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match=match):
        w2v.load_hf_wav2vec2(str(tmp_path), device="cpu")
