"""The port's subject preprocessing against the JAX package's:
`preprocess_subject` with placeholders and the port's `cli preprocess
--device cpu` against JAX's `cmd_preprocess`; `build_appliers(weights=...)`
on both sides with the same bridged weights, stage by stage (BiSeNet masks,
FAN landmarks, netG expressions) and as a whole (the fit fed the same
masks and landmarks on both sides); strict mode refusing a missing stage;
and the subject it wrote loading as a training dataset. The JAX
networks are applied through `jitted_class` (one compile each, shared
with `test_torch_face_nets.py`), its fit through `fast_fit3dmm`.
"""

import argparse
import json
import wave

import numpy as np
import pytest
from _jax_reference import (
    face_net,
    fast_fit3dmm,
    fast_jit,
    jitted_class,
    netg_variables,
    nl3dmm_variables,
)

from nerf3dtalker_tpu import cli as jcli
from nerf3dtalker_tpu.data import preprocess as jpre
from nerf3dtalker_tpu.models import audio as jaudio
from nerf3dtalker_tpu.models import bisenet as jbisenet
from nerf3dtalker_tpu.models import fan as jfan
from nerf3dtalker_tpu_torch import cli
from nerf3dtalker_tpu_torch.data import preprocess
from nerf3dtalker_tpu_torch.utils import bridge

# the placeholder arrays and the mel / blink front end: the same numpy code
PLAIN_ATOL = 1e-6
# masks: the parsing argmax of f32 logits computed in another order may
# flip at a near tie
MASK_AGREE = 0.99
# landmarks move in quarter-heatmap-pixel steps (S / 64 output pixels at
# the 64^2 heatmaps): within one step of JAX's on LM_AGREE of them
LM_AGREE = 0.95
# netG: f32 through 13 conv blocks
NETG_RTOL = 1e-5
# the whole strict path, fed the same masks and landmarks: the fit's Adam
# over (2, 3) iterations and what follows from it, by max|err| / max|ref|
FIT_RTOL = 1e-3
T, S = 2, 32       # B=2 frames: the JAX networks compile at test_torch_face_nets.py's shapes


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S] / S
    blob = np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.04)
    images = np.clip(0.3 + 0.5 * blob[None, ..., None]
                     + 0.1 * rng.standard_normal((T, S, S, 3)), 0, 1).astype(np.float32)
    wav = (rng.standard_normal(16000 // 25 * (T + 1)) * 0.1).astype(np.float32)
    return images, wav


def _write_inputs(tmp_path):
    images, wav = _inputs()
    frames = tmp_path / "frames.npy"
    np.save(frames, images)
    path = tmp_path / "speech.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
    return str(frames), str(path)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("missing", ["bisenet_apply", "fan_apply", "netg_apply", "fit3dmm_fn"])
def test_strict_raises_on_a_missing_stage(missing):
    images, wav = _inputs()
    stages = {n: (lambda *a: None) for n in ("bisenet_apply", "fan_apply", "netg_apply",
                                             "fit3dmm_fn") if n != missing}
    with pytest.raises(ValueError, match=f"missing model stages \\['{missing}'\\]"):
        preprocess.preprocess_subject(images, wav, strict=True, **stages)


def test_placeholders_and_cli_match_jax(tmp_path):
    """Without networks: preprocess_subject, and `cli preprocess --device
    cpu` against JAX's cmd_preprocess on the same files, every array within
    PLAIN_ATOL."""
    images, wav = _inputs()
    want = jpre.preprocess_subject(images, wav, featmap_size=8, seed=3)
    got = preprocess.preprocess_subject(images, wav, featmap_size=8, seed=3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PLAIN_ATOL, err_msg=k)

    frames, speech = _write_inputs(tmp_path)
    jcli.cmd_preprocess(argparse.Namespace(frames=frames, wav=speech, featmap_size=8, seed=3,
                                           strict=False, out=str(tmp_path / "jax.npz")))
    rec = cli.main(["preprocess", "--device", "cpu", "--frames", frames, "--wav", speech,
                    "--featmap-size", "8", "--seed", "3", "--out", str(tmp_path / "port.npz")])
    assert rec["device"] == "cpu" and rec["frames"] == T and not rec["strict"]
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_allclose(zp[k], zj[k], rtol=0, atol=PLAIN_ATOL, err_msg=k)


def _weights():
    """(JAX weights, the port's state dicts) of the four stages."""
    jw = {"bisenet": face_net("bisenet")[1], "fan": face_net("fan", 1)[1],
          "netg": netg_variables(), "nl3dmm": nl3dmm_variables(7)}
    pw = {"bisenet": bridge.bn_net_state_dict(jw["bisenet"]),
          "fan": bridge.bn_net_state_dict(jw["fan"]),
          "netg": bridge.simple_wrapper_v2_state_dict(jw["netg"]),
          "nl3dmm": tuple(bridge.nl3dmm_state_dict(v) for v in jw["nl3dmm"])}
    return jw, pw


@pytest.fixture
def jax_appliers(monkeypatch):
    """JAX's build_appliers with the JAX weights, BiSeNet and FAN applied
    through `jitted_class`, the heatmap decoding and netG's sequence
    jitted."""
    import functools

    import jax

    for mod, name in ((jbisenet, "BiSeNet"), (jfan, "FAN")):
        monkeypatch.setattr(mod, name, jitted_class(getattr(mod, name)))
    monkeypatch.setattr(jfan, "decode_heatmaps",
                        jax.jit(jfan.decode_heatmaps, static_argnames="crop_size"))
    seq = fast_jit(functools.partial(jaudio.audio2exp_sequence,
                                     jaudio.SimpleWrapperV2().apply))
    monkeypatch.setattr(jaudio, "audio2exp_sequence", lambda _, *a: seq(*a))
    return jpre.build_appliers(S, seed=0, weights=_weights()[0], fit_iters=(2, 3))


def _port_appliers():
    return preprocess.build_appliers(S, seed=0, weights=_weights()[1], fit_iters=(2, 3),
                                     device="cpu")


def test_strict_stages_match_jax(jax_appliers):
    """The same bridged weights: the parsing and the cleaned head masks on
    >= MASK_AGREE of the pixels, the landmarks within a quarter heatmap
    pixel on >= LM_AGREE, netG's expressions to NETG_RTOL."""
    images, _ = _inputs()
    port = _port_appliers()
    pj, pp = np.asarray(jax_appliers["bisenet_apply"](images)), port["bisenet_apply"](images)
    assert pp.shape == (T, S, S) and (pp == pj).mean() >= MASK_AGREE
    masks = [np.stack([jbisenet.correct_head_mask(m) for m in
                       np.asarray(jbisenet.head_mask_from_parsing(p))]) for p in (pj, pp)]
    assert (masks[0] == masks[1]).mean() >= MASK_AGREE

    lj, lp = np.asarray(jax_appliers["fan_apply"](images)), port["fan_apply"](images)
    assert lp.shape == (T, 68, 2)
    step = 0.25 * S / 64
    assert (np.abs(lp - lj).max(-1) <= step + 1e-6).mean() >= LM_AGREE

    rng = np.random.default_rng(1)
    mels = rng.uniform(-4, 4, (T, 80, 16)).astype(np.float32)
    ref = (0.3 * rng.standard_normal(64)).astype(np.float32)
    ratios = rng.uniform(0, 1, T).astype(np.float32)
    ej = np.asarray(jax_appliers["netg_apply"](mels, ref, ratios))
    assert _max_rel(port["netg_apply"](mels, ref, ratios), ej) <= NETG_RTOL


def test_strict_path_matches_jax(jax_appliers, tmp_path):
    """preprocess_subject(strict=True) through both sides' appliers, JAX's
    fed the port's parsing and landmarks (so that no discrete flip upstream
    decides the fit): every array within FIT_RTOL; the discrete choices in
    which the two sides' own parsing and landmarks differ are counted in
    the message. Then `load_subject` gives the FrameDataset that `cli train
    --data` trains on."""
    images, wav = _inputs()
    port = _port_appliers()
    got = preprocess.preprocess_subject(images, wav, featmap_size=8, seed=2, strict=True,
                                        **port)
    parsing, lms = port["bisenet_apply"](images), port["fan_apply"](images)
    flips = {"parsing_pixels": int((np.asarray(jax_appliers["bisenet_apply"](images))
                                    != parsing).sum()),
             "landmark_coords": int((np.asarray(jax_appliers["fan_apply"](images))
                                     != lms).sum())}
    with fast_fit3dmm():
        want = jpre.preprocess_subject(images, wav, featmap_size=8, seed=2, strict=True,
                                       **{**jax_appliers, "bisenet_apply": lambda _: parsing,
                                          "fan_apply": lambda _: lms})
    assert sorted(got) == sorted(want)
    errs = {k: _max_rel(got[k], want[k]) for k in want}
    assert max(errs.values()) <= FIT_RTOL, (errs, flips)
    assert not np.allclose(got["Tvec"][:, 2], 12.0)           # the fit ran
    assert np.abs(got["audio_exp"]).max() > 0                 # netG ran
    print(json.dumps({"strict_path_max_rel": max(errs.values()), "discrete_flips": flips}))

    path = tmp_path / "subject.npz"
    preprocess.save_subject(str(path), got)
    ds = preprocess.load_subject(str(path), featmap_size=8)
    assert ds.num_frames == T and ds.batch(np.arange(2))["gt_rgb"].shape == (2, S, S, 3)

