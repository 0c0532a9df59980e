"""The port's SadTalker audio -> expression path against the JAX package's:
`SimpleWrapperV2` (with non-trivial BatchNorm running statistics),
`audio2exp_sequence`, `FusAudio2Style`, the safetensors reader and
`convert_simple_wrapper_v2`, `Audio2Coeff`, `savgol_smooth_pose`,
`blink_ratio_sequence`, the placeholder TTS, one step of each trainer and
`cli infer-coeff` on the CPU against JAX's `cmd_infer_coeff`.
"""

import argparse
import functools
import json

import jax
import numpy as np
import optax
import pytest
import torch
from _jax_reference import fast_jit, seeded_variables

from nerf3dtalker_tpu import cli as jcli
from nerf3dtalker_tpu.data import ingest as jingest
from nerf3dtalker_tpu.data import mel as jmel
from nerf3dtalker_tpu.data import tts as jtts
from nerf3dtalker_tpu.models import audio as jaudio
from nerf3dtalker_tpu.models.audio2coeff import Audio2Coeff as JAudio2Coeff
from nerf3dtalker_tpu.models.audio2pose import savgol_smooth_pose as j_savgol
from nerf3dtalker_tpu.train import audio2exp_trainer as ja2e
from nerf3dtalker_tpu.train import disexp_trainer as jdis
from nerf3dtalker_tpu.utils.convert import convert_simple_wrapper_v2 as j_convert
from nerf3dtalker_tpu_torch import cli
from nerf3dtalker_tpu_torch.data import ingest, mel, tts
from nerf3dtalker_tpu_torch.models import audio
from nerf3dtalker_tpu_torch.models.audio2coeff import Audio2Coeff
from nerf3dtalker_tpu_torch.models.audio2pose import savgol_smooth_pose
from nerf3dtalker_tpu_torch.train import audio2exp_trainer, disexp_trainer
from nerf3dtalker_tpu_torch.utils import bridge
from nerf3dtalker_tpu_torch.utils.convert import convert_simple_wrapper_v2

# f32 on both sides, sums in other orders through 13 conv blocks (measured
# up to 1e-6 of max|ref|)
RTOL = 1e-5
# one Adam step: each leaf's change from the start by its relative L2 (the
# change is ~lr an element; Adam divides each gradient element by its own
# RMS, so a rounding-sized one takes a step of full size whose sign the
# rounding picks)
DELTA_REL_L2 = 1e-2
PREFIX = "audio2exp.audio2exp_model.netG."


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _mels(T, seed=0):
    return np.random.default_rng(seed).uniform(-4, 4, (T, 80, 16)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _netg_vars():
    """SimpleWrapperV2 variables: kernels N(0, 1/fan_in), BN running means
    N(0, 0.1^2) and variances in [0.5, 1.5]."""
    return seeded_variables(jaudio.SimpleWrapperV2().init, np.zeros((1, 80, 16, 1), np.float32),
                            np.zeros((1, 64), np.float32), np.zeros((1, 1), np.float32), seed=1)


def _port_netg(variables=None):
    netg = audio.SimpleWrapperV2(device="cpu")
    return bridge.load_into(netg, bridge.simple_wrapper_v2_state_dict(variables or _netg_vars()))


def _sadtalker_state_dict(variables):
    """The JAX variables in SadTalker's torch layout (`audio_encoder.{i}.
    conv_block.{0,1}`, `mapping1`), with a num_batches_tracked per norm."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {"mapping1.weight": p["mapping1"]["kernel"].T, "mapping1.bias": p["mapping1"]["bias"]}
    for i in range(13):
        c, b = f"audio_encoder.{i}.conv_block.0", f"audio_encoder.{i}.conv_block.1"
        sd[f"{c}.weight"] = p[f"enc_{i}"]["conv"]["kernel"].transpose(3, 2, 0, 1)
        sd[f"{c}.bias"] = p[f"enc_{i}"]["conv"]["bias"]
        sd[f"{b}.weight"], sd[f"{b}.bias"] = (p[f"enc_{i}"]["bn"][k] for k in ("scale", "bias"))
        sd[f"{b}.running_mean"], sd[f"{b}.running_var"] = (s[f"enc_{i}"]["bn"][k]
                                                           for k in ("mean", "var"))
        sd[f"{b}.num_batches_tracked"] = np.asarray(100 + i, np.int64)
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def sadtalker_file(tmp_path_factory):
    """A SadTalker-layout safetensors file of the seeded netG (and one
    tensor of another model)."""
    from safetensors.numpy import save_file

    path = str(tmp_path_factory.mktemp("sadtalker") / "SadTalker.safetensors")
    sd = {PREFIX + k: v for k, v in _sadtalker_state_dict(_netg_vars()).items()}
    sd["kp_extractor.conv.weight"] = np.ones((2, 3), np.float32)
    save_file(sd, path)
    return path


def test_simple_wrapper_v2_matches_jax():
    rng = np.random.default_rng(2)
    mel_b = rng.uniform(-4, 4, (3, 80, 16, 1)).astype(np.float32)
    ref = rng.standard_normal((3, 64)).astype(np.float32)
    ratio = rng.uniform(0, 1, (3, 1)).astype(np.float32)
    want = fast_jit(jaudio.SimpleWrapperV2().apply)(_netg_vars(), mel_b, ref, ratio)
    with torch.no_grad():
        got = _port_netg()(_t(mel_b).permute(0, 3, 1, 2), _t(ref), _t(ratio))
    _close(got, want)


def test_audio2exp_sequence_matches_jax():
    mels, ref = _mels(6), np.random.default_rng(3).standard_normal(64).astype(np.float32)
    ratios = np.linspace(0, 1, 6, dtype=np.float32)
    want = fast_jit(lambda v, m, r, q: jaudio.audio2exp_sequence(
        jaudio.SimpleWrapperV2().apply, v, m, r, q))(_netg_vars(), mels[..., None], ref, ratios)
    with torch.no_grad():
        got = audio.audio2exp_sequence(_port_netg(), _t(mels), _t(ref), _t(ratios))
    _close(got, want)


def test_fus_audio2style_matches_jax():
    rng = np.random.default_rng(4)
    f1, f2 = (rng.standard_normal((5, 64)).astype(np.float32) for _ in range(2))
    mod = jaudio.FusAudio2Style()
    params = seeded_variables(mod.init, f1, f2, seed=2)
    port = bridge.load_into(audio.FusAudio2Style(device="cpu"), bridge.vq_state_dict(params))
    with torch.no_grad():
        _close(port(_t(f1), _t(f2)), fast_jit(mod.apply)(params, f1, f2))


def test_safetensors_reader_and_converter_match_jax(sadtalker_file):
    got = ingest.load_safetensors_prefix(sadtalker_file, "audio2exp")
    want = jingest.load_safetensors_prefix(sadtalker_file, "audio2exp")
    assert set(got) == set(want) and len(got) == 13 * 7 + 2
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    inner = {k[len(PREFIX) - len("audio2exp."):]: v for k, v in got.items()}
    port_sd = convert_simple_wrapper_v2(inner)
    jax_sd = bridge.simple_wrapper_v2_state_dict(j_convert(inner))
    assert set(port_sd) == set(jax_sd)
    for k, v in jax_sd.items():
        if k.endswith("num_batches_tracked"):
            assert port_sd[k] == inner[k]
        else:
            np.testing.assert_array_equal(port_sd[k], v)


@pytest.fixture
def jitted_jax_audio2exp(monkeypatch):
    """JAX's `audio2exp_sequence` compiled whole where `Audio2Coeff.generate`
    looks it up (the same function; eagerly, each op compiles on its own)."""
    netg_apply = jaudio.SimpleWrapperV2().apply
    compiled = fast_jit(lambda v, m, r, q: JAX_AUDIO2EXP(netg_apply, v, m, r, q))
    monkeypatch.setattr(jaudio, "audio2exp_sequence",
                        lambda apply_fn, v, m, r, q: compiled(v, m, r, q))


JAX_AUDIO2EXP = jaudio.audio2exp_sequence


def test_audio2coeff_generate_matches_jax(sadtalker_file, jitted_jax_audio2exp):
    T = 50      # the CLI test's frames: one compile of the JAX reference
    mels, ref = _mels(T, seed=5), np.random.default_rng(5).standard_normal(64)
    ratios = jmel.blink_ratio_sequence(T, np.random.default_rng(0))
    pose = np.random.default_rng(6).standard_normal((T, 6)).astype(np.float32)
    want = JAudio2Coeff.from_safetensors(sadtalker_file).generate(mels, ref, ratios, pose)
    got = Audio2Coeff.from_safetensors(sadtalker_file, device="cpu").generate(
        mels, ref, ratios, pose)
    _close(got["exp"], want["exp"])
    np.testing.assert_array_equal(got["pose"], want["pose"])
    zero = Audio2Coeff().generate(mels, ref, ratios)
    assert set(zero) == {"exp"} and not zero["exp"].any()


@pytest.mark.parametrize("T", [2, 5, 12, 30])
def test_savgol_smooth_pose_matches_jax(T):
    pose = np.random.default_rng(T).standard_normal((T, 6)).astype(np.float32)
    np.testing.assert_array_equal(savgol_smooth_pose(pose), j_savgol(pose))


@pytest.mark.parametrize("T,seed", [(10, 0), (21, 1), (64, 2), (300, 3)])
def test_blink_ratio_sequence_matches_jax(T, seed):
    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    try:
        want = jmel.blink_ratio_sequence(T, rng_j)
    except ValueError:          # 21 frames: the JAX draw's range is empty
        with pytest.raises(ValueError):
            mel.blink_ratio_sequence(T, rng_p)
        return
    np.testing.assert_array_equal(mel.blink_ratio_sequence(T, rng_p), want)
    assert rng_p.bit_generator.state == rng_j.bit_generator.state


def test_placeholder_tts_is_byte_for_byte_jax(tmp_path):
    for text in ("hello world, this is a test", ""):
        p = tts.synthesize_placeholder(text, str(tmp_path / "port.wav"))
        j = jtts.synthesize_placeholder(text, str(tmp_path / "jax.wav"))
        assert open(p, "rb").read() == open(j, "rb").read()
    with pytest.raises(ImportError, match="coqui-tts"):
        tts.TTSTalker()


def _a2e_batch(B=2, T=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"mels": rng.uniform(-4, 4, (B, T, 80, 16)).astype(np.float32),
            "expr79": rng.standard_normal((B, T, 79)).astype(np.float32),
            "expr79_0": rng.standard_normal((B, 79)).astype(np.float32),
            "ratios": rng.uniform(0, 1, (B, T)).astype(np.float32)}


def _delta_check(start, got, want):
    """Every leaf's change from `start` against JAX's, by relative L2."""
    for k, v in got.items():
        a, b = (np.asarray(x, np.float64) - start[k] for x in (v, want[k]))
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= DELTA_REL_L2, (k, err)


def test_audio2exp_step_matches_jax():
    lr = 1e-3      # the trainer's 1e-7 moves an f32 leaf by less than its rounding
    variables = _netg_vars()
    opt = jax.eval_shape(optax.adam(lr).init, variables)
    jstate = ja2e.A2ETrainState(variables, jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), opt), np.zeros((), np.int32))
    batch = _a2e_batch()
    jstate, jm = fast_jit(ja2e.build_audio2exp_step(lr)[1])(jstate, batch)
    init, step, _ = audio2exp_trainer.build_audio2exp_step(lr, device="cpu")
    state = init(torch.Generator().manual_seed(0), None)
    bridge.load_into(state.netg, bridge.simple_wrapper_v2_state_dict(variables))
    state, m = step(state, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["exp_loss"]), float(jm["exp_loss"]), rtol=RTOL)
    start = bridge.simple_wrapper_v2_state_dict(variables)
    want = bridge.simple_wrapper_v2_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                        jstate.params))
    got = {k: v.detach().numpy() for k, v in state.netg.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    # the running statistics move as JAX moves them: by Adam, not by a batch
    assert np.abs(got["audio_encoder.0.conv_block.1.running_var"]
                  - start["audio_encoder.0.conv_block.1.running_var"]).max() > lr / 2
    _delta_check(start, got, want)
    assert audio2exp_trainer.BIAN.shape == (64,)
    np.testing.assert_array_equal(
        audio2exp_trainer.select_expr64(_t(batch["expr79"])).numpy(),
        np.asarray(ja2e.select_expr64(batch["expr79"])))


def test_disexp_step_matches_jax():
    from nerf3dtalker_tpu_torch.models.audio import Audio2Style

    lr = 1e-4
    rng = np.random.default_rng(7)
    batch = {"mels": rng.uniform(-4, 4, (2, 80, 16)).astype(np.float32),
             "auds_exp": rng.standard_normal((2, 64)).astype(np.float32),
             "sad_exp": rng.standard_normal((2, 64)).astype(np.float32)}
    a_vars = seeded_variables(jaudio.Audio2Style().init, batch["mels"], seed=8)
    f_vars = seeded_variables(jaudio.FusAudio2Style().init, batch["auds_exp"],
                              batch["auds_exp"], seed=9)
    opt = jax.eval_shape(optax.adam(lr).init, f_vars)
    jstate = jdis.DisexpTrainState(f_vars, a_vars, jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), opt), np.zeros((), np.int32))
    jstate, jm = fast_jit(jdis.build_disexp_step(lr)[1])(jstate, batch)
    init, step = disexp_trainer.build_disexp_step(lr, device="cpu")
    state = init(torch.Generator().manual_seed(0), None)
    assert isinstance(state.audio, Audio2Style)
    assert not any(p.requires_grad for p in state.audio.parameters())
    bridge.load_into(state.audio, bridge.audio2style_state_dict(a_vars))
    bridge.load_into(state.fus, bridge.vq_state_dict(f_vars))
    state, m = step(state, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["exp_loss"]), float(jm["exp_loss"]), rtol=RTOL)
    got = {k: v.numpy() for k, v in state.fus.state_dict().items()}
    _delta_check(bridge.vq_state_dict(f_vars), got, bridge.vq_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.fus_params)))
    np.testing.assert_array_equal(state.audio.linear1.weight.numpy(),
                                  bridge.audio2style_state_dict(a_vars)["linear1.weight"])


@pytest.mark.parametrize("source", ["wav", "text"])
def test_cli_infer_coeff_matches_jax(tmp_path, sadtalker_file, capsys, jitted_jax_audio2exp,
                                    source):
    if source == "wav":
        wav = tts.synthesize_placeholder("one two three four five", str(tmp_path / "in.wav"))
        flags = ["--wav", wav]
    else:
        flags = ["--text", "one two three four five"]
    port_out, jax_out = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    rec = cli.main(["infer-coeff", *flags, "--safetensors", sadtalker_file, "--seed", "3",
                    "--device", "cpu", "--out", port_out])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    args = argparse.Namespace(wav=flags[1] if source == "wav" else "",
                              text=flags[1] if source == "text" else "",
                              safetensors=sadtalker_file, fps=25, seed=3, out=jax_out)
    jcli.cmd_infer_coeff(args)
    got, want = dict(np.load(port_out)), dict(np.load(jax_out))
    assert set(got) == set(want) == {"exp", "pose", "mels", "ratios"}
    assert rec["frames"] == len(want["exp"]) == 50
    _close(got["exp"], want["exp"])
    for k in ("pose", "mels", "ratios"):
        np.testing.assert_array_equal(got[k], want[k])
