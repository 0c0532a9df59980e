"""The port's Standardized Space stage 2 against the JAX package's, at the
JAX tests' TINY stage 1 (`_jax_reference.VQ_TINY`: 16^2 frames, hidden 32,
8-d codes, 64 codes a frame) and a CodeTalker of width 16 over 4 subjects:
the masks and the periodic encoding, cross-modal attention, CodeTalker
(with and without the two-subject style blend), `frame_vq_apply`, three
AdamW steps of `build_stage2_step` against optax.adamw, the autoregressive
`predict`, `eval_stage2` with LVE / FDD, and `cli infer-stage2` on the CPU
against the in-process predict.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _jax_reference import FAST_COMPILE, VQ_TINY, fast_jit, seeded_variables

from nerf3dtalker_tpu.config import VQConfig as JVQConfig
from nerf3dtalker_tpu.models.vq import stage2 as jstage2
from nerf3dtalker_tpu.models.vq import transformer as jtr
from nerf3dtalker_tpu.models.vq.stage1 import VQAutoEncoder as JVQAutoEncoder
from nerf3dtalker_tpu.train import vq_eval as jvq_eval
from nerf3dtalker_tpu.train.stage2_trainer import Stage2TrainState, build_stage2_step
from nerf3dtalker_tpu.utils import mesh_metrics as jmm
from nerf3dtalker_tpu_torch import cli
from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.models.vq import stage2, transformer
from nerf3dtalker_tpu_torch.models.vq.stage1 import VQAutoEncoder
from nerf3dtalker_tpu_torch.train import stage2_trainer, vq_eval
from nerf3dtalker_tpu_torch.utils import bridge, mesh_metrics
from nerf3dtalker_tpu_torch.utils.checkpoints import save_checkpoint

L, V3 = 16 * 32 // 8, 16 * 16 * 3       # codes a frame, values a frame at VQ_TINY
FEAT, SUBJ, AUDIO = 16, 4, 32           # CodeTalker's width, subjects, audio features
JCFG = dataclasses.replace(JVQConfig(**VQ_TINY), face_quan_num=L)
CFG = dataclasses.replace(VQConfig(**VQ_TINY), face_quan_num=L)
LR = 1e-4                                # build_stage2_step's default
# f32 on both sides, sums in other orders: forward outputs within this of
# max|ref| (measured up to 2e-6 through the stage-1 decoder)
RTOL = 1e-5
# every CodeTalker leaf after three AdamW steps, by the relative L2 of its
# change from the start (the change is ~3 lr an element)
DELTA_REL_L2 = 1e-2
# but the leaves whose gradient is 0 in exact arithmetic: a key projection's
# bias (softmax is invariant to a shift of a row; measured 2.9e-8 in f32
# against O(1) elsewhere), and the cross-attention's q and k, since the
# vocaset mask leaves one key a row. Adam divides each gradient element by
# its own RMS, so rounding there takes a step of full size whose sign it
# picks: such a leaf is held to what three steps can move it, 3 lr and the
# decay, on each side
ZERO_GRAD = ("dec_0.self_k.bias", "dec_0.cross_q.weight", "dec_0.cross_q.bias",
             "dec_0.cross_k.weight", "dec_0.cross_k.bias")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _t(x):
    return torch.as_tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _vq_params():
    img, au = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 5, 256))
    p = seeded_variables(JVQAutoEncoder(JVQConfig(**VQ_TINY)).init, img, au, seed=3)
    # codebooks at the JAX init's scale, +-1/n
    rng = np.random.default_rng(4)
    for q in ("quantize", "quantize_au"):
        e = p["params"][q]["embedding"]
        p["params"][q]["embedding"] = rng.uniform(-1, 1, e.shape).astype(np.float32) / len(e)
    return p


def _port_vq():
    vq = VQAutoEncoder(VQConfig(**VQ_TINY), device="cpu")
    return bridge.load_into(vq, bridge.vq_state_dict(_vq_params())).eval()


def _batch(T=4, S=10, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:16, 0:16] / 16
    motion = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy * (1 + 0.2 * t)))
                       for t in range(T)])[..., None].repeat(3, -1)
    return {"audio_feats": rng.standard_normal((1, S, AUDIO)).astype(np.float32),
            "motion": motion.reshape(1, T, V3).astype(np.float32),
            "onehot": np.eye(SUBJ, dtype=np.float32)[[2]]}


def _jmodel():
    return jstage2.CodeTalker(JCFG, feature_dim=FEAT, n_subjects=SUBJ, vertice_dim=V3)


@functools.lru_cache(maxsize=None)
def _ct_params():
    b = _batch()
    return seeded_variables(_jmodel().init, b["audio_feats"], b["motion"], b["onehot"], seed=5)


def _port_model():
    m = stage2.CodeTalker(CFG, feature_dim=FEAT, n_subjects=SUBJ, vertice_dim=V3,
                          audio_dim=AUDIO, device="cpu")
    return bridge.load_into(m, bridge.codetalker_state_dict(_ct_params()))


@pytest.mark.parametrize("n_head,n,period", [(4, 30, 25), (6, 12, 5), (3, 7, 1)])
def test_masks_and_positional_encoding_match_jax(n_head, n, period):
    cases = [(d, T, S) for d in ("vocaset", "BIWI") for T, S in ((n, n), (n, 2 * n + 1),
                                                                  (2 * n, n))]
    x = np.random.default_rng(n).standard_normal((2, n, 8)).astype(np.float32)
    bias, causal, ppe, *enc_dec = fast_jit(lambda x: (
        jstage2.init_biased_mask(n_head, 40, period), jtr.biased_causal_mask(n, period),
        jstage2.periodic_positional_encoding(x, period, 40),
        *(jstage2.enc_dec_mask(T, S, d) for d, T, S in cases)))(x)
    np.testing.assert_allclose(stage2.init_biased_mask(n_head, n, period).numpy(),
                               np.asarray(bias)[:, :n, :n], rtol=1e-6)
    np.testing.assert_array_equal(transformer.biased_causal_mask(n, period).numpy(),
                                  np.asarray(causal))
    _close(stage2.periodic_positional_encoding(_t(x), period, 40), ppe, 1e-6)
    for (d, T, S), ref in zip(cases, enc_dec):
        np.testing.assert_array_equal(stage2.enc_dec_mask(T, S, d).numpy(), np.asarray(ref))


def test_cross_modal_attention_matches_jax():
    rng = np.random.default_rng(1)
    xa, xb = (rng.standard_normal((2, n, 16)).astype(np.float32) for n in (5, 7))
    mask = np.where(rng.uniform(size=(5, 7)) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    mod = jtr.CrossModalAttention(16, heads=4)
    params = seeded_variables(mod.init, xa, xb)
    port = bridge.load_into(transformer.CrossModalAttention(16, heads=4),
                            bridge.vq_state_dict(params))
    with torch.no_grad():
        _close(port(_t(xa), _t(xb), _t(mask)), fast_jit(mod.apply)(params, xa, xb, mask))


@pytest.mark.parametrize("blend", [False, True])
def test_codetalker_matches_jax(blend):
    b = _batch()
    kw = {"subject_onehot2": np.eye(SUBJ, dtype=np.float32)[[0]], "style_weight": 0.3} \
        if blend else {}
    ref = fast_jit(functools.partial(_jmodel().apply, **kw))(
        _ct_params(), b["audio_feats"], b["motion"], b["onehot"])
    with torch.no_grad():
        out = _port_model()(_t(b["audio_feats"]), _t(b["motion"]), _t(b["onehot"]),
                            **{k: _t(v) if k.endswith("2") else v for k, v in kw.items()})
    assert out.shape == (1, 4 * L, 8)
    _close(out, ref)


def test_codetalker_init_has_a_zero_code_head():
    m = stage2.CodeTalker(CFG, feature_dim=FEAT, n_subjects=SUBJ, vertice_dim=V3,
                          audio_dim=AUDIO, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not m.feat_map.weight.any()
    assert set(m.state_dict()) == set(bridge.codetalker_state_dict(_ct_params()))


def test_frame_vq_apply_matches_jax():
    j = jvq_eval.frame_vq_apply(JVQConfig(**VQ_TINY), _vq_params())
    p = vq_eval.frame_vq_apply(_port_vq())
    assert (p["codes_per_frame"], p["vertice_dim"]) == (j["codes_per_frame"], j["vertice_dim"])
    motion = _batch()["motion"]
    codes = np.random.default_rng(2).standard_normal((1, 2 * L, 8)).astype(np.float32) * 0.05
    gq_j, (qj, ij), dec_j = fast_jit(lambda m, c: (
        j["get_gt_quant"](m), j["quantize"](c), j["decode"](j["quantize"](c)[0])))(motion, codes)
    _close(p["get_gt_quant"](_t(motion)), gq_j)
    qp, ip = p["quantize"](_t(codes))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    _close(qp, qj)
    with torch.no_grad():
        _close(p["decode"](qp), dec_j)


@functools.lru_cache(maxsize=None)
def _jax_stage2():
    """(init, jitted train_step, predict) of the JAX build_stage2_step over
    the JAX frame_vq_apply."""
    jv = jvq_eval.frame_vq_apply(JVQConfig(**VQ_TINY), _vq_params())
    return build_stage2_step(JCFG, jv, V3, lr=LR, feature_dim=FEAT, n_subjects=SUBJ)


def _port_stage2(lr=LR):
    init, step, predict = stage2_trainer.build_stage2_step(
        CFG, vq_eval.frame_vq_apply(_port_vq()), V3, lr=lr, feature_dim=FEAT,
        n_subjects=SUBJ, audio_dim=AUDIO, device="cpu")
    state = init(torch.Generator().manual_seed(0), None)
    bridge.load_into(state.model, bridge.codetalker_state_dict(_ct_params()))
    return state, step, predict


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_three_adamw_steps_match_optax():
    params = _ct_params()
    opt = jax.eval_shape(optax.adamw(LR, weight_decay=2e-3).init, params)
    jstate = Stage2TrainState(params, jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), opt), np.zeros((), np.int32))
    batches = [_batch(seed=s) for s in range(3)]
    jstep = _jax_stage2()[1].lower(jstate, batches[0]).compile(compiler_options=FAST_COMPILE)
    state, step, _ = _port_stage2()
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    for b in batches:
        jstate, jm = jstep(jstate, b)
        state, m = step(state, {k: _t(v) for k, v in b.items()})
        for k in ("loss_motion", "loss_reg", "total_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL)
    assert state.step == 3
    want = bridge.codetalker_state_dict(jstate.params)
    start_j = bridge.codetalker_state_dict(params)
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(start[k].numpy(), start_j[k])
        if k in ZERO_GRAD:
            bound = 3 * LR * (1 + 2e-3 * np.abs(start_j[k]).max()) * (1 + 1e-6)
            assert np.abs(v.numpy() - start_j[k]).max() <= bound, k
            assert np.abs(want[k] - start_j[k]).max() <= bound, k
            continue
        err = _rel_l2(v.numpy() - start_j[k], want[k] - start_j[k])
        assert err <= DELTA_REL_L2, (k, err)


@functools.lru_cache(maxsize=None)
def _jax_prediction(T):
    b = _batch(T=T)
    predict = fast_jit(functools.partial(_jax_stage2()[2], T=T))
    return np.asarray(predict(_ct_params(), b["audio_feats"], b["onehot"]))


def test_predict_matches_jax_autoregressive_predict():
    T = 4
    b = _batch(T=T)
    _, _, predict = _port_stage2()
    out = predict(_port_model(), _t(b["audio_feats"]), _t(b["onehot"]), T)
    assert out.shape == (1, T, V3)
    _close(out, _jax_prediction(T))


def test_eval_stage2_metrics_match_jax(tmp_path):
    T = 4
    b = _batch(T=T)
    rng = np.random.default_rng(7)
    template = rng.uniform(0, 1, (V3 // 3, 3)).astype(np.float32)
    verts_gt = (template[None] + 0.1 * rng.standard_normal((T, V3 // 3, 3))).astype(np.float32)
    mouth, upper = list(range(0, 200, 3)), list(range(100, 256))
    kw = dict(verts_gt=verts_gt, template=template, mouth_map=mouth, upper_map=upper)
    jpred = _jax_prediction(T)
    ref = jvq_eval.eval_stage2(lambda *a: jpred, None, b["audio_feats"], b["onehot"], T, **kw)
    _, _, predict = _port_stage2()
    out_path = tmp_path / "pred.npy"
    got = vq_eval.eval_stage2(predict, _port_model(), _t(b["audio_feats"]), _t(b["onehot"]), T,
                              out_path=str(out_path), **kw)
    assert set(got) == set(ref) == {"num_frames", "LVE", "FDD"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4)
    assert np.load(out_path).shape == (1, T, V3)
    # the numpy metrics themselves, on the same arrays
    vp = jpred[0].reshape(T, -1, 3)
    assert mesh_metrics.lip_vertex_error(verts_gt, vp, mouth) == jmm.lip_vertex_error(
        verts_gt, vp, mouth)
    assert mesh_metrics.fdd(verts_gt, vp, template, upper) == jmm.fdd(verts_gt, vp, template,
                                                                        upper)


def test_cli_infer_stage2_equals_in_process_predict(tmp_path, capsys):
    import wave

    from nerf3dtalker_tpu_torch.data.mel import read_wav_mono
    from nerf3dtalker_tpu_torch.models.vq import wav2vec as w2v

    sr, n = 16000, 3300
    pcm = 0.3 * np.sin(2 * np.pi * 140 * np.arange(n) / sr)
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((pcm * 32767).astype(np.int16).tobytes())
    vq = _port_vq()
    save_checkpoint(str(tmp_path / "vq"), {"config": dataclasses.asdict(vq.cfg), "crop_size": 48,
                                           "vq": vq.state_dict(), "au": {}}, 1)
    # a CodeTalker over the small encoder's 768-d features, its code head
    # not zero
    model = stage2.CodeTalker(CFG, feature_dim=FEAT, n_subjects=SUBJ, vertice_dim=V3,
                              device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.feat_map.weight.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(4))
    save_checkpoint(str(tmp_path / "s2"), stage2_trainer.codetalker_payload(model), 1)
    out = tmp_path / "frames.npy"
    rec = cli.main(["infer-stage2", "--wav", str(wav), "--vq-ckpt", str(tmp_path / "vq"),
                    "--ckpt", str(tmp_path / "s2"), "--img-size", "16", "--subject", "1",
                    "--device", "cpu", "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    T = int(n / sr * 25)
    assert rec == {"out": str(out), "frames": T, "img_size": 16, "finite": True,
                   "num_frames": float(T)}
    # in process: the same seeded small encoder, stage 1 and CodeTalker
    enc = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**cli.SMALL_WAV2VEC), device="cpu",
                              generator=torch.Generator().manual_seed(0)).eval()
    pcm_r, _ = read_wav_mono(str(wav))
    with torch.no_grad():
        feats = w2v.encode_audio(enc, w2v.normalize_wav(torch.as_tensor(pcm_r[None])), T)
    _, _, predict = stage2_trainer.build_stage2_step(CFG, vq_eval.frame_vq_apply(vq), V3,
                                                     device="cpu")
    want = predict(model.eval(), feats, torch.eye(SUBJ)[[1]], T).numpy()
    got = np.load(out)
    assert got.shape == (1, T, V3) and np.ptp(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
