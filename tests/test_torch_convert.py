"""The port's reference-checkpoint converters (`utils/convert.py`) on
synthetic torch modules in the reference's layer spec and key schema (the
oracles of `tests/test_convert.py`, and an NCHW `classifier_AU`): the port
module loaded with the converted state dict must give the oracle's output,
and each converter must equal the bridge of the JAX converter's tree
(`utils/bridge.py` of `nerf3dtalker_tpu/utils/convert.py`), exactly (both
only move and add the same f32 values). `convert_checkpoint` reads a
synthetic checkpoint with `para` saved to disk.

Tolerances against the oracles: f32 in another summation order (the
MLP's 1x1 convs against the port's matmuls, cuDNN-free LSTMs on both
sides), within 2e-5 of max|ref|.
"""

import argparse

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_convert import _torch_mlp, _torch_mlp_forward, _TorchAudio2Style
from torch import nn
import _jax_reference  # noqa: F401  (each xdist worker's share of torch threads)

from nerf3dtalker_tpu.utils import convert as jconvert
from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.models.audio import Audio2Style
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.models.nerf_mlp import NeRFMLP
from nerf3dtalker_tpu_torch.models.vq.au_classifier import AUClassifier
from nerf3dtalker_tpu_torch.utils import bridge, convert

RTOL = 2e-5


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, f"{what}: {err:.3e} of max|ref|"


def _equal(a, b):
    assert set(a) == set(b), (sorted(set(a) ^ set(b)))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _sd(module, prefix=""):
    return {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}


def _seeded(module, seed):
    """Nonzero values in every parameter (the biases too)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5 if p.ndim > 1
                    else torch.randn(p.shape, generator=g) * 0.05)
    return module


def test_nerf_mlp_converter_matches_the_reference_spec():
    torch.manual_seed(0)
    m = _seeded(_torch_mlp(), 1)
    sd = _sd(m, "fg_CD_predictor.")
    got = convert.convert_nerf_mlp(sd)
    _equal(got, jconvert.convert_nerf_mlp(sd))
    mlp = NeRFMLP(vp_channels=242, vd_channels=127, hidden=384, out_features=256)
    bridge.load_into(mlp, got)
    rng = np.random.default_rng(0)
    B, Nr, Ns = 1, 8, 4
    pe = rng.standard_normal((B, Nr, Ns, 63)).astype(np.float32)
    shape = rng.standard_normal((B, 179)).astype(np.float32) * 0.1
    appea = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    aud = rng.standard_normal((B, 64)).astype(np.float32) * 0.1
    with torch.no_grad():
        feat, dens = mlp(*(torch.from_numpy(x) for x in (pe, shape, appea, aud)))

        def bc(code, C):
            return torch.from_numpy(code).view(B, C, 1, 1).expand(B, C, Nr, Ns)

        vps = torch.cat([torch.from_numpy(pe).permute(0, 3, 1, 2), bc(shape, 179)], dim=1)
        rgb_t, dens_t = _torch_mlp_forward(m, vps, bc(appea, 127), bc(aud, 64))
    _close(feat, rgb_t.permute(0, 2, 3, 1), "features")
    _close(dens, dens_t.permute(0, 2, 3, 1), "density")


def _reference_net(cfg, seed=2):
    """A reference `net` state dict for `cfg`: the MLP oracle's keys, and a
    neural renderer's 1x1 convs and NCHW bg featmap in the reference's
    names (neural_renderer.py:49-69), from the port's own shapes."""
    port = HeadNeRF(cfg, device="cpu")
    g = torch.Generator().manual_seed(seed)
    sd = _sd(_seeded(_torch_mlp(), seed), "fg_CD_predictor.")
    for k, v in port.state_dict().items():
        if not k.startswith("neural_render."):
            continue
        name = k[len("neural_render."):]
        if name == "bg_featmap":
            sd["neural_render.bg_featmap"] = torch.randn(
                v.permute(0, 3, 1, 2).shape, generator=g).numpy()
            continue
        ref = (name.replace("feat_upsamples.", "feat_upsample_list.")
               .replace("feat_2_rgb.", "feat_2_rgb_list."))
        value = torch.randn(v.shape, generator=g) * 0.1
        sd[f"neural_render.{ref}"] = (value[:, :, None, None] if name.endswith("weight")
                                      else value).numpy()
    return sd


def test_headnerf_converter_equals_the_bridge_of_jax():
    cfg = NeRFConfig(featmap_size=8, pred_img_size=32)
    sd = _reference_net(cfg)
    got = convert.convert_headnerf(sd, n_blocks=2)
    _equal(got, bridge.headnerf_state_dict({"params": jconvert.convert_headnerf(sd, 2)}))
    bridge.load_into(HeadNeRF(cfg, device="cpu"), got)
    assert got["neural_render.bg_featmap"].shape == (1, 8, 8, cfg.featmap_nc)


def test_audio2style_converter_matches_the_reference_lstm():
    tm = _seeded(_TorchAudio2Style(), 3).eval()
    sd = _sd(tm)
    got = convert.convert_audio2style(sd)
    _equal(got, bridge.audio2style_state_dict({"params": jconvert.convert_audio2style(sd)}))
    for k in got:
        if "bias_ih" in k:
            assert not got[k].any()
            hh = k.replace("bias_ih", "bias_hh")
            np.testing.assert_array_equal(got[hh], sd[k] + sd[hh])
    a2s = bridge.load_into(Audio2Style(device="cpu"), got).eval()
    mels = np.random.default_rng(1).standard_normal((5, 80, 16)).astype(np.float32) * 0.5
    with torch.no_grad():
        _close(a2s(torch.from_numpy(mels)), tm(torch.from_numpy(mels)), "styles")


class _TorchClassifierAU(nn.Module):
    """Torch twin of the reference `classifier_AU` (train_vq.py:60-93),
    NCHW: 5x5 convs with padding 1, InstanceNorm2d, LeakyReLU(0.2), max
    pools, and Linear + LeakyReLU + Dropout heads."""

    def __init__(self, crop=112):
        super().__init__()
        cin = 3
        for i, (ch, s) in enumerate(((16, 2), (32, 1), (64, 2), (128, 1))):
            self.add_module(f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(cin, ch, 5, s, 1), nn.InstanceNorm2d(ch), nn.LeakyReLU(0.2)))
            cin = ch
        with torch.no_grad():
            fin = self._trunk(torch.zeros(1, 3, crop, crop)).shape[1]
        for i, fout in enumerate((1600, 512, 256, 64)):
            self.add_module(f"linear{i}", nn.Sequential(nn.Linear(fin, fout), nn.LeakyReLU(0.2),
                                                        nn.Dropout(0.5)))
            fin = fout
        self.linear4 = nn.Linear(64, 1)

    def _trunk(self, x):
        x = F.max_pool2d(self.conv2(self.conv1(x)), 2)
        return F.max_pool2d(self.conv4(self.conv3(x)), 2).flatten(1)

    def forward(self, x):
        feats = self.linear2(self.linear1(self.linear0(self._trunk(x))))
        return feats, torch.sigmoid(self.linear4(self.linear3(feats)))


@pytest.mark.parametrize("crop", [48, 112])
def test_au_classifier_converter_matches_the_reference(crop):
    tm = _seeded(_TorchClassifierAU(crop), 4).eval()
    sd = _sd(tm)
    got = convert.convert_au_classifier(sd)
    if crop == 112:   # the JAX converter's flatten permutation assumes 5x5
        jtree = jconvert.convert_au_classifier(sd)["params"]
        jax_stack = {k: {n: v[None] for n, v in leaf.items()} for k, leaf in jtree.items()}
        _equal({k[len("0."):]: v for k, v in
                bridge.au_classifiers_state_dict({"params": jax_stack}).items()}, got)
    clf = bridge.load_into(AUClassifier(crop, device="cpu"), got)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, crop, crop))
                         .astype(np.float32))
    with torch.no_grad():
        f, p = clf(x)
        f_t, p_t = tm(x)
    _close(f, f_t, "features")
    _close(p, p_t, "probability")


def test_convert_checkpoint_reads_para_and_both_nets(tmp_path):
    cfg = NeRFConfig(featmap_size=8, pred_img_size=32)
    net = {k: torch.from_numpy(v) for k, v in _reference_net(cfg, seed=5).items()}
    # the converters read any LSTM size: a narrow one keeps the file small
    small = nn.Module()
    small.rnn = nn.Module()
    small.rnn.rnn = nn.LSTM(16, 8, 2, batch_first=True, bidirectional=True)
    for i, (cin, cout) in enumerate(((16, 8), (8, 4), (4, 2))):
        small.add_module(f"linear{i + 1}", nn.Sequential(nn.Linear(cin, cout)))
    a2s = {k: v.clone() for k, v in _seeded(small, 6).state_dict().items()}
    path = str(tmp_path / "model_ckpt.pth.tar")
    torch.save({"epoch": 7, "net": net, "audio2style": a2s,
                "para": {"featmap_size": 8, "pred_img_size": 32}}, path)
    sd, meta = convert.convert_checkpoint(path)
    # JAX's convert_checkpoint does the same with convert_headnerf and
    # convert_audio2style: held against those on the saved state dicts
    # (importing it imports the JAX package's data modules and scipy.signal)
    numpy = {k: {n: v.numpy() for n, v in d.items()} for k, d in (("net", net), ("a2s", a2s))}
    _equal(sd, bridge.headnerf_state_dict({"params": jconvert.convert_headnerf(numpy["net"], 2)}))
    _equal(meta["audio2style"], bridge.audio2style_state_dict(
        {"params": jconvert.convert_audio2style(numpy["a2s"])}))
    assert meta["epoch"] == 7 and meta["para"] == {"featmap_size": 8, "pred_img_size": 32}
    bridge.load_into(HeadNeRF(cfg, device="cpu"), sd)
    # torch.load(weights_only=True) refuses what is not tensors and containers
    bad = str(tmp_path / "bad.pth.tar")
    torch.save({"net": net, "para": {"opt": argparse.Namespace(featmap_size=8)}}, bad)
    with pytest.raises(Exception, match="weights_only"):
        convert.convert_checkpoint(bad)
    torch.save({"state_dict": {"w": torch.ones(2)}}, tmp_path / "sd.pt")
    assert convert.torch_state_dict_to_numpy(str(tmp_path / "sd.pt"))["w"].tolist() == [1, 1]
