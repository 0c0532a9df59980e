"""The port's preprocessing networks against the JAX package's, in eval
mode with non-trivial BatchNorm statistics: BiSeNet's three heads and its
parsing, FAN at 1 and 2 stacks, ReconNet; `decode_heatmaps` and the
heatmap targets; the resizes of `build_appliers`; the numpy modules
(`correct_head_mask`, `align`, `crop_and_extract`); and `convert_bisenet` /
`convert_recon_net` on reference-layout state dicts against the JAX
converters. Weights are numpy draws in the shapes of `jax.eval_shape` of
the flax init (`seeded_variables`), bridged into the port; each JAX
forward compiles once (`fast_jit`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import face_net

from nerf3dtalker_tpu.data import align as jalign
from nerf3dtalker_tpu.data import crop_extract as jcrop
from nerf3dtalker_tpu.models import bisenet as jbisenet
from nerf3dtalker_tpu.models import fan as jfan
from nerf3dtalker_tpu.utils import convert as jconvert
from nerf3dtalker_tpu_torch.data import align, crop_extract
from nerf3dtalker_tpu_torch.data.preprocess import linear_resize
from nerf3dtalker_tpu_torch.models import bisenet, fan, resnets
from nerf3dtalker_tpu_torch.utils import bridge, convert
from nerf3dtalker_tpu_torch.utils.device import uninitialized

# f32 convolutions through 20-60 layers in another summation order, each
# output by relative L2 (measured ~1e-6)
NET_REL_L2 = 1e-4
# the parsing argmax: a near tie of two logits may flip
ARGMAX_AGREE = 0.99
# resizes: the same taps, weights rounded apart
RESIZE_RTOL = 1e-5
# the numpy copies run the same numpy code
NUMPY_RTOL = 1e-6


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _nchw(x):
    return torch.as_tensor(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _port_net(factory, variables):
    return bridge.load_into(uninitialized(factory, "cpu"),
                            bridge.bn_net_state_dict(variables)).eval()


def _images(B, S, seed=0):
    """Smooth frames with a bright blob: a parse with structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S] / S
    base = np.stack([0.5 + 0.3 * np.sin(2 * np.pi * (a * xx + b * yy))
                     for a, b in rng.uniform(0.5, 2, (B, 2))])
    blob = np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05)
    img = np.clip(base[..., None] * 0.6 + blob[None, ..., None] * 0.4
                  + 0.05 * rng.standard_normal((B, S, S, 3)), 0, 1)
    return img.astype(np.float32)


def test_bisenet_heads_and_parsing_match_jax():
    mod, variables, apply = face_net("bisenet")
    x = _images(2, 64)
    want = apply(variables, x)
    net = _port_net(lambda d: bisenet.BiSeNet(device=d), variables)
    with torch.no_grad():
        got = net(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_l2(_nhwc(g), w) <= NET_REL_L2
    agree = (got[0].argmax(1).numpy() == np.asarray(want[0]).argmax(-1)).mean()
    assert agree >= ARGMAX_AGREE
    parsing = got[0].argmax(1)
    np.testing.assert_array_equal(bisenet.head_mask_from_parsing(parsing).numpy(),
                                  np.asarray(jbisenet.head_mask_from_parsing(parsing.numpy())))
    np.testing.assert_array_equal(bisenet.eye_mask_from_parsing(parsing).numpy(),
                                  np.asarray(jbisenet.eye_mask_from_parsing(parsing.numpy())))


@pytest.mark.parametrize("n_stacks,side", [(1, 256), (2, 64)])
def test_fan_matches_jax(n_stacks, side):
    """One stack at the preprocessing crop (256^2), two at 64^2."""
    mod, variables, apply = face_net("fan", n_stacks)
    x = _images(2, side, seed=1)
    want = apply(variables, x)
    net = _port_net(lambda d: fan.FAN(n_stacks=n_stacks, device=d), variables)
    with torch.no_grad():
        got = net(_nchw(x))
    assert got.shape == (2, 68, side // 4, side // 4)
    assert _rel_l2(_nhwc(got), want) <= NET_REL_L2


def test_recon_net_matches_jax():
    mod, variables, apply = face_net("recon")
    x = _images(2, 32, seed=2)
    want = apply(variables, x)
    net = _port_net(lambda d: resnets.ReconNet(device=d), variables)
    with torch.no_grad():
        got = net(_nchw(x))
    assert got.shape == (2, 257)
    assert _rel_l2(got, want) <= NET_REL_L2


def test_decode_heatmaps_and_targets_match_jax():
    """A heatmap with a unique maximum (one at a border) and non-zero
    neighbour differences: exactly equal; the Gaussian targets to
    NUMPY_RTOL."""
    rng = np.random.default_rng(3)
    hm = rng.standard_normal((2, 16, 16, 68)).astype(np.float32)
    hm[0, 0, 5, 0] = hm[1, 15, 15, 1] = 10.0
    want = np.asarray(jax.jit(jfan.decode_heatmaps, static_argnames="crop_size")(hm, crop_size=256))
    got = fan.decode_heatmaps(torch.as_tensor(hm).permute(0, 3, 1, 2), crop_size=256)
    np.testing.assert_array_equal(got.numpy(), want)
    lm = rng.uniform(0, 16, (2, 68, 2)).astype(np.float32)
    t_j = np.asarray(jax.jit(jfan.landmark_heatmap_targets, static_argnames="hw")(lm, hw=16))
    t = fan.landmark_heatmap_targets(torch.as_tensor(lm), hw=16)
    np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), t_j, rtol=0, atol=NUMPY_RTOL)


@pytest.mark.parametrize("src,dst", [(64, 32), (64, 24), (24, 64), (32, 256), (96, 64)])
def test_appliers_resizes_match_jax_image_resize(src, dst):
    """`build_appliers`' resizes: the frames' linear resize (antialiased
    when it shrinks) and the parsing's nearest resize (half-pixel
    centres), shrinking and growing."""
    x = _images(2, src, seed=4)
    want = np.asarray(jax.image.resize(x, (2, dst, dst, 3), "linear"))
    got = _nhwc(linear_resize(_nchw(x), (dst, dst)))
    assert np.abs(got - want).max() <= RESIZE_RTOL
    labels = np.random.default_rng(5).integers(0, 19, (2, src, src)).astype(np.float32)
    want_n = np.asarray(jax.image.resize(labels, (2, dst, dst), "nearest"))
    got_n = bisenet._nearest_resize(torch.as_tensor(labels)[:, None], (dst, dst))[:, 0]
    np.testing.assert_array_equal(got_n.numpy(), want_n)


def test_correct_head_mask_and_align_match_jax():
    rng = np.random.default_rng(6)
    mask = (rng.uniform(0, 1, (48, 48)) > 0.4).astype(np.float32)
    mask[10:30, 10:30] = 1
    np.testing.assert_array_equal(bisenet.correct_head_mask(mask),
                                  jbisenet.correct_head_mask(mask))
    img = _images(1, 96, seed=7)[0]
    lm = (48 + rng.uniform(-25, 25, (68, 2))).astype(np.float32)
    np.testing.assert_array_equal(align.landmarks68_to_5(lm), jalign.landmarks68_to_5(lm))
    five = align.landmarks68_to_5(lm)
    np.testing.assert_allclose(align.umeyama(five, align.TEMPLATE_5PT),
                               jalign.umeyama(five, jalign.TEMPLATE_5PT), rtol=0,
                               atol=NUMPY_RTOL)
    got, M = align.align_face(img, lm, out_size=56)
    want, Mj = jalign.align_face(img, lm, out_size=56)
    np.testing.assert_allclose(got, want, rtol=0, atol=NUMPY_RTOL)
    np.testing.assert_allclose(M, Mj, rtol=0, atol=NUMPY_RTOL)
    np.testing.assert_allclose(align.ffhq_quad_crop(lm), jalign.ffhq_quad_crop(lm), rtol=0,
                               atol=NUMPY_RTOL)


def test_crop_and_extract_matches_jax():
    """crop_and_extract and extract_exp_sequence with one numpy regressor on
    both sides (a fixed projection of the
    aligned crop to 257)."""
    rng = np.random.default_rng(8)
    proj = rng.standard_normal((56 * 56 * 3, 257)).astype(np.float32) / 100

    def recon_apply(aligned):                     # [B, 224, 224, 3] -> [B, 257]
        a = np.asarray(aligned, np.float32)[:, ::4, ::4]
        return a.reshape(len(a), -1) @ proj

    imgs = _images(2, 96, seed=9)
    lms = (48 + rng.uniform(-25, 25, (2, 68, 2))).astype(np.float32)
    got = crop_extract.crop_and_extract(imgs[0], recon_apply, lms[0])
    want = jcrop.crop_and_extract(imgs[0], recon_apply, lms[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=NUMPY_RTOL)
    np.testing.assert_allclose(crop_extract.extract_exp_sequence(imgs, recon_apply, lms),
                               jcrop.extract_exp_sequence(imgs, recon_apply, lms), rtol=0,
                               atol=NUMPY_RTOL)
    with pytest.raises(ValueError, match="landmarks or a fan_apply"):
        crop_extract.crop_and_extract(imgs[0], recon_apply)


def _reference_state_dict(port_keys_shapes, ref_key, seed):
    """A reference-layout state dict: each port key's tensor under the
    reference's name, drawn from `seed` (convs N(0, 1/fan_in), BatchNorm
    weights 1 + N(0, 0.1^2), running means N(0, 0.1^2), variances in
    [0.5, 1.5], biases N(0, 0.05^2))."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in port_keys_shapes:
        if k.endswith("num_batches_tracked"):
            sd[ref_key(k)] = torch.tensor(7)
            continue
        noise = rng.standard_normal(shape)
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            v = 0.1 * noise
        elif len(shape) > 1:
            v = noise / np.sqrt(np.prod(shape[1:]))
        elif "bn" in k.split(".")[-2]:
            v = (1.0 if k.endswith("weight") else 0.0) + 0.1 * noise
        else:
            v = 0.05 * noise
        sd[ref_key(k)] = torch.as_tensor(v.astype(np.float32))
    return sd


def _keys_shapes(factory):
    with torch.device("meta"):
        return [(k, tuple(v.shape)) for k, v in factory(device="meta").state_dict().items()]


def test_convert_bisenet_matches_jax_converter():
    """A BiSeNet state dict in the reference's layout (`cp.resnet.layer1.0.
    downsample.0`, `cp.arm16.conv.conv`, `conv_out16.conv_out`, ...): the
    port loaded through `convert_bisenet`, JAX through its converter, agree
    on the three heads."""
    sd = _reference_state_dict(_keys_shapes(bisenet.BiSeNet), convert._bisenet_ref_key, 10)
    assert "cp.resnet.layer2.0.downsample.1.running_var" in sd
    assert "conv_out32.conv_out.weight" in sd and "cp.arm32.bn_atten.bias" in sd
    net = bridge.load_into(uninitialized(lambda d: bisenet.BiSeNet(device=d), "cpu"),
                           convert.convert_bisenet(sd)).eval()
    _, _, apply = face_net("bisenet")
    jvars = jax.tree_util.tree_map(np.asarray, jconvert.convert_bisenet(
        {k: v.numpy() for k, v in sd.items()}))
    x = _images(2, 64, seed=11)
    want = apply(jvars, x)
    with torch.no_grad():
        got = net(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_l2(_nhwc(g), w) <= NET_REL_L2


def test_convert_recon_net_matches_jax_converter():
    """A ReconNetWrapper state dict (`backbone.layer1.0.downsample.0`, the
    seven 1x1 heads `final_layers.{i}` of 80/64/80/3/27/2/1 coefficients)
    through `convert_recon_net` and JAX's converter."""
    keys = [kv for kv in _keys_shapes(resnets.ReconNet) if kv[0].startswith("backbone.")]
    sd = _reference_state_dict(keys, convert._resnet_ref_key, 12)
    assert "backbone.layer4.0.downsample.1.weight" in sd
    rng = np.random.default_rng(13)
    for i, n in enumerate((80, 64, 80, 3, 27, 2, 1)):
        sd[f"final_layers.{i}.weight"] = torch.as_tensor(
            (rng.standard_normal((n, 2048, 1, 1)) / np.sqrt(2048)).astype(np.float32))
        sd[f"final_layers.{i}.bias"] = torch.as_tensor(
            (0.05 * rng.standard_normal(n)).astype(np.float32))
    net = bridge.load_into(uninitialized(lambda d: resnets.ReconNet(device=d), "cpu"),
                           convert.convert_recon_net(sd)).eval()
    _, _, apply = face_net("recon")
    jvars = jax.tree_util.tree_map(np.asarray, jconvert.convert_recon_net(
        {k: v.numpy() for k, v in sd.items()}))
    x = _images(2, 32, seed=14)
    want = apply(jvars, x)
    with torch.no_grad():
        got = net(_nchw(x))
    assert _rel_l2(got, want) <= NET_REL_L2
    recon = crop_extract.recon_applier(net)
    np.testing.assert_allclose(recon(x), got.numpy(), rtol=0, atol=NUMPY_RTOL)
