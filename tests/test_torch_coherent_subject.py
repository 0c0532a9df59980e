"""The learnable subject and the serving extras of the port against the JAX
package, on the CPU: `coherent_subject` and its helpers (numpy on both
sides, so exactly equal), LPIPS-alex through an .npz written by the JAX
`save_lpips_alex` (within 1e-5 relative: f32 convolutions summed in another
order), the unsharp enhancer (within 1e-6: scipy's filter on both sides),
and `animate_sequence` with an `expr_seq` (frames within 1e-4, as
`tests/test_torch_animate.py`: MLP and decoder sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import headnerf as jax_headnerf

from nerf3dtalker_tpu.config import NeRFConfig as JNeRFConfig
from nerf3dtalker_tpu.data import dataset as jdataset
from nerf3dtalker_tpu.train import animate as janimate
from nerf3dtalker_tpu.utils import metrics as jmetrics
from nerf3dtalker_tpu.utils import video as jvideo
from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.data import dataset
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.train import animate
from nerf3dtalker_tpu_torch.utils import bridge, metrics, video

TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=16,
            mlp_hidden=64)


@pytest.mark.parametrize("t0", [0, 40])
def test_coherent_subject_equals_jax(t0):
    a, b = dataset.talking_signals(12, t0=t0)
    ja, jb = jdataset.talking_signals(12, t0=t0)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(dataset.talking_mels(a), jdataset.talking_mels(ja))
    for got, want in zip(dataset.render_talking_frame(48, a[3], b[3]),
                         jdataset.render_talking_frame(48, ja[3], jb[3])):
        np.testing.assert_array_equal(got, want)
    ds = dataset.coherent_subject(NeRFConfig(**TINY), num_frames=6, t0=t0)
    jds = jdataset.coherent_subject(JNeRFConfig(**TINY), num_frames=6, t0=t0)
    assert sorted(ds.arrays) == sorted(jds.arrays)
    for k in jds.arrays:
        assert ds.arrays[k].dtype == jds.arrays[k].dtype, k
        np.testing.assert_array_equal(ds.arrays[k], jds.arrays[k], err_msg=k)
    np.testing.assert_array_equal(ds.xy, jds.xy)


def test_lpips_alex_matches_jax_through_npz(tmp_path):
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    img2 = np.clip(img1 + 0.1 * rng.standard_normal(img1.shape), 0, 1).astype(np.float32)
    # the flax AlexNetFeatures tree, seeded (LeCun-normal kernels [k, k, in, out])
    params, cin = {}, 3
    for i, (cout, k) in enumerate(((64, 11), (192, 5), (384, 3), (256, 3), (256, 3))):
        params[f"conv{i}"] = {
            "kernel": jnp.asarray((rng.standard_normal((k, k, cin, cout))
                                   / np.sqrt(k * k * cin)).astype(np.float32)),
            "bias": jnp.asarray((0.1 * rng.standard_normal(cout)).astype(np.float32))}
        cin = cout
    params = {"params": params}
    lins = [jnp.asarray(rng.uniform(0, 1, c).astype(np.float32))
            for c in (64, 192, 384, 256, 256)]
    path = str(tmp_path / "lpips_alex.npz")
    jmetrics.save_lpips_alex(path, params, lins)
    want = np.asarray(jax.jit(jmetrics.lpips_alex)(params, lins, jnp.asarray(img1),
                                                   jnp.asarray(img2)))
    net, tlins = metrics.load_lpips_alex(path, device="cpu")
    with torch.no_grad():
        got = metrics.lpips_alex(net, tlins, torch.from_numpy(img1), torch.from_numpy(img2))
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_unsharp_enhancer_matches_jax():
    frames = np.random.default_rng(1).uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    got = video.enhance_frames(frames, video.unsharp_enhancer)
    want = jvideo.enhance_frames(frames, jvideo.unsharp_enhancer)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert video.enhance_frames(frames) is frames


def test_animate_sequence_with_expr_seq_matches_jax():
    rng = np.random.default_rng(2)
    shape = (rng.standard_normal((1, 179)) * 0.3).astype(np.float32)
    appea = (rng.standard_normal((1, 127)) * 0.3).astype(np.float32)
    styles = (rng.standard_normal((5, 64)) * 0.3).astype(np.float32)
    expr = (rng.standard_normal((5, 64)) * 0.5).astype(np.float32)
    jmodel, nerf, cam = jax_headnerf(0, **TINY)
    want = janimate.animate_sequence(jmodel, nerf, shape, appea, styles, cam, expr_seq=expr,
                                     chunk=2)
    model = HeadNeRF(NeRFConfig(**TINY), device="cpu")
    bridge.load_into(model, bridge.headnerf_state_dict(nerf))
    got = animate.animate_sequence(model.eval(), shape, appea, styles, cam, expr_seq=expr,
                                   chunk=2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the expression rows do reach the frames
    plain = animate.animate_sequence(model, shape, appea, styles, cam, chunk=2)
    assert np.abs(plain - got).max() > 1e-3
