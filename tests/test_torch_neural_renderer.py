"""Port parity of `models/neural_renderer.py`: `blur3`, `pixel_shuffle_2x`,
`bilinear_2x` and `NeuralRenderer` (params bridged from the JAX init)
against the JAX package, f32 on the CPU. Tolerances: atol 1e-5 for the
elementwise ops; atol 1e-4 for the decoder, whose 1x1 convs sum over up to
256 channels in another order than XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import _jax_reference  # noqa: F401  (each xdist worker's share of torch threads)

from nerf3dtalker_tpu.models import neural_renderer as jnr
from nerf3dtalker_tpu_torch.models import neural_renderer as nr
from nerf3dtalker_tpu_torch.utils import bridge


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_elementwise_ops_match_jax():
    x = _x((2, 6, 5, 8))
    for jf, tf in ((jnr.blur3, nr.blur3), (jnr.pixel_shuffle_2x, nr.pixel_shuffle_2x),
                   (jnr.bilinear_2x, nr.bilinear_2x)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), rtol=1e-5, atol=1e-5,
                                   err_msg=tf.__name__)


def test_neural_renderer_matches_jax():
    feat_nc, fm, img = 32, 4, 16
    jmod = jnr.NeuralRenderer(feat_nc=feat_nc, featmap_size=fm, img_size=img)
    x = _x((2, fm, fm, feat_nc), seed=1)
    params = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x))
    # a non-constant bg featmap, so the bridge's copy of it is checked too
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["bg_featmap"] = _x((1, fm, fm, feat_nc), seed=2)
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))

    tmod = nr.NeuralRenderer(feat_nc=feat_nc, featmap_size=fm, img_size=img)
    sd = bridge.headnerf_state_dict(
        {"params": {"fg_CD_predictor": {}, "neural_render": params["params"]}})
    bridge.load_into(tmod, {k.removeprefix("neural_render."): v for k, v in sd.items()})
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
    assert out.shape == (2, img, img, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tmod.bg_featmap.detach().numpy(),
                                  params["params"]["bg_featmap"])
