"""JAX reference models shared by the port's parity tests
(`tests/test_torch_*.py`). Each is built once per process: flax's init of
the 2x640 BiLSTM and of a full-width HeadNeRF takes seconds to compile on
the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from nerf3dtalker_tpu.config import NeRFConfig
from nerf3dtalker_tpu.models import HeadNeRF
from nerf3dtalker_tpu.models.audio import Audio2Style
from nerf3dtalker_tpu.utils.camera import base_cam, ray_grid


@functools.lru_cache(maxsize=None)
def audio2style():
    """(module, params, jitted apply) of Audio2Style, init key 1 (eager:
    compiling the whole init with jit takes twice as long here)."""
    mod = Audio2Style()
    params = mod.init(jax.random.key(1), jnp.zeros((1, 80, 16)))
    return mod, params, jax.jit(mod.apply)


@functools.lru_cache(maxsize=None)
def headnerf(seed=0, **cfg_kw):
    """(module, params, cam dict) of HeadNeRF(NeRFConfig(**cfg_kw)),
    initialized from `seed` at batch 1 with zero codes."""
    cfg = NeRFConfig(**cfg_kw)
    mod = HeadNeRF(cfg)
    xy, _ = ray_grid(cfg.featmap_size)
    cam = base_cam(cfg.featmap_size)
    params = jax.jit(mod.init)(
        jax.random.key(seed), batch_xy=jnp.asarray(xy),
        shape_code=jnp.zeros((1, cfg.shape_code_dims)),
        appea_code=jnp.zeros((1, cfg.appea_code_dims)),
        audio_style=jnp.zeros((1, cfg.audio_style_dims)),
        Rmat=jnp.asarray(cam.Rmat), Tvec=jnp.asarray(cam.Tvec),
        inv_inmat=jnp.asarray(cam.inv_inmat))
    params = jax.tree_util.tree_map(np.asarray, params)
    return mod, params, {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}


@functools.lru_cache(maxsize=None)
def vgg16(seed=0):
    """Flax VGG16Features params, numpy leaves: the values of
    `init_vgg16(key(seed))`, which traces its forward at 224x224; the conv
    params do not depend on the input's size, so a 16x16 trace suffices."""
    from nerf3dtalker_tpu.models.perceptual import VGG16Features

    params = jax.jit(VGG16Features().init)(jax.random.key(seed), jnp.zeros((1, 16, 16, 3)))
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def neural_renderer(featmap=8, img=64, feat_nc=32, min_feat=8, seed=0):
    """(module, params with numpy leaves) of the JAX NeuralRenderer at the
    size `tests/test_phase_upsampler.py` uses."""
    from nerf3dtalker_tpu.models.neural_renderer import NeuralRenderer

    mod = NeuralRenderer(feat_nc=feat_nc, out_dim=3, final_actvn=True, min_feat=min_feat,
                         featmap_size=featmap, img_size=img, bg_type="white")
    params = jax.jit(mod.init)(jax.random.key(seed), jnp.zeros((1, featmap, featmap, feat_nc)))
    return mod, jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def phase_block(i, bf16=False):
    """Jitted (forward, vjp) of the JAX `phase_block_forward` of block i
    over a leading batch axis: forward(net, rgb, bp) -> (net_next,
    rgb_next); vjp(net, rgb, bp, g_net_next, g_rgb_next) -> (g_net, g_rgb,
    g_bp), the weight gradients summed over the batch."""
    from nerf3dtalker_tpu.models.phase_renderer import phase_block_forward

    cdt = jnp.bfloat16 if bf16 else jnp.float32

    def fwd(net, rgb, bp):
        return jax.vmap(lambda n, r: phase_block_forward(n, r, bp, i, cdt))(net, rgb)

    def vjp(net, rgb, bp, gn, gr):
        return jax.vjp(fwd, net, rgb, bp)[1]((gn, gr))

    return jax.jit(fwd), jax.jit(vjp)


@functools.lru_cache(maxsize=None)
def seeded_headnerf(seed=0, **cfg_kw):
    """(module, params, cam dict) of HeadNeRF(NeRFConfig(**cfg_kw)) with
    numpy-seeded weights in the flax tree's shapes: kernels N(0, 2/fan_in),
    biases N(0, 0.05^2) (nonzero, so every bias path is checked) but the
    density bias 0.5 + N(0, 0.05^2), the bg featmap 1 + N(0, 0.05^2). The shapes come from `jax.eval_shape` of the
    init, which traces without compiling."""
    cfg = NeRFConfig(**cfg_kw)
    mod = HeadNeRF(cfg)
    xy, _ = ray_grid(cfg.featmap_size)
    cam = base_cam(cfg.featmap_size)
    shapes = jax.eval_shape(
        mod.init, jax.random.key(seed), batch_xy=jnp.asarray(xy),
        shape_code=jnp.zeros((1, cfg.shape_code_dims)),
        appea_code=jnp.zeros((1, cfg.appea_code_dims)),
        audio_style=jnp.zeros((1, cfg.audio_style_dims)),
        Rmat=jnp.asarray(cam.Rmat), Tvec=jnp.asarray(cam.Tvec),
        inv_inmat=jnp.asarray(cam.inv_inmat))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        noise = rng.standard_normal(leaf.shape)
        if name.endswith("kernel"):
            value = noise * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        elif name == "bg_featmap":
            value = 1.0 + 0.05 * noise
        elif name == "density_bias":   # partly opaque: the MLP's features reach the image
            value = 0.5 + 0.05 * noise
        else:
            value = 0.05 * noise
        return value.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return mod, params, {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
