"""JAX reference models shared by the port's parity tests
(`tests/test_torch_*.py`). Each is built once per process: flax's init of
the 2x640 BiLSTM and of a full-width HeadNeRF takes seconds to compile on
the CPU."""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np

from nerf3dtalker_tpu.config import NeRFConfig
from nerf3dtalker_tpu.models import HeadNeRF
from nerf3dtalker_tpu.models.audio import Audio2Style
from nerf3dtalker_tpu.utils.camera import base_cam, ray_grid


def by_content(fn):
    """`fn` memoized for the process on the content of its arguments:
    arrays (numpy or JAX, anywhere in a pytree) by their shape, dtype and
    bytes, anything else by its repr. For a JAX reference that tests in
    several files compute from the same inputs."""
    cache = {}

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        h = hashlib.blake2b(digest_size=16)
        for leaf in jax.tree_util.tree_leaves((args, sorted(kw.items()))):
            if hasattr(leaf, "shape"):
                a = np.ascontiguousarray(leaf)
                h.update(repr((a.shape, a.dtype.str)).encode())
                h.update(a.tobytes())
            else:
                h.update(repr(leaf).encode())
        key = h.digest()
        if key not in cache:
            cache[key] = fn(*args, **kw)
        return cache[key]

    return wrapper


class JittedApply:
    """A JAX model whose `apply` is jitted. JAX's `fit_single_image`
    evaluates its final losses eagerly, which compiles each op of the
    forward on its own; through this it compiles the forward once (the same
    ops)."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.apply = jax.jit(model.apply)


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


# XLA's backend optimizations off: for a reference run once, compiling
# faster matters more than running fast (per-call option, no global state)
FAST_COMPILE = {"xla_backend_optimization_level": 0}

# the Standardized Space stage 1 at the size of tests/test_vq_roundtrip.py
VQ_TINY = dict(hidden_size=32, embed_dim=8, n_embed=64, n_embed_au=8, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=64, img_size=16, au_dim=256, n_au=5)


def vq_batch(seed=0, B=2, crop=48, cfg_kw=VQ_TINY):
    """A stage-1 batch of numpy arrays from `seed`: smooth gt frames, gen =
    gt plus noise, a partial mask, random crops and labels."""
    rng = np.random.default_rng(seed)
    S = cfg_kw["img_size"]
    yy, xx = np.mgrid[0:S, 0:S] / S
    gt = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (a * xx + b * yy + c))
                   for a, b, c in rng.uniform(0.3, 1.5, (B, 3))])[..., None].repeat(3, -1)
    gen = np.clip(gt + rng.uniform(-0.3, 0.3, gt.shape), 0, 1)
    return {"gen_img": gen.astype(np.float32), "gt_img": gt.astype(np.float32),
            "mask": (rng.uniform(0, 1, (B, S, S, 1)) > 0.2).astype(np.float32),
            "crops": rng.uniform(0, 1, (B, cfg_kw["n_au"], crop, crop, 3)).astype(np.float32),
            "au_labels": (rng.uniform(0, 1, (B, cfg_kw["n_au"])) > 0.5).astype(np.float32)}


def vq_step(lr=1e-4, au_loss_weight=1.0):
    """(init, jitted train_step, jitted eval_step) of the JAX
    `build_vq_step` at VQ_TINY, one per value (however it is passed)."""
    return _vq_step(float(lr), float(au_loss_weight))


@functools.lru_cache(maxsize=None)
def _vq_step(lr, au_loss_weight):
    from nerf3dtalker_tpu.config import VQConfig
    from nerf3dtalker_tpu.train.vq_trainer import build_vq_step

    return build_vq_step(VQConfig(**VQ_TINY), lr=lr, au_loss_weight=au_loss_weight)


def vq_state(lr=1e-4, seed=0, crop=48):
    """The JAX step's VQTrainState at VQ_TINY: `vq_init`'s weights and a
    fresh optax.adamw(lr, 2e-3) state (zeros in the shapes of its init: no
    compile)."""
    import optax

    from nerf3dtalker_tpu.train.vq_trainer import VQTrainState

    params = vq_init(seed, crop)
    opt = jax.eval_shape(optax.adamw(lr, weight_decay=2e-3).init, params)
    opt = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), opt)
    return VQTrainState(*params, opt, np.zeros((), np.int32))


def vq_init(seed=0, crop=48):
    """(vq variables, stacked AU variables) in the shapes of the JAX step's
    init at VQ_TINY (`jax.eval_shape`: no init compiles), numpy values drawn
    from `seed` as the flax init draws them: kernels N(0, 1/fan_in),
    codebooks uniform in +-1/n_embed; but biases N(0, 0.05^2) and LayerNorm
    scales 1 + N(0, 0.1^2), so that every bias and scale path is checked,
    and each of the n_au classifiers drawn apart. One per value, however
    the arguments are passed."""
    return _vq_init(seed, crop)


@functools.lru_cache(maxsize=None)
def _vq_init(seed, crop):
    state = jax.eval_shape(vq_step()[0], jax.random.key(seed), vq_batch(crop=crop))
    rng = np.random.default_rng(seed)

    def fill(path, leaf, stacked):
        name = str(path[-1].key)
        shape = leaf.shape[1:] if stacked else leaf.shape
        noise = rng.standard_normal(leaf.shape)
        if name == "kernel":
            value = noise / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            value = rng.uniform(-1.0 / shape[0], 1.0 / shape[0], leaf.shape)
        elif name == "scale":
            value = 1.0 + 0.1 * noise
        else:
            value = 0.05 * noise
        return value.astype(np.float32)

    return (jax.tree_util.tree_map_with_path(lambda p, x: fill(p, x, False), state.vq_params),
            jax.tree_util.tree_map_with_path(lambda p, x: fill(p, x, True), state.au_params))


def seeded_variables(init_fn, *args, seed=0, **kw):
    """Variables in the shapes of `jax.eval_shape(init_fn, key(seed), ...)`
    (no init compiles), numpy values from `seed`: kernels and embeddings
    N(0, 1/fan_in), LayerNorm / GroupNorm / BatchNorm scales 1 + N(0, 0.1^2),
    BatchNorm running means N(0, 0.1^2) and variances in [0.5, 1.5], other
    leaves (biases) N(0, 0.05^2): every path nonzero."""
    shapes = jax.eval_shape(init_fn, jax.random.key(seed), *args, **kw)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        noise = rng.standard_normal(leaf.shape)
        if name in ("kernel", "embedding"):
            value = noise / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * noise
        elif name == "mean":
            value = 0.1 * noise
        elif name == "var":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            value = 0.05 * noise
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# the tiny wav2vec2 of the port's parity tests
W2V_TINY = dict(conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
                num_layers=2, num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)


@functools.lru_cache(maxsize=None)
def wav2vec_tiny(seed=0):
    """(module, seeded variables, `fast_jit` apply) of the JAX
    Wav2Vec2Encoder at W2V_TINY."""
    from nerf3dtalker_tpu.models.vq.wav2vec import Wav2Vec2Encoder

    mod = Wav2Vec2Encoder(**W2V_TINY)
    params = seeded_variables(mod.init, jnp.zeros((1, 1600)), seed=seed)
    return mod, params, fast_jit(mod.apply)


def fast_jit(fn):
    """`fn` jitted and compiled with FAST_COMPILE, once per shape and dtype
    of its array arguments (pass anything static through a partial)."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = tuple((np.shape(a), np.result_type(a).str)
                    for a in jax.tree_util.tree_leaves(args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=FAST_COMPILE)
        return compiled[key](*args)

    return call
