"""JAX reference models shared by the port's parity tests
(`tests/test_torch_*.py`). Each is built once per process: flax's init of
a full-width HeadNeRF takes seconds to compile on the CPU."""

import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

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
    """(module, params, jitted apply) of Audio2Style, its weights
    `seeded_variables` of seed 1: numpy draws in the shapes of the flax
    init, which traces without compiling (flax's own init of the 2x640
    BiLSTM took 6-11 s a process: eagerly it compiles each op, and jitted
    whole it compiles twice as long)."""
    mod = Audio2Style()
    params = seeded_variables(mod.init, jnp.zeros((1, 80, 16)), seed=1)
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


# Under pytest-xdist the workers share the machine's cores. torch's
# intra-op pool takes every core in each worker, and its threads then wait
# on one another: under `-n 6` on 8 cores the port's suite took 657-670 s
# with it and 158 s with one thread a worker. Every port test file imports
# this module, so each worker takes its share once.
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


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


# one `fast_jit` of a flax module's apply per module class and attributes
_APPLIES = {}


def jit_apply(module, cls=None):
    """`cls.apply` bound to `module` (by default its own class's, or the
    class a `jitted_class` stands for) through `fast_jit`, shared by every
    test of the process that applies a module of that class and those
    attributes."""
    cls = cls or getattr(type(module), "jitted_base", type(module))
    key = repr(module)
    if key not in _APPLIES:
        _APPLIES[key] = fast_jit(functools.partial(cls.apply, module))
    return _APPLIES[key]


def jitted_class(cls):
    """A subclass of the flax module `cls`, of the same name, whose `apply`
    goes through `jit_apply`: patched over a JAX module's class, it
    compiles code that builds the module itself and applies it eagerly."""
    class Jitted(cls):
        def apply(self, variables, *args):
            return jit_apply(self, cls)(variables, *args)

    Jitted.__name__ = Jitted.__qualname__ = cls.__name__
    Jitted.jitted_base = cls
    return Jitted


@functools.lru_cache(maxsize=None)
def face_net(name, n_stacks=1):
    """(module, seeded variables, jitted apply) of the JAX BiSeNet, FAN of
    `n_stacks` stacks or ReconNet: variables in the shapes of the flax init
    (which do not depend on the image size), from seed 1, 2 + n_stacks or
    3."""
    from nerf3dtalker_tpu.models.bisenet import BiSeNet
    from nerf3dtalker_tpu.models.fan import FAN
    from nerf3dtalker_tpu.models.resnets import ReconNet

    mod, side, seed = {"bisenet": (BiSeNet(), 64, 1),
                       "fan": (FAN(n_stacks=n_stacks), 64, 2 + n_stacks),
                       "recon": (ReconNet(), 32, 3)}[name]
    variables = seeded_variables(mod.init, jnp.zeros((1, side, side, 3)), seed=seed)
    return mod, variables, jit_apply(mod)


@functools.lru_cache(maxsize=None)
def netg_variables(seed=1):
    """SimpleWrapperV2 variables: kernels N(0, 1/fan_in), BN running means
    N(0, 0.1^2) and variances in [0.5, 1.5]."""
    from nerf3dtalker_tpu.models.audio import SimpleWrapperV2

    return seeded_variables(SimpleWrapperV2().init, np.zeros((1, 80, 16, 1), np.float32),
                            np.zeros((1, 64), np.float32), np.zeros((1, 1), np.float32),
                            seed=seed)


class fast_fit3dmm:
    """Within it, JAX's `fit_3dmm` compiles its two stages with
    FAST_COMPILE and computes its final losses through one jitted render,
    loss and rotation (eagerly each op compiles on its own, ~12 s)."""

    NAMES = ("render_nl3dmm", "fitting_losses", "euler_to_rmat")

    def __enter__(self):
        import nerf3dtalker_tpu.train.fit3dmm as mod

        self.mod, self.jit = mod, jax.jit
        self.eager = {n: getattr(mod, n) for n in self.NAMES}
        jit = self.jit

        def fast(fn):
            jitted = jit(fn)
            return lambda *a: jitted.lower(*a).compile(compiler_options=FAST_COMPILE)(*a)

        mod.jax.jit = fast
        mod.render_nl3dmm = jit(self.eager["render_nl3dmm"], static_argnames=("H", "W", "chunk"))
        mod.fitting_losses = jit(self.eager["fitting_losses"])
        mod.euler_to_rmat = jit(self.eager["euler_to_rmat"])
        return self

    def __exit__(self, *exc):
        self.mod.jax.jit = self.jit
        for n, fn in self.eager.items():
            setattr(self.mod, n, fn)
        return False


@functools.lru_cache(maxsize=None)
def nl3dmm_variables(G=7, seed=0):
    """(geo, tex) JAX NL3DMM variables at the G x G mesh (numpy, `seed`):
    geo_fc2 N(0, 1/179) with N(0, 0.05^2) biases (some units active at zero
    codes), geo_fc3 N(0, 0.02^2 / 1024) with the frontal grid as bias,
    b_tex N(0, 0.01^2), mu_tex in [0.3, 0.7], sig_tex in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    xs, ys = np.meshgrid(np.linspace(-0.5, 0.5, G), np.linspace(-0.5, 0.5, G))
    grid = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1)
    geo = {"params": {
        "geo_fc2": {"kernel": f32(rng.standard_normal((179, 1024)) / np.sqrt(179)),
                    "bias": f32(0.05 * rng.standard_normal(1024))},
        "geo_fc3": {"kernel": f32(0.02 * rng.standard_normal((1024, 3 * G * G)) / 32),
                    "bias": f32(grid)}}}
    tex = {"params": {"b_tex": f32(0.01 * rng.standard_normal((100, 3 * G * G))),
                      "mu_tex": f32(rng.uniform(0.3, 0.7, 3 * G * G)),
                      "sig_tex": f32(rng.uniform(0.5, 1.5, 100))}}
    return geo, tex
