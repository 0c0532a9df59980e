"""Port parity of the phase-stacked upsampler slice at featmap 8, image
32/64, 32 feature channels, min_feat 8 (the sizes of the JAX package's
`tests/test_phase_upsampler.py`), weights from the JAX init through the
bridge, inputs from a numpy seed:

  the phase ops (both edge fills), `extract_phase_params` of the bridged
  module, `phase_renderer_forward` against the JAX one and the port's own
  `NeuralRenderer`, the plain kernel versions `reference_block_fwd` /
  `reference_block_bwd` against the JAX `phase_block_forward` and its
  `jax.vjp` (the function the Pallas kernels run), the autograd Function
  `PhaseBlockApply` (on the CPU through the plain versions) against autograd
  through the plain decoder, and `HeadNeRF(use_fused_upsampler=True)`
  against the JAX HeadNeRF.

Tolerances. f32: the stencils and relabelings copy or add the same values
in the same order (exact, checked at 1e-6); products sum over channels in
another order than XLA: forwards within 1e-5, gradients within 2e-4 of
each leaf's own max|ref|, the bounds of the JAX package's own tests.
bf16: both round to bf16 after every product and elementwise op, but XLA
may keep an elementwise chain such as the blur's (A + 2X + B) * 0.25 in
f32 and round once, and JAX rounds the 0.2 of the leaky ReLU to bf16
first; one bf16 ulp is 2^-8 relative and a flip propagates through the
later layers, so bf16 holds only within 3e-2 of max|ref| (forward) and
5e-2 relative L2 (backward, where leaky-ReLU slopes flip with the
rounding of a pre-activation near 0). HeadNeRF: values within 1e-4 and
every gradient leaf's norm within 1e-3 relative, the JAX test's bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import headnerf as jax_headnerf
from _jax_reference import neural_renderer as jax_neural_renderer
from _jax_reference import phase_block as jax_phase_block

from nerf3dtalker_tpu.config import NeRFConfig as JNeRFConfig
from nerf3dtalker_tpu.models import HeadNeRF as JHeadNeRF
from nerf3dtalker_tpu.models import phase_renderer as jpr
from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.models import phase_renderer as pr
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.models.neural_renderer import NeuralRenderer
from nerf3dtalker_tpu_torch.ops.kernels import fused_upsampler as fu
from nerf3dtalker_tpu_torch.utils import bridge
from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

FEATMAP, FEAT_NC, MIN_FEAT = 8, 32, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool contends with XLA's in one process; tiny
    shapes run fastest on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_renderer(img):
    """(JAX params, the port's NeuralRenderer with them) at image `img`."""
    _, params = jax_neural_renderer(FEATMAP, img, FEAT_NC, MIN_FEAT)
    mod = NeuralRenderer(feat_nc=FEAT_NC, min_feat=MIN_FEAT, featmap_size=FEATMAP, img_size=img)
    sd = bridge.headnerf_state_dict(
        {"params": {"fg_CD_predictor": {}, "neural_render": params["params"]}})
    bridge.load_into(mod, {k.removeprefix("neural_render."): v for k, v in sd.items()})
    return params, mod


@functools.lru_cache(maxsize=None)
def _jax_pp(img):
    """The JAX `extract_phase_params` of the image-`img` renderer (jitted:
    eager, its gathers compile one program each)."""
    _, params = jax_neural_renderer(FEATMAP, img, FEAT_NC, MIN_FEAT)
    n_blocks = int(np.log2(img // FEATMAP))
    return jax.jit(jpr.extract_phase_params, static_argnums=1)(params, n_blocks)


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------- phase ops


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("mode", ["reflect", "clamp"])
@pytest.mark.parametrize("fn", ["_shift_m1", "_shift_p1"])
def test_phase_shifts_match_jax(fn, mode, L):
    """Both fine-neighbor shifts with both edge fills, on both axes."""
    X = _rand((L, L, 3, 5, 4), seed=L)
    jfn = jax.jit(getattr(jpr, fn), static_argnums=(1, 2, 3, 4))
    for axis_p, axis_s in ((0, 2), (1, 3)):
        want = np.asarray(jfn(jnp.asarray(X), axis_p, axis_s, L, mode))
        got = getattr(pr, fn)(torch.from_numpy(X), axis_p - 5, axis_s - 5, L, mode).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l", [0, 1, 2])
def test_phase_stencils_and_relabelings_match_jax(l):
    L = 1 << l
    X = _rand((L, L, 4, 3, 5), seed=10 + l)
    Z = _rand((L, L, 4, 3, 8), seed=20 + l)
    bil, blur = (jax.jit(f, static_argnums=1) for f in (jpr.phase_bilinear2x, jpr.phase_blur3))
    pairs = [(bil(jnp.asarray(X), l), pr.phase_bilinear2x(torch.from_numpy(X), l)),
             (jpr.phase_split(jnp.asarray(Z), l), pr.phase_split(torch.from_numpy(Z), l)),
             (jpr.unstack_phases(jnp.asarray(X)), pr.unstack_phases(torch.from_numpy(X)))]
    if l > 0:     # the blur runs at levels >= 1
        pairs.append((blur(jnp.asarray(X), l), pr.phase_blur3(torch.from_numpy(X), l)))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    img = pr.unstack_phases(torch.from_numpy(X))
    np.testing.assert_array_equal(pr.stack_phases(img, l).numpy(), X)
    # leading batch axes
    Xb = _rand((2, L, L, 4, 3, 5), seed=30 + l)
    np.testing.assert_allclose(
        pr.phase_bilinear2x(torch.from_numpy(Xb), l).numpy(),
        np.asarray(jax.vmap(lambda x: bil(x, l))(jnp.asarray(Xb))),
        rtol=1e-6, atol=1e-6)


def test_tiled_identity_gather_is_the_tile_product():
    x = _rand((5, 16), seed=3)
    np.testing.assert_array_equal(x[:, pr.tile_index(16)], x @ jpr._tile_pm_np(16))
    np.testing.assert_array_equal(pr._tile_pm_np(16), jpr._tile_pm_np(16))


@pytest.mark.parametrize("l", [1, 2])
def test_transposed_stencils_are_the_vjps(l):
    """The explicit transposes (edge taps written out) against autograd
    through the forward stencils, f64."""
    L = 1 << l
    X = torch.randn(2, L, L, 3, 4, 3, dtype=torch.float64, requires_grad=True)
    G = torch.randn(2, L, L, 3, 4, 3, dtype=torch.float64)
    G2 = torch.randn(2, 2 * L, 2 * L, 3, 4, 3, dtype=torch.float64)
    (gb,) = torch.autograd.grad((pr.phase_blur3(X, l) * G).sum(), X)
    (gi,) = torch.autograd.grad((pr.phase_bilinear2x(X, l) * G2).sum(), X)
    torch.testing.assert_close(pr.blur3_t(G, l), gb, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(pr.bilinear2x_t(G2, l), gi, rtol=1e-12, atol=1e-12)
    Z = torch.randn(2, L, L, 3, 4, 32, dtype=torch.float64, requires_grad=True)
    G3 = torch.randn(2, 2 * L, 2 * L, 3, 4, 8, dtype=torch.float64)
    (gz,) = torch.autograd.grad((pr.phase_split(Z, l) * G3).sum(), Z)
    torch.testing.assert_close(pr.phase_split_t(G3), gz)
    G4 = torch.randn(2, L, L, 3, 4, 128, dtype=torch.float64)
    (gt,) = torch.autograd.grad((Z[..., torch.as_tensor(pr.tile_index(32))] * G4).sum(), Z)
    torch.testing.assert_close(pr.tile_t(G4), gt)


# ---------------------------------------------------------------- params


def test_extract_phase_params_of_bridged_module():
    params, mod = _port_renderer(64)
    want = _jax_pp(64)
    got = pr.extract_phase_params(mod, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k)


# --------------------------------------------------------------- forward


@pytest.mark.parametrize("img", [32, 64])
def test_phase_renderer_forward_matches_jax_and_module(img):
    params, mod = _port_renderer(img)
    n_blocks = int(np.log2(img // FEATMAP))
    x = _rand((FEATMAP, FEATMAP, FEAT_NC), seed=4)
    want = np.asarray(jax.jit(jpr.phase_renderer_forward, static_argnums=2)(
        jnp.asarray(x), _jax_pp(img), n_blocks))
    with torch.no_grad():
        got = pr.phase_renderer_forward(torch.from_numpy(x), pr.extract_phase_params(mod, n_blocks),
                                        n_blocks).numpy()
        module = mod(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, module, rtol=1e-5, atol=1e-5)


def _block_case(i, B=2, seed=5):
    """Block i of the featmap-8 / image-64 renderer: (JAX bp, port weight
    list, net, rgb, g_net_next, g_rgb_next), numpy inputs."""
    params, mod = _port_renderer(64)
    bp = jpr.block_params(_jax_pp(64), i)
    wl = [w.detach() for w in fu.block_weight_list(pr.extract_phase_params(mod, 3), i)]
    L = 1 << i
    C, Cn = wl[0].shape[0], wl[4].shape[1]
    rng = np.random.default_rng(seed + i)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (bp, wl, r(B, L, L, FEATMAP, FEATMAP, C), r(B, L, L, FEATMAP, FEATMAP, 3),
            r(B, 2 * L, 2 * L, FEATMAP, FEATMAP, Cn), r(B, 2 * L, 2 * L, FEATMAP, FEATMAP, 3))


def _stack(a):      # [B, L, L, Hc, Wc, C] numpy -> the kernels' [B, P, Hc, Wc, C] tensor
    return torch.from_numpy(a.reshape(a.shape[0], -1, *a.shape[3:]))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_reference_block_fwd_matches_jax(i):
    bp, wl, net, rgb, _, _ = _block_case(i)
    want = jax_phase_block(i)[0](jnp.asarray(net), jnp.asarray(rgb), bp)
    got = fu.reference_block_fwd(_stack(net), _stack(rgb), wl, i)
    assert fu.phase_block_fwd(_stack(net), _stack(rgb), wl, i, torch.float32)[0].equal(got[0])
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_reference_block_bwd_matches_jax_vjp(i):
    bp, wl, net, rgb, gn, gr = _block_case(i)
    g_net, g_rgb, g_bp = jax_phase_block(i)[1](*(jnp.asarray(a) for a in (net, rgb)), bp,
                                               jnp.asarray(gn), jnp.asarray(gr))
    got_net, got_rgb, got_w = fu.reference_block_bwd(_stack(net), _stack(rgb), wl, i,
                                                     _stack(gn), _stack(gr))
    checks = [("g_net", got_net, g_net), ("g_rgb", got_rgb, g_rgb)]
    checks += [(k, g, g_bp[k]) for k, g in zip(bp, got_w)]
    for name, got, want in checks:
        want = np.asarray(want).reshape(got.shape)
        assert got.dtype == torch.float32, name
        assert _max_rel(got.numpy(), want) <= 2e-4, (name, _max_rel(got.numpy(), want))


def test_reference_block_bf16_loosely_matches_jax():
    i = 1
    bp, wl, net, rgb, gn, gr = _block_case(i)
    jf, jv = jax_phase_block(i, bf16=True)
    want = jf(jnp.asarray(net), jnp.asarray(rgb), bp)
    bf = torch.bfloat16
    tnet, trgb = _stack(net).to(bf), _stack(rgb).to(bf)
    got = fu.reference_block_fwd(tnet, trgb, wl, i, bf)
    for g, w in zip(got, want):
        assert g.dtype == bf
        assert _max_rel(g.float().numpy(), np.asarray(w, np.float32).reshape(g.shape)) <= 3e-2
    g_net, _, g_bp = jv(jnp.asarray(net, jnp.bfloat16), jnp.asarray(rgb, jnp.bfloat16), bp,
                        jnp.asarray(gn, jnp.bfloat16), jnp.asarray(gr, jnp.bfloat16))
    got_net, _, got_w = fu.reference_block_bwd(tnet, trgb, wl, i, _stack(gn).to(bf),
                                               _stack(gr).to(bf), bf)
    for name, g, w in [("g_net", got_net, g_net)] + [(k, g, g_bp[k]) for k, g in zip(bp, got_w)]:
        w = np.asarray(w, np.float32).reshape(g.shape)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 5e-2, (name, rel)


# ---------------------------------------------------------- autograd path


def test_phase_block_apply_grads_match_plain_decoder():
    """f32 on the CPU: the fused decoder (PhaseBlockApply over the plain
    versions, hand-written VJP) against autograd through the port's
    NeuralRenderer, for the input and every parameter."""
    _, mod = _port_renderer(32)
    x = torch.from_numpy(_rand((2, FEATMAP, FEATMAP, FEAT_NC), seed=6)).requires_grad_()
    params = list(mod.parameters())
    target = torch.from_numpy(_rand((2, 32, 32, 3), seed=7)).sigmoid()

    def grads(decode):
        loss = ((decode(x) - target) ** 2).sum()
        return torch.autograd.grad(loss, [x] + params, allow_unused=True)

    before = fu.phase_block_bwd.launches
    fused = grads(lambda t: fu.fused_upsampler(t, pr.extract_phase_params(mod, 2), 2,
                                               torch.float32))
    plain = grads(mod)
    assert fu.phase_block_bwd.launches == before      # the CPU takes the plain versions
    names = ["x"] + [n for n, _ in mod.named_parameters()]
    for name, a, b in zip(names, fused, plain):
        if b is None:                                 # bg_featmap is not read by the decoder
            assert a is None, name
            continue
        assert _max_rel(a.numpy(), b.numpy()) <= 2e-4, (name, _max_rel(a.numpy(), b.numpy()))


def test_kernel_gate():
    fu.check_dims(256, 128, 64, 64)
    fu.check_dims(64, 32, 32, 32)
    with pytest.raises(ValueError, match="compiled for"):
        fu.check_dims(32, 16, 8, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        fu.check_dims(256, 128, 12, 12)


# --------------------------------------------------------------- HeadNeRF

TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=8,
            mlp_hidden=32)


@pytest.fixture(scope="module")
def headnerf_case():
    """Inputs as the JAX test makes them, and the JAX HeadNeRF's images and
    loss gradients from one jitted call (its standard decoder: the JAX test
    holds the fused-upsampler path to it at these bounds)."""
    _, params, _ = jax_headnerf(0, **TINY)
    rng = np.random.default_rng(0)
    xy, _ = ray_grid(8)
    cam = base_cam(8)
    inp = dict(batch_xy=xy, shape_code=rng.standard_normal((1, 179)).astype(np.float32) * 0.1,
               appea_code=rng.standard_normal((1, 127)).astype(np.float32) * 0.1,
               audio_style=rng.standard_normal((1, 64)).astype(np.float32) * 0.1,
               Rmat=cam.Rmat, Tvec=cam.Tvec, inv_inmat=cam.inv_inmat)
    model = JHeadNeRF(JNeRFConfig(**TINY))

    def loss(p, i):
        out = model.apply(p, **i)
        return (jnp.mean((out["merge_img"] - 0.4) ** 2)
                + jnp.mean((out["bg_img"] - 1.0) ** 2)), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in inp.items()})
    return params, inp, out, g


def test_headnerf_fused_upsampler_matches_jax(headnerf_case):
    params, inp, out, g = headnerf_case
    model = HeadNeRF(NeRFConfig(**TINY), use_fused_upsampler=True, device="cpu")
    assert model._fusedup_ok
    bridge.load_into(model, bridge.headnerf_state_dict(params))
    got = model(**{k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in inp.items()})
    for key in ("merge_img", "bg_img"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(out[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    loss = (((got["merge_img"] - 0.4) ** 2).mean() + ((got["bg_img"] - 1.0) ** 2).mean())
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = bridge.headnerf_state_dict(jax.tree_util.tree_map(np.asarray, g))
    assert sorted(want) == sorted(grads)
    for k, v in want.items():
        n1, n2 = float(np.linalg.norm(v)), float(grads[k].norm())
        assert abs(n1 - n2) <= 1e-3 * max(n1, n2, 1e-6), (k, n1, n2)


def test_headnerf_fused_upsampler_gate():
    """Off by default; on only where the image is 2, 4 or 8 times the
    featmap, else the plain decoder runs (as in the JAX package)."""
    assert not HeadNeRF(NeRFConfig(**TINY), device="cpu")._fusedup_ok
    odd = dict(TINY, pred_img_size=24)
    assert not HeadNeRF(NeRFConfig(**odd), use_fused_upsampler=True, device="cpu")._fusedup_ok


# ------------------------------------------------- the kernels' weight streams
#
# CPU twins of the CUDA kernels' algorithms: each consumes its kernel's
# pre-packed weight stream chunk by chunk, in order, undoing each chunk's
# core-matrix layout (`fu.stream_layout`), and multiplies it into the
# product the kernel multiplies it into; f32, at each block's real widths
# on an 8 x 8 featmap grid. A chunk-order, layout or decomposition bug
# shows here without a card. f32 sums in another order than the plain
# version's: within 1e-5 of each output's own max|ref|.

TWIN_RTOL = 1e-5


def _block_weights(i, seed=11):
    """Block i's weight list at the kernels' widths, f32 from a numpy seed
    (nonzero biases)."""
    C, Cn = fu.KERNEL_DIMS[i]
    rng = np.random.default_rng(seed + i)
    shapes = [(C, 2 * C), (2 * C,), (2 * C, 4 * C), (4 * C,), (C, Cn), (Cn,), (Cn, 3), (3,)]
    if i == 0:
        shapes += [(C, 3), (3,)]
    return [torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[0] if len(s) == 2 else 10))
                             .astype(np.float32)) for s in shapes]


def _block_inputs(i, B=1, hw=8, seed=12):
    C, Cn = fu.KERNEL_DIMS[i]
    P = 4 ** i
    rng = np.random.default_rng(seed + i)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return r(B, P, hw, hw, C), r(B, P, hw, hw, 3), r(B, 4 * P, hw, hw, Cn), r(B, 4 * P, hw, hw, 3)


class _Stream:
    """A packed stream read chunk by chunk in its layout's order."""

    def __init__(self, kind, wl, C, Cn):
        self.data, = fu.pack_streams((kind,), wl[0], wl[2], wl[4])
        chunks = (fu.chain_stream_chunks(C) if kind == "chain"
                  else fu.tile_stream_chunks(C, Cn, kind == "rec"))
        self.layout = iter(fu.stream_layout(chunks, C, Cn))

    def take(self, k, n):
        """The next chunk as B [k, n], its core matrices undone."""
        _, major, kk, nn, off = next(self.layout)
        assert (kk, nn) == (k, n), ((kk, nn), (k, n))
        flat = self.data[off:off + k * n]
        if major == "n":   # [n / 8][k / 8][8 k][8 n]
            return flat.reshape(n // 8, k // 8, 8, 8).permute(1, 2, 0, 3).reshape(k, n)
        return flat.reshape(n // 8, k // 8, 8, 8).permute(1, 3, 0, 2).reshape(k, n)

    def done(self):
        return next(self.layout, None) is None


def _lrelu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def _twin_tile(net, wl, i, stream, grads=None):
    """The tile kernel's products over the whole image, f32: D1 by passes,
    D2 by channel chunks (shuffled and blurred alone, multiplied into
    feat_layer's sum onto its bias). Returns (net', saved) and, with grads
    = (g_net', g_rgb'), also g_af and g_up = g_af wf^T from the stream's
    tail."""
    C, Cn = fu.KERNEL_DIMS[i]
    cfg = fu.TILE_CFG[(C, Cn)]
    N1, KC1, KCH, KC2, GNB = (cfg[k] for k in ("N1", "KC1", "KCH", "KC2", "GNB"))
    w1, b1, w2, b2, wf, bf, wr = wl[:7]
    B, P, Hc, Wc, _ = net.shape
    L = 1 << i
    x = net.reshape(-1, C)
    h1 = []
    for p1 in range(2 * C // N1):
        acc = b1[p1 * N1:(p1 + 1) * N1].expand(x.shape[0], N1)
        for kc in range(C // KC1):
            acc = acc + x[:, kc * KC1:(kc + 1) * KC1] @ stream.take(KC1, N1)
        h1.append(_lrelu(acc))
    h1 = torch.cat(h1, -1)
    tidx = torch.as_tensor(pr.tile_index(C))
    accf = bf.expand(4 * x.shape[0], Cn)
    a2, up = torch.zeros(x.shape[0], 4 * C), []   # a2 in phase-major columns
    for j in range(C // KCH):
        cols = fu._w2_cols(C, j * KCH, KCH)
        acc = b2[cols].expand(x.shape[0], 4 * KCH)
        for s in range(2 * C // KC2):
            acc = acc + h1[:, s * KC2:(s + 1) * KC2] @ stream.take(KC2, 4 * KCH)
        a2[:, cols] = acc
        z = _lrelu(acc) + x[:, tidx[cols]]
        u = pr.phase_blur3(pr.phase_split(z.reshape(B, L, L, Hc, Wc, 4 * KCH), i), i + 1)
        up.append(u.reshape(-1, KCH))
        accf = accf + up[-1] @ stream.take(KCH, Cn)
    nn = _lrelu(accf)
    saved = dict(h1=h1, a2=a2, up=torch.cat(up, -1), af=accf, nn=nn)
    if grads is not None:
        gn, gr = (g.reshape(-1, g.shape[-1]) for g in grads)
        g_af = torch.where(accf >= 0, 1.0, 0.2) * (gn + gr @ wr.t())
        g_up = []
        for pg in range(C // GNB):
            acc = torch.zeros(g_af.shape[0], GNB)
            for s in range(Cn // fu.GKC):
                acc = acc + g_af[:, s * fu.GKC:(s + 1) * fu.GKC] @ stream.take(fu.GKC, GNB)
            g_up.append(acc)
        saved.update(g_af=g_af, g_up=torch.cat(g_up, -1))
    return nn, saved


@pytest.mark.parametrize("i", [0, 1, 2])
def test_fwd_stream_twin_matches_reference_block_fwd(i):
    """K5-fwd's stream (forward) consumed as the tile kernel consumes it,
    with the rgb heads and path, against `reference_block_fwd` in f32."""
    C, Cn = fu.KERNEL_DIMS[i]
    wl = _block_weights(i)
    net, rgb, _, _ = _block_inputs(i)
    B, P, Hc, Wc, _ = net.shape
    L = 1 << i
    stream = _Stream("fwd", wl, C, Cn)
    nn, _ = _twin_tile(net, wl, i, stream)
    assert stream.done()
    rgb_i = net.reshape(-1, C) @ wl[8] + wl[9] if i == 0 else rgb.reshape(-1, 3)
    rgbup = pr.phase_blur3(pr.phase_bilinear2x(rgb_i.reshape(B, L, L, Hc, Wc, 3), i), i + 1)
    rgb_next = rgbup.reshape(-1, 3) + nn @ wl[6] + wl[7]
    ref = fu.reference_block_fwd(net, rgb, wl, i, torch.float32)
    for name, a, b in (("net_next", nn, ref[0]), ("rgb_next", rgb_next, ref[1])):
        err, peak = float((a.reshape(b.shape) - b).abs().max()), float(b.abs().max())
        assert err <= TWIN_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.mark.parametrize("i", [0, 1, 2])
def test_bwd_plan_twin_matches_reference_block_bwd(i):
    """K5-bwd's plan in f32: the recompute pass on its stream (the forward's
    products, then g_af and g_up = g_af wf^T from the stream's tail); the
    chain pass on its stream (channel chunks in the kernel's order: g_z,
    g_a2, the tiled identity's transpose summed over the four chunks that
    share its channels, g_a1 = slope(h1) g_a2 w2^T, g_net = g_a1 w1^T +
    g_tile (+ g_rgb_0 wr_0^T)); the rgb path; the X^T G jobs (products
    here) — against `reference_block_bwd`."""
    C, Cn = fu.KERNEL_DIMS[i]
    wl = _block_weights(i)
    net, rgb, gn, gr = _block_inputs(i)
    B, P, Hc, Wc, _ = net.shape
    L = 1 << i
    rec = _Stream("rec", wl, C, Cn)
    _, s = _twin_tile(net, wl, i, rec, grads=(gn, gr))
    assert rec.done()

    chain = _Stream("chain", wl, C, Cn)
    x = net.reshape(-1, C)
    g_up = s["g_up"].reshape(B, 2 * L, 2 * L, Hc, Wc, C)
    k2 = fu.CHAIN_KCH
    acc1 = torch.zeros(x.shape[0], 2 * C)
    g_tile = torch.zeros(x.shape[0], C)
    g_a2 = torch.zeros(x.shape[0], 4 * C)
    for ch in range(C // k2):
        jj, m = divmod(ch, 4)
        c0 = jj * k2 + m * (C // 4)
        g_z = pr.phase_split_t(pr.blur3_t(g_up[..., c0:c0 + k2], i + 1)).reshape(-1, 4 * k2)
        cols = fu._w2_cols(C, c0, k2)
        ga2 = torch.where(s["a2"][:, cols] >= 0, 1.0, 0.2) * g_z
        g_a2[:, cols] = ga2
        for p in range(4):
            acc1 = acc1 + ga2[:, p * k2:(p + 1) * k2] @ chain.take(16, 2 * C)
        for p in range(4):
            for cc in range(k2):
                g_tile[:, 4 * (jj * k2 + cc) + p] += g_z[:, p * k2 + cc]
    g_a1 = torch.where(s["h1"] >= 0, 1.0, 0.2) * acc1
    acc2 = torch.zeros(x.shape[0], C)
    for r in range(2 * C // 16):
        acc2 = acc2 + g_a1[:, 16 * r:16 * r + 16] @ chain.take(16, C)
    g_net = acc2 + g_tile
    assert chain.done()
    g_rgb = pr.bilinear2x_t(pr.blur3_t(gr.reshape(B, 2 * L, 2 * L, Hc, Wc, 3), i + 1), i)
    g_rgb = g_rgb.reshape(-1, 3)
    if i == 0:
        g_net = g_net + g_rgb @ wl[8].t()
    up, g_af, nn = s["up"], s["g_af"], s["nn"]
    gw = [x.t() @ g_a1, g_a1.sum(0), s["h1"].t() @ g_a2, g_a2.sum(0), up.t() @ g_af,
          g_af.sum(0), nn.t() @ gr.reshape(-1, 3), gr.reshape(-1, 3).sum(0)]
    if i == 0:
        gw += [x.t() @ g_rgb, g_rgb.sum(0)]
        g_rgb = torch.zeros_like(g_rgb)
    ref_net, ref_rgb, ref_w = fu.reference_block_bwd(net, rgb, wl, i, gn, gr, torch.float32)
    checks = [("g_net", g_net, ref_net), ("g_rgb", g_rgb, ref_rgb)]
    checks += [(f"weight {k}", a, b) for k, (a, b) in enumerate(zip(gw, ref_w))]
    for name, a, b in checks:
        err, peak = float((a.reshape(b.shape) - b).abs().max()), float(b.abs().max())
        assert err <= TWIN_RTOL * max(peak, 1e-30), \
            f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"
