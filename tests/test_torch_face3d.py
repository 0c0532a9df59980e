"""The port's face3d path against the JAX package's: the mesh rasterizer
(winners, barycentrics, depth, coverage, the rendered image and its
gradients), vertex normals and SH shading, `render_nl3dmm` and
`fitting_losses` through bridged NL3DMM weights, the two-stage
`fit_3dmm`, and the BFM functions. The JAX references are jitted once
(`fast_jit`), its fit's stages compiled with FAST_COMPILE.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import by_content, fast_fit3dmm, fast_jit, nl3dmm_variables

from nerf3dtalker_tpu.models.face3d import bfm as jbfm
from nerf3dtalker_tpu.models.face3d import nl3dmm as jnl
from nerf3dtalker_tpu.models.face3d import rasterizer as jrast
from nerf3dtalker_tpu.train import fit3dmm as jfit
from nerf3dtalker_tpu_torch.data.preprocess import grid_mesh
from nerf3dtalker_tpu_torch.models.face3d import bfm, nl3dmm, rasterizer
from nerf3dtalker_tpu_torch.train import fit3dmm
from nerf3dtalker_tpu_torch.utils import bridge
from nerf3dtalker_tpu_torch.utils.device import uninitialized

# f32 on both sides, the same formulas in the same order: the rasterizer's
# planes and image, render_nl3dmm and the losses (measured <= 2e-6 of
# max|ref|)
RTOL = 1e-5
# normals and SH shading: a handful of f32 operations an element
NORMAL_RTOL = 1e-6
# gradients through the rasterizer: relative L2 against jax.grad
GRAD_REL_L2 = 1e-4
# the fit: Adam over (2, 3) iterations; each leaf by max|err| / max|ref|
FIT_RTOL = 1e-3
# the BFM decode: einsums over 80 / 64 basis columns in another order
BFM_RTOL = 1e-6
H = W = 24


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _scene(B=2, G=6, seed=0):
    """A jittered G x G sheet at depth ~4, a smaller sheet in front of part
    of it (z-buffering), a triangle behind the camera (culled) and a
    degenerate one (no area): verts_cam [B, V, 3], faces [F, 3], inmat."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-1.2, 1.2, G), np.linspace(-1.2, 1.2, G))
    back = np.stack([xs, ys, np.full_like(xs, 4.0)], -1).reshape(-1, 3)
    front = np.stack([xs * 0.4 + 0.3, ys * 0.4 - 0.2, np.full_like(xs, 3.0)], -1).reshape(-1, 3)
    extra = np.array([[-0.5, -0.5, -2.0], [0.5, -0.5, -2.0], [0.0, 0.6, -2.0],
                      [-0.6, 0.1, 3.5], [0.0, 0.1, 3.5], [0.6, 0.1, 3.5]])
    verts = np.concatenate([back, front, extra])
    verts = verts[None] + rng.uniform(-0.05, 0.05, (B,) + verts.shape)
    verts[:, -3:, 1:] = (0.1, 3.5)                         # collinear: no area
    tri = grid_mesh(G).numpy()
    n = G * G
    faces = np.concatenate([tri, tri + n, [[2 * n, 2 * n + 1, 2 * n + 2],
                                           [2 * n + 3, 2 * n + 4, 2 * n + 5]]])
    f = 0.9 * H
    inmat = np.tile(np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]]), (B, 1, 1))
    return (verts.astype(np.float32), faces.astype(np.int32), inmat.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_raster(chunk):
    def fn(verts, faces, inmat):
        return jrast.rasterize_mesh(jrast.project_perspective(verts, inmat), faces, H, W,
                                    chunk=chunk)
    return fast_jit(fn)


@functools.lru_cache(maxsize=None)
def _jax_render_grad():
    def loss(verts, attrs, faces, inmat, wimg):
        img, _ = jrast.render_mesh(verts, faces, attrs, inmat, H, W, background=0.3, chunk=16)
        return jnp.sum(img * wimg), img
    return fast_jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("chunk", [16, 512])
def test_rasterize_mesh_matches_jax(chunk):
    """Winners equal on every pixel (chunks of 16 over 55 faces, a short
    last chunk, and one chunk wider than the mesh); barycentrics, depth and
    coverage to RTOL."""
    verts, faces, inmat = _scene()
    want = _jax_raster(chunk)(verts, faces, inmat)
    screen = rasterizer.project_perspective(_t(verts), _t(inmat))
    got = rasterizer.rasterize_mesh(screen, _t(faces), H, W, chunk=chunk)
    fi = got.face_idx.numpy()
    np.testing.assert_array_equal(fi, np.asarray(want.face_idx))
    n = 2 * 5 * 5                                    # faces a sheet
    assert (fi >= n).any() and (fi < n).any() and (fi < 0).any()   # both sheets, background
    assert not (fi >= 2 * n).any()                                 # culled, degenerate
    for name in ("bary", "zbuf", "mask"):
        assert _rel(getattr(got, name), getattr(want, name)) <= RTOL, name


def test_render_mesh_and_its_gradients_match_jax():
    """The image on a background to RTOL; d(sum(img * w)) / d verts and
    d / d attrs within GRAD_REL_L2 of jax.grad."""
    verts, faces, inmat = _scene(seed=1)
    rng = np.random.default_rng(2)
    attrs = rng.uniform(0, 1, verts.shape[:2] + (3,)).astype(np.float32)
    wimg = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    (_, img_j), (gv_j, ga_j) = _jax_render_grad()(verts, attrs, faces, inmat, wimg)
    v, a = _t(verts).requires_grad_(), _t(attrs).requires_grad_()
    img, mask = rasterizer.render_mesh(v, _t(faces), a, _t(inmat), H, W, background=0.3,
                                       chunk=16)
    (img * _t(wimg)).sum().backward()
    assert _rel(img.detach(), img_j) <= RTOL
    assert _rel_l2(v.grad, gv_j) <= GRAD_REL_L2
    assert _rel_l2(a.grad, ga_j) <= GRAD_REL_L2
    assert np.abs(np.asarray(gv_j)).max() > 0


def test_vertex_normals_and_sh_lighting_match_jax():
    verts, faces, _ = _scene(seed=3)
    rng = np.random.default_rng(3)
    gamma = rng.standard_normal((2, 27)).astype(np.float32) * 0.3
    vcolor = rng.uniform(0, 1, verts.shape).astype(np.float32)
    n_j = jax.jit(jrast.vertex_normals)(verts, faces)
    n = rasterizer.vertex_normals(_t(verts), _t(faces))
    assert _rel(n, n_j) <= NORMAL_RTOL
    s_j = jax.jit(jnl.sh_lighting)(vcolor, np.asarray(n_j), gamma)
    s = nl3dmm.sh_lighting(_t(vcolor), _t(n_j), _t(gamma))
    assert _rel(s, s_j) <= NORMAL_RTOL


G = 7
S = 32


def _port_nl3dmm():
    geo, tex = nl3dmm_variables(G)
    g = bridge.load_into(uninitialized(
        lambda d: nl3dmm.NonLinear3DMM(point_num=G * G, device=d), "cpu"),
        bridge.nl3dmm_state_dict(geo))
    t = bridge.load_into(uninitialized(
        lambda d: nl3dmm.Linear3DMMTexture(point_num=G * G, device=d), "cpu"),
        bridge.nl3dmm_state_dict(tex))
    return g.requires_grad_(False), t.requires_grad_(False)


def _fit_problem(B=2, seed=4):
    """Codes, camera and targets at S^2: the target is the render of other
    codes at another pose plus noise, its mask that render's, the
    landmarks its projected ones plus noise."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    codes = {"iden": f32(0.3 * rng.standard_normal((B, 100))),
             "expr": f32(0.3 * rng.standard_normal((B, 79))),
             "text": f32(0.3 * rng.standard_normal((B, 100))),
             "gamma": f32(0.2 * rng.standard_normal((B, 27))),
             "euler": f32(rng.uniform(-0.15, 0.15, (B, 3))),
             "tvec": f32(np.array([[0.0, 0.0, 5.0]]) + rng.uniform(-0.2, 0.2, (B, 3)))}
    f = S * 1.2
    inmat = f32(np.tile([[[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]]], (B, 1, 1)))
    return codes, inmat, grid_mesh(G).numpy().astype(np.int32), np.arange(68) % (G * G)


@by_content
def _jax_render(geo, tex, codes, inmat, faces, lm_index):
    from nerf3dtalker_tpu.utils.rotations import euler_to_rmat

    def fn(geo, tex, codes, inmat, faces, lm_index):
        r = jnl.render_nl3dmm(geo, tex, codes["iden"], codes["expr"], codes["text"],
                              codes["gamma"], euler_to_rmat(codes["euler"]), codes["tvec"],
                              inmat, faces, lm_index, S, S, chunk=512)
        vcol = jnl.Linear3DMMTexture(point_num=G * G).apply(tex, codes["text"])
        return r, vcol
    out = fast_jit(fn)(geo, tex, codes, inmat, faces, lm_index)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_render(g, t, codes, inmat, faces, lm_index):
    from nerf3dtalker_tpu_torch.utils.rotations import euler_to_rmat

    c = {k: _t(v) for k, v in codes.items()}
    return nl3dmm.render_nl3dmm(g, t, c["iden"], c["expr"], c["text"], c["gamma"],
                                euler_to_rmat(c["euler"]), c["tvec"], _t(inmat), _t(faces),
                                _t(lm_index), S, S, chunk=512)


def test_render_nl3dmm_and_fitting_losses_match_jax():
    """image, mask and lm2d of render_nl3dmm, then every fitting loss on a
    target that differs from the render, to RTOL."""
    geo, tex = nl3dmm_variables(G)
    codes, inmat, faces, lm_index = _fit_problem()
    want, vcol_j = _jax_render(geo, tex, codes, inmat, faces, lm_index)
    g, t = _port_nl3dmm()
    got = _port_render(g, t, codes, inmat, faces, lm_index)
    for name in ("image", "mask", "lm2d", "verts_cam"):
        assert _rel(getattr(got, name), getattr(want, name)) <= RTOL, name
    assert 0 < float(got.mask.mean()) < 1

    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    hm = (rng.uniform(0, 1, (2, S, S, 1)) > 0.3).astype(np.float32)
    lm = rng.uniform(0, S, (2, 68, 2)).astype(np.float32)
    skin = (rng.uniform(0, 1, G * G) > 0.5).astype(np.float32)
    j_render = jnl.NL3DMMRenderResult(*(jnp.asarray(x) for x in want))
    lj = jax.jit(jfit.fitting_losses)(j_render, gt, hm, lm, vcol_j, skin, codes["iden"],
                                      codes["expr"], codes["text"], codes["gamma"])
    lp = fit3dmm.fitting_losses(got, _t(gt), _t(hm), _t(lm), t(_t(codes["text"])), _t(skin),
                                *(_t(codes[k]) for k in ("iden", "expr", "text", "gamma")))
    assert set(lp) == set(lj)
    for k in lj:
        assert abs(float(lp[k]) - float(lj[k])) <= RTOL * abs(float(lj[k])), k


@by_content
def _jax_fit(geo, tex, gt, mask, lm, inmat, faces, lm_index, iters):
    """JAX's fit_3dmm (`fast_fit3dmm`), numpy leaves."""
    with fast_fit3dmm():
        r = jfit.fit_3dmm(geo, tex, gt, mask, lm, inmat, faces, lm_index,
                          skinmask=jnp.ones((G * G,)), stage1_iters=iters[0],
                          stage2_iters=iters[1], chunk=512)
    return {**{k: np.asarray(getattr(r, k)) for k in ("iden", "expr", "text", "gamma",
                                                       "euler", "tvec")}, "losses": r.losses}


def fit_targets(seed=6):
    """Target frames, head masks and landmarks for the fit: another code's
    render plus noise (numpy)."""
    geo, tex = nl3dmm_variables(G)
    codes, inmat, faces, lm_index = _fit_problem(seed=seed)
    r, _ = _jax_render(geo, tex, codes, inmat, faces, lm_index)
    rng = np.random.default_rng(seed)
    gt = np.clip(np.asarray(r.image) + 0.05 * rng.standard_normal(r.image.shape), 0, 1)
    lm = np.asarray(r.lm2d) + rng.standard_normal(r.lm2d.shape)
    return (gt.astype(np.float32), np.asarray(r.mask)[..., None].astype(np.float32),
            lm.astype(np.float32), inmat, faces, lm_index)


def test_fit_3dmm_matches_jax():
    """(2, 3) iterations from the zero codes at the default camera: every
    returned leaf and loss within FIT_RTOL of JAX's; the fit moved."""
    geo, tex = nl3dmm_variables(G)
    gt, mask, lm, inmat, faces, lm_index = fit_targets()
    want = _jax_fit(geo, tex, gt, mask, lm, inmat, faces, lm_index, (2, 3))
    g, t = _port_nl3dmm()
    got = fit3dmm.fit_3dmm(g, t, _t(gt), _t(mask), _t(lm), _t(inmat), _t(faces), _t(lm_index),
                           skinmask=torch.ones(G * G), stage1_iters=2, stage2_iters=3,
                           chunk=512)
    for k in ("iden", "expr", "text", "gamma", "euler", "tvec"):
        assert _rel(getattr(got, k), want[k]) <= FIT_RTOL, k
        assert np.abs(want[k]).max() > 0, k
    for k, v in want["losses"].items():
        assert abs(got.losses[k] - v) <= FIT_RTOL * abs(v), k
    assert got.code().shape == (2, 306)
    R, T = got.w2c()
    assert R.shape == (2, 3, 3) and T.shape == (2, 3)


def test_bfm_matches_jax():
    """split_coeff and compute_for_render (shape, rotation, camera,
    projection, texture, normals, colour) on the synthetic BFM."""
    rng = np.random.default_rng(7)
    coeffs = (0.3 * rng.standard_normal((2, 257))).astype(np.float32)
    jb, pb = jbfm.synthetic_bfm(seed=1), bfm.synthetic_bfm(seed=1, device="cpu")
    for name in jb._fields[:8]:
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)))
    sj, sp = jbfm.split_coeff(coeffs), bfm.split_coeff(_t(coeffs))
    for k in sj:
        np.testing.assert_array_equal(sp[k].numpy(), np.asarray(sj[k]))
    want = jax.jit(lambda c: jbfm.compute_for_render(jb, c))(coeffs)
    got = bfm.compute_for_render(pb, _t(coeffs))
    for name, g, w in zip(("verts_cam", "texture", "color", "lm"), got, want):
        assert _rel(g, w) <= BFM_RTOL, name
    rot = bfm.compute_rotation(_t(coeffs[:, 224:227]))
    assert _rel(rot, jax.jit(jbfm.compute_rotation)(coeffs[:, 224:227])) <= BFM_RTOL
