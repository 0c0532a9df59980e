"""Port parity of single-image fitting (`train/fitting.py`), its rotations,
regularizers and rigs, `fine_zvals`, the viewer math, and `cli fit` /
`cli render`, each against the JAX function on the same numpy-seeded inputs,
weights carried across by `utils/bridge.py`, f32 on the CPU. The fits, their
gradients and the renders run at the JAX fitting test's TINY config
(featmap 8, 8 samples, hidden 32, feat 32, img 32); `cli fit` at the CLI's
smallest config (FIT: featmap 8, image 32, full width). Each test states its
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import JittedApply, seeded_headnerf

from nerf3dtalker_tpu.config import NeRFConfig as JNeRFConfig
from nerf3dtalker_tpu.models import HeadNeRF as JHeadNeRF
from nerf3dtalker_tpu.train import fitting as jfit
from nerf3dtalker_tpu.train import losses as jlosses
from nerf3dtalker_tpu.utils import rotations as jrot
from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.train import fitting, losses
from nerf3dtalker_tpu_torch.utils import bridge, rotations
from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=8,
            mlp_hidden=32)
FIT = dict(featmap_size=8, pred_img_size=32)
# the camera offset the target is rendered at, and the base codes' error
TARGET_EULER, TARGET_T = (0.05, -0.05, 0.0), (0.1, 0.0, 0.0)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _port(cfg_kw, params, **kw):
    model = HeadNeRF(NeRFConfig(**cfg_kw), device="cpu", **kw)
    bridge.load_into(model, bridge.headnerf_state_dict(params))
    return model.eval()


# ---- rotations, rigs, regularizers, fine samples, viewer math

ROT_FNS = {
    "euler_to_rmat": lambda rng: [rng.uniform(-np.pi, np.pi, (4, 3))],
    "quat_to_rmat": lambda rng: [rng.standard_normal((4, 4))],
    "rmat_to_d6": lambda rng: [rng.standard_normal((4, 3, 3))],
    "d6_to_rmat": lambda rng: [rng.standard_normal((4, 6))],
    "quat_to_d6": lambda rng: [rng.standard_normal((4, 4))],
    "rpy_to_rmat": lambda rng: list(rng.uniform(-1, 1, 3)),
    "gaze_to_d6": lambda rng: [rng.uniform(-1, 1, 2)],
}


@pytest.mark.parametrize("name", list(ROT_FNS))
def test_rotation_matches_jax(name):
    """Each function on seeded inputs within 1e-6 of JAX (f32 trig and
    products in the same order)."""
    args = [np.float32(a) if np.ndim(a) == 0 else a.astype(np.float32)
            for a in ROT_FNS[name](np.random.default_rng(len(name)))]
    ref = jax.jit(getattr(jrot, name))(*args)
    got = getattr(rotations, name)(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_rotations_are_orthonormal_and_round_trip():
    """`tests/test_fitting.py:97-117` on the port: zero Euler angles give I,
    rotations are orthonormal with det 1, the d6 round trip, and the
    camera gradient passes through `euler_to_rmat`."""
    torch.testing.assert_close(rotations.euler_to_rmat(torch.zeros(1, 3))[0], torch.eye(3))
    angles = torch.tensor([[0.3, -0.2, 0.5]], requires_grad=True)
    R = rotations.euler_to_rmat(angles)[0]
    torch.testing.assert_close(R @ R.T, torch.eye(3), atol=1e-6, rtol=0)
    assert abs(float(torch.linalg.det(R.detach())) - 1.0) < 1e-6
    torch.testing.assert_close(rotations.quat_to_rmat(torch.tensor([[1.0, 0, 0, 0]]))[0],
                               torch.eye(3), atol=1e-6, rtol=0)
    R2 = rotations.d6_to_rmat(rotations.rmat_to_d6(R[None]))[0]
    torch.testing.assert_close(R2, R, atol=1e-5, rtol=0)
    assert torch.isfinite(rotations.gaze_to_d6(torch.tensor([0.2, -0.1]))).all()
    R.sum().backward()
    assert torch.isfinite(angles.grad).all() and angles.grad.abs().sum() > 0


def test_orbit_cams_and_code_utils_match_jax():
    """The orbit rig and the code helpers (numpy, and the port's
    `euler_to_rmat` in `euler_orbit_cams`) within 1e-6 of JAX."""
    from nerf3dtalker_tpu.utils import camera as jcam
    from nerf3dtalker_tpu.utils import code_utils as jcu
    from nerf3dtalker_tpu_torch.utils import camera, code_utils

    for a, b in zip(camera.orbit_cams(5, 16), jcam.orbit_cams(5, 16)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
    got, ref = code_utils.random_codes(np.random.default_rng(3)), jcu.random_codes(
        np.random.default_rng(3))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    a, b = ref["iden"], ref["iden"][:, ::-1].copy()
    np.testing.assert_allclose(code_utils.lerp_codes(a, b, 5), jcu.lerp_codes(a, b, 5),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(code_utils.slerp_codes(a, b, 5), jcu.slerp_codes(a, b, 5),
                               rtol=1e-6, atol=1e-6)
    for c, d in zip(code_utils.euler_orbit_cams(steps=4), jcu.euler_orbit_cams(steps=4)):
        for k in ("Rmat", "Tvec"):
            np.testing.assert_allclose(c[k], d[k], rtol=1e-6, atol=1e-6)


def test_viewer_math_matches_jax():
    """`utils/interactive.py` is numpy copied as it is: the same arcball
    drag, camera moves, projection and gizmo pixels."""
    from nerf3dtalker_tpu.utils import interactive as jint
    from nerf3dtalker_tpu_torch.utils import interactive

    rots = []
    for mod in (interactive, jint):
        ball = mod.ArcBall(64, 48)
        ball.click((10.0, 20.0))
        cam = mod.ViewerCamera(img_size=64)
        cam.rotate(ball.drag((40.0, 5.0)))
        cam.zoom(0.8)
        cam.pan(0.3, -0.2)
        R, T = cam.w2c()
        pts = mod.project_points(np.eye(3, dtype=np.float32), R, T, np.diag([60.0, 60.0, 1.0]))
        img = mod.draw_axis_gizmo(np.zeros((64, 64, 3), np.uint8), R, T)
        rots.append((R, T, pts, img))
    for x, y in zip(*rots):
        np.testing.assert_array_equal(x, y)


def test_regularizers_and_total_match_jax():
    """The camera and code regularizers and the weighted fitting objective
    within 1e-6 of JAX (means of squares in f32)."""
    rng = np.random.default_rng(4)
    x = {k: rng.standard_normal((1, n)).astype(np.float32)
         for k, n in (("e", 3), ("t", 3), ("i", 100), ("x", 79), ("a", 127), ("b", 9))}
    data = {"total_loss": np.float32(0.37)}
    for bg in (None, "b"):
        jc = jlosses.cam_reg_loss(jnp.asarray(x["e"]), jnp.asarray(x["t"]))
        jk = jlosses.code_reg_loss(*(jnp.asarray(x[k]) for k in "ixa"),
                                   None if bg is None else jnp.asarray(x[bg]))
        c = losses.cam_reg_loss(_t(x["e"]), _t(x["t"]))
        k = losses.code_reg_loss(*(_t(x[n]) for n in "ixa"), None if bg is None else _t(x[bg]))
        assert c.keys() == jc.keys() == {"delta_eular", "delta_tvec"}
        assert k.keys() == jk.keys()
        for ours, ref in ((c, jc), (k, jk)):
            for name in ref:
                np.testing.assert_allclose(float(ours[name]), float(ref[name]), rtol=1e-6,
                                           atol=1e-6)
        total = losses.fitting_total_loss({"total_loss": _t(data["total_loss"])}, c, k)
        ref = jlosses.fitting_total_loss({"total_loss": jnp.asarray(data["total_loss"])}, jc, jk)
        np.testing.assert_allclose(float(total), float(ref), rtol=1e-6, atol=1e-6)


def test_fine_zvals_matches_jax():
    """Deterministic u (a linspace) and JAX's own uniform draws passed to
    the port as `u`, within 1e-5 (f32 cumsum and interpolation); ties of u
    with the CDF (u = 0, and rays whose weights vanish) take the same
    bins."""
    from nerf3dtalker_tpu.ops.rays import fine_zvals as jfine
    from nerf3dtalker_tpu_torch.ops.rays import fine_zvals

    rng = np.random.default_rng(5)
    w = rng.uniform(0, 1, (2, 6, 8)).astype(np.float32) ** 3
    w[0, 0] = 0.0          # a transparent ray: every u lands past the CDF
    zv = np.sort(rng.uniform(0, 6, (2, 6, 8)), -1).astype(np.float32)
    ref = jax.jit(jfine, static_argnums=2)(jnp.asarray(w), jnp.asarray(zv), 9)
    np.testing.assert_allclose(fine_zvals(_t(w), _t(zv), 9).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    key = jax.random.key(7)
    ref = jax.jit(jfine, static_argnums=2)(jnp.asarray(w), jnp.asarray(zv), 9, key)
    u = np.asarray(jax.random.uniform(key, (2, 6, 9), dtype=jnp.float32))
    np.testing.assert_allclose(fine_zvals(_t(w), _t(zv), 9, _t(u)).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_fit_optimizer_matches_optax():
    """The five Adam groups with their scales and the 0.1^(it/iters) decay
    against JAX's `make_fit_optimizer` (optax), fed the same gradients:
    within 1e-6 over 6 steps of a 6-step schedule."""
    rng = np.random.default_rng(6)
    grads = [[rng.standard_normal(v.shape).astype(np.float32) for v in fitting.init_fit_vars()]
             for _ in range(6)]
    tx = jfit.make_fit_optimizer(0.01, 6)
    jvars = jfit.init_fit_vars()
    state = tx.init(jvars)
    update = jax.jit(tx.update)
    fit = fitting.init_fit_vars()
    opt, sched = fitting.make_fit_optimizer(fit, 0.01, 6)
    for g in grads:
        upd, state = update(jfit.FitVars(*map(jnp.asarray, g)), state, jvars)
        jvars = jax.tree_util.tree_map(lambda a, b: a + b, jvars, upd)
        for v, gi in zip(fit, g):
            v.grad = _t(gi)
        opt.step()
        sched.step()
    for ours, ref in zip(fit, jvars):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---- the fit

def _problem(seed=0):
    """A fitting problem at TINY: seeded weights, the target rendered (by
    the port, plain f32) from the true codes at a camera offset, the base
    codes off by +0.1 on iden, a head mask that leaves the corners out."""
    _, params, cam = seeded_headnerf(seed, **TINY)
    rng = np.random.default_rng(seed + 10)
    codes = {k: (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
             for k, n in (("iden", 100), ("expr", 79), ("text", 100), ("illu", 27))}
    aud = (rng.standard_normal((1, 64)) * 0.3).astype(np.float32)
    true = fitting.FitVars(torch.zeros(1, 100), torch.zeros(1, 79), torch.zeros(1, 127),
                           torch.tensor([TARGET_EULER]), torch.tensor([TARGET_T]))
    model = _port(TINY, params)
    with torch.no_grad():
        shape, appea, R, T = fitting.apply_fit_vars(
            true, {k: _t(v) for k, v in codes.items()}, {k: _t(v) for k, v in cam.items()})
        gt = model(_t(ray_grid(8)[0]), shape, appea, _t(aud), R, T,
                   _t(cam["inv_inmat"]))["merge_img"].numpy()
    yy, xx = np.mgrid[:32, :32]
    mask = (((yy - 15.5) ** 2 + (xx - 15.5) ** 2) < 14 ** 2).astype(np.float32)[None, ..., None]
    base = dict(codes, iden=codes["iden"] + 0.1)
    return params, gt, mask, base, cam, aud


_JAX_GRADS = {}


def _jax_loss_grad(fused, params, gt, mask, codes, cam, aud):
    """jax.grad at the first iteration of JAX's fitting objective,
    `fit_single_image`'s `loss_fn` (nerf3dtalker_tpu/train/fitting.py:123-145)
    line for line, through `HeadNeRF(use_fused=fused,
    fused_interpret=fused)`; computed once per process for `_problem()`."""
    if fused in _JAX_GRADS:
        return _JAX_GRADS[fused]
    jmodel = JHeadNeRF(JNeRFConfig(**TINY), use_fused=fused, fused_interpret=fused)
    xy = jnp.asarray(ray_grid(jmodel.cfg.featmap_size)[0])
    codes = {k: jnp.asarray(v) for k, v in codes.items()}
    cam = {k: jnp.asarray(v) for k, v in cam.items()}

    def loss_fn(fit):
        shape_code, appea_code, Rmat, Tvec = jfit.apply_fit_vars(fit, codes, cam, None)
        pred = jmodel.apply(params, batch_xy=xy, shape_code=shape_code, appea_code=appea_code,
                            audio_style=jnp.asarray(aud), Rmat=Rmat, Tvec=Tvec,
                            inv_inmat=cam["inv_inmat"])
        data = jlosses.headnerf_losses(pred, jnp.asarray(gt), jnp.asarray(mask), bg_value=1.0)
        cam_l = jlosses.cam_reg_loss(fit.delta_euler, fit.delta_tvec)
        code_l = jlosses.code_reg_loss(fit.iden_offset, fit.expr_offset, fit.appea_offset)
        return jlosses.fitting_total_loss(data, cam_l, code_l)

    grads = jax.jit(jax.grad(loss_fn))(jfit.init_fit_vars())
    _JAX_GRADS[fused] = [np.asarray(g) for g in grads]
    return _JAX_GRADS[fused]


@pytest.mark.parametrize("fused", [False, True])
def test_gradient_at_iteration_zero_matches_jax(fused):
    """d(fitting objective)/d(each FitVar) at the first iteration, f32,
    within 1e-4 of each leaf's max|ref|. Plain: the port's plain path
    against jax.grad of JAX's loss. Fused: `use_fused=True` on the CPU (the
    plain versions of the forward and backward kernels inside
    `FusedRender`, the backward with its input gradients, which carry the
    camera's gradient) against the JAX `HeadNeRF(use_fused=True,
    fused_interpret=True)`, whose backward is the Pallas kernel in
    interpret mode with input_grads=True."""
    params, gt, mask, codes, cam, aud = _problem()
    ref = _jax_loss_grad(fused, params, gt, mask, codes, cam, aud)
    model = _port(TINY, params, use_fused=fused)
    _, _, grads = fitting.FitProblem(model, gt, mask, codes, cam, aud).gradients(
        fitting.init_fit_vars())
    for name, ours, theirs in zip(fitting.FitVars._fields, grads, ref):
        peak = np.abs(theirs).max()
        assert peak > 0, name
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4 * peak, err_msg=name)
    assert all(p.grad is None and p.requires_grad for p in model.parameters())


def test_fit_single_image_matches_jax():
    """5 Adam iterations with the camera on, against JAX's
    `fit_single_image`.
    - Adam's first step is lr·scale·sign(g) per component, whatever |g|
      is: a component whose gradient lay within rounding of zero could
      take the other sign and land 2·lr·scale (up to 3e-2) away. Checked
      not to happen here: every component's |g| at iteration 0 is at least
      100 times the port's f32 difference from JAX in it (measured ≥ 1300
      times).
    - Later steps divide each component by its own history, so one whose
      gradient passes near zero turns that f32 difference into a relative
      difference of its step: measured 2.7e-5 on the offsets after 5 steps
      of up to 1.5e-2 each. FitVars are held within 1e-4 (under 1 % of one
      step), the final losses within 1e-3 relative (the small head loss,
      3.6e-3, moved by 9.6e-7)."""
    params, gt, mask, codes, cam, aud = _problem()
    g_ref = _jax_loss_grad(False, params, gt, mask, codes, cam, aud)
    model = _port(TINY, params)
    _, _, g0 = fitting.FitProblem(model, gt, mask, codes, cam, aud).gradients(
        fitting.init_fit_vars())
    for name, ours, theirs in zip(fitting.FitVars._fields, g0, g_ref):
        assert np.abs(theirs).min() >= 100 * np.abs(ours.numpy() - theirs).max(), name
    jmodel = JittedApply(JHeadNeRF(JNeRFConfig(**TINY)))
    ref_fit, ref_losses = jfit.fit_single_image(
        jmodel, params, jnp.asarray(gt), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in codes.items()},
        {k: jnp.asarray(v) for k, v in cam.items()}, jnp.asarray(aud), iters=5)
    fit, got_losses = fitting.fit_single_image(model, gt, mask, codes, cam, aud, iters=5)
    for name, ours, theirs in zip(fitting.FitVars._fields, fit, ref_fit):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert got_losses.keys() == ref_losses.keys()
    for k in ref_losses:
        np.testing.assert_allclose(got_losses[k], ref_losses[k], rtol=1e-3, atol=1e-7, err_msg=k)


def test_fitting_reduces_loss():
    """The JAX fitting test's own check (`tests/test_fitting.py:59-77`) on
    the port: the port's seeded TINY model renders the target, the base
    iden is off by +0.3, and 40 iterations at lr 0.02 without the camera
    lower the head loss and move iden's offset below zero; the camera
    deltas stay exactly zero."""
    cfg = NeRFConfig(**TINY)
    model = HeadNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    codes = {k: (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
             for k, n in (("iden", 100), ("expr", 79), ("text", 100), ("illu", 27))}
    aud = (rng.standard_normal((1, 64)) * 0.1).astype(np.float32)
    cam = base_cam(8)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    with torch.no_grad():
        target = model(_t(ray_grid(8)[0]), _t(np.concatenate([codes["iden"], codes["expr"]], -1)),
                       _t(np.concatenate([codes["text"], codes["illu"]], -1)), _t(aud),
                       _t(cam.Rmat), _t(cam.Tvec), _t(cam.inv_inmat))["merge_img"].numpy()
    bad = dict(codes, iden=codes["iden"] + 0.3)
    mask = np.ones_like(target[..., :1])
    fit, after = fitting.fit_single_image(model, target, mask, bad, cam_d, aud, iters=40,
                                          init_lr=0.02, opt_cam=False)
    _, before = fitting.fit_single_image(model, target, mask, bad, cam_d, aud, iters=1,
                                         init_lr=0.0, opt_cam=False)
    assert after["head_loss"] < before["head_loss"]
    assert float(fit.iden_offset.mean()) < 0.0
    assert not fit.delta_euler.any() and not fit.delta_tvec.any()


# ---- renders

def test_renders_match_jax():
    """`render_novel_views` (3 views), `render_morphing` (3 steps) and, on a
    gaze model, `render_with_gaze` with `gaze_angle_error`, against JAX,
    within 1e-4 (f32; measured ~1e-6)."""
    from nerf3dtalker_tpu_torch.utils.camera import base_cam

    params, _, _, codes, _, aud = _problem()
    shape = np.concatenate([codes["iden"], codes["expr"]], -1)
    appea = np.concatenate([codes["text"], codes["illu"]], -1)
    jmodel, model = JHeadNeRF(JNeRFConfig(**TINY)), _port(TINY, params)
    views = fitting.render_novel_views(model, shape, appea, aud, view_num=3)
    ref = jfit.render_novel_views(jmodel, params, jnp.asarray(shape), jnp.asarray(appea),
                                  jnp.asarray(aud), view_num=3)
    assert views.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(views, ref, rtol=1e-4, atol=1e-4)
    cam = base_cam(8)
    morphs = fitting.render_morphing(model, shape, shape + 0.5, appea, aud, cam, steps=3)
    ref = jfit.render_morphing(jmodel, params, jnp.asarray(shape), jnp.asarray(shape + 0.5),
                               jnp.asarray(appea), jnp.asarray(aud), cam, steps=3)
    np.testing.assert_allclose(morphs, ref, rtol=1e-4, atol=1e-4)
    assert not np.allclose(morphs[0], morphs[-1])

    gaze_kw = dict(TINY, include_gaze=True)
    _, gparams, _ = seeded_headnerf(0, **gaze_kw)
    gazes = np.array([[0.1, -0.2], [-0.3, 0.4]], np.float32)
    frames = fitting.render_with_gaze(_port(gaze_kw, gparams), shape, appea, aud, cam, gazes)
    ref = jfit.render_with_gaze(JHeadNeRF(JNeRFConfig(**gaze_kw)), gparams, jnp.asarray(shape),
                                jnp.asarray(appea), jnp.asarray(aud), cam, gazes)
    np.testing.assert_allclose(frames, ref, rtol=1e-4, atol=1e-4)
    assert np.abs(frames[0] - frames[1]).max() > 0
    assert fitting.gaze_angle_error(gazes[0], gazes[1]) == jfit.gaze_angle_error(gazes[0],
                                                                                 gazes[1])
    with pytest.raises(ValueError, match="include_gaze"):
        fitting.render_with_gaze(model, shape, appea, aud, cam, gazes)


# ---- the CLI

def test_cli_fit_and_render_match_jax(tmp_path):
    """`cli fit --device cpu` at featmap 8 / image 32 (full width), --iters
    3, weights from a flax .npz: fitted.npz has exactly the JAX `cmd_fit`'s
    keys, and its values agree with JAX's `fit_single_image` on the same
    synthetic target.
    - Tolerance 2e-3 on the offsets. At full width the f32 gradients
      themselves differ: on the camera the port's and JAX's are each
      2e-3 to 6e-3 (of max|ref|) from an f64 evaluation, and 1e-3 from each
      other. Adam divides each component by its own history, so a component
      whose gradient is near zero carries that difference into a share of
      its step (1.5e-2 a step on iden/expr). Measured 5.1e-4 on one expr
      component, under 1e-4 on the others; a flipped first step would be
      3e-2, a wrong group scale or decay 5e-3 a step or more.
    - The final losses within 1e-4 relative (measured 2e-6).
    `cli render --latents` gives the frames of the port's
    `render_novel_views` on those codes (same arithmetic: exact)."""
    from nerf3dtalker_tpu.utils.checkpoints import save_pytree_npz
    from nerf3dtalker_tpu_torch import cli

    jmodel, params, cam = seeded_headnerf(0, **FIT)
    npz = str(tmp_path / "params.npz")
    save_pytree_npz(npz, {"nerf": params})
    out = str(tmp_path / "fitted.npz")
    rec = cli.main(["fit", "--device", "cpu", "--featmap-size", "8", "--img-size", "32",
                    "--iters", "3", "--params", npz, "--seed", "2", "--out", out])
    assert rec["device"] == "cpu" and rec["out"] == out

    S = 32
    gt = np.random.default_rng(2).uniform(0, 1, (1, S, S, 3)).astype(np.float32)
    zero = {k: jnp.zeros((1, n)) for k, n in (("iden", 100), ("expr", 79), ("text", 100),
                                              ("illu", 27))}
    ref_fit, ref_losses = jfit.fit_single_image(
        JittedApply(jmodel), params, jnp.asarray(gt), jnp.ones((1, S, S, 1)), zero,
        {k: jnp.asarray(v) for k, v in cam.items()}, jnp.zeros((1, 64)), iters=3)
    with np.load(out) as z:
        fitted = {k: z[k] for k in z.files}
    assert set(fitted) == set(jfit.FitVars._fields) | set(zero)
    for name, theirs in ref_fit._asdict().items():
        np.testing.assert_allclose(fitted[name], np.asarray(theirs), rtol=0, atol=2e-3,
                                   err_msg=name)
    for k in ref_losses:
        np.testing.assert_allclose(rec[k], ref_losses[k], rtol=1e-4, atol=1e-6, err_msg=k)

    views = str(tmp_path / "views.npy")
    rec = cli.main(["render", "--device", "cpu", "--featmap-size", "8", "--img-size", "32",
                    "--params", npz, "--latents", out, "--views", "3", "--out", views])
    assert rec["shape"] == [3, S, S, 3]
    shape, appea = cli._codes_from_latents(out)
    rng = np.random.default_rng(0)   # cli render's seeded draws: shape, appea, then style
    rng.standard_normal((1, 179)), rng.standard_normal((1, 127))
    aud = rng.standard_normal((1, 64)).astype(np.float32) * 0.1
    model = _port(FIT, params)
    np.testing.assert_array_equal(np.load(views),
                                  fitting.render_novel_views(model, shape, appea, aud, 3))


def test_cli_fit_refuses_two_weight_sources(tmp_path):
    from nerf3dtalker_tpu_torch import cli

    for cmd in ("fit", "render"):
        with pytest.raises(SystemExit, match="one of them"):
            cli.main([cmd, "--device", "cpu", "--ckpt", str(tmp_path), "--params", "x.npz"])


def test_fit_precision_script_on_the_cpu():
    """`scripts/fit_precision.py` at its tiny scale: K2's plain version in
    f32 gives the same input gradients as f64 autograd through the plain
    forward (within 1e-5 relative L2, d_pe and the camera gradients they
    carry), and bf16 rounding moves them by far more."""
    from nerf3dtalker_tpu_torch.scripts import fit_precision

    rec = fit_precision.main(["--scale", "tiny", "--device", "cpu"])
    assert set(rec["fit_gradient_vs_f64"]) == {"plain_bf16", "plain_f32"}
    k2 = rec["k2_input_grads_vs_f64"]
    assert max(k2["plain_f32"].values()) < 1e-5
    assert k2["plain_bf16"]["d_pe"] > 100 * k2["plain_f32"]["d_pe"]
