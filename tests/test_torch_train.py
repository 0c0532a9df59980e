"""Port parity of the training slice against the JAX package, on the CPU in
f32: VGG16 features and the perceptual loss (weights through the bridge),
`headnerf_losses`, one deterministic train step (losses, every gradient
leaf, the params after one two-group Adam step), the StepLR schedule at a
staircase boundary, the non-finite-step guard, and the SSIM / PSNR metrics.

The train step runs at a tiny config (featmap 8, image 32, 8 samples,
hidden 32, 32 feature channels) through the port's fused route, which on
the CPU is K3 over the kernels' plain versions, against JAX's
`HeadNeRF.apply(rng=None)` + `Audio2Style.apply(deterministic=True)` +
`headnerf_losses` + `make_optimizer` (the JAX `train_step` always jitters
and drops out).

Tolerances, each against the compared value's own magnitude, max|a - b| <=
tol * max|b|: VGG activations 1e-4 (f32 3x3 convs over up to 512 channels
and a resize whose antialiased taps sum in another order); losses and
their gradients 1e-4 (the same math through ten conv layers, eight MLP
layers and the LSTM, f32 sums in another order), 1e-3 for a gradient through
the VGG (an f32 pre-activation within rounding of 0 can take the other side
of a ReLU in one of its ten conv layers). Params after one Adam step within
1e-6 absolute (an Adam step moves each param by about lr = 1e-4, so this
holds the update to ~1% of its size). SSIM 1e-4 and PSNR 1e-4 dB (the JAX package
takes SSIM's statistics in f32, the port in f64).
"""

import jax
import jax.numpy as jnp
import shutil

import numpy as np
import pytest
import torch
from _jax_reference import audio2style as jax_audio2style
from _jax_reference import by_content
from _jax_reference import headnerf as jax_headnerf
from _jax_reference import vgg16 as jax_vgg16

import optax

from nerf3dtalker_tpu.config import NeRFConfig as JNeRFConfig
from nerf3dtalker_tpu.config import TrainConfig as JTrainConfig
from nerf3dtalker_tpu.models import HeadNeRF as JHeadNeRF
from nerf3dtalker_tpu.models import perceptual as jperc
from nerf3dtalker_tpu.train import losses as jlosses
from nerf3dtalker_tpu.train.step import make_optimizer as jmake_optimizer
from nerf3dtalker_tpu.train.step import make_schedule as jmake_schedule
from nerf3dtalker_tpu.utils import metrics as jmetrics
from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
from nerf3dtalker_tpu_torch.data.dataset import synthetic_dataset, to_tensors
from nerf3dtalker_tpu_torch.models.perceptual import VGG16Features, vgg_features
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
from nerf3dtalker_tpu_torch.train import losses
from nerf3dtalker_tpu_torch.train.step import (TrainState, apply_update, build_step_fns,
                                               make_optimizer, make_schedule)
from nerf3dtalker_tpu_torch.utils import bridge, metrics

# 32 feature channels: the decoder's narrowest block is 32 wide (min_feat)
TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=8,
            mlp_hidden=32)


def _close(a, b, tol, name="", atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, name
    err, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * peak + atol, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.fixture(scope="module")
def vgg_pair():
    params = jax_vgg16()
    vgg = VGG16Features()
    bridge.load_into(vgg, bridge.vgg16_state_dict(params))
    return params, vgg.requires_grad_(False)


def test_vgg_features_match_jax_downsampled(vgg_pair):
    """512 -> 224: jax.image.resize's linear filter antialiases when it
    shrinks; F.interpolate(antialias=False) would be 0.49 off here."""
    params, vgg = vgg_pair
    img = np.random.default_rng(0).uniform(0, 1, (1, 512, 512, 3)).astype(np.float32)
    ref = jax.jit(jperc.vgg_features)(params, jnp.asarray(img))
    with torch.no_grad():
        out = vgg_features(vgg, torch.from_numpy(img))
    for i, (a, b) in enumerate(zip(out, ref)):
        _close(a.numpy(), b, 1e-4, f"block {i}")


def test_losses_and_grad_match_jax_with_vgg(vgg_pair):
    """`headnerf_losses` with the VGG term on 32x32 images (upsampled to
    224): every loss term and the gradient of the total on merge_img."""
    params, vgg = vgg_pair
    rng = np.random.default_rng(1)
    pred = {"merge_img": rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32),
            "bg_img": rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)}
    gt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)

    def jtotal(merge):
        out = jlosses.headnerf_losses({**pred, "merge_img": merge}, jnp.asarray(gt),
                                      jnp.asarray(mask), 1.0, vgg_params=params)
        return out["total_loss"], out

    (_, jl), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jnp.asarray(pred["merge_img"]))
    merge = torch.tensor(pred["merge_img"], requires_grad=True)
    tl = losses.headnerf_losses({"merge_img": merge, "bg_img": torch.from_numpy(pred["bg_img"])},
                                torch.from_numpy(gt), torch.from_numpy(mask), 1.0, vgg=vgg)
    assert set(tl) == set(jl) == {"bg_loss", "head_loss", "nonhead_loss", "vgg", "total_loss"}
    for k in tl:
        _close(tl[k].detach().numpy(), jl[k], 1e-4, k)
    tl["total_loss"].backward()
    _close(merge.grad.numpy(), jg, 1e-3, "d total / d merge_img")


def test_losses_match_jax_without_vgg_and_nan_input():
    """The masked MSE terms, with a NaN in merge_img (nan_to_num) and
    precomputed-plane-free, VGG-free config."""
    rng = np.random.default_rng(2)
    merge = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    merge[0, 3, 4, 1] = np.nan
    bg = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    jl = jlosses.headnerf_losses({"merge_img": jnp.asarray(merge), "bg_img": jnp.asarray(bg)},
                                 jnp.asarray(gt), jnp.asarray(mask), 0.0)
    tl = losses.headnerf_losses({"merge_img": torch.from_numpy(merge),
                                 "bg_img": torch.from_numpy(bg)},
                                torch.from_numpy(gt), torch.from_numpy(mask), 0.0)
    assert set(tl) == set(jl)
    for k in tl:
        _close(tl[k].numpy(), jl[k], 1e-6, k)


@pytest.fixture(scope="module")
def step_setup():
    """The JAX and port models on the same weights, and one tiny batch."""
    jparams = {"nerf": jax_headnerf(0, **TINY)[1], "audio": jax_audio2style()[1]}
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    batch = synthetic_dataset(NeRFConfig(**TINY), num_frames=2, seed=3).batch(np.arange(2))
    return jparams, batch


@by_content
def _jax_step(jparams, batch, tc, steps_per_epoch):
    """Losses, gradients and params after one update, JAX. The gradient is
    taken in two compiled pieces joined by the chain rule (the NeRF part,
    with respect to its params and audio_style, then the Audio2Style VJP of
    d audio_style): one program for both compiles four times longer.
    Computed once a process for the same inputs (tests/test_torch_parallel.py
    asks for this file's)."""
    jmodel = JHeadNeRF(JNeRFConfig(**TINY))
    jaudio = jax_audio2style()[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def audio_fn(p):
        return jaudio.apply(p, jb["mels"], deterministic=True)

    def nerf_loss(p, style):
        expr = jnp.concatenate([jb["audio_exp"], jb["expr"][:, 64:]], -1)
        pred = jmodel.apply(p, batch_xy=jb["xy"],
                            shape_code=jnp.concatenate([jb["iden"], expr], -1),
                            appea_code=jnp.concatenate([jb["text"], jb["illu"]], -1),
                            audio_style=style, Rmat=jb["Rmat"], Tvec=jb["Tvec"],
                            inv_inmat=jb["inv_inmat"], rng=None)
        out = jlosses.headnerf_losses(pred, jb["gt_rgb"], jb["head_mask"], 1.0)
        return out["total_loss"], out

    style = jax.jit(audio_fn)(jparams["audio"])
    (_, jl), (g_nerf, g_style) = jax.jit(jax.value_and_grad(nerf_loss, argnums=(0, 1),
                                                            has_aux=True))(jparams["nerf"], style)
    g_audio = jax.jit(jax.grad(lambda p, ct: jnp.sum(audio_fn(p) * ct)))(jparams["audio"], g_style)
    grads = {"nerf": g_nerf, "audio": g_audio}
    opt = jmake_optimizer(tc, steps_per_epoch)

    def update(g, p):
        return optax.apply_updates(p, opt.update(g, opt.init(p), p)[0])

    return jl, grads, jax.jit(update)(grads, jparams)


def _port_state(jparams, tc, steps_per_epoch):
    fns = build_step_fns(NeRFConfig(**TINY), tc, steps_per_epoch, device="cpu", use_fused=True)
    state = fns.init(0)
    bridge.load_into(state.nerf, bridge.headnerf_state_dict(jparams["nerf"]))
    bridge.load_into(state.audio, bridge.audio2style_state_dict(jparams["audio"]))
    return fns, state


def _port_tree(jtree):
    """A JAX {"nerf", "audio"} tree in the port's names and layouts."""
    return {"nerf": bridge.headnerf_state_dict(jtree["nerf"]),
            "audio": bridge.audio2style_state_dict(jtree["audio"])}


def test_train_step_matches_jax(step_setup):
    """One deterministic step: losses, every gradient leaf (the audio
    encoder's reach it through audio_style -> pack_weights' b0 fold -> K3's
    backward), and every param after the two-group Adam update."""
    jparams, batch = step_setup
    tc = TrainConfig(lr=1e-4, lr_audio=2e-4)
    jl, jgrads, jnew = _jax_step(jparams, batch, JTrainConfig(lr=1e-4, lr_audio=2e-4), 4)
    fns, state = _port_state(jparams, tc, 4)
    tb = to_tensors(batch, "cpu")
    before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
    tl, grads = fns.loss_and_grads(state, tb)
    for k in ("bg_loss", "head_loss", "nonhead_loss", "total_loss"):
        _close(tl[k].detach().numpy(), jl[k], 1e-4, k)
    jg = _port_tree(jgrads)
    for group, module in (("nerf", state.nerf), ("audio", state.audio)):
        names = [n for n, p in module.named_parameters() if p.requires_grad]
        assert len(names) == len(grads[group])
        for name, g in zip(names, grads[group]):
            _close(g.numpy(), jg[group][name], 1e-4, f"grad {group}.{name}")
    out = fns.train_step(state, tb, deterministic=True)
    assert float(out["finite_step"]) == 1.0 and state.step == 1
    assert (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches) == before  # CPU
    jn = _port_tree(jnew)
    for group, module in (("nerf", state.nerf), ("audio", state.audio)):
        for name, p in module.named_parameters():
            _close(p.detach().numpy(), jn[group][name], 0.0, f"param {group}.{name}", atol=1e-6)


def test_step_lr_staircase_matches_optax():
    """StepLR at staircase boundaries: step_lr_every=1 epoch of 2 steps."""
    tc = TrainConfig(lr=1e-3, step_lr_every=1, step_lr_gamma=0.5)
    ours = make_schedule(tc, steps_per_epoch=2)
    ref = jmake_schedule(JTrainConfig(lr=1e-3, step_lr_every=1, step_lr_gamma=0.5), 2)
    for count in range(6):
        np.testing.assert_allclose(float(ours(torch.tensor(float(count)))),
                                   float(ref(count)), rtol=1e-6, err_msg=str(count))


def test_update_follows_the_staircase_of_its_step_count():
    """`apply_update` with a constant gradient: Adam's bias-corrected move
    is then lr itself, so the NeRF param moves by the StepLR rate of Adam's
    own step count (step_lr_every 1 epoch of 2 steps, gamma 0.5) and the
    audio param by lr_audio; a skipped step moves nothing and does not
    advance the schedule. Moves within 1e-5 relative (eps 1e-8 against a
    gradient of 1, f32 rounding)."""
    tc = TrainConfig(lr=1e-3, lr_audio=2e-3, step_lr_every=1, step_lr_gamma=0.5)
    nerf_p, audio_p = torch.zeros(3), torch.zeros(2)
    state = TrainState(None, None, make_optimizer({"nerf": [nerf_p], "audio": [audio_p]}, tc),
                       make_schedule(tc, steps_per_epoch=2))
    grads = {"nerf": [torch.ones(3)], "audio": [torch.ones(2)]}
    moves = []
    for ok in (True, True, False, True, True, True):
        before = (nerf_p.clone(), audio_p.clone())
        apply_update(state, grads, torch.tensor(ok))
        moves.append([float((before[0] - nerf_p).max()), float((before[1] - audio_p).max())])
    expect = [[1e-3, 2e-3], [1e-3, 2e-3], [0.0, 0.0], [5e-4, 2e-3], [5e-4, 2e-3], [2.5e-4, 2e-3]]
    np.testing.assert_allclose(moves, expect, rtol=1e-5, atol=0.0)


def test_device_batches_match_host_batches():
    """The trainer's two batch routes, gathered from the device cache
    (`to_device` + `device_batch`) and sliced on the host (`batch`), give
    the same tensors, VGG planes included."""
    ds = synthetic_dataset(NeRFConfig(**TINY), num_frames=4, seed=5)
    ds.arrays["vgg_f0"] = np.random.default_rng(6).standard_normal((4, 8, 2, 2)).astype(np.float16)
    ds.to_device(2, "cpu")
    idx = np.array([3, 1])
    host, dev = to_tensors(ds.batch(idx), "cpu"), ds.device_batch(idx)
    assert set(host) == set(dev) and "vgg_f0" in dev
    for k in host:
        assert torch.equal(host[k], dev[k]), k


def test_non_finite_step_keeps_params_and_adam_state(step_setup):
    """A step on a NaN batch, between two good ones: it reports
    finite_step 0 and leaves every param, both Adam moments and Adam's step
    count of both groups as they were; the next good step counts as the
    second."""
    jparams, batch = step_setup
    fns, state = _port_state(jparams, TrainConfig(), 1)
    bad = dict(batch, gt_rgb=batch["gt_rgb"].copy())
    bad["gt_rgb"][0, 0, 0, 0] = np.nan
    opt = state.opt
    counts = lambda: [float(opt.state[g["params"][0]]["step"]) for g in opt.param_groups]
    snap = lambda: ([p.detach().clone() for ps in state.params().values() for p in ps],
                    [t.clone() for g in opt.param_groups for p in g["params"]
                     for t in (opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"],
                               opt.state[p]["step"])])
    assert float(fns.train_step(state, to_tensors(batch, "cpu"), deterministic=True)
                 ["finite_step"]) == 1.0
    params0, opt0 = snap()
    out = fns.train_step(state, to_tensors(bad, "cpu"), deterministic=True)
    assert float(out["finite_step"]) == 0.0 and not np.isfinite(float(out["total_loss"]))
    params1, opt1 = snap()
    assert all(torch.equal(a, b) for a, b in zip(params0 + opt0, params1 + opt1))
    assert state.step == 2 and counts() == [1.0, 1.0]   # the step is counted; Adam's is not
    out = fns.train_step(state, to_tensors(batch, "cpu"), deterministic=True)
    assert float(out["finite_step"]) == 1.0 and counts() == [2.0, 2.0]
    params2, _ = snap()
    assert not any(torch.equal(a, b) for a, b in zip(params0, params2))


def test_ssim_psnr_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)
    for b in (np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32),
              rng.uniform(0, 1, a.shape).astype(np.float32)):
        np.testing.assert_allclose(float(metrics.ssim_rgb(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(jmetrics.ssim_rgb(jnp.asarray(a), jnp.asarray(b))),
                                   atol=1e-4)
        np.testing.assert_allclose(float(metrics.psnr(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                                   atol=1e-4)


def test_cli_train_save_and_resume_on_cpu(tmp_path, capsys):
    """`cli train --device cpu`: one epoch with a checkpoint, then --resume
    goes on at the saved step; the plain path runs, no kernel launches."""
    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.utils import checkpoints

    args = ["train", "--device", "cpu", "--featmap-size", "8", "--img-size", "32", "--no-vgg",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs")]
    before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
    rec = cli.main(args + ["--epochs", "1"])
    assert rec["epoch"] == 0 and rec["finite_step"] == 1.0 and np.isfinite(rec["total_loss"])
    assert {"SSIM", "PSNR", "sec_per_step", "rays_per_s"} <= set(rec)
    assert checkpoints.load_checkpoint(str(tmp_path / "ckpt"))["step"] == 4   # 8 frames, B=2
    rec = cli.main(args + ["--epochs", "2", "--resume"])
    assert "resumed from step 4 (epoch 1)" in capsys.readouterr().out
    assert rec["epoch"] == 1
    assert checkpoints.load_checkpoint(str(tmp_path / "ckpt"))["step"] == 8
    assert (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches) == before
    # checked: the two checkpoints (~270 MB each, Audio2Style and its Adam
    # moments at full width) need not outlive the test
    shutil.rmtree(tmp_path / "ckpt")
