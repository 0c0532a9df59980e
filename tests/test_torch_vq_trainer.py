"""The port's Standardized Space stage-1 training and evaluation against the
JAX package's, at the JAX tests' TINY size (`_jax_reference.VQ_TINY`, 48^2
crops): three steps of `train/vq_trainer.py:build_vq_step` against the
jitted JAX `build_vq_step`, `train/vq_eval.py:reconstruct_split` (metrics
and PNG pixels), the r05 script's data builder; and, port only, the
script on the CPU and the `train-vq` / `eval-vq` round trip.
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from _jax_reference import FAST_COMPILE, VQ_TINY, vq_batch, vq_init, vq_state, vq_step

from nerf3dtalker_tpu.config import VQConfig as JVQConfig
from nerf3dtalker_tpu.train import vq_eval as jvq_eval
from nerf3dtalker_tpu.train.vq_trainer import calc_vq_loss as j_calc_vq_loss
from nerf3dtalker_tpu_torch import cli
from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.scripts import vq_run
from nerf3dtalker_tpu_torch.train import vq_eval, vq_trainer
from nerf3dtalker_tpu_torch.utils import bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = VQConfig(**VQ_TINY)
LR = 1e-4                # build_vq_step's default
STEPS = 3
# metrics of each step: f32 sums in other orders on both sides (measured
# up to 3.3e-6)
METRIC_RTOL = 1e-5
# every leaf after three AdamW steps, by the relative L2 of its change
# from the start (the change is ~3 lr an element: comparing the parameters
# themselves would hide it under their size). Adam divides each gradient
# element by its own root mean square, so an element whose gradient is
# rounding-sized takes a step of full size whose sign the rounding picks;
# the relative L2 over a leaf stays small (measured up to 4.2e-3, in the
# AU classifiers' conv weights, 1.1e-3 elsewhere)
DELTA_REL_L2 = 1e-2
# the bias of a conv that feeds an instance norm (`vq_trainer.norm_fed_convs`)
# has a gradient of 0 in exact arithmetic wherever the norm takes the
# channel's mean out: in every channel of the AU classifiers' convs, and in
# a channel of the squasher's or the expander's whose positions all sit on
# one side of the leaky ReLU's knee (one side of 0 before it). f32 rounding
# on each side (~1e-9) then becomes Adam steps of full size and random
# sign. Such a channel is held only to what Adam can move it: each side at
# most STEPS * lr from the start (plus the decay), so 2 STEPS lr apart. The
# other channels of the squasher's and the expander's biases, which
# straddled the knee at some step, are held to DELTA_REL_L2 (measured
# 1.8e-5; all 32 channels together 0.45 and 0.19, from the one-sided ones)

def _port_state(lr=LR):
    init, train_step, eval_step = vq_trainer.build_vq_step(CFG, lr=lr, device="cpu")
    state = init(torch.Generator().manual_seed(0), vq_trainer.to_batch(vq_batch(), "cpu"))
    vq_p, au_p = vq_init()
    bridge.load_into(state.vq, bridge.vq_state_dict(vq_p))
    bridge.load_into(state.au, bridge.au_classifiers_state_dict(au_p))
    return state, train_step


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_three_steps_match_jax():
    jstate = vq_state(LR)
    j_step = vq_step(lr=LR)[1].lower(jstate, vq_batch()).compile(compiler_options=FAST_COMPILE)
    state, step = _port_state()
    start = {**{f"vq.{k}": v.clone() for k, v in state.vq.state_dict().items()},
             **{f"au.{k}": v.clone() for k, v in state.au.state_dict().items()}}
    # per channel, whether a conv's output straddled 0 at some step
    straddled = {}

    def watch(name):
        def hook(_module, _inputs, out):
            both = (out > 0).any(0).any(-1) & (out <= 0).any(0).any(-1)
            straddled[name] = straddled.get(name, both) | both
        return hook

    fed = vq_trainer.norm_fed_convs(state.vq, state.au)
    for name, conv in fed.items():
        if name.startswith("vq."):    # through a leaky ReLU
            conv.register_forward_hook(watch(name))
    for i in range(STEPS):
        b = vq_batch(seed=10 + i)
        jstate, jm = j_step(jstate, b)
        state, m = step(state, vq_trainer.to_batch(b, "cpu"))
        for k, v in jm.items():
            got, want = float(m[k]), float(v)
            assert abs(got - want) <= METRIC_RTOL * abs(want), (i, k, got, want)
    assert state.step == STEPS and int(jstate.step) == STEPS
    want = {**{f"vq.{k}": v for k, v in bridge.vq_state_dict(jstate.vq_params).items()},
            **{f"au.{k}": v
               for k, v in bridge.au_classifiers_state_dict(jstate.au_params).items()}}
    got = {**{f"vq.{k}": v for k, v in state.vq.state_dict().items()},
           **{f"au.{k}": v for k, v in state.au.state_dict().items()}}
    assert set(got) == set(want)
    for k in got:
        delta_want = want[k] - start[k].numpy()
        assert np.abs(delta_want).max() > 0, k
        change = (got[k] - start[k]).numpy()
        one_sided = np.zeros(change.shape, bool)
        if k in fed:     # the classifiers' convs: every channel
            one_sided[:] = ~straddled[k].numpy() if k in straddled else True
        apart = np.abs(got[k].numpy() - want[k])[one_sided]
        assert apart.max(initial=0) <= 2 * STEPS * LR * 1.01, k
        if one_sided.all():
            continue
        err = _rel_l2(change[~one_sided], delta_want[~one_sided])
        assert err <= DELTA_REL_L2, f"{k}: change {err:.3e} relative L2 off JAX's"


def test_port_init_copies_one_classifier():
    """The JAX init stacks one classifier's init n_au times; so does the
    port's, and the AdamW is the one optax.adamw(lr, 2e-3) is."""
    init, _, _ = vq_trainer.build_vq_step(CFG, device="cpu")
    state = init(torch.Generator().manual_seed(0), vq_trainer.to_batch(vq_batch(), "cpu"))
    sds = [clf.state_dict() for clf in state.au]
    assert len(sds) == CFG.n_au
    for sd in sds[1:]:
        assert all(torch.equal(sd[k], sds[0][k]) for k in sd)
    assert sds[0]["linear0.weight"].shape == (1600, 128)
    group = state.opt.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["betas"], group["eps"]) == (
        1e-4, 2e-3, (0.9, 0.999), 1e-8)
    assert len(group["params"]) == len(list(state.vq.parameters())) + len(
        list(state.au.parameters()))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_calc_vq_loss_matches_jax(masked):
    b = vq_batch(seed=3)
    q = np.float32(0.37)
    mask = b["mask"] if masked else None
    want = j_calc_vq_loss(b["gen_img"], b["gt_img"], q, mask)
    got = vq_trainer.calc_vq_loss(torch.from_numpy(b["gen_img"]), torch.from_numpy(b["gt_img"]),
                                  torch.tensor(q),
                                  None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= METRIC_RTOL * abs(float(w))


def test_reconstruct_split_matches_jax(tmp_path):
    """The metrics within 1e-5 relative; the PNGs' pixels equal but where a
    value lies within f32 rounding of a uint8 step (counted, at most one
    level apart)."""
    from PIL import Image

    vq_p, au_p = vq_init()
    data = vq_batch(seed=20, B=3)
    want = jvq_eval.reconstruct_split(JVQConfig(**VQ_TINY), vq_p, au_p, data,
                                      out_dir=str(tmp_path / "jax"), batch_size=2)
    state, _ = _port_state()
    got = vq_eval.reconstruct_split(state.vq, state.au, data, out_dir=str(tmp_path / "port"),
                                    batch_size=2)
    assert set(got) == set(want) == {"num_frames", "rec_l1", "rec_psnr"}
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k]), k
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["0.png", "1.png", "2.png"]
    for n in names:
        a = np.asarray(Image.open(tmp_path / "jax" / n), np.int16)
        b = np.asarray(Image.open(tmp_path / "port" / n), np.int16)
        assert a.shape == (16, 16, 3) and np.abs(a - b).max() <= 1 and (a != b).mean() < 0.01


def _jax_vq_run():
    spec = importlib.util.spec_from_file_location("jax_vq_run",
                                                  os.path.join(ROOT, "scripts", "vq_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _renders(S, n=2, nv=1, seed=0):
    """A renders.npz of `train_r05` at image size S, numpy-seeded."""
    rng = np.random.default_rng(seed)
    d = {}
    for split, k in (("train", n), ("val", nv)):
        gt = rng.uniform(0, 1, (k, S, S, 3)).astype(np.float32)
        d[f"{split}_gt"] = gt
        d[f"{split}_render"] = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
        d[f"{split}_degraded"] = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0,
                                         1).astype(np.float32)
        d[f"{split}_mask"] = (rng.uniform(0, 1, (k, S, S, 1)) > 0.3).astype(np.float32)
        d[f"a_{split}"] = rng.uniform(0, 1, k).astype(np.float32)
        d[f"b_{split}"] = rng.uniform(-1, 1, k).astype(np.float32)
    return d


@pytest.mark.parametrize("S", [512, 64, 600], ids=["r05_no_resize", "upsample", "shrink"])
def test_build_vq_data_matches_jax(S):
    """At r05's 512^2 renders the crops are exactly 112^2 and nothing is
    resized: equal bit for bit. Elsewhere the crops are resized to 112^2,
    by jax.image.resize in JAX and an antialiased bilinear F.interpolate in
    the port: within 1e-5 (both weigh the same taps; measured ~1e-7)."""
    renders = _renders(S, n=1, nv=1)
    want = _jax_vq_run().build_vq_data(renders, "train")
    got = vq_run.build_vq_data(renders, "train")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if S == 512 or k != "crops":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_vq_run_script_on_the_cpu(tmp_path, monkeypatch):
    """The whole flow of the r05 VQ script, its autoencoder at VQ_TINY's
    widths (its own are the reference's: hidden 512, 6 + 6 layers)."""
    widths = {k: v for k, v in VQ_TINY.items() if k != "img_size"}
    monkeypatch.setattr(vq_run, "VQConfig", functools.partial(VQConfig, **widths))
    path = str(tmp_path / "renders.npz")
    np.savez(path, **_renders(32, n=4, nv=2))
    out = str(tmp_path / "vq.json")
    rec = vq_run.main(["--device", "cpu", "--renders", path, "--steps", "2",
                       "--batch-size", "2", "--bench-iters", "1", "--out", out])
    with open(os.path.join(ROOT, "BENCH_VQ_r05.json")) as f:
        jax_rec = json.load(f)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert set(jax_rec["refinement"]) == set(rec["refinement"])
    for regime in ("degraded_conditioning", "high_quality_renders"):
        assert set(jax_rec["refinement"][regime]) <= set(rec["refinement"][regime])
        assert rec["refinement"][regime]["steps"] == 2
        for split, row in rec["refinement"][regime].items():
            if isinstance(row, dict):
                assert set(row) == set(jax_rec["refinement"][regime][split])
                assert all(np.isfinite(v) for v in row.values())
    bench = rec["bench"]
    assert {"img_size", "batch_size", "train_ms_per_step", "infer_ms_per_frame"} <= set(bench)
    assert bench["img_size"] == 16 and bench["train_ms_per_step"] > 0


def test_cli_train_vq_then_eval_vq(tmp_path, capsys):
    data = vq_batch(seed=30, B=3)
    path = str(tmp_path / "split.npz")
    np.savez(path, **data)
    flags = ["--device", "cpu", "--data", path, "--img-size", "16", "--hidden", "32",
             "--embed-dim", "8", "--n-embed", "64", "--layers", "1"]
    rec = cli.main(["train-vq", *flags, "--epochs", "2", "--batch-size", "2", "--ckpt-dir",
                    str(tmp_path / "ckpt")])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["epoch"] for ln in lines[:2]] == [0, 1] and lines[2]["step"] == 2
    assert all(np.isfinite(v) for v in lines[1].values())
    out = str(tmp_path / "gen+")
    ev = cli.main(["eval-vq", "--device", "cpu", "--data", path, "--ckpt", str(tmp_path / "ckpt"),
                   "--out", out])
    assert sorted(os.listdir(out)) == ["0.png", "1.png", "2.png"]
    assert ev["config"]["hidden_size"] == 32 and ev["num_frames"] == 3.0
    # the same state in process: equal metrics
    ck = torch.load(rec["ckpt"], weights_only=True)
    vq, au = vq_trainer.init_modules(VQConfig(**ck["config"]), ck["crop_size"], "cpu")
    vq.load_state_dict(ck["vq"])
    au.load_state_dict(ck["au"])
    own = vq_eval.reconstruct_split(vq, au, data)
    assert {k: ev[k] for k in own} == own and np.isfinite(own["rec_psnr"])
    # a VQ flag typed beside --ckpt that agrees with it is taken; one that
    # disagrees raises
    again = cli.main(["eval-vq", "--device", "cpu", "--data", path, "--ckpt",
                      str(tmp_path / "ckpt"), "--hidden", "32", "--layers", "1", "--out", out])
    assert {k: again[k] for k in own} == own
    with pytest.raises(SystemExit, match="disagrees"):
        cli.main(["eval-vq", "--device", "cpu", "--data", path, "--ckpt",
                  str(tmp_path / "ckpt"), "--hidden", "64", "--out", out])
