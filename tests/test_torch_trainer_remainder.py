"""Port parity of the trainer's remainder against the JAX package, on the
CPU in f32 at a tiny config (featmap 8, image 32, 8 samples, hidden 32, 32
feature channels, no VGG): grouped epochs (`train_epoch_group`, the plain
version of the GPU's CUDA graph of the step) against per-epoch calls and
against JAX's orders, keys and steps; `train()`'s grouping, validation
epochs and metrics.jsonl step indices against the JAX trainer's; the native
prefetcher against JAX's binding of the same C++ source; the metric logger,
TensorBoard and the profiler trace; the guard's `guard_max_bad`.

Tolerances: grouped against per-epoch epochs, the same steps in the same
order, per-epoch losses 1e-5 and every leaf 1e-6 absolute; against the JAX
steps, per-epoch losses 1e-4 of their size (f32 sums in another order
through the MLP, the decoder and the LSTM, as `tests/test_torch_train.py`)
and every param 1e-6 absolute per Adam step taken (a step moves a param by
about lr = 1e-4; `tests/test_torch_train.py` holds one step to 1e-6); the
native and the Python mel 2e-4 (`tests/test_native.py`); prefetched batches
exactly.
"""

import dataclasses
import functools
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _jax_reference import audio2style as jax_audio2style
from _jax_reference import fast_jit, seeded_headnerf

from nerf3dtalker_tpu.config import NeRFConfig as JNeRFConfig
from nerf3dtalker_tpu.config import TrainConfig as JTrainConfig
from nerf3dtalker_tpu.data import native as jnative
from nerf3dtalker_tpu.data.dataset import coherent_subject as jcoherent_subject
from nerf3dtalker_tpu.models import HeadNeRF as JHeadNeRF
from nerf3dtalker_tpu.train import losses as jlosses
from nerf3dtalker_tpu.train.step import make_optimizer as jmake_optimizer
from nerf3dtalker_tpu.train.trainer import Trainer as JTrainer
from nerf3dtalker_tpu.utils import observability as jobservability
from nerf3dtalker_tpu.utils.guards import StepGuard as JStepGuard
from nerf3dtalker_tpu_torch import cli
from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
from nerf3dtalker_tpu_torch.data import native
from nerf3dtalker_tpu_torch.data.dataset import coherent_subject, to_tensors
from nerf3dtalker_tpu_torch.data.mel import melspectrogram
from nerf3dtalker_tpu_torch.train.trainer import Trainer, epoch_order
from nerf3dtalker_tpu_torch.utils import bridge, observability

TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=8,
            mlp_hidden=32)
CFG = NeRFConfig(**TINY)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this file's small ops (the share an xdist worker
    takes, `_jax_reference.py`), also when the file runs alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, **kw):
    base = dict(batch_size=2, epochs=4, use_vgg_loss=False, ckpt_dir="",
                log_dir=str(tmp_path / "logs"))
    return TrainConfig(**{**base, **kw})


def _leaves(t):
    return [p.detach().clone() for ps in t.state.params().values() for p in ps]


def test_train_config_has_the_jax_fields_and_defaults():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert port_fields == jax_fields


def test_grouped_epochs_match_per_epoch(tmp_path):
    """3 epochs of one step (2 frames, B=2, each epoch's order shuffled) as
    groups of one (val_every 1) and as one group of three (val_every 3): the
    same losses and leaves (tests/test_epoch_group.py)."""
    runs = []
    for every in (1, 3):
        t = Trainer(CFG, _config(tmp_path / str(every), val_every=every), coherent_subject(CFG, 2),
                    device="cpu")
        t.init(seed=0)
        runs.append((t, t.train(epochs=3)))
    (t1, h1), (t3, h3) = runs
    assert [h["epoch"] for h in h1] == [h["epoch"] for h in h3] == [0, 1, 2]
    for a, b in zip(h1, h3):
        assert abs(a["total_loss"] - b["total_loss"]) <= 1e-5, (a, b)
    for x, y in zip(_leaves(t1), _leaves(t3)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    assert t1.state.step == t3.state.step == 3


def _jax_trainer(tc, frames):
    return JTrainer(JNeRFConfig(**TINY), tc, jcoherent_subject(JNeRFConfig(**TINY), frames))


def test_group_orders_and_seeds_match_jax(tmp_path):
    """A 3-epoch group from epoch 2: the frame orders and the per-step keys
    (seed_base + i, uint32) of JAX's `train_epoch_group`, at a seed whose
    (seed + e) * 100003 wraps 32 bits."""
    seed = 45_000
    jt = _jax_trainer(JTrainConfig(batch_size=2, use_vgg_loss=False, seed=seed, ckpt_dir="",
                                   log_dir=""), 7)
    seen = {}

    def program(n_steps, n_epochs):
        def run(state, cache, xy, orders, seed_bases):
            seen["orders"], seen["seed_bases"] = np.asarray(orders), np.asarray(seed_bases)
            return state, {"total_loss": jnp.zeros(n_epochs)}
        return run

    jt._cached_epoch = program
    jt.state = None
    jt.train_epoch_group(2, 3)
    t = Trainer(CFG, _config(tmp_path, seed=seed), coherent_subject(CFG, 7), device="cpu")
    orders, seeds = t.group_orders(2, 3)
    np.testing.assert_array_equal(orders, seen["orders"])
    jax_seeds = seen["seed_bases"].astype(np.uint32)[:, None] + np.arange(3, dtype=np.uint32)
    np.testing.assert_array_equal(seeds, jax_seeds.astype(np.int64))
    assert (seed + 2) * 100003 > 2**32 and seen["seed_bases"].dtype == np.uint32


@functools.lru_cache(maxsize=None)
def _jax_step_fns(lr, lr_audio, steps_per_epoch):
    """(audio forward, NeRF value-and-grad w.r.t. params and style, audio
    VJP, optax update) of the deterministic JAX step, each compiled once
    (the two pieces joined by the chain rule compile faster than one)."""
    jmodel = JHeadNeRF(JNeRFConfig(**TINY))
    jaudio = jax_audio2style()[0]

    def audio_fn(p, mels):
        return jaudio.apply(p, mels, deterministic=True)

    def nerf_loss(p, style, jb):
        expr = jnp.concatenate([jb["audio_exp"], jb["expr"][:, 64:]], -1)
        pred = jmodel.apply(p, batch_xy=jb["xy"],
                            shape_code=jnp.concatenate([jb["iden"], expr], -1),
                            appea_code=jnp.concatenate([jb["text"], jb["illu"]], -1),
                            audio_style=style, Rmat=jb["Rmat"], Tvec=jb["Tvec"],
                            inv_inmat=jb["inv_inmat"], rng=None)
        out = jlosses.headnerf_losses(pred, jb["gt_rgb"], jb["head_mask"], 1.0)
        return out["total_loss"], out

    opt = jmake_optimizer(JTrainConfig(lr=lr, lr_audio=lr_audio), steps_per_epoch)

    def update(g, s, p):
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s

    return (fast_jit(audio_fn),
            fast_jit(jax.value_and_grad(nerf_loss, argnums=(0, 1), has_aux=True)),
            fast_jit(lambda p, mels, ct: jax.vjp(lambda q: audio_fn(q, mels), p)[1](ct)[0]),
            fast_jit(update), opt)


def test_deterministic_group_matches_jax_steps(tmp_path):
    """A two-epoch group of deterministic steps (no jitter, no dropout: the
    JAX step always draws both) against JAX's loss, gradient and two-group
    Adam update applied over the same frame orders, from the same weights
    (carried across by utils/bridge.py): per-epoch losses and every param."""
    frames, seed, lr, lr_audio = 2, 3, 1e-4, 2e-4
    data = coherent_subject(CFG, frames)
    t = Trainer(CFG, _config(tmp_path, seed=seed, lr=lr, lr_audio=lr_audio), data, device="cpu")
    t.init()
    jparams = {"nerf": seeded_headnerf(0, **TINY)[1], "audio": jax_audio2style()[1]}
    bridge.load_into(t.state.nerf, bridge.headnerf_state_dict(jparams["nerf"]))
    bridge.load_into(t.state.audio, bridge.audio2style_state_dict(jparams["audio"]))
    step = t.fns.train_step
    t.fns = dataclasses.replace(t.fns, train_step=functools.partial(step, deterministic=True))
    got = t.train_epoch_group(0, 2)

    audio_fn, nerf_grad, audio_vjp, update, opt = _jax_step_fns(lr, lr_audio, t.steps_per_epoch)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    opt_state = opt.init(params)
    want = []
    for e in range(2):
        order = epoch_order(frames, seed, e)
        losses = []
        for i in range(frames // 2):
            jb = {k: jnp.asarray(v) for k, v in data.batch(order[2 * i:2 * i + 2]).items()}
            style = audio_fn(params["audio"], jb["mels"])
            (_, out), (g_nerf, g_style) = nerf_grad(params["nerf"], style, jb)
            grads = {"nerf": g_nerf, "audio": audio_vjp(params["audio"], jb["mels"], g_style)}
            params, opt_state = update(grads, opt_state, params)
            losses.append(float(out["total_loss"]))
        want.append(np.mean(losses))
    for g, w in zip(got, want):
        assert abs(g["total_loss"] - w) <= 1e-4 * abs(w), (g["total_loss"], w)
    n_steps = 2 * (frames // 2)
    assert t.state.step == n_steps
    jn = {"nerf": bridge.headnerf_state_dict(params["nerf"]),
          "audio": bridge.audio2style_state_dict(params["audio"])}
    for group, module in (("nerf", t.state.nerf), ("audio", t.state.audio)):
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jn[group][name]), rtol=0,
                                       atol=1e-6 * n_steps, err_msg=f"{group}.{name}")


def _group_stub(trainer, steps, bad_epoch):
    """A trainer's epoch groups replaced by `steps` counted steps an epoch
    that report epoch `bad_epoch` non-finite: `train()`'s grouping alone."""
    def group(start, n):
        trainer.state.step += steps * n
        trainer._last_epoch_steps = steps
        return [{"total_loss": 1.0, "finite_step": 0.0 if start + j == bad_epoch else 1.0}
                for j in range(n)]
    return group


def _jax_train_records(tmp_path, epochs, val_every, steps, bad_epoch):
    """JAX `Trainer.train` with its epoch programs and validation stubbed."""
    jt = object.__new__(JTrainer)
    jt.train_cfg = JTrainConfig(epochs=epochs, val_every=val_every, ckpt_dir="",
                                log_dir=str(tmp_path / "jax_logs"), guard_policy="rollback")
    jt.state = types.SimpleNamespace(step=0)
    jt.start_epoch, jt.history = 0, []
    jt.guard = JStepGuard(policy="rollback")
    jt._use_device_cache, jt._trace_pending = True, False
    jt.train_epoch_group = _group_stub(jt, steps, bad_epoch)
    jt.validate = lambda dump_dir=None, epoch=0: {"PSNR": 1.0}
    jt.save = lambda metrics=None: None
    return jt.train(epochs)


@pytest.mark.parametrize("bad_epoch", [None, 1], ids=["clean", "rollback_in_epoch_1"])
def test_train_records_match_jax_trainer(tmp_path, bad_epoch):
    """`train()` at val_every=3, epochs=5 (groups [0, 1, 2], [3, 4]), both
    trainers' epoch groups stubbed alike: the records' epochs, which of them
    validate or roll back, and each metrics.jsonl line's step, as the JAX
    trainer's; with epoch 1 reported non-finite under the rollback guard (no
    checkpoint yet: training goes on), its group ends there and training
    resumes at epoch 2."""
    epochs, every, steps = 5, 3, 2
    t = Trainer(CFG, _config(tmp_path, epochs=epochs, val_every=every, guard_policy="rollback"),
                coherent_subject(CFG, 2), coherent_subject(CFG, 1, t0=2), device="cpu")
    t.init()
    t.train_epoch_group = _group_stub(t, steps, bad_epoch)
    hist = t.train()
    jhist = _jax_train_records(tmp_path, epochs, every, steps, bad_epoch)

    def summary(h):
        return [(r["epoch"], "PSNR" in r, "rollback" in r) for r in h]

    assert summary(hist) == summary(jhist)

    def lines(d):
        return [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]

    port, jax_lines = lines(tmp_path / "logs"), lines(tmp_path / "jax_logs")
    assert [(r["step"], "PSNR" in r, "rollback" in r) for r in port] == \
        [(r["step"], "PSNR" in r, "rollback" in r) for r in jax_lines]


def test_native_mel_matches_the_port_mel():
    wav = (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(np.float32)
    ours, ref = native.melspectrogram_native(wav), melspectrogram(wav)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_frame_prefetcher_matches_jax_and_the_host_loader(monkeypatch):
    """The port's FramePrefetcher and JAX's on one library built from the one
    C++ source (JAX's binding pointed at the port's build): the same batches
    at the same seed, across passes (5 frames, B=2); and each batch equals
    the host loader's batch of its frames, dtypes included."""
    data = coherent_subject(CFG, 5)
    data.arrays["vgg_f0"] = np.random.default_rng(1).standard_normal((5, 4, 4, 8)).astype(
        np.float16)
    monkeypatch.setattr(jnative, "_LIB_PATH", str(native.build()))
    monkeypatch.setattr(jnative, "_lib", None)
    ours = native.FramePrefetcher(data, 2, seed=11)
    theirs = jnative.FramePrefetcher(data, 2, seed=11)
    try:
        for _ in range(6):
            a, b = ours.next(), theirs.next()
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k].numpy().astype(np.float32), b[k], err_msg=k)
            host = to_tensors(data.batch(ours.last_indices), "cpu")
            for k in host:
                assert a[k].dtype == host[k].dtype and torch.equal(a[k], host[k]), k
    finally:
        ours.close()
        theirs.close()


def test_native_prefetch_feeds_training(tmp_path):
    """`native_prefetch` with the device cache off: an epoch's batches come
    from the prefetcher, one step each."""
    t = Trainer(CFG, _config(tmp_path, native_prefetch=True, device_cache=False),
                coherent_subject(CFG, 2), device="cpu")
    seen = []
    nxt = t._prefetcher.next
    t._prefetcher.next = lambda: seen.append(1) or nxt()
    try:
        rec = t.train_one_epoch(0)
    finally:
        t.close()
    assert len(seen) == 1 and t.state.step == 1 and np.isfinite(rec["total_loss"])


def test_metric_logger_and_trace_wired(tmp_path):
    """metrics.jsonl a line an epoch and the profiler trace of the first
    epoch's step 1 (tests/test_trainer_wiring.py:85)."""
    logd, traced = tmp_path / "logs", tmp_path / "trace"
    t = Trainer(CFG, _config(tmp_path, trace_dir=str(traced), trace_steps=1),
                coherent_subject(CFG, 4),
                coherent_subject(CFG, 1, t0=4), device="cpu")
    hist = t.train(epochs=2)
    assert len(hist) == 2
    recs = [json.loads(x) for x in (logd / "metrics.jsonl").read_text().splitlines()]
    assert len(recs) == 2 and all("total_loss" in r and "SSIM" in r for r in recs)
    assert [r["step"] for r in recs] == [2, 4]
    events = json.loads((traced / observability.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_missing_tensorboard_raises_before_training(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    t = Trainer(CFG, _config(tmp_path, use_tensorboard=True), coherent_subject(CFG, 2),
                device="cpu")
    with pytest.raises(observability.TensorBoardUnavailable, match="tensorboard"):
        t.train(epochs=1)
    assert t.state.step == 0


def test_guard_max_bad_aborts_where_jax_does(tmp_path):
    """guard_policy "abort" with guard_max_bad 3 and one bad step in every
    epoch: the port's trainer raises in the epoch where JAX's guard, fed the
    same counts, does."""
    t = Trainer(CFG, _config(tmp_path, epochs=6, guard_policy="abort", guard_max_bad=3),
                coherent_subject(CFG, 4), device="cpu")
    t.init()
    stub = _group_stub(t, 2, None)
    t.train_epoch_group = lambda e0, n: [{**m, "finite_step": 0.5} for m in stub(e0, n)]
    with pytest.raises(FloatingPointError):
        t.train()
    jguard = JStepGuard(max_bad=3, policy="abort")
    raised_at = None
    for e in range(6):
        try:
            jguard.epoch_check(1, 2, e)
        except FloatingPointError:
            raised_at = e
            break
    assert raised_at == len(t.history) == 2 and t.guard.total_bad == 3


def test_cli_train_flags_and_their_resume_forwarding(tmp_path):
    """`cli train --trace-dir --trace-steps --native-prefetch` on the CPU
    (TensorBoard's writer imports TensorFlow here, seconds: the card's smoke
    writes its events), and --resume's forwarding of the four flags."""
    assert {"native_prefetch", "tensorboard", "trace_dir", "trace_steps"} <= set(
        cli.RESUME_FIELDS)
    assert cli.RESUME_FIELDS["tensorboard"] == "use_tensorboard"
    data = tmp_path / "subject.npz"     # 2 train frames (one step) and 1 val frame
    np.savez(data, **coherent_subject(NeRFConfig(featmap_size=8, pred_img_size=32), 3).arrays)
    args = ["train", "--device", "cpu", "--featmap-size", "8", "--img-size", "32", "--no-vgg",
            "--data", str(data), "--ckpt-dir", str(tmp_path / "ck"),
            "--log-dir", str(tmp_path / "lg")]
    cli.main(args + ["--epochs", "1", "--native-prefetch", "--trace-dir",
                     str(tmp_path / "tr"), "--trace-steps", "2"])
    assert (tmp_path / "tr" / observability.TRACE_FILE).exists()
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint

    saved = load_checkpoint(str(tmp_path / "ck"))["config"]["train"]
    assert (saved["use_tensorboard"], saved["native_prefetch"], saved["trace_steps"]) == (
        False, True, 2)


def test_meters_match_jax_and_trace_writes_a_trace(tmp_path):
    """AverageMeter's running average as JAX's for the same updates, a
    Throughput rate, and `trace` around a region writes its trace.json."""
    ours, theirs = observability.AverageMeter(), jobservability.AverageMeter()
    for v, n in ((1.5, 2), (4.0, 1), (-2.0, 3)):
        ours.update(v, n)
        theirs.update(v, n)
    assert (ours.avg, ours.val, ours.count) == (theirs.avg, theirs.val, theirs.count)
    rate = observability.Throughput()
    rate.tick(4)
    assert rate.tick(4) > 0
    with observability.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    with observability.annotate("span"):
        pass
    events = json.loads((tmp_path / "tr" / observability.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
