"""Port parity of multi-rank training over a (data, rays) mesh, on the CPU in
f32 with the kernels' plain versions. Ranks are spawned processes over gloo
with a file rendezvous under `tmp_path`; what they run is the port's own
rank-side code (`parallel.selfcheck`, `cli train`), so they import torch
only. Three spawns hold every check: 4 ranks on a 2 x 2 mesh, 2 ranks on
2 x 1 and 1 x 2 meshes, and `cli train` (4 ranks, then again for
`--resume`). All start before the first test runs, and the ranks work
while this process computes the JAX and single-rank references.

  (a) K4's plain version on 2 x 2 against JAX's `fused_render_spmd` on
      `make_mesh(2, 2)` (Pallas in interpret mode): outputs and every weight
      gradient within 1e-5 of max|ref| (the same f32 math, sums in another
      order; the data sum of the shared keys, which the step does, is done
      here by adding the data ranks' gradients);
  (b) one deterministic step on each mesh against the port's single-rank
      step: losses within 1e-5 relative, gradients within 1e-4 of each
      leaf's max|ref|, params after the Adam step within 1e-4 relative and
      1e-6 absolute (the bounds of the JAX package's own sharded-step test,
      tests/test_fused_training.py:113-128), and on 2 x 2
      against the JAX step of tests/test_torch_train.py at that test's
      tolerances (losses and gradients 1e-4 of max|ref|, params 1e-6
      absolute); every rank's gradients and params are bit-identical;
  (c) `gather_rays`' backward is this rank's slice of the gradient, not Rr
      times it (exact: a copy);
  (d) the losses with head masks of very different counts on the two data
      ranks equal the single-rank losses within 1e-6 relative, and each
      rank's gradient on its rows of merge_img is the single-rank one
      within 1e-6 relative (a local-mean denominator would be off by the
      ratio of the counts);
  (e) Audio2Style under a 2 x 1 mesh, with dropout: each rank's rows equal
      the rows of the whole sequence's output within 1e-5 relative (the
      same ops on the same inputs; the CPU's matmuls split their f32 sums by
      the process's thread count, and the ranks run on one thread each);
  (f) `cli train --device cpu --data-parallel 2 --ray-parallel 2` writes
      one checkpoint after an epoch, and `--resume` goes on from it.
"""

import functools
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import audio2style as jax_audio2style
from _jax_reference import headnerf as jax_headnerf
from test_torch_train import TINY, _close, _jax_step, _port_state, _port_tree

from nerf3dtalker_tpu.config import TrainConfig as JTrainConfig
from nerf3dtalker_tpu.models.nerf_mlp import NeRFMLP as JNeRFMLP
from nerf3dtalker_tpu.ops.pallas import fused_render as jfr
from nerf3dtalker_tpu.parallel import make_mesh as jmake_mesh
from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
from nerf3dtalker_tpu_torch.data.dataset import synthetic_dataset, to_tensors
from nerf3dtalker_tpu_torch.models.audio import Audio2Style
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
from nerf3dtalker_tpu_torch.parallel import selfcheck
from nerf3dtalker_tpu_torch.train.losses import headnerf_losses
from nerf3dtalker_tpu_torch.utils import bridge

LR = dict(lr=1e-4, lr_audio=2e-4)
HID, FEAT, NS, B, R = 32, 16, 8, 2, 32      # K4 inputs, as tests/test_torch_fused_render.py


@functools.lru_cache(maxsize=None)
def _k4_inputs(seed=0):
    """Global K4 inputs and cotangents, and the JAX and port packed weights
    of one NeRFMLP with the same per-frame codes."""
    rng = np.random.default_rng(seed)
    mlp = JNeRFMLP(vp_channels=63 + 179, vd_channels=127, hidden=HID, out_features=FEAT)
    codes = [(rng.standard_normal((B, n)) * 0.1).astype(np.float32) for n in (179, 127, 64)]
    params = jax.jit(mlp.init)(jax.random.key(seed), jnp.zeros((1, 2, 2, 63)),
                               *(c[:1] for c in codes))["params"]
    pe = rng.standard_normal((B, R, NS, 64)).astype(np.float32)
    pe[..., 63:] = 0.0
    zd = (np.abs(rng.standard_normal((B, R, NS))) * 0.3).astype(np.float32)
    zv = np.sort(rng.standard_normal((B, R, NS)), axis=-1).astype(np.float32)
    cot = (rng.standard_normal((B, R, FEAT)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32))
    jpacked = jfr.pack_weights(params, *(jnp.asarray(c) for c in codes))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tpacked = fr.pack_weights(tparams, *(torch.from_numpy(c) for c in codes))
    return (pe, zd, zv), cot, jpacked, tpacked


def _loss_inputs(seed=7):
    """merge/bg images, GT and head masks whose counts differ between the two
    frames: frame 0 is 90 % head, frame 1 about 5 %."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (2, 16, 16, 1))
    mask = np.concatenate([u[:1] < 0.9, u[1:] < 0.05]).astype(np.float32)
    return {"merge_img": rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32),
            "bg_img": rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32),
            "gt_rgb": rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32),
            "head_mask": mask}


@pytest.fixture(scope="module")
def step_inputs():
    """The JAX weights (numpy), the port's state dicts of them and one tiny
    batch of 2 frames, as tests/test_torch_train.py builds them."""
    jparams = {"nerf": jax_headnerf(0, **TINY)[1], "audio": jax_audio2style()[1]}
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    batch = synthetic_dataset(NeRFConfig(**TINY), num_frames=2, seed=3).batch(np.arange(2))
    state = {"nerf": bridge.headnerf_state_dict(jparams["nerf"]),
             "audio": bridge.audio2style_state_dict(jparams["audio"])}
    return jparams, batch, state


def _step_job(batch, state):
    return {"nerf_cfg": TINY, "train_cfg": LR, "steps_per_epoch": 4, "state": state,
            "batch": to_tensors(batch, "cpu"), "adam": True, "save": True}


@pytest.fixture(scope="module")
def single_rank(step_inputs):
    """The port's single-rank deterministic step: losses, gradients and the
    params after the Adam step."""
    jparams, batch, _ = step_inputs
    fns, state = _port_state(jparams, TrainConfig(**LR), 4)
    tb = to_tensors(batch, "cpu")
    losses, grads = fns.loss_and_grads(state, tb)
    fns.train_step(state, tb, deterministic=True)
    params = {"nerf": state.nerf.state_dict(), "audio": state.audio.state_dict()}
    return {k: float(v.detach()) for k, v in losses.items()}, grads, params


def _audio_mels():
    return torch.from_numpy(np.random.default_rng(12).standard_normal((4, 80, 16)).astype(
        np.float32))


CLI_ARGS = ["train", "--device", "cpu", "--featmap-size", "8", "--img-size", "32", "--no-vgg",
            "--data-parallel", "2", "--ray-parallel", "2"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """(f)'s two `cli train` calls, one after the other in a thread that runs
    beside the module's other work: one epoch, then `--resume` to two."""
    from nerf3dtalker_tpu_torch import cli

    d = tmp_path_factory.mktemp("cli")
    args = CLI_ARGS + ["--ckpt-dir", str(d / "ckpt"), "--log-dir", str(d / "logs")]
    out = {"dir": d}

    def run():
        try:
            out["first"] = cli.main(args + ["--epochs", "1"])
            out["ckpts"] = sorted(p.name for p in (d / "ckpt").iterdir())
            out["metric_lines"] = len((d / "logs" / "metrics.jsonl").read_text().splitlines())
            out["second"] = cli.main(args + ["--epochs", "2", "--resume"])
        except BaseException as e:   # handed to the test, which raises it
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join(timeout=600)
        assert not thread.is_alive(), "cli train did not finish in 600 s"
        if "error" in out:
            raise out["error"]
        return out

    yield result
    # the checkpoints (~270 MB each), once the module's tests have read them
    thread.join(timeout=600)
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def spawned(step_inputs, tmp_path_factory):
    """The 2 x 2 job on 4 ranks and the 2 x 1 / 1 x 2 job on 2 ranks, both
    started; each entry waits for its ranks and returns their results."""
    _, batch, state = step_inputs
    inputs, cot, _, tpacked = _k4_inputs()
    g = torch.Generator().manual_seed(11)
    job22 = {"device": "cpu", "meshes": [(2, 2)], "step": _step_job(batch, state),
             "checks": {
                 "k4": {"pe": torch.from_numpy(inputs[0]), "zd": torch.from_numpy(inputs[1]),
                        "zv": torch.from_numpy(inputs[2]), "packed": tpacked,
                        "g_feat": torch.from_numpy(cot[0]), "g_bg": torch.from_numpy(cot[1]),
                        "g_depth": torch.from_numpy(cot[2])},
                 "gather": {"x": torch.randn(2, 8, 3, generator=g),
                            "w": torch.randn(2, 8, 3, generator=g)},
                 "losses": {k: torch.from_numpy(v) for k, v in _loss_inputs().items()}}}
    job2 = {"device": "cpu", "meshes": [(2, 1), (1, 2)], "step": _step_job(batch, state),
            "checks": {"audio": {"mels": _audio_mels(), "init_seed": 1, "dropout_seed": 5}}}
    dirs = {"2x2": tmp_path_factory.mktemp("mesh22"), "2": tmp_path_factory.mktemp("mesh2")}
    waits = {"2x2": selfcheck.start(job22, 4, str(dirs["2x2"])),
             "2": selfcheck.start(job2, 2, str(dirs["2"]))}
    waits = {k: functools.lru_cache(maxsize=None)(w) for k, w in waits.items()}
    yield waits
    # the jobs and the ranks' results (~120-330 MB each), once the module's
    # tests have read them; every rank has ended when its wait returns
    for k, d in dirs.items():
        try:
            waits[k]()
        except BaseException:   # a failed job has failed its tests already
            pass
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def _start_ranks(spawned, cli_runs):
    """Every spawn starts at the module's first test, after the JAX weights
    the mesh jobs need (their init runs faster on an idle host). While the
    ranks run, this process's torch takes two threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mesh_2x2(spawned):
    return spawned["2x2"]()


@pytest.fixture(scope="module")
def mesh_2_ranks(spawned):
    return spawned["2"]()


def test_k4_plain_version_matches_jax_fused_render_spmd(spawned):
    """(a) outputs and every weight gradient of K4's plain version on a
    2 x 2 mesh against JAX's shard_map + psum on make_mesh(2, 2)."""
    inputs, cot, jpacked, _ = _k4_inputs()
    jmesh = jmake_mesh(2, 2)

    def f(w):
        return jfr.fused_render_spmd(*(jnp.asarray(v) for v in inputs), w, jmesh,
                                     ("data", "rays"), 256, jnp.float32, True, False)

    def outs_and_vjp(w, c):   # one compiled program: eagerly, interpret mode runs op by op
        outs, vjp = jax.vjp(f, w)
        return outs, vjp(c)[0]

    jouts, jdw = jax.jit(outs_and_vjp)(jpacked, tuple(jnp.asarray(c) for c in cot))
    by_coords = {res[(2, 2)]["coords"]: res[(2, 2)]["k4"] for res in spawned["2x2"]()}
    half_b, half_r = B // 2, R // 2
    for i, name in enumerate(("feat", "bg_alpha", "depth")):
        got = np.zeros(np.asarray(jouts[i]).shape, np.float32)
        for (d, r), k4 in by_coords.items():
            got[d * half_b:(d + 1) * half_b, r * half_r:(r + 1) * half_r] = k4["outs"][i].numpy()
        _close(got, jouts[i], 1e-5, name)
    for k, ref in jdw.items():
        ref = np.asarray(ref)[:, :1] if k == "wd" else np.asarray(ref)
        # the rays ranks of a data row hold the same rays-summed gradient
        for d in range(2):
            assert torch.equal(by_coords[(d, 0)]["grads"][k], by_coords[(d, 1)]["grads"][k]), k
        rows = [by_coords[(d, 0)]["grads"][k].numpy() for d in range(2)]
        got = np.concatenate(rows) if k in ("b0", "b5", "br1") else rows[0] + rows[1]
        _close(got, ref, 1e-5, f"d{k}")


def test_mesh_step_2x2_matches_single_rank_step(mesh_2x2, single_rank):
    """(b) losses, gradients and params after one Adam step on 2 x 2,
    bit-identical on every rank."""
    _check_against_single_rank(mesh_2x2, (2, 2), single_rank)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_step_one_axis_matches_single_rank_step(mesh_2_ranks, single_rank, shape):
    """(b) on each axis alone: a wrong data sum shows on 2 x 1, a wrong
    gather backward or rays sum on 1 x 2."""
    _check_against_single_rank(mesh_2_ranks, shape, single_rank)


def _check_against_single_rank(results, shape, single_rank):
    losses, grads, params = single_rank
    steps = [res[shape]["step"] for res in results]
    assert all(s["grads_identical"] and s["params_identical"] for s in steps)
    assert all(s["finite_step"] == 1.0 for s in steps)
    assert all(s["launches"] == {"fused_render_fwd": 0, "fused_render_bwd": 0,
                                 "fused_render_spmd": 0} for s in steps)   # the CPU: plain
    step = steps[0]
    for k, v in losses.items():
        for s in steps:
            np.testing.assert_allclose(s["losses"][k], v, rtol=1e-5, err_msg=k)
    for group in ("nerf", "audio"):
        for i, (a, b) in enumerate(zip(step["grads"][group], grads[group])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()), err_msg=f"{group} {i}")
        for name, b in params[group].items():
            np.testing.assert_allclose(step["params"][group][name].numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{group}.{name}")


def test_mesh_step_2x2_matches_jax_step(spawned, step_inputs):
    """(b) the 2 x 2 step against the JAX deterministic step."""
    jparams, batch, _ = step_inputs
    jl, jgrads, jnew = _jax_step(jparams, batch, JTrainConfig(**LR), 4)
    step = next(res[(2, 2)]["step"] for res in spawned["2x2"]()
                if res[(2, 2)]["coords"] == (0, 0))
    for k in ("bg_loss", "head_loss", "nonhead_loss", "total_loss"):
        _close(step["losses"][k], jl[k], 1e-4, k)
    jg, jn = _port_tree(jgrads), _port_tree(jnew)
    fns, state = _port_state(jparams, TrainConfig(**LR), 4)
    for group, module in (("nerf", state.nerf), ("audio", state.audio)):
        names = [n for n, p in module.named_parameters() if p.requires_grad]
        for name, g in zip(names, step["grads"][group]):
            _close(g.numpy(), jg[group][name], 1e-4, f"grad {group}.{name}")
        for name, p in step["params"][group].items():
            _close(p.numpy(), jn[group][name], 0.0, f"param {group}.{name}", atol=1e-6)


def test_backend_follows_the_layout():
    """NCCL only when every rank of the host has a card of its own."""
    from nerf3dtalker_tpu_torch.parallel.mesh import choose_backend

    assert choose_backend("cuda", 4, 4) == "nccl" and choose_backend("cuda", 1, 1) == "nccl"
    assert choose_backend("cuda", 4, 1) == "gloo"      # 4 ranks share one card
    assert choose_backend("cpu", 4, 0) == "gloo"


def test_gather_rays_backward_is_the_slice(mesh_2x2):
    """(c) the gathered value is the data row's whole [b, R, C], and the
    shard's gradient is its slice of the (replicated) upstream gradient."""
    for res in mesh_2x2:
        assert res[(2, 2)]["gather"] == {"value_err": 0.0, "grad_err": 0.0}


def test_losses_are_global_means_with_uneven_masks(mesh_2x2):
    """(d) mesh losses and each rank's gradient on its rows against
    `headnerf_losses` over the whole batch."""
    inp = {k: torch.from_numpy(v) for k, v in _loss_inputs().items()}
    counts = inp["head_mask"].sum((1, 2, 3))
    assert counts[0] > 10 * counts[1]
    merge = inp["merge_img"].clone().requires_grad_()
    ref = headnerf_losses({"merge_img": merge, "bg_img": inp["bg_img"]}, inp["gt_rgb"],
                          inp["head_mask"], 1.0)
    ref["total_loss"].backward()
    for res in mesh_2x2:
        got = res[(2, 2)]["losses"]
        for k, v in ref.items():
            np.testing.assert_allclose(got["losses"][k], float(v.detach()), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["grad_rows"].numpy(), merge.grad[got["rows"]].numpy(),
                                   rtol=1e-6, atol=1e-6 * float(merge.grad.abs().max()))


def test_audio2style_under_2x1_reads_the_whole_sequence(mesh_2_ranks):
    """(e) with dropout on, from the same generator seed on both ranks."""
    audio = Audio2Style(device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = audio(_audio_mels(), torch.Generator().manual_seed(5))
    seen = []
    for res in mesh_2_ranks:
        got = res[(2, 1)]["audio"]
        torch.testing.assert_close(got["styles"], full[got["rows"]], rtol=1e-5,
                                   atol=1e-5 * float(full.abs().max()))
        seen.append(got["rows"])
    assert seen == [slice(0, 2), slice(2, 4)]


def test_cli_train_on_a_2x2_mesh_saves_and_resumes(cli_runs):
    """(f) one epoch on 4 CPU ranks writes one checkpoint and one metrics
    line (rank 0 only), the run reports identical params on every rank, and
    --resume goes on from the checkpoint."""
    from nerf3dtalker_tpu_torch.utils import checkpoints

    out = cli_runs()
    rec = out["first"]
    assert rec["epoch"] == 0 and rec["finite_step"] == 1.0 and np.isfinite(rec["total_loss"])
    assert rec["mesh"]["params_identical"] and {"SSIM", "PSNR"} <= set(rec)
    assert out["ckpts"] == ["ckpt_00000004.pt"] and out["metric_lines"] == 1   # 8 frames, B=2
    rec = out["second"]
    assert rec["epoch"] == 1 and rec["mesh"]["params_identical"]
    assert checkpoints.load_checkpoint(str(out["dir"] / "ckpt"))["step"] == 8
