"""Command-line entry points of the port (counterpart of
`nerf3dtalker_tpu/cli.py`): `python -m nerf3dtalker_tpu_torch.cli <command>`.

  train   — train HeadNeRF + Audio2Style on a frame dataset (.npz of the
            `data.dataset` schema, or a synthetic one), validate with SSIM /
            PSNR (LPIPS with --lpips-weights), checkpoint under --ckpt-dir,
            print the last epoch's record; --resume rebuilds the run from
            its newest checkpoint, with the flags set on this command line
            over the checkpoint's config
  animate — wav -> per-frame mel chunks -> Audio2Style -> chunked HeadNeRF
            render (seeded weights, a flax --params npz, or the newest
            checkpoint of `train` with --ckpt) -> optional enhancer ->
            frames as an .mp4 with the wav muxed in (ffmpeg; PNGs without
            it) or as .npy
  fit     — fit a subject's code offsets and camera deltas to one image
            (an .npz with `image`, optional `mask` and base codes, or a
            synthetic target), HeadNeRF's weights frozen (seeded, --params,
            or --ckpt); writes fitted.npz with the JAX `fit`'s keys
  render  — the 45-view orbit of a subject (--latents fitted.npz, or
            seeded codes) as an .npy of frames
  train-vq — train the Standardized Space stage 1 (the VQ autoencoder and
            the five AU classifiers) on an .npz of gen_img / gt_img / mask /
            crops / au_labels (or random batches), one JSON line an epoch;
            --ckpt-dir writes the port's checkpoint of both modules
  eval-vq — reconstruct a split through stage 1 (a train-vq --ckpt, else
            seeded weights): gen+ PNGs into --out, metrics as one JSON line
  infer-stage2 — wav -> wav2vec2 (a local HF directory, or a small seeded
            encoder) -> CodeTalker's autoregressive codes over the frozen
            stage-1 codebook (a train-vq --vq-ckpt and a stage-2 --ckpt, or
            seeded) -> decoded frames [1, T, H*W*3] as .npy
  infer-coeff — wav (or --text through the placeholder TTS) -> mel chunks
            -> SadTalker's audio2exp netG (a --safetensors file, else zero
            expressions) -> exp [T, 64] and smoothed poses as .npz
  preprocess — a subject's frames (a [T, H, W, 3] .npy in [0, 1]) and wav
            -> the training arrays `train --data` reads (.npz): with
            --strict BiSeNet head masks, FAN landmarks, the two-stage NL3DMM
            fit through the mesh rasterizer and netG audio expressions
            (seeded networks); without it placeholders for the network
            stages

Runs on `cuda` unless `--device cpu` is given. On the GPU HeadNeRF computes
in bf16 through the fused render kernels; on the CPU in f32 through the
plain path.

`train --data-parallel D --ray-parallel R` trains on D·R ranks laid out as a
(data, rays) mesh (`parallel.mesh`). Under `torchrun` (RANK and WORLD_SIZE
set) this process is one of them; otherwise it builds every kernel, starts
the D·R ranks itself (`torch.multiprocessing` spawn, rendezvous through a
file under --ckpt-dir) and prints rank 0's result. Both at 1 (the default)
is the single-device run.
"""

from __future__ import annotations

import argparse
import json
import os


def _codes_from_latents(path):
    """fitted.npz from `fit` -> (shape_code, appea_code), with the fitted
    offsets applied to the base codes."""
    import numpy as np

    z = dict(np.load(path))
    shape = np.concatenate(
        [z["iden"] + z.get("iden_offset", 0.0),
         z["expr"] + z.get("expr_offset", 0.0)], -1).astype(np.float32)
    appea = (np.concatenate([z["text"], z["illu"]], -1)
             + z.get("appea_offset", 0.0)).astype(np.float32)
    return shape, appea


def _params_tree(params: str, keys) -> dict:
    """The `/`-joined .npz of flax variables that `save_pytree_npz` writes,
    with the top-level `keys` (`nerf`, and `audio` where the command needs
    it; `fit` and `render` read only `nerf`)."""
    from nerf3dtalker_tpu_torch.utils import bridge

    tree = bridge.load_npz_tree(params)
    if not set(keys) <= set(tree) <= {"nerf", "audio"}:
        raise ValueError(f"{params}: top-level keys must be {' and '.join(keys)}"
                         f"{'' if 'audio' in keys else ' (audio optional)'}, got {sorted(tree)}")
    return tree


def build_nerf(cfg, seed: int, device, nerf_tree=None, state=None):
    """HeadNeRF on `device`: bf16 through the fused kernels on the GPU
    (f32, plain path on the CPU). Weights come from `nerf_tree` (the `nerf`
    flax variables of a params .npz), or from `state`, a checkpoint payload
    of the port's trainer; without either they are initialized from
    `seed`."""
    import torch

    from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
    from nerf3dtalker_tpu_torch.utils import bridge

    on_gpu = device.type == "cuda"
    model = HeadNeRF(cfg, compute_dtype=torch.bfloat16 if on_gpu else torch.float32,
                     use_fused=on_gpu, device=device,
                     generator=torch.Generator().manual_seed(seed))
    if nerf_tree is not None:
        bridge.load_into(model, bridge.headnerf_state_dict(nerf_tree))
    if state is not None:
        model.load_state_dict(state["nerf"])
    return model.eval()


def build_models(cfg, seed: int, device, params: str = "", state=None):
    """The serving models on `device`: `build_nerf`'s HeadNeRF and
    Audio2Style. Weights come from `params`, the `/`-joined .npz of
    `{"nerf": ..., "audio": ...}` flax variables, or from `state`, a
    checkpoint payload of the port's trainer (`nerf` and `audio` state
    dicts); without either they are initialized from `seed` (NeRF) and 1
    (audio), as the JAX CLI does."""
    import torch

    from nerf3dtalker_tpu_torch.models.audio import Audio2Style
    from nerf3dtalker_tpu_torch.utils import bridge

    tree = _params_tree(params, ("nerf", "audio")) if params else {}
    model = build_nerf(cfg, seed, device, tree.get("nerf"), state)
    a2s = Audio2Style(device=device, generator=torch.Generator().manual_seed(1))
    if params:
        bridge.load_into(a2s, bridge.audio2style_state_dict(tree["audio"]))
    if state is not None:
        a2s.load_state_dict(state["audio"])
    return model, a2s.eval()


def _nerf_config(args, state=None):
    """The served model's config: a checkpoint's embedded NeRFConfig (else
    the defaults) with --featmap-size / --img-size over it where given."""
    import dataclasses

    from nerf3dtalker_tpu_torch.config import NeRFConfig

    base = {}
    if state is not None:
        fields = {f.name for f in dataclasses.fields(NeRFConfig)}
        base = {k: v for k, v in state["config"]["nerf"].items() if k in fields}
    cfg = NeRFConfig(**base)
    return dataclasses.replace(
        cfg, featmap_size=args.featmap_size or cfg.featmap_size,
        pred_img_size=args.img_size or cfg.pred_img_size)


def cmd_animate(args) -> dict:
    import numpy as np

    from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
    from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
    from nerf3dtalker_tpu_torch.utils import video
    from nerf3dtalker_tpu_torch.utils.camera import base_cam
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    if args.ckpt and args.params:
        raise SystemExit("--ckpt and --params both give the weights: pass one of them")
    if args.enhancer == "gfpgan":
        raise SystemExit("--enhancer gfpgan is not ported yet (models/gfpgan.py)")
    out = args.out or "talking_head.mp4"
    dev = resolve_device(args.device)
    pcm, sr = read_wav_mono(args.wav)
    mels = per_frame_mel_chunks(pcm, sr=sr, fps=args.fps)
    if args.max_frames:
        mels = mels[: args.max_frames]
    T = len(mels)

    state = load_checkpoint(args.ckpt, map_location="cpu") if args.ckpt else None
    cfg = _nerf_config(args, state)
    model, a2s = build_models(cfg, args.seed, dev, args.params, state)
    del state
    shape = np.zeros((1, cfg.shape_code_dims), np.float32)
    appea = np.zeros((1, cfg.appea_code_dims), np.float32)
    if args.latents:
        shape, appea = _codes_from_latents(args.latents)
    cam = base_cam(cfg.featmap_size)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}

    styles = styles_from_mels(a2s, mels)
    frames = animate_sequence(model, shape, appea, styles, cam_d, chunk=args.chunk)
    rec = {"frames": T, "size": list(frames.shape[1:3]), "device": str(dev)}
    if args.enhancer == "unsharp":
        frames = video.enhance_frames(frames, video.unsharp_enhancer)
        rec["enhancer"] = args.enhancer
    if out.endswith(".npy"):
        np.save(out, frames)
    else:
        video.write_video(frames, out, fps=args.fps, audio_path=args.wav)
    rec["out"] = out
    print(json.dumps(rec))
    return rec


def _fit_model(args):
    """(model, cfg, device) of `fit` and `render`: the weights of --ckpt
    (its config, with --featmap-size / --img-size over it), of --params, or
    seeded."""
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    if args.ckpt and args.params:
        raise SystemExit("--ckpt and --params both give the weights: pass one of them")
    dev = resolve_device(args.device)
    state = load_checkpoint(args.ckpt, map_location="cpu") if args.ckpt else None
    cfg = _nerf_config(args, state)
    tree = _params_tree(args.params, ("nerf",))["nerf"] if args.params else None
    return build_nerf(cfg, args.seed, dev, tree, state), cfg, dev


def cmd_fit(args) -> dict:
    """Single-image latent/camera fitting (FittingSingleImage_new.py:620-903,
    JAX `cli.py:cmd_fit`): `--iters` Adam steps over code offsets and
    camera deltas against one target image at the base camera, audio style
    zero. --data: an .npz with image [H, W, 3] (+ optional mask [H, W, 1]
    and iden/expr/text/illu base codes, zero where absent); without it a
    synthetic target, uniform noise from --seed (smoke mode)."""
    import numpy as np

    from nerf3dtalker_tpu_torch.train.fitting import fit_single_image
    from nerf3dtalker_tpu_torch.utils.camera import base_cam

    model, cfg, dev = _fit_model(args)
    cam = base_cam(cfg.featmap_size)
    S = cfg.pred_img_size
    dims = {"iden": cfg.iden_code_dims, "expr": cfg.expr_code_dims,
            "text": cfg.text_code_dims, "illu": cfg.illu_code_dims}
    base_codes = {k: np.zeros((1, d), np.float32) for k, d in dims.items()}
    if args.data:
        with np.load(args.data) as z:
            gt = z["image"].astype(np.float32)[None]
            mask = (z["mask"] if "mask" in z.files else np.ones((S, S, 1))).astype(np.float32)[None]
            for k in base_codes:
                if k in z.files:
                    base_codes[k] = z[k].reshape(1, -1).astype(np.float32)
    else:
        print("no --data; fitting a synthetic target (smoke mode)")
        rng = np.random.default_rng(args.seed)
        gt = rng.uniform(0, 1, (1, S, S, 3)).astype(np.float32)
        mask = np.ones((1, S, S, 1), np.float32)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    fit, losses = fit_single_image(model, gt, mask, base_codes, cam_d,
                                   np.zeros((1, cfg.audio_style_dims), np.float32),
                                   iters=args.iters, opt_cam=not args.no_cam_opt)
    out = args.out or "fitted.npz"
    np.savez(out, **{k: v.cpu().numpy() for k, v in fit._asdict().items()}, **base_codes)
    rec = {"out": out, **losses, "device": str(dev)}
    print(json.dumps(rec))
    return rec


def cmd_render(args) -> dict:
    """The orbit of a subject (JAX `cli.py:cmd_render`): --views cameras of
    the orbit rig, one render each, to an .npy [V, H, W, 3]. The codes and
    audio style are seeded draws (0.1 N(0, 1)); --latents (fitted.npz of
    `fit`) gives the codes with the fitted offsets applied, and its
    `audio_style` where it has one. The orbit rig ignores the fitted camera
    deltas, as the reference's render_novel_views does."""
    import numpy as np

    from nerf3dtalker_tpu_torch.train.fitting import render_novel_views

    model, cfg, dev = _fit_model(args)
    rng = np.random.default_rng(args.seed)
    shape = rng.standard_normal((1, cfg.shape_code_dims)).astype(np.float32) * 0.1
    appea = rng.standard_normal((1, cfg.appea_code_dims)).astype(np.float32) * 0.1
    aud = rng.standard_normal((1, cfg.audio_style_dims)).astype(np.float32) * 0.1
    if args.latents:
        shape, appea = _codes_from_latents(args.latents)
        with np.load(args.latents) as z:
            if "audio_style" in z.files:
                aud = z["audio_style"].astype(np.float32)
    views = render_novel_views(model, shape, appea, aud, view_num=args.views)
    out = args.out or "novel_views.npy"
    np.save(out, views)
    rec = {"out": out, "shape": list(views.shape), "device": str(dev)}
    print(json.dumps(rec))
    return rec


def _train(args, mesh=None) -> dict:
    """One rank's training run (the only one without a mesh): the epoch
    record of the last epoch, and under a mesh its `mesh_report`."""
    import numpy as np

    from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig
    from nerf3dtalker_tpu_torch.data.dataset import FrameDataset, synthetic_dataset
    from nerf3dtalker_tpu_torch.train.trainer import Trainer
    from nerf3dtalker_tpu_torch.utils.camera import ray_grid
    from nerf3dtalker_tpu_torch.utils.checkpoints import has_checkpoint
    from nerf3dtalker_tpu_torch.utils.device import resolve_device
    from nerf3dtalker_tpu_torch.utils.metrics import load_lpips_alex

    dev = resolve_device(args.device) if mesh is None else mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    cfg = NeRFConfig(featmap_size=args.featmap_size, pred_img_size=args.img_size)
    if args.data:
        with np.load(args.data) as z:
            arrays = {k: z[k] for k in z.files}
        xy, _ = ray_grid(cfg.featmap_size)
        n_val = max(1, len(arrays["images"]) // 10)
        train = FrameDataset({k: v[:-n_val] for k, v in arrays.items()}, xy)
        val = FrameDataset({k: v[-n_val:] for k, v in arrays.items()}, xy)
    else:
        say("no --data given; training on a synthetic sanity dataset")
        train = synthetic_dataset(cfg, num_frames=8)
        val = synthetic_dataset(cfg, num_frames=2, seed=1)

    lpips = load_lpips_alex(args.lpips_weights, device=dev) if args.lpips_weights else None
    if args.resume and has_checkpoint(args.ckpt_dir):
        # the configs come from the checkpoint; a training flag set on this
        # command line (not left at its parser default) goes over them
        overrides = {"epochs": args.epochs}
        for dest in args.explicit:
            if dest in RESUME_FIELDS:
                overrides[RESUME_FIELDS[dest]] = getattr(args, dest)
        if "no_vgg" in args.explicit:
            overrides["use_vgg_loss"] = False
        forwarded = sorted(k for k in overrides if k != "epochs")
        if forwarded:
            say(f"--resume: flags set on the command line over the checkpoint's config: "
                f"{forwarded}")
        t = Trainer.from_checkpoint(args.ckpt_dir, train, val, device=dev, mesh=mesh,
                                    lpips=lpips, **overrides)
        say(f"resumed from step {t.state.step} (epoch {t.start_epoch})")
    else:
        if args.resume:
            say(f"--resume: no checkpoint under {args.ckpt_dir}; starting fresh")
        tc = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
                         ckpt_dir=args.ckpt_dir, use_vgg_loss=not args.no_vgg,
                         vgg_weights=args.vgg_weights, seed=args.seed,
                         native_prefetch=args.native_prefetch, log_dir=args.log_dir,
                         use_tensorboard=args.tensorboard, trace_dir=args.trace_dir,
                         trace_steps=args.trace_steps, guard_policy=args.guard_policy)
        t = Trainer(cfg, tc, train, val, device=dev, mesh=mesh, lpips=lpips)
        t.init()
    try:
        hist = t.train(args.epochs)
    finally:
        t.close()
    rec = hist[-1] if hist else {
        "epochs_done": t.start_epoch, "step": t.state.step,
        "note": "checkpoint already at/beyond --epochs; nothing to do"}
    if mesh is not None:
        rec = {**rec, "mesh": {"data": mesh.data, "rays": mesh.rays, **t.mesh_report()}}
    return rec


# `cli train` flags that --resume lays over the checkpoint's TrainConfig when
# they are set on the command line (JAX cli.py:126-153): flag dest -> field
RESUME_FIELDS = {"batch_size": "batch_size", "lr": "lr", "vgg_weights": "vgg_weights",
                 "seed": "seed", "native_prefetch": "native_prefetch", "log_dir": "log_dir",
                 "tensorboard": "use_tensorboard", "trace_dir": "trace_dir",
                 "trace_steps": "trace_steps", "guard_policy": "guard_policy"}


def _train_rank(local_rank: int, world: int, args, init_method: str, result_path: str) -> None:
    """One spawned rank of `cmd_train`: rank = local_rank on this host.
    Rank 0 writes the result to `result_path`."""
    import torch.distributed as dist

    from nerf3dtalker_tpu_torch.parallel.mesh import init_ranks, make_mesh

    dev = init_ranks(local_rank, world, local_rank, world, args.device, init_method)
    try:
        rec = _train(args, make_mesh(args.data_parallel, args.ray_parallel, device=dev))
        if local_rank == 0:
            with open(result_path, "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def cmd_train(args) -> dict:
    data, rays = args.data_parallel, args.ray_parallel
    if data < 1 or rays < 1:
        raise SystemExit("--data-parallel and --ray-parallel must be >= 1")
    world = data * rays
    if world == 1:
        rec = _train(args)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # one rank of torchrun
        import torch.distributed as dist

        from nerf3dtalker_tpu_torch.parallel.mesh import init_ranks, make_mesh

        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if size != world:
            raise SystemExit(f"WORLD_SIZE {size} != --data-parallel x --ray-parallel {world}")
        dev = init_ranks(rank, size, int(os.environ.get("LOCAL_RANK", rank)),
                         int(os.environ.get("LOCAL_WORLD_SIZE", size)), args.device)
        try:
            rec = _train(args, make_mesh(data, rays, device=dev))
        finally:
            dist.destroy_process_group()
        if rank:
            return rec
    else:
        rec = _spawn_train(args, world)
    print(json.dumps(rec))
    return rec


def _spawn_train(args, world: int) -> dict:
    """Start `world` ranks on this host, wait for all of them (one that dies
    fails this call) and return rank 0's result. Every kernel is built here
    first, so that the ranks load them and never compile at once."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    if args.device != "cpu":
        from nerf3dtalker_tpu_torch.ops.kernels import build
        from nerf3dtalker_tpu_torch.utils.device import resolve_device

        resolve_device(args.device)
        build.build_all()
    parent = args.ckpt_dir or args.log_dir or "."
    os.makedirs(parent, exist_ok=True)
    rdv = tempfile.mkdtemp(prefix=".rendezvous-", dir=parent)
    try:
        result = os.path.join(rdv, "result.json")
        mp.spawn(_train_rank, args=(world, args, f"file://{os.path.join(rdv, 'store')}", result),
                 nprocs=world, join=True)
        with open(result) as f:
            return json.load(f)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


# VQConfig fields that the VQ commands' flags set: flag dest -> field
VQ_FIELDS = {"img_size": "img_size", "hidden": "hidden_size", "embed_dim": "embed_dim",
             "n_embed": "n_embed", "layers": "num_hidden_layers"}
# the JAX CLI's defaults of those flags, by command
TRAIN_VQ_DEFAULTS = {"img_size": 256, "hidden": 512, "embed_dim": 64, "n_embed": 8192, "layers": 6}
# (infer-stage2's are eval-vq's)
EVAL_VQ_DEFAULTS = {"img_size": 256, "hidden": 64, "embed_dim": 64, "n_embed": 256, "layers": 1}


def _vq_config(flags: dict):
    from nerf3dtalker_tpu_torch.config import VQConfig

    return VQConfig(**{field: flags[dest] for dest, field in VQ_FIELDS.items()})


def _vq_config_of(args, state, defaults: dict, source: str):
    """The VQConfig of a command that reads a train-vq checkpoint: the
    checkpoint's (`state`, named `source` in the error; a VQ flag typed
    beside it that disagrees raises), else the flags, with `defaults` where
    a flag is not given."""
    from nerf3dtalker_tpu_torch.config import VQConfig

    flags = {d: getattr(args, d) for d in VQ_FIELDS if getattr(args, d) is not None}
    if state is None:
        return _vq_config({**defaults, **flags})
    cfg = VQConfig(**state["config"])
    clash = {VQ_FIELDS[d]: (getattr(cfg, VQ_FIELDS[d]), v) for d, v in flags.items()
             if getattr(cfg, VQ_FIELDS[d]) != v}
    if clash:
        raise SystemExit(f"{source}: its VQConfig disagrees with the flags "
                         f"(field: (checkpoint, flag)) {clash}")
    return cfg


def _vq_random_split(img_size: int, random_labels: bool) -> dict:
    """The JAX VQ commands' stand-in data without --data: 4 random frames
    and 112^2 crops from numpy seed 0; random AU labels (train-vq) or all
    ones (eval-vq)."""
    import numpy as np

    rng = np.random.default_rng(0)
    S = img_size
    data = {"gen_img": rng.uniform(0, 1, (4, S, S, 3)).astype(np.float32),
            "gt_img": rng.uniform(0, 1, (4, S, S, 3)).astype(np.float32),
            "mask": np.ones((4, S, S, 1), np.float32),
            "crops": rng.uniform(0, 1, (4, 5, 112, 112, 3)).astype(np.float32)}
    data["au_labels"] = ((rng.uniform(0, 1, (4, 5)) > 0.5) if random_labels
                         else np.ones((4, 5))).astype(np.float32)
    return data


def cmd_train_vq(args) -> dict:
    """Standardized Space stage 1 training (StandardizedSpace/main/
    train_vq.py, JAX `cli.py:cmd_train_vq`): --epochs passes over the
    frames in batches of --batch-size (numpy seed = epoch for the order),
    one JSON line of the epoch's last step metrics each. --ckpt-dir writes
    the port's checkpoint (`torch.save`: the VQConfig, the crop size and
    both modules' state) after the last epoch; the JAX command writes
    none."""
    import dataclasses

    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.train.vq_trainer import BATCH_KEYS, build_vq_step, to_batch
    from nerf3dtalker_tpu_torch.utils.checkpoints import save_checkpoint
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = _vq_config(vars(args))
    init, train_step, _ = build_vq_step(cfg, lr=args.lr, device=dev)
    if args.data:
        with np.load(args.data) as z:
            data = {k: z[k] for k in BATCH_KEYS}
    else:
        print("no --data; sanity run on random batches")
        data = _vq_random_split(args.img_size, random_labels=True)
    N = len(data["gen_img"])
    bs = min(args.batch_size, N)
    state = init(torch.Generator().manual_seed(args.seed), to_batch(data, dev, slice(0, bs)))
    rec = {}
    for ep in range(args.epochs):
        order = np.random.default_rng(ep).permutation(N)
        for i in range(0, N - bs + 1, bs):
            state, m = train_step(state, to_batch(data, dev, order[i : i + bs]))
        rec = {"epoch": ep, **{k: float(v) for k, v in m.items()}}
        print(json.dumps(rec))
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, {
            "config": dataclasses.asdict(cfg), "crop_size": int(data["crops"].shape[2]),
            "vq": state.vq.state_dict(), "au": state.au.state_dict()}, state.step)
        rec = {**rec, "ckpt": path}
        print(json.dumps({"ckpt": path, "step": state.step}))
    return rec


def cmd_eval_vq(args) -> dict:
    """Stage-1 reconstruction of a split (StandardizedSpace/main/test_vq.py:
    52-150, JAX `cli.py:cmd_eval_vq`): an .npz with gen_img / mask / crops
    (+ optional gt_img) -> AU-conditioned VQ reconstructions as `gen+`
    PNGs in --out, metrics as one JSON line. The weights come from --ckpt
    (a train-vq --ckpt-dir, whose VQConfig is used; a flag typed on the
    command line that disagrees with it raises), else seeded from --seed
    with the flags, or the JAX eval-vq defaults where a flag is not given."""
    import dataclasses

    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.train.vq_eval import reconstruct_split
    from nerf3dtalker_tpu_torch.train.vq_trainer import init_modules
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    state = load_checkpoint(args.ckpt, map_location="cpu") if args.ckpt else None
    cfg = _vq_config_of(args, state, EVAL_VQ_DEFAULTS, f"--ckpt {args.ckpt}")
    if args.data:
        with np.load(args.data) as z:
            data = {k: z[k] for k in z.files}
    else:
        print("no --data; smoke run on random frames")
        data = _vq_random_split(cfg.img_size, random_labels=False)
    if state is not None:
        if state["crop_size"] != data["crops"].shape[2]:
            raise SystemExit(f"--ckpt {args.ckpt}: its AU classifiers take {state['crop_size']}^2 "
                             f"crops, the data has {data['crops'].shape[2]}^2")
    vq, au = init_modules(cfg, data["crops"].shape[2], dev,
                          torch.Generator().manual_seed(args.seed))
    if state is not None:
        vq.load_state_dict(state["vq"])
        au.load_state_dict(state["au"])
    out_dir = args.out or "./gen+"
    metrics = reconstruct_split(vq, au, data, out_dir=out_dir)
    rec = {"out_dir": out_dir, **metrics, "config": dataclasses.asdict(cfg)}
    print(json.dumps({"out_dir": out_dir, **metrics}))
    return rec


def _stage1(args, dev):
    """The stage-1 VQAutoEncoder of infer-stage2 on `dev`: a train-vq
    checkpoint's (--vq-ckpt), else seeded from --seed at `_vq_config_of`'s
    config."""
    import torch

    from nerf3dtalker_tpu_torch.models.vq.stage1 import VQAutoEncoder
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint
    from nerf3dtalker_tpu_torch.utils.device import uninitialized

    state = load_checkpoint(args.vq_ckpt, map_location="cpu") if args.vq_ckpt else None
    cfg = _vq_config_of(args, state, EVAL_VQ_DEFAULTS, f"--vq-ckpt {args.vq_ckpt}")
    if state is None:
        return VQAutoEncoder(cfg, device=dev, generator=torch.Generator().manual_seed(args.seed))
    vq = uninitialized(lambda d: VQAutoEncoder(cfg, device=d), dev)
    vq.load_state_dict(state["vq"])
    return vq


# the small seeded encoder of the JAX infer-stage2 without --hf-wav2vec
SMALL_WAV2VEC = dict(conv_dim=(64, 64), conv_kernel=(10, 3), conv_stride=(5, 2),
                     hidden_size=768, num_layers=2, num_heads=4, intermediate_size=1024,
                     num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def cmd_infer_stage2(args) -> dict:
    """Standardized-Space inference from a wav (StandardizedSpace/models/
    stage2.py:102-155 predict + main/test_pred.py; JAX `cli.py:
    cmd_infer_stage2`): wav -> wav2vec2 -> CodeTalker's autoregressive codes
    over the frozen stage-1 codebook -> decoded frames, [1, T, H*W*3] as
    .npy, and one JSON line (out, frames, img_size, finite, num_frames).
    --hf-wav2vec is a local HF model directory, else the JAX command's small
    encoder seeded from 0; --vq-ckpt a train-vq checkpoint directory, else
    stage 1 seeded from --seed; --ckpt a stage-2 checkpoint directory
    (`train/stage2_trainer.py:codetalker_payload`), else CodeTalker seeded
    from --seed + 1 (its code head is zero)."""
    import dataclasses

    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.data.mel import read_wav_mono
    from nerf3dtalker_tpu_torch.models.vq.wav2vec import (
        Wav2Vec2Config,
        Wav2Vec2Encoder,
        encode_audio,
        load_hf_wav2vec2,
        normalize_wav,
    )
    from nerf3dtalker_tpu_torch.train.stage2_trainer import (
        build_stage2_step,
        codetalker_from_payload,
    )
    from nerf3dtalker_tpu_torch.train.vq_eval import eval_stage2, frame_vq_apply
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    pcm, sr = read_wav_mono(args.wav)
    T = args.frames or max(1, int(len(pcm) / sr * args.fps))
    if args.hf_wav2vec:
        enc = load_hf_wav2vec2(args.hf_wav2vec, device=dev)
    else:
        enc = Wav2Vec2Encoder(Wav2Vec2Config(**SMALL_WAV2VEC), device=dev,
                              generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        wav = torch.as_tensor(pcm[None], dtype=torch.float32, device=dev)
        feats = encode_audio(enc, normalize_wav(wav), T)
    del enc

    vq = _stage1(args, dev)
    vq_apply = frame_vq_apply(vq)
    V3, L = vq_apply["vertice_dim"], vq_apply["codes_per_frame"]
    if args.ckpt:
        model = codetalker_from_payload(load_checkpoint(args.ckpt, map_location="cpu"), dev)
        want = {"vertice_dim": V3, "audio_dim": feats.shape[-1], "face_quan_num": L,
                "embed_dim": vq.cfg.embed_dim}
        have = {**model.dims, "face_quan_num": model.cfg.face_quan_num,
                "embed_dim": model.cfg.embed_dim}
        bad = {k: (have[k], v) for k, v in want.items() if have[k] != v}
        if bad:
            raise SystemExit(f"--ckpt {args.ckpt} does not fit the stage 1 and the audio "
                             f"encoder (field: (checkpoint, here)) {bad}")
        n_subjects = model.dims["n_subjects"]
        _, _, predict = build_stage2_step(model.cfg, vq_apply, V3, device=dev)
    else:
        n_subjects = args.n_subjects
        init, _, predict = build_stage2_step(
            dataclasses.replace(vq.cfg, face_quan_num=L), vq_apply, V3,
            feature_dim=args.feature_dim, n_subjects=n_subjects, audio_dim=feats.shape[-1],
            device=dev)
        model = init(torch.Generator().manual_seed(args.seed + 1), None).model
    model.eval()
    onehot = torch.nn.functional.one_hot(torch.tensor([args.subject], device=dev),
                                         n_subjects).float()
    out_path = args.out or "stage2_frames.npy"
    metrics = eval_stage2(predict, model, feats, onehot, T, out_path=out_path)
    S = vq.cfg.img_size
    frames = np.load(out_path).reshape(1, T, S, S, 3)
    rec = {"out": out_path, "frames": int(T), "img_size": S,
           "finite": bool(np.isfinite(frames).all()), **metrics}
    print(json.dumps(rec))
    return rec


def cmd_infer_coeff(args) -> dict:
    """Audio -> per-frame expression and pose coefficients (the reference
    s_inference.py:14-90; JAX `cli.py:cmd_infer_coeff`): a wav, or --text
    through the placeholder TTS (its wav written beside --out) -> mel chunks
    -> `Audio2Coeff.generate` (netG from --safetensors, else zero
    expressions; the blink ratios drawn from --seed; the reference pose
    zero, smoothed) -> an .npz of exp [T, 64], pose [T, 6], mels and
    ratios; one JSON line."""
    import numpy as np

    from nerf3dtalker_tpu_torch.data.mel import (
        blink_ratio_sequence,
        per_frame_mel_chunks,
        read_wav_mono,
    )
    from nerf3dtalker_tpu_torch.models.audio2coeff import Audio2Coeff
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if not args.wav and not args.text:
        raise SystemExit("infer-coeff needs --wav or --text")
    path = args.out or "coeffs.npz"
    rec = {}
    wav_path = args.wav
    if not wav_path:
        from nerf3dtalker_tpu_torch.data.tts import synthesize_placeholder

        wav_path = synthesize_placeholder(args.text, os.path.splitext(path)[0] + ".tts.wav")
        rec["tts"] = wav_path
    pcm, sr = read_wav_mono(wav_path)
    mels = per_frame_mel_chunks(pcm, sr=sr, fps=args.fps)
    T = len(mels)
    ratios = blink_ratio_sequence(T, np.random.default_rng(args.seed))
    a2c = Audio2Coeff.from_safetensors(args.safetensors, dev) if args.safetensors \
        else Audio2Coeff()
    out = a2c.generate(mels, np.zeros(64, np.float32), ratios,
                       ref_pose=np.zeros((T, 6), np.float32))
    np.savez(path, exp=out["exp"], pose=out["pose"], mels=mels, ratios=ratios)
    rec.update({"out": path, "frames": T, "exp": list(out["exp"].shape),
                "pose": list(out["pose"].shape), "device": str(dev)})
    print(json.dumps(rec))
    return rec


def cmd_preprocess(args) -> dict:
    """Offline subject preprocessing (the reference's DataProcess/
    Gen_mask_lm_3DMM.py flow; JAX `cli.py:cmd_preprocess`): frames .npy +
    wav -> the subject's arrays as an .npz (np.savez); one JSON line. With
    --strict every stage runs its network (`build_appliers` at the frames'
    size, seeded from --seed, the fit at (10, 20) iterations)."""
    import time

    import numpy as np

    from nerf3dtalker_tpu_torch.data.mel import read_wav_mono
    from nerf3dtalker_tpu_torch.data.preprocess import build_appliers, preprocess_subject
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if not args.frames.endswith(".npy"):
        raise SystemExit("--frames must be a [T,H,W,3] .npy stack")
    frames = np.load(args.frames)
    pcm, _ = read_wav_mono(args.wav)
    t0 = time.perf_counter()
    appliers = build_appliers(frames.shape[1], seed=args.seed, fit_iters=(10, 20),
                              device=dev) if args.strict else {}
    arrays = preprocess_subject(frames.astype(np.float32), pcm, featmap_size=args.featmap_size,
                                seed=args.seed, strict=args.strict, **appliers)
    path = args.out or "subject.npz"
    np.savez(path, **arrays)
    rec = {"out": path, "keys": sorted(arrays), "frames": len(arrays["images"]),
           "strict": args.strict, "device": str(dev), "s": time.perf_counter() - t0}
    print(json.dumps(rec))
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(prog="nerf3dtalker_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train HeadNeRF + Audio2Style")
    pt.add_argument("--featmap-size", type=int, default=32)
    pt.add_argument("--img-size", type=int, default=256)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--data", default="", help="frame dataset .npz (data.dataset schema); "
                    "without it a synthetic one")
    pt.add_argument("--batch-size", type=int, default=2)
    pt.add_argument("--epochs", type=int, default=30)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--ckpt-dir", default="./logs/ckpt")
    pt.add_argument("--no-vgg", action="store_true", help="train without the VGG loss")
    pt.add_argument("--vgg-weights", default="",
                    help="torchvision vgg16 features state_dict (.pth/.npz); "
                    "without it a seeded random VGG16")
    pt.add_argument("--native-prefetch", action="store_true",
                    help="batches from the C++ threaded prefetcher where the frame set is not "
                    "on the device (built with g++ into build/native/ at first use)")
    pt.add_argument("--resume", action="store_true",
                    help="go on from the newest checkpoint in --ckpt-dir")
    pt.add_argument("--log-dir", default="./logs",
                    help="metrics.jsonl, TensorBoard events and validation strips go here")
    pt.add_argument("--tensorboard", action="store_true",
                    help="the per-epoch metrics as TensorBoard scalars too (needs the "
                    "tensorboard package)")
    pt.add_argument("--trace-dir", default="",
                    help="a torch.profiler trace (trace.json, Chrome / Perfetto) of the first "
                    "epoch's steps 1..--trace-steps, written here")
    pt.add_argument("--trace-steps", type=int, default=5)
    pt.add_argument("--guard-policy", default="warn", choices=["warn", "rollback", "abort"],
                    help="on non-finite steps: warn / roll back to the last checkpoint / abort")
    pt.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pt.add_argument("--data-parallel", type=int, default=1,
                    help="ranks over the frames of a batch (the mesh's data axis)")
    pt.add_argument("--ray-parallel", type=int, default=1,
                    help="ranks over the rays of a frame (the mesh's rays axis)")
    pt.add_argument("--lpips-weights", default="",
                    help="LPIPS-alex .npz (the JAX package's save_lpips_alex layout) to "
                    "report LPIPS in validation")
    pt.set_defaults(fn=cmd_train)

    pa = sub.add_parser("animate", help="wav -> talking-head video (.mp4) or frames (.npy)")
    pa.add_argument("--featmap-size", type=int, default=None,
                    help="default: the --ckpt's config, else 32")
    pa.add_argument("--img-size", type=int, default=None,
                    help="default: the --ckpt's config, else 256")
    pa.add_argument("--seed", type=int, default=0,
                    help="seed of the NeRF weights when --params and --ckpt give none")
    pa.add_argument("--wav", required=True)
    pa.add_argument("--latents", help="fitted.npz from `fit`")
    pa.add_argument("--params", help="flax variables as a '/'-joined .npz "
                    "(keys nerf/params/... and audio/params/...)")
    pa.add_argument("--ckpt", help="checkpoint directory of `train` (its newest checkpoint)")
    pa.add_argument("--fps", type=int, default=25)
    pa.add_argument("--chunk", type=int, default=4)
    pa.add_argument("--max-frames", type=int, default=0)
    pa.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pa.add_argument("--enhancer", default="none", choices=["none", "unsharp", "gfpgan"],
                    help="post-render enhancer (gfpgan is not ported yet)")
    pa.add_argument("--out", help=".mp4 (default talking_head.mp4; ffmpeg, the wav muxed "
                    "in) or .npy (frames [T, H, W, 3] in [0, 1])")
    pa.set_defaults(fn=cmd_animate)

    def weights_flags(sp):
        sp.add_argument("--featmap-size", type=int, default=None,
                        help="default: the --ckpt's config, else 32")
        sp.add_argument("--img-size", type=int, default=None,
                        help="default: the --ckpt's config, else 256")
        sp.add_argument("--seed", type=int, default=0,
                        help="seed of the NeRF weights when --params and --ckpt give none, "
                        "and of the synthetic target or codes")
        sp.add_argument("--params", help="flax variables as a '/'-joined .npz (keys "
                        "nerf/params/...; audio/... is ignored)")
        sp.add_argument("--ckpt", help="checkpoint directory of `train` (its newest checkpoint)")
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pf = sub.add_parser("fit", help="fit code offsets and camera deltas to one image")
    weights_flags(pf)
    pf.add_argument("--data", help="npz: image [H,W,3] (+ mask [H,W,1], iden/expr/text/illu)")
    pf.add_argument("--iters", type=int, default=300)
    pf.add_argument("--no-cam-opt", action="store_true", help="keep the camera fixed")
    pf.add_argument("--out", help="default fitted.npz")
    pf.set_defaults(fn=cmd_fit)

    pr = sub.add_parser("render", help="orbit views of a subject -> .npy")
    weights_flags(pr)
    pr.add_argument("--views", type=int, default=45)
    pr.add_argument("--latents", help="fitted.npz from `fit`: orbit the fitted subject")
    pr.add_argument("--out", help="default novel_views.npy")
    pr.set_defaults(fn=cmd_render)

    def vq_flags(sp, defaults, note=""):
        sp.add_argument("--img-size", type=int, default=defaults["img_size"], help=note)
        sp.add_argument("--seed", type=int, default=0, help="seed of the weights' init")
        sp.add_argument("--data", default="", help="npz: gen_img, gt_img, mask [N,H,W,1], "
                        "crops [N,5,S,S,3], au_labels [N,5]; without it random frames")
        sp.add_argument("--hidden", type=int, default=defaults["hidden"], help=note)
        sp.add_argument("--embed-dim", type=int, default=defaults["embed_dim"], help=note)
        sp.add_argument("--n-embed", type=int, default=defaults["n_embed"], help=note)
        sp.add_argument("--layers", type=int, default=defaults["layers"], help=note)
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pv = sub.add_parser("train-vq", help="train the Standardized Space stage 1")
    vq_flags(pv, TRAIN_VQ_DEFAULTS)
    pv.add_argument("--batch-size", type=int, default=1)
    pv.add_argument("--epochs", type=int, default=60)
    pv.add_argument("--lr", type=float, default=1e-4)
    pv.add_argument("--ckpt-dir", default="", help="write a checkpoint here after training")
    pv.set_defaults(fn=cmd_train_vq)

    pev = sub.add_parser("eval-vq", help="test_vq: reconstruct a split -> gen+/")
    vq_flags(pev, dict.fromkeys(EVAL_VQ_DEFAULTS),
             note="default: the --ckpt's config, else the JAX eval-vq default")
    pev.add_argument("--ckpt", default="", help="checkpoint directory of train-vq "
                     "(its newest checkpoint; its VQConfig is used)")
    pev.add_argument("--out", default="", help="PNG directory (default ./gen+)")
    pev.set_defaults(fn=cmd_eval_vq)

    ps2 = sub.add_parser("infer-stage2", help="wav -> wav2vec2 -> CodeTalker codes -> frames")
    ps2.add_argument("--wav", required=True)
    ps2.add_argument("--frames", type=int, default=0, help="default: the wav's length at --fps")
    ps2.add_argument("--fps", type=int, default=25)
    ps2.add_argument("--hf-wav2vec", default="", help="local HF Wav2Vec2Model directory "
                     "(config.json + model.safetensors or pytorch_model.bin)")
    ps2.add_argument("--vq-ckpt", default="", help="checkpoint directory of train-vq "
                     "(its newest checkpoint; its VQConfig is used)")
    ps2.add_argument("--ckpt", default="", help="stage-2 checkpoint directory (CodeTalker "
                     "and its dims)")
    note = "default: the --vq-ckpt's config, else the JAX infer-stage2 default"
    ps2.add_argument("--img-size", type=int, default=None, help=note)
    ps2.add_argument("--hidden", type=int, default=None, help=note)
    ps2.add_argument("--embed-dim", type=int, default=None, help=note)
    ps2.add_argument("--n-embed", type=int, default=None, help=note)
    ps2.add_argument("--layers", type=int, default=None, help=note)
    ps2.add_argument("--feature-dim", type=int, default=64, help="without --ckpt")
    ps2.add_argument("--n-subjects", type=int, default=8, help="without --ckpt")
    ps2.add_argument("--subject", type=int, default=0)
    ps2.add_argument("--seed", type=int, default=0, help="seed of the weights --vq-ckpt and "
                     "--ckpt do not give")
    ps2.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ps2.add_argument("--out", default="", help="default stage2_frames.npy")
    ps2.set_defaults(fn=cmd_infer_stage2)

    pi = sub.add_parser("infer-coeff", help="wav or text -> SadTalker exp / pose .npz")
    pi.add_argument("--wav", default="")
    pi.add_argument("--text", default="", help="without --wav: the placeholder TTS's wav")
    pi.add_argument("--safetensors", default="", help="SadTalker checkpoint (its "
                    "audio2exp.* tensors); without it the expressions are zero")
    pi.add_argument("--fps", type=int, default=25)
    pi.add_argument("--seed", type=int, default=0, help="seed of the blink ratios")
    pi.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pi.add_argument("--out", default="", help="default coeffs.npz")
    pi.set_defaults(fn=cmd_infer_coeff)

    pp = sub.add_parser("preprocess", help="frames .npy + wav -> a subject .npz for train --data")
    pp.add_argument("--frames", required=True, help="[T, H, W, 3] .npy, values in [0, 1]")
    pp.add_argument("--wav", required=True)
    pp.add_argument("--featmap-size", type=int, default=32, help="of the base camera's "
                    "inv_inmat (and of the placeholder camera without --strict)")
    pp.add_argument("--seed", type=int, default=0, help="seed of the networks and the blink "
                    "ratios")
    pp.add_argument("--strict", action="store_true",
                    help="run the full network path; no placeholder arrays")
    pp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pp.add_argument("--out", default="", help="default subject.npz")
    pp.set_defaults(fn=cmd_preprocess)

    args = p.parse_args(argv)
    # the flags set on the command line, not left at their parser default
    args.explicit = sorted(a.dest for a in sub.choices[args.cmd]._actions
                           if a.dest != "help" and getattr(args, a.dest) != a.default)
    return args.fn(args)


if __name__ == "__main__":
    main()
