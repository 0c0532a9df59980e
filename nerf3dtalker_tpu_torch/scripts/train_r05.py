"""Convergence run: the port's Trainer learns a learnable audio-conditioned
subject (port of the JAX package's `scripts/train_r05.py`, whose output is
`TRAIN_r05.json`).

The dataset is `coherent_subject`: smooth frame-consistent face images
whose mouth aperture rides only on the mel chunks (through Audio2Style) and
brow height only on audio_exp (the expr[:64] overwrite,
talker_trainer.py:853). The targets:

  * train PSNR >= 28 and train SSIM >= 0.9;
  * val PSNR (held-out frames of the same performance) climbs by > 3 dB;
  * ablations: shuffled mels and zeroed audio_exp each cost > 1 dB.

Training runs `--epochs`, then `--extend-chunk` more at a time until the
train-split targets hold or `--max-epochs`. The final train and val
renders (with GT, masks, the renders under zeroed audio_exp and the
openness/brow signals) go to `renders.npz` in the workdir.

    python -m nerf3dtalker_tpu_torch.scripts.train_r05 --out TRAIN_r05_torch.json
    python -m nerf3dtalker_tpu_torch.scripts.train_r05 --scale tiny --device cpu \\
        --frames 4 --val-frames 2 --epochs 2 --max-epochs 2 --val-every 1 --out /tmp/t.json

On the GPU HeadNeRF computes in bf16 through the fused render kernels (K1
forward, K2 backward); on the CPU in f32 through the plain path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig, reso64
from nerf3dtalker_tpu_torch.data.dataset import coherent_subject, talking_signals, to_tensors
from nerf3dtalker_tpu_torch.train.trainer import Trainer
from nerf3dtalker_tpu_torch.utils.device import resolve_device
from nerf3dtalker_tpu_torch.utils.metrics import psnr, ssim_rgb


def eval_split(t: Trainer, ds, batch_override=None):
    """Mean PSNR/SSIM of the trainer's deterministic renders over a dataset
    in batches of the trainer's size (a last partial batch is left out),
    optionally with ablated audio inputs; and the renders [N, H, W, 3]."""
    psnrs, ssims, imgs_out = [], [], []
    for s in range(0, len(ds) - len(ds) % t.batch_size, t.batch_size):
        idx = np.arange(s, s + t.batch_size)
        batch = ds.batch(idx)
        if batch_override:
            batch = {**batch, **{k: v[idx] for k, v in batch_override.items()}}
        tb = to_tensors(batch, t.device)
        imgs, _ = t.fns.eval_step(t.state, tb)
        for j in range(imgs.shape[0]):
            psnrs.append(float(psnr(imgs[j], tb["gt_rgb"][j])))
            ssims.append(float(ssim_rgb(imgs[j], tb["gt_rgb"][j])))
            imgs_out.append(imgs[j].float().cpu().numpy())
    return ({"PSNR": float(np.mean(psnrs)), "SSIM": float(np.mean(ssims))},
            np.stack(imgs_out))


@torch.no_grad()
def mean_opacity(t: Trainer, ds) -> float:
    """Mean opacity (1 - bg_alpha) of the NeRF over a dataset's rays. A
    NeRF that renders nothing (opacity 0) leaves the whole image to the
    decoder's static bg featmap, so the audio inputs cannot reach it."""
    vals = []
    for s in range(0, len(ds) - len(ds) % t.batch_size, t.batch_size):
        tb = to_tensors(ds.batch(np.arange(s, s + t.batch_size)), t.device)
        vals.append(float((1.0 - t.fns.render(t.state, tb)["bg_alpha"]).mean()))
    return float(np.mean(vals))


def device_record(dev: torch.device):
    """(platform, device): the card's name with its power limit as
    nvidia-smi reports them, or the CPU."""
    if dev.type != "cuda":
        return "cpu", "cpu"
    name = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
    except (FileNotFoundError, subprocess.CalledProcessError):
        return "gpu", name
    return "gpu", smi[dev.index or 0] if smi else name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="TRAIN_r05_torch.json")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--val-frames", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--max-epochs", type=int, default=500,
                    help="keep extending in chunks until train PSNR>=28 & SSIM>=0.9 or this cap")
    ap.add_argument("--extend-chunk", type=int, default=75)
    ap.add_argument("--val-every", type=int, default=5)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--scale", default="reso64", choices=["reso64", "tiny"],
                    help="tiny = a small config for a smoke test of the whole flow")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="TrainConfig.seed: the weights' init, the batch order, the jitter")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    wd = args.workdir or tempfile.mkdtemp(prefix="train_r05_")
    cfg = reso64() if args.scale == "reso64" else NeRFConfig(
        featmap_size=8, featmap_nc=32, pred_img_size=64, num_sample_coarse=8, mlp_hidden=32)
    tc = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
                     ckpt_dir=os.path.join(wd, "ckpt"), log_dir=os.path.join(wd, "logs"),
                     guard_policy="rollback", use_vgg_loss=True, val_every=args.val_every,
                     seed=args.seed)
    train = coherent_subject(cfg, num_frames=args.frames, t0=0)
    val = coherent_subject(cfg, num_frames=args.val_frames, t0=args.frames)
    train_eval = coherent_subject(cfg, num_frames=args.val_frames, t0=0)

    t0 = time.time()
    t = Trainer(cfg, tc, train, val, device=dev, train_eval_data=train_eval)
    t.init()
    setup_s = time.time() - t0
    init_opacity = mean_opacity(t, train_eval)

    ta = time.time()
    epochs_done = 0
    while True:
        chunk = args.epochs if epochs_done == 0 else args.extend_chunk
        chunk = min(chunk, args.max_epochs - epochs_done)
        if chunk <= 0:
            break
        t.start_epoch = epochs_done
        hist = t.train(epochs=epochs_done + chunk)
        epochs_done += chunk
        tp = [h for h in hist if "TRAIN_PSNR" in h]
        if tp and tp[-1]["TRAIN_PSNR"] >= 28.0 and tp[-1]["TRAIN_SSIM"] >= 0.9:
            break
        print(f"[extend] epoch {epochs_done}: TRAIN_PSNR="
              f"{tp[-1]['TRAIN_PSNR'] if tp else float('nan'):.2f} — continuing", flush=True)
    train_s = time.time() - ta

    # ---- final full-split metrics + ablations ----------------------------
    final_train, train_renders = eval_split(t, train)
    final_val, val_renders = eval_split(t, val)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(train))
    while np.any(perm == np.arange(len(train))):     # a full derangement
        perm = rng.permutation(len(train))
    abl_shuf, _ = eval_split(t, train, {"mels": train.arrays["mels"][perm]})
    abl_zexp, degraded_renders = eval_split(
        t, train, {"audio_exp": np.zeros_like(train.arrays["audio_exp"])})
    _, degraded_val = eval_split(t, val, {"audio_exp": np.zeros_like(val.arrays["audio_exp"])})

    a_tr, b_tr = talking_signals(args.frames, t0=0)
    a_va, b_va = talking_signals(args.val_frames, t0=args.frames)
    np.savez(
        os.path.join(wd, "renders.npz"),
        train_render=train_renders.astype(np.float32),
        train_gt=train.arrays["images"],
        train_mask=train.arrays["head_mask"],
        val_render=val_renders.astype(np.float32),
        val_gt=val.arrays["images"],
        val_mask=val.arrays["head_mask"],
        # renders under a conditioning mismatch (zeroed audio_exp)
        train_degraded=degraded_renders.astype(np.float32),
        val_degraded=degraded_val.astype(np.float32),
        a_train=a_tr, b_train=b_tr, a_val=a_va, b_val=b_va,
    )

    curve = [{k: (round(v, 5) if isinstance(v, float) else v) for k, v in h.items()}
             for h in hist]
    psnr_curve = [(h["epoch"], h["TRAIN_PSNR"]) for h in hist if "TRAIN_PSNR" in h]
    val_psnrs = [h["PSNR"] for h in hist if "PSNR" in h]
    sec_per_step = sorted(h["sec_per_step"] for h in hist)
    platform, device = device_record(dev)
    render = ("HeadNeRF in bf16 through the CUDA C++ kernels K1/K2" if dev.type == "cuda"
              else "HeadNeRF in f32 through the plain path")
    out = {
        "metric": f"train_convergence_{args.scale}",
        "platform": platform,
        "device": device,
        "workload": (
            f"nerf3dtalker_tpu_torch Trainer, {args.scale}, full objective (bg+head+nonhead+"
            f"vgg16 precomputed-GT), {render}, nn.LSTM BiLSTM, B={args.batch_size}, "
            f"lr={args.lr}, {args.frames}-frame coherent "
            "audio-conditioned subject (mouth<-mels, brow<-audio_exp), guard=rollback, "
            "device-cached input path"),
        "dataset": "data/dataset.py:coherent_subject (learnable; audio is the only "
                   "per-frame signal)",
        "seed": args.seed,
        "total_steps": int(t.state.step),
        "epochs": len(hist),
        "sec_per_step_median": round(sec_per_step[len(sec_per_step) // 2], 4),
        "setup_s": round(setup_s, 1),
        "train_s": round(train_s, 1),
        "final_train": {k: round(v, 3) for k, v in final_train.items()},
        "final_val": {k: round(v, 3) for k, v in final_val.items()},
        "targets": {
            "train_psnr_ge_28": final_train["PSNR"] >= 28.0,
            "train_ssim_ge_0.9": final_train["SSIM"] >= 0.9,
            "val_psnr_climbs": len(val_psnrs) >= 3 and val_psnrs[-1] > val_psnrs[0] + 3.0,
        },
        "ablations": {
            "note": "audio pathway must be load-bearing: each row ablates ONE audio input "
                    "on the trained model over the full train split",
            "intact_psnr": round(final_train["PSNR"], 3),
            "shuffled_mels_psnr": round(abl_shuf["PSNR"], 3),
            "shuffled_mels_delta_db": round(final_train["PSNR"] - abl_shuf["PSNR"], 3),
            "zeroed_audio_exp_psnr": round(abl_zexp["PSNR"], 3),
            "zeroed_audio_exp_delta_db": round(final_train["PSNR"] - abl_zexp["PSNR"], 3),
            "both_exceed_1db": bool(final_train["PSNR"] - abl_shuf["PSNR"] > 1.0
                                    and final_train["PSNR"] - abl_zexp["PSNR"] > 1.0),
        },
        "opacity": {"note": "mean 1 - bg_alpha of the NeRF over the train-eval frames",
                    "init": round(init_opacity, 4), "final": round(mean_opacity(t, train_eval), 4)},
        "train_psnr_curve": [[e, round(p, 3)] for e, p in psnr_curve],
        "history": curve,
        "renders_npz": os.path.join(wd, "renders.npz"),
        "metrics_jsonl": os.path.join(wd, "logs", "metrics.jsonl"),
        "workdir": wd,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("history", "train_psnr_curve")}, indent=1))
    return out


if __name__ == "__main__":
    main()
