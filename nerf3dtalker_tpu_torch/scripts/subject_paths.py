"""Does the subject's NeRF stay opaque? Train `coherent_subject` for a few
epochs through each render path and seed, and print per epoch the losses
and the NeRF's mean opacity (1 - bg_alpha) over two train frames.

A NeRF whose ReLU density dies everywhere renders nothing (opacity 0) and
gets no gradient again; the decoder then draws the static face from its bg
featmap and the renders no longer depend on the audio. The paths tell a
kernel fault or a precision effect apart from the init's: `kernels` (K1/K2
in bf16 on the GPU), `plain` (the plain autograd path in the device's
dtype) and `plain-f32`.

    python -m nerf3dtalker_tpu_torch.scripts.subject_paths --epochs 4 --seeds 0,1
    python -m nerf3dtalker_tpu_torch.scripts.subject_paths --scale tiny --device cpu \\
        --frames 4 --epochs 1 --seeds 0 --paths plain,plain-f32
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nerf3dtalker_tpu_torch.config import NeRFConfig, TrainConfig, reso64
from nerf3dtalker_tpu_torch.data.dataset import coherent_subject, to_tensors
from nerf3dtalker_tpu_torch.models.perceptual import load_vgg16
from nerf3dtalker_tpu_torch.train.step import build_step_fns
from nerf3dtalker_tpu_torch.train.trainer import Trainer
from nerf3dtalker_tpu_torch.utils.device import resolve_device

LOSSES = ("bg_loss", "head_loss", "nonhead_loss", "vgg", "total_loss")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--paths", default="kernels,plain,plain-f32")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--scale", default="reso64", choices=["reso64", "tiny"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reso64() if args.scale == "reso64" else NeRFConfig(
        featmap_size=8, featmap_nc=32, pred_img_size=64, num_sample_coarse=8, mlp_hidden=32)
    train = coherent_subject(cfg, num_frames=args.frames)
    probe = to_tensors(train.batch(np.arange(2)), dev)
    vgg = load_vgg16(seed=0, device=dev)
    out = []
    for seed in map(int, args.seeds.split(",")):
        for path in args.paths.split(","):
            tc = TrainConfig(batch_size=2, epochs=args.epochs, lr=args.lr, seed=seed,
                             ckpt_dir="", log_dir="")
            t = Trainer(cfg, tc, train, device=dev)
            # the trainer's VGG (seed 0) and its target planes, in its dtype
            t.fns = build_step_fns(cfg, tc, t.steps_per_epoch, vgg=vgg, device=dev,
                                   use_fused=path == "kernels",
                                   compute_dtype=torch.float32 if path == "plain-f32" else None)
            t.init()

            def opacity():
                with torch.no_grad():
                    return float((1.0 - t.fns.render(t.state, probe)["bg_alpha"]).mean())

            rec = {"seed": seed, "path": path, "init_opacity": opacity(), "epochs": []}
            for e in range(args.epochs):
                losses = t.train_one_epoch(e)
                rec["epochs"].append({**{k: losses[k] for k in LOSSES}, "opacity": opacity()})
            t.close()     # the step's CUDA graph and its pool
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
