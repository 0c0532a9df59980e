"""The Standardized Space stage 1 on real NeRF renders (port of the JAX
package's `scripts/vq_run.py`, whose record is `BENCH_VQ_r05.json`).

Two phases, one record:

  1. bench  — the stage-1 train step (5 AU classifiers + the dual-codebook
     autoencoder + AdamW) and the `reconstruct_split` inference of a batch
     at the reference scale (img 256, VQConfig defaults), timed with CUDA
     events on the card (the host's clock on the CPU), the data resident
     on the device. Reference: StandardizedSpace/main/train_vq.py:239-375.
  2. refine — stage-1 training on the renders of the r05 convergence run
     (`nerf3dtalker_tpu_torch/scripts/train_r05.py` -> renders.npz): gen =
     the trained HeadNeRF's renders, gt = ground truth. The refined frames
     (gen+, the background reset through the mask, test_vq.py:137) are
     held against the raw renders on PSNR/L1 (test_vq.py:52-150), in two
     regimes: `degraded_conditioning` (the renders under zeroed audio_exp,
     trained on train and scored on held-out val) and
     `high_quality_renders` (with `gt_passthrough`, the autoencoder's own
     ceiling).

    python -m nerf3dtalker_tpu_torch.scripts.vq_run --renders <workdir>/renders.npz \\
        --steps 8000 --out VQ_r05_torch.json
    python -m nerf3dtalker_tpu_torch.scripts.vq_run --device cpu \\
        --renders <renders.npz> --steps 4 --batch-size 2 --bench-iters 2 --out /tmp/v.json

The batch orders are the JAX script's (numpy seeds), the weights' init a
torch generator seeded 0 in each regime. Everything runs in f32.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.scripts.train_r05 import device_record
from nerf3dtalker_tpu_torch.train.vq_eval import reconstruct_batch
from nerf3dtalker_tpu_torch.train.vq_trainer import build_vq_step, to_batch
from nerf3dtalker_tpu_torch.utils.device import resolve_device

CROP = 112


def downsample2x(x: np.ndarray) -> np.ndarray:
    """[N, 2H, 2W, C] -> [N, H, W, C] area average."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))


def resize_crops(c: np.ndarray, size: int) -> np.ndarray:
    """[N, s, s, 3] -> [N, size, size, 3], bilinear with half-pixel centres,
    antialiased when it shrinks (what `jax.image.resize(..., "linear")`
    does; the two agree to float rounding, `tests/test_torch_vq_trainer.py`)."""
    t = torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32)).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return t.permute(0, 2, 3, 1).contiguous().numpy()


def build_vq_data(renders, split: str, size: int = 256) -> dict:
    """VQ training arrays from the r05 renders: images downsampled 2x toward
    the reference's 256, mouth/brow crops resized to the AU classifiers'
    112^2, AU labels from the subject's openness/brow signals (AU25/26 <-
    mouth open, AU10/14/20 <- brow/mouth)."""
    gen = downsample2x(renders[f"{split}_render"]).astype(np.float32)
    gt = downsample2x(renders[f"{split}_gt"]).astype(np.float32)
    mask = (downsample2x(renders[f"{split}_mask"]) >= 0.5).astype(np.float32)
    a = renders[f"a_{split}"]
    b = renders[f"b_{split}"]
    S = gen.shape[1]

    def crop(img, cy_frac):
        # a feature-centred square crop of ~0.44 S
        cs = max(8, int(0.44 * S))
        cy, cx = int(cy_frac * S), S // 2
        y0 = max(0, min(S - cs, cy - cs // 2))
        x0 = max(0, min(S - cs, cx - cs // 2))
        c = img[:, y0 : y0 + cs, x0 : x0 + cs, :]
        return resize_crops(c, CROP) if cs != CROP else c

    mouth = crop(gen, 0.70)
    brow = crop(gen, 0.34)
    crops = np.stack([brow, brow, mouth, mouth, mouth], axis=1)
    labels = np.stack([(b > 0.0), (b < -0.3), (a > 0.5), (a > 0.33), (a > 0.66)],
                      axis=1).astype(np.float32)
    return {"gen_img": gen, "gt_img": gt, "mask": mask,
            "crops": crops.astype(np.float32), "au_labels": labels}


def orders(n_train: int, B: int, n_steps: int, seed: int) -> np.ndarray:
    """[n_steps, B] frame indices, each row drawn without replacement."""
    r = np.random.default_rng(seed)
    return np.stack([r.choice(n_train, B, replace=False) for _ in range(n_steps)])


class Timer:
    """Elapsed ms of a block: CUDA events on the card (device time of the
    work queued in it), the host's clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            self.ms = self.ev[0].elapsed_time(self.ev[1])
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def split_metrics(state, data: dict, B: int) -> dict:
    """gen (raw render) and gen+ (refined) PSNR and L1 against gt."""
    dev = next(state.vq.parameters()).device
    outs = []
    for s in range(0, len(data["gen_img"]), B):
        b = to_batch({k: data[k] for k in ("gen_img", "crops", "mask")}, dev, slice(s, s + B))
        outs.append(reconstruct_batch(state.vq, state.au, b["gen_img"], b["crops"],
                                      b["mask"]).cpu().numpy())
    rec = np.concatenate(outs, 0)

    def psnr_l1(x):
        mse = np.mean((x - data["gt_img"]) ** 2)
        return (float(10 * np.log10(1.0 / max(mse, 1e-10))),
                float(np.mean(np.abs(x - data["gt_img"]))))

    gen_psnr, gen_l1 = psnr_l1(data["gen_img"])
    rec_psnr, rec_l1 = psnr_l1(rec)
    return {"gen_psnr": gen_psnr, "genplus_psnr": rec_psnr, "gen_l1": gen_l1,
            "genplus_l1": rec_l1, "refined_beats_raw": bool(rec_psnr > gen_psnr)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--renders", required=True)
    ap.add_argument("--out", default="VQ_r05_torch.json")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--bench-iters", type=int, default=100,
                    help="timed steps of the bench, and the refine's chunk of steps "
                         "between two loss prints")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    B = args.batch_size
    with np.load(args.renders) as z:
        renders = {k: z[k] for k in z.files}
    train = build_vq_data(renders, "train")
    val = build_vq_data(renders, "val")
    # the reference stage-1 scale is 256 px (hidden 512); img_size follows
    # the renders (512 px r05 renders downsample to exactly 256)
    cfg = VQConfig(img_size=int(train["gen_img"].shape[1]))
    n_train = len(train["gen_img"])
    init, train_step, _ = build_vq_step(cfg, lr=args.lr, device=dev)

    def train_steps(state, dev_data, order):
        for idx in torch.as_tensor(order, device=dev):
            state, m = train_step(state, {k: v[idx] for k, v in dev_data.items()})
        return m

    # ---- phase 1: the step and the inference, timed ---------------------
    dev_train = to_batch(train, dev)
    state = init(torch.Generator().manual_seed(0), {k: v[:B] for k, v in dev_train.items()})
    t0 = time.perf_counter()
    with Timer(dev) as warm:
        train_steps(state, dev_train, orders(n_train, B, min(args.bench_iters, 10), 0))
    warm_s = time.perf_counter() - t0
    with Timer(dev) as timed:
        m = train_steps(state, dev_train, orders(n_train, B, args.bench_iters, 1))
    ms_step = timed.ms / args.bench_iters
    b = {k: v[:B] for k, v in dev_train.items()}
    reconstruct_batch(state.vq, state.au, b["gen_img"], b["crops"], b["mask"])
    iters = 20
    with Timer(dev) as inf:
        for _ in range(iters):
            reconstruct_batch(state.vq, state.au, b["gen_img"], b["crops"], b["mask"])
    bench = {
        "img_size": cfg.img_size, "batch_size": B, "steps_timed": args.bench_iters,
        "train_ms_per_step": ms_step, "train_steps_per_s": 1e3 / ms_step,
        "infer_ms_per_frame": inf.ms / (iters * B), "warmup_s": warm_s,
        "final_total_loss": float(m["total_loss"]),
        "timing": ("CUDA events around back-to-back steps (device time of the queued work)"
                   if dev.type == "cuda" else "host clock"),
        "workload": "stage-1 VQ autoencoder + 5 AU classifiers + AdamW, f32, "
                    "device-resident data, one step per batch",
    }
    print("bench:", json.dumps(bench), flush=True)
    del state

    # ---- phase 2: refinement on the r05 renders --------------------------
    def train_refiner(data, tag):
        d = to_batch(data, dev)
        st = init(torch.Generator().manual_seed(0), {k: v[:B] for k, v in d.items()})
        steps_done = 0
        t0 = time.time()
        while steps_done < args.steps:
            chunk = min(args.bench_iters, args.steps - steps_done)
            m = train_steps(st, d, orders(len(data["gen_img"]), B, chunk, 100 + steps_done))
            steps_done += chunk
            print(f"[{tag}] refine step {steps_done}: loss {float(m['total_loss']):.4f}",
                  flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return st, steps_done, time.time() - t0

    refine = {"source": "HeadNeRF renders of nerf3dtalker_tpu_torch/scripts/train_r05.py "
                        "(renders.npz), downsampled toward the reference's 256 px"}
    if "train_degraded" in renders:
        # the gen frames and their crops from the renders under zeroed
        # audio_exp (the AU classifiers see gen frames, test_vq.py:107-123)
        def degraded(split):
            return {f"{split}_render": renders[f"{split}_degraded"],
                    **{k: renders[k] for k in (f"{split}_gt", f"{split}_mask", f"a_{split}",
                                               f"b_{split}")}}

        tr_deg = build_vq_data(degraded("train"), "train")
        st_a, n_a, s_a = train_refiner(tr_deg, "degraded")
        rows = {"train": split_metrics(st_a, tr_deg, B)}
        if "val_degraded" in renders:
            rows["val_heldout"] = split_metrics(st_a, build_vq_data(degraded("val"), "val"), B)
        refine["degraded_conditioning"] = {
            "note": "the reference's refinement regime (test_vq.py): gen frames whose "
                    "quality is limited by conditioning mismatch; stage-1 must pull them "
                    "toward GT",
            "steps": n_a, "refine_s": s_a, **rows}
        print("refine A:", json.dumps(refine["degraded_conditioning"]), flush=True)
        del st_a

    st_b, n_b, s_b = train_refiner(train, "hq")
    hq = {"steps": n_b, "refine_s": s_b, "train": split_metrics(st_b, train, B),
          "val": split_metrics(st_b, val, B),
          "gt_passthrough": split_metrics(st_b, dict(train, gen_img=train["gt_img"]), B),
          "note": "gt_passthrough.genplus_psnr is the trained autoencoder's own "
                  "reconstruction ceiling; raw renders above it cannot be improved by "
                  "this stage"}
    refine["high_quality_renders"] = hq
    print("refine B:", json.dumps(hq), flush=True)

    platform, device = device_record(dev)
    out = {
        "metric": "vq_standardized_space_torch",
        "platform": platform,
        "device": device,
        "torch": torch.__version__,
        "tf32": {"cudnn_conv": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
        "reference": "StandardizedSpace/main/train_vq.py:239-375 (train), "
                     "test_vq.py:52-150 (gen+ refinement)",
        "bench": bench,
        "refinement": refine,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
