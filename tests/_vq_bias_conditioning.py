"""How well f32 computes the gradient of a conv bias that feeds an instance
norm in the Standardized Space stage 1 (`vq_trainer.norm_fed_convs`), at
the config of `tests/test_torch_cuda.py::test_vq_step_on_the_card_matches_the_cpu`.

    python tests/_vq_bias_conditioning.py [--seeds 6]

For each seed: the card test's weights and batch, one loss and backward on
the CPU in f32 and in f64. Prints one JSON line a seed: the image-code
indices that differ, and per bias the f32 error's L2 relative to the f64
gradient's own norm and relative to the mass of the terms it sums
(`bias_term_mass`: Σ|dL/d(conv output)| per channel), and for the
squasher and the expander the positions whose pre-activation changed
sides of the leaky ReLU's knee.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf3dtalker_tpu_torch.config import VQConfig  # noqa: E402
from nerf3dtalker_tpu_torch.train.vq_trainer import (  # noqa: E402
    bias_term_mass,
    init_modules,
    norm_fed_convs,
    to_batch,
    vq_loss,
)

# the card test's config and batch
CFG = VQConfig(img_size=64, hidden_size=128, embed_dim=16, n_embed=1024, n_embed_au=64,
               num_hidden_layers=2, num_attention_heads=4, intermediate_size=256)
KNEE = ("vq.encoder.squasher.conv.bias", "vq.decoder.expander.conv.bias")


def batch(seed, B=2):
    rng = np.random.default_rng(seed)
    S = CFG.img_size
    gt = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    return {"gen_img": np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32),
            "gt_img": gt, "mask": (rng.uniform(0, 1, (B, S, S, 1)) > 0.3).astype(np.float32),
            "crops": rng.uniform(0, 1, (B, 5, 112, 112, 3)).astype(np.float32),
            "au_labels": (rng.uniform(0, 1, (B, 5)) > 0.5).astype(np.float32)}


def run(seed, dtype):
    """({bias: gradient}, {bias: mass}, {bias: conv output}, indices)."""
    vq, au = init_modules(CFG, 112, "cpu", torch.Generator().manual_seed(seed))
    vq.to(dtype)
    au.to(dtype)
    convs = norm_fed_convs(vq, au)
    outs = {}
    for name in KNEE:
        convs[name].register_forward_hook(
            lambda _m, _i, o, name=name: outs.__setitem__(name, o.detach().double()))
    b = {k: v.to(dtype) for k, v in to_batch(batch(seed), "cpu").items()}
    with bias_term_mass(convs) as mass:
        total, _, out = vq_loss(vq, au, b)
        total.backward()
    grads = {k: c.bias.grad.double() for k, c in convs.items()}
    return grads, {k: v.double() for k, v in mass.items()}, outs, out.indices


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    for seed in range(args.seeds):
        g32, _, o32, i32 = run(seed, torch.float32)
        g64, m64, o64, i64 = run(seed, torch.float64)
        rel = {k: float((g32[k] - g64[k]).norm() / g64[k].norm()) for k in g64}
        to_mass = {k: float((g32[k] - g64[k]).norm() / m64[k].norm()) for k in g64}
        au = [k for k in g64 if k.startswith("au.")]
        row = {"seed": seed, "code_flips": int((i32 != i64).sum()),
               "au_biases_max_to_mass": max(to_mass[k] for k in au)}
        for k in KNEE:
            row[k] = {"to_own": rel[k], "to_mass": to_mass[k],
                      "knee_flips": int(((o32[k] > 0) != (o64[k] > 0)).sum())}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
