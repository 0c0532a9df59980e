"""How opaque a Reso64 HeadNeRF starts, over init seeds, for the port's init
and for the JAX package's.

    JAX_PLATFORMS=cpu python tests/_init_opacity.py [--seeds 32] [--stride 4]

For each seed: the port's `HeadNeRF(reso64(), generator=seed)` (the init
that `TrainConfig.seed` gives the trainer) and the JAX `HeadNeRF(reso64())
.init(jax.random.key(seed))`, bridged into the port. Both are evaluated by
the same plain f32 forward: the rays of every `stride`-th pixel of the
64 x 64 grid at the base camera, 64 deterministic samples, the codes of the
`coherent_subject` val frame 0 (as the smoke's `nerf_opacity` takes them),
audio style zero. Opacity = 1 - mean bg_alpha over those rays. Prints one
JSON object: the opacities by seed and their quantiles for each init, and
the two-sample Kolmogorov-Smirnov distance between them.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf3dtalker_tpu.config import reso64 as jreso64  # noqa: E402
from nerf3dtalker_tpu.models import HeadNeRF as JHeadNeRF  # noqa: E402
from nerf3dtalker_tpu_torch.config import reso64  # noqa: E402
from nerf3dtalker_tpu_torch.data.dataset import coherent_subject  # noqa: E402
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF  # noqa: E402
from nerf3dtalker_tpu_torch.ops.rays import gen_rays, sample_points, stratified_zvals  # noqa
from nerf3dtalker_tpu_torch.utils import bridge  # noqa: E402
from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid  # noqa: E402


def subject_codes(cfg):
    """(shape_code, appea_code) of the subject's val frame 0, expr[:64]
    overwritten by its audio_exp (as the trainer assembles them)."""
    f = {k: v[:1] for k, v in coherent_subject(cfg, 8, t0=40).arrays.items()}
    expr = np.concatenate([f["audio_exp"], f["expr"][:, 64:]], -1)
    return (torch.from_numpy(np.concatenate([f["iden"], expr], -1).astype(np.float32)),
            torch.from_numpy(np.concatenate([f["text"], f["illu"]], -1).astype(np.float32)))


@torch.no_grad()
def opacity(model: HeadNeRF, codes, stride: int) -> float:
    cfg = model.cfg
    S = cfg.featmap_size
    xy = ray_grid(S)[0].reshape(1, S, S, 2)[:, ::stride, ::stride].reshape(1, -1, 2)
    cam = base_cam(S)
    rays = gen_rays(*(torch.as_tensor(a, dtype=torch.float32) for a in
                      (xy, cam.Rmat, cam.Tvec, cam.inv_inmat)))
    sp = sample_points(rays, stratified_zvals(rays, cfg.num_sample_coarse, cfg.world_z1,
                                              cfg.world_z2, None))
    comp = model._plain_composite(model.fg_CD_predictor, sp, *codes,
                                  torch.zeros(1, cfg.audio_style_dims))
    return 1.0 - float(comp.bg_alpha.mean())


def jax_init(cfg):
    """The JAX HeadNeRF's init, jitted once: key -> numpy variables."""
    m = JHeadNeRF(cfg)
    S = cfg.featmap_size
    cam = base_cam(S)
    xy = jnp.asarray(ray_grid(S)[0])

    def init(key):
        return m.init(key, batch_xy=xy, shape_code=jnp.zeros((1, cfg.shape_code_dims)),
                      appea_code=jnp.zeros((1, cfg.appea_code_dims)),
                      audio_style=jnp.zeros((1, cfg.audio_style_dims)),
                      Rmat=jnp.asarray(cam.Rmat), Tvec=jnp.asarray(cam.Tvec),
                      inv_inmat=jnp.asarray(cam.inv_inmat))

    jitted = jax.jit(init)
    return lambda seed: jax.tree_util.tree_map(np.asarray, jitted(jax.random.key(seed)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--stride", type=int, default=4, help="every stride-th ray of the grid")
    args = ap.parse_args(argv)
    cfg = reso64()
    codes = subject_codes(cfg)
    init = jax_init(jreso64())
    out = {"port": [], "jax": []}
    for seed in range(args.seeds):
        port = HeadNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        out["port"].append(opacity(port, codes, args.stride))
        bridge.load_into(port, bridge.headnerf_state_dict(init(seed)))
        out["jax"].append(opacity(port, codes, args.stride))
        print(f"seed {seed}: port {out['port'][-1]:.4f}, jax {out['jax'][-1]:.4f}", flush=True)
    q = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
    rec = {"seeds": args.seeds, "rays": (cfg.featmap_size // args.stride) ** 2,
           "opacity_by_seed": out,
           "quantiles": {k: dict(zip(map(str, q), np.quantile(v, q).tolist()))
                         for k, v in out.items()},
           "below_0.1": {k: int(np.sum(np.asarray(v) < 0.1)) for k, v in out.items()}}
    # two-sample Kolmogorov-Smirnov: the largest gap between the two
    # empirical distributions, beside its 5 % critical value
    grid = np.sort(np.concatenate([out["port"], out["jax"]]))
    cdf = [np.searchsorted(np.sort(v), grid, side="right") / len(v) for v in out.values()]
    rec["ks"] = {"D": float(np.abs(cdf[0] - cdf[1]).max()),
                 "critical_5pct": 1.358 * float(np.sqrt(2.0 / args.seeds))}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
