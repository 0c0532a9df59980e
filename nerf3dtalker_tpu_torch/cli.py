"""Command-line entry points of the port (counterpart of
`nerf3dtalker_tpu/cli.py`): `python -m nerf3dtalker_tpu_torch.cli <command>`.

  animate — wav -> per-frame mel chunks -> Audio2Style -> chunked HeadNeRF
            render -> frames saved as .npy

Runs on `cuda` unless `--device cpu` is given. On the GPU the model
computes in bf16 through the fused render kernel; on the CPU in f32 through
the plain path, as the JAX CLI does off the TPU.
"""

from __future__ import annotations

import argparse
import json


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


def build_models(cfg, seed: int, device, params: str = ""):
    """The serving models on `device`: HeadNeRF in bf16 through the fused
    kernel on the GPU (f32, plain path on the CPU) and Audio2Style. Weights
    come from `params`, the `/`-joined .npz of `{"nerf": ..., "audio": ...}`
    flax variables that `save_pytree_npz` writes; without it they are
    initialized from `seed` (NeRF) and 1 (audio), as the JAX CLI does."""
    import torch

    from nerf3dtalker_tpu_torch.models.audio import Audio2Style
    from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
    from nerf3dtalker_tpu_torch.utils import bridge

    on_gpu = device.type == "cuda"
    model = HeadNeRF(cfg, compute_dtype=torch.bfloat16 if on_gpu else torch.float32,
                     use_fused=on_gpu, device=device,
                     generator=torch.Generator().manual_seed(seed))
    a2s = Audio2Style(device=device, generator=torch.Generator().manual_seed(1))
    if params:
        tree = bridge.load_npz_tree(params)
        if set(tree) != {"nerf", "audio"}:
            raise ValueError(f"{params}: top-level keys must be nerf and audio, "
                             f"got {sorted(tree)}")
        bridge.load_into(model, bridge.headnerf_state_dict(tree["nerf"]))
        bridge.load_into(a2s, bridge.audio2style_state_dict(tree["audio"]))
    return model.eval(), a2s.eval()


def cmd_animate(args) -> dict:
    import numpy as np

    from nerf3dtalker_tpu_torch.config import NeRFConfig
    from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
    from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
    from nerf3dtalker_tpu_torch.utils.camera import base_cam
    from nerf3dtalker_tpu_torch.utils.device import resolve_device

    out = args.out or "talking_head.npy"
    if not out.endswith(".npy"):
        raise SystemExit("--out must be a .npy file (mp4 muxing is not ported yet)")
    dev = resolve_device(args.device)
    pcm, sr = read_wav_mono(args.wav)
    mels = per_frame_mel_chunks(pcm, sr=sr, fps=args.fps)
    if args.max_frames:
        mels = mels[: args.max_frames]
    T = len(mels)

    cfg = NeRFConfig(featmap_size=args.featmap_size, pred_img_size=args.img_size)
    model, a2s = build_models(cfg, args.seed, dev, args.params)
    shape = np.zeros((1, cfg.shape_code_dims), np.float32)
    appea = np.zeros((1, cfg.appea_code_dims), np.float32)
    if args.latents:
        shape, appea = _codes_from_latents(args.latents)
    cam = base_cam(cfg.featmap_size)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}

    styles = styles_from_mels(a2s, mels)
    frames = animate_sequence(model, shape, appea, styles, cam_d, chunk=args.chunk)
    np.save(out, frames)
    rec = {"frames": T, "size": list(frames.shape[1:3]), "device": str(dev), "out": out}
    print(json.dumps(rec))
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(prog="nerf3dtalker_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("animate", help="wav -> talking-head frames (.npy)")
    pa.add_argument("--featmap-size", type=int, default=32)
    pa.add_argument("--img-size", type=int, default=256)
    pa.add_argument("--seed", type=int, default=0,
                    help="seed of the NeRF weights when --params gives none")
    pa.add_argument("--wav", required=True)
    pa.add_argument("--latents", help="fitted.npz from `fit`")
    pa.add_argument("--params", help="flax variables as a '/'-joined .npz "
                    "(keys nerf/params/... and audio/params/...)")
    pa.add_argument("--fps", type=int, default=25)
    pa.add_argument("--chunk", type=int, default=4)
    pa.add_argument("--max-frames", type=int, default=0)
    pa.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pa.add_argument("--out", help="frames [T, H, W, 3] in [0, 1] as .npy")
    pa.set_defaults(fn=cmd_animate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
