#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. build   — compile every CUDA kernel of the serving path from the
               sources in the checkout (`nvcc`);
  2. kernels — call each kernel's wrapper on the card at the shapes the
               serving path gives it (Reso64, chunk 4), hold it against its
               plain PyTorch version on the same inputs, and time both with
               CUDA events;
  3. serving — drive `cli animate` at Reso64 (featmap 64, image 512, chunk
               4) on a wav synthesized from the seed, with seeded weights;
               count kernel launches, check the frames, and hold the first
               chunk against the plain (kernel-free) render path;
  4. records — a per-stage time breakdown of one chunk, the `kernels`
               line, the card's name and power limit, and last the
               `{"ok": true, "device": ...}` line.
Without CUDA it exits 1 before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import wave

# published dense peaks of one H100 SXM (NVIDIA data sheet), used for bounds
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# bf16 tolerance of a kernel against its plain version: max abs error over
# each output's own max|ref|. Both round operands and activations to bf16 at
# the same places; a different f32 summation order can flip a bf16 rounding
# (2^-8 relative) that then propagates through the later layers, which puts
# the error near 5e-4 of the magnitude. A wrong strip, bias or composite
# step is off by the size of a typical element (mean|ref| is printed beside)
KERNEL_RTOL = 5e-3
# image tolerance of the fused render against the plain render path (which
# rounds each matmul output to bf16 before its bias, where the kernel keeps
# f32): max and mean absolute difference of frames in [0, 1]
FRAME_MAX_ABS = 5e-2
FRAME_MEAN_ABS = 5e-3

KERNELS = ("fused_render_fwd",)
FRAMES = 8   # served at Reso64 in chunks of 4: two K1 launches


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_build():
    from nerf3dtalker_tpu_torch.ops.kernels import build

    nvcc = build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    records = [build.build(name) for name in KERNELS]
    secs = time.perf_counter() - t0
    for r in records:
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        log(f"build {r['name']}: {r['seconds']:.1f} s; " + " | ".join(ptxas))
    log(f"build: {len(records)} kernel(s) in {secs:.1f} s with {version}")
    return {"nvcc": version, "build_s": secs}


def fused_render_inputs(seed: int, B: int = 4):
    """Reso64 kernel inputs made by the port's own functions."""
    import torch

    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf3dtalker_tpu_torch.ops.embedding import positional_encoding_rays
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.rays import gen_rays, sample_points, stratified_zvals
    from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

    cfg = reso64()
    dev = torch.device("cuda")
    S = cfg.featmap_size
    xy, _ = ray_grid(S)
    cam = base_cam(S)

    def t(a, *reps):
        import numpy as np

        return torch.as_tensor(np.tile(a, reps), device=dev)

    rays = gen_rays(t(xy, B, 1, 1), t(cam.Rmat, B, 1, 1), t(cam.Tvec, B, 1),
                    t(cam.inv_inmat, B, 1, 1))
    zb = stratified_zvals(rays, cfg.num_sample_coarse, cfg.world_z1, cfg.world_z2)
    sp = sample_points(rays, zb)
    pe = positional_encoding_rays(rays.origins, rays.directions, rays.lengths, sp.zvals,
                                  cfg.vp_n_freqs, cfg.vp_include_input,
                                  pad_to=fr.pe_pad_for(cfg.vp_pe_dims)).contiguous()
    g = torch.Generator().manual_seed(seed)
    mlp = NeRFMLP(cfg.vp_channels, cfg.vd_channels, cfg.audio_style_dims,
                  hidden=cfg.mlp_hidden, out_features=cfg.featmap_nc)
    mlp.reset_parameters(g)
    with torch.no_grad():   # nonzero biases (the init's are zero), so each is checked
        for name, p in mlp.named_parameters():
            if name.endswith("_bias"):
                p.normal_(0.0, 0.1, generator=g)
    codes = [(torch.randn(B, n, generator=g) * 0.3).to(dev)
             for n in (cfg.shape_code_dims, cfg.appea_code_dims, cfg.audio_style_dims)]
    with torch.no_grad():
        packed = fr.pack_weights({k: v.to(dev) for k, v in mlp.named_parameters()}, *codes)
    # the kernel's operand types, so the timed wrapper casts nothing
    packed = {k: (v.to(torch.bfloat16) if k.startswith("w") else v.float()).contiguous()
              for k, v in packed.items()}
    return pe, sp.z_dists.contiguous(), sp.zvals.contiguous(), packed


def phase_kernels(seed: int):
    import torch

    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    pe, zd, zv, packed = fused_render_inputs(seed)
    B, R, ns, pe_pad = pe.shape
    with torch.no_grad():
        out = fr.fused_render_fwd(pe, zd, zv, packed)
        ref = fr.reference_render(pe, zd, zv, packed, torch.bfloat16)
    torch.cuda.synchronize()
    max_abs = 0.0
    for name, a, b in zip(("feat", "bg_alpha", "depth"), out, ref):
        if not torch.isfinite(a).all():
            raise AssertionError(f"fused_render_fwd: non-finite {name}")
        err = float((a - b).abs().max())
        peak, mean = float(b.abs().max()), float(b.abs().mean())
        tol = KERNEL_RTOL * peak
        log(f"fused_render_fwd {name}: max_abs_err {err:.3e}, tolerance {tol:.3e} "
            f"({KERNEL_RTOL:.0e} of max|ref| {peak:.3e}); mean|ref| {mean:.3e}")
        if not err <= tol:
            raise AssertionError(f"fused_render_fwd {name} disagrees with its plain version")
        max_abs = max(max_abs, err)

    with torch.no_grad():
        ms = cuda_ms(lambda: fr.fused_render_fwd(pe, zd, zv, packed), reps=10)
        plain_ms = cuda_ms(lambda: fr.reference_render(pe, zd, zv, packed, torch.bfloat16),
                           reps=10, warmup=1)
    w = packed
    macs = (w["w0p"].numel() + w["wh"].numel() + w["w5p"].numel() + w["w5x"].numel()
            + w["wd"].numel() + w["wr0"].numel() + w["wr1"].numel() + w["wr2"].numel())
    flops = 2.0 * B * R * ns * macs
    nbytes = sum(t.numel() * t.element_size() for t in (pe, zd, zv, *w.values()))
    nbytes += sum(t.numel() * t.element_size() for t in out)
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    log(f"fused_render_fwd B={B} R={R}: {ms:.3f} ms (plain {plain_ms:.3f} ms); "
        f"{flops / 1e12:.4f} TFLOP, {nbytes / 1e6:.1f} MB -> bound {bound_ms:.3f} ms "
        f"by {bound_by}; {flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"name": "fused_render_fwd", "route": "cuda",
            "source": "nerf3dtalker_tpu_torch/csrc/fused_render_fwd.cu",
            "replaces": "nerf3dtalker_tpu/ops/pallas/fused_render.py:151",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}  # no single PyTorch call computes MLP + composite


def write_wav(path: str, seed: int, frames: int, sr: int = 16000, fps: int = 25) -> None:
    """A seeded speech-like tone: `frames` video frames of audio (+100
    samples so the frame count does not hang on float rounding)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = frames * sr // fps + 100
    t = np.arange(n) / sr
    f0 = 120 + 40 * rng.random()
    pcm = (0.4 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
           + 0.02 * rng.standard_normal(n))
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())


def phase_serving(seed: int, frames: int, workdir: str):
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
    from nerf3dtalker_tpu_torch.utils.camera import base_cam

    chunk = 4
    wav = os.path.join(workdir, "speech.wav")
    out = os.path.join(workdir, "frames.npy")
    write_wav(wav, seed, frames)
    argv = ["animate", "--wav", wav, "--featmap-size", "64", "--img-size", "512",
            "--chunk", str(chunk), "--seed", str(seed), "--out", out]
    cli.main(argv + ["--max-frames", str(chunk)])      # warm-up: one chunk

    fr.fused_render_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fr.fused_render_fwd.launches
    expect = -(-frames // chunk)
    log(f"serving: {rec['frames']} frames, wall {wall * 1e3 / rec['frames']:.2f} ms/frame "
        f"(whole cli call: wav, mels, model build, audio, render, .npy), "
        f"fused_render_fwd launches {launches} (expected {expect})")
    if rec["frames"] != frames or launches != expect:
        raise AssertionError(f"serving ran {rec['frames']} frames with {launches} launches")
    img = np.load(out)
    if img.shape != (frames, 512, 512, 3) or not np.isfinite(img).all() \
            or img.min() < 0 or img.max() > 1:
        raise AssertionError(f"bad frames: shape {img.shape}, range [{img.min()}, {img.max()}]")

    # the first chunk again through the plain (kernel-free) render path
    dev = torch.device("cuda")
    model, a2s = cli.build_models(reso64(), seed, dev)
    mels = per_frame_mel_chunks(*read_wav_mono(wav))
    styles = styles_from_mels(a2s, mels)
    cam = base_cam(64)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    model.use_fused = False
    plain = animate_sequence(model, np.zeros((1, 179), np.float32),
                             np.zeros((1, 127), np.float32), styles[:chunk], cam_d, chunk)
    diff = np.abs(plain - img[:chunk])
    log(f"serving vs plain render path, first chunk: max_abs {diff.max():.3e} "
        f"(tolerance {FRAME_MAX_ABS:.0e}), mean_abs {diff.mean():.3e} "
        f"(tolerance {FRAME_MEAN_ABS:.0e}); frame mean {img.mean():.4f}")
    if diff.max() > FRAME_MAX_ABS or diff.mean() > FRAME_MEAN_ABS:
        raise AssertionError("fused serving path disagrees with the plain render path")
    return launches, wall * 1e3 / frames


def phase_breakdown(seed: int):
    """CUDA-event times of each stage of one Reso64 chunk (B=4)."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.ops.embedding import positional_encoding_rays
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.rays import gen_rays, sample_points, stratified_zvals
    from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

    cfg = reso64()
    dev = torch.device("cuda")
    model, a2s = cli.build_models(cfg, seed, dev)
    B = 4
    xy, _ = ray_grid(64)
    cam = base_cam(64)

    def t(a, *reps):
        return torch.as_tensor(np.tile(a, reps), device=dev)

    xy_b, Rm, Tv, iv = (t(xy, B, 1, 1), t(cam.Rmat, B, 1, 1), t(cam.Tvec, B, 1),
                        t(cam.inv_inmat, B, 1, 1))
    codes = [torch.zeros(B, n, device=dev) for n in (179, 127)] + [torch.zeros(B, 64, device=dev)]
    mels = torch.randn(8, 80, 16, generator=torch.Generator().manual_seed(seed)).to(dev)
    st = {}
    with torch.no_grad():
        def rays_pe():
            rays = gen_rays(xy_b, Rm, Tv, iv)
            sp = sample_points(rays, stratified_zvals(rays, 64, cfg.world_z1, cfg.world_z2))
            pe = positional_encoding_rays(rays.origins, rays.directions, rays.lengths,
                                          sp.zvals, 10, True, pad_to=64)
            st["in"] = (pe.contiguous(), sp.z_dists.contiguous(), sp.zvals.contiguous())

        def pack():
            st["w"] = fr.pack_weights(dict(model.fg_CD_predictor.named_parameters()), *codes)

        def kernel():
            st["out"] = fr.fused_render_fwd(*st["in"], st["w"])

        def decoder():
            feat, bg_alpha, _ = st["out"]
            merge = (feat.reshape(B, 64, 64, 256) + bg_alpha.reshape(B, 64, 64, 1)
                     * model.neural_render.bg_featmap)
            model.neural_render(merge)
            model.neural_render(model.neural_render.bg_featmap)

        def chunk():
            model(xy_b, codes[0], codes[1], codes[2], Rm, Tv, iv)

        times = {name: cuda_ms(fn, reps=5) for name, fn in
                 (("rays_pe", rays_pe), ("pack_weights", pack), ("fused_render_fwd", kernel),
                  ("decoder_x2", decoder), ("chunk_total", chunk),
                  ("audio2style_8_frames", lambda: a2s(mels)))}
    log("breakdown " + json.dumps({"chunk": B, "ms": times}))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import nerf3dtalker_tpu_torch  # noqa: F401  (fails outside a checkout)

    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    log(json.dumps({"env": {"torch": torch.__version__, "cuda": torch.version.cuda,
                            "triton": triton_version, "python": sys.version.split()[0]}}))
    workdir = os.path.join(root, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)

    build_info = phase_build()
    kernel = phase_kernels(args.seed)
    launches, ms_per_frame = phase_serving(args.seed, FRAMES, workdir)
    kernel["launches"] = launches
    phase_breakdown(args.seed)
    log(json.dumps({"serving": {"frames": FRAMES, "ms_per_frame": ms_per_frame,
                                "build_s": build_info["build_s"], "nvcc": build_info["nvcc"]}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(json.dumps({"kernels": [kernel]}))
    log(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
