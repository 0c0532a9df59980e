#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. build    — compile every CUDA kernel from the sources in the checkout,
                one `nvcc` each, all at once;
  2. kernels  — call each kernel's wrapper on the card at the shapes its
                main path gives it (K1 at the Reso64 serving chunk, B=4,
                with its design's numbers and its time at the K4 shard;
                K2 at the Reso64 training batch, B=2, both input_grads
                variants; K5-fwd at each of the three Reso64 decoder blocks
                for the serving merge pass B=4, the training merge pass B=2
                and the bg pass B=1; K5-bwd at each block for B=2 and B=1),
                hold it against its plain PyTorch version on the same
                inputs, and time both with CUDA events (K2's launches, the
                ray kernel and the X^T G core's two, and K5-bwd's four
                apart with torch.profiler; K5-fwd's device time and design
                numbers per block);
  3. serving  — drive `cli animate` at Reso64 (featmap 64, image 512, chunk
                4) on a wav synthesized from the seed, with seeded weights;
                count kernel launches, check the frames, and hold the first
                chunk against the plain (kernel-free) render path;
  4. training — drive `cli train` at Reso64 (B=2, VGG loss with its seeded
                init, synthetic dataset) for a few steps: count K1 and K2
                launches per train step and per validation render, require
                finite losses, every step finite and every parameter moved;
                hold one deterministic train step through the kernels
                against the plain (kernel-free, autograd) path; time the
                steady-state step (ms/step, rays/s) and its parts, and
                profile 3 steps (device time by kernel, idle share);
                The trainer's steps replay one CUDA graph of the step
                (`Trainer.train_epoch_group`): each replay counts one K1
                and one K2, and the two warm-up steps before the capture
                are counted apart (here and in 4b and 4g);
  4a. epoch_program — whole epochs as replays of that graph at Reso64 (16
                `coherent_subject` frames, B=2, VGG on, seeded weights): a
                graph epoch against an eager epoch from the same state and
                seeds (per-epoch losses, every leaf's change) and the
                graph's generator draws against eager ones; one K1 and one
                K2 a replayed step by the counters and by torch.profiler;
                ms/step and the device's idle share both ways, the
                capture's seconds and its pool's bytes; a rollback mid-run
                (the state restored in place, the next group against an
                eager epoch from the checkpoint); a native-prefetch epoch
                with the device cache off (each batch equal to the host
                loader's); `cli train --trace-dir --trace-steps 3` (K1 and
                K2 in the trace) and `--tensorboard` (an event file, or the
                clear error without the package);
  4b. subject — train the learnable `coherent_subject` at Reso64 (40 train,
                8 val, 8 train-eval frames, B=2, VGG on, lr 2e-4, rollback
                guard) for 10 epochs with validation every 5, through K1/K2:
                every loss finite, the final TRAIN_PSNR at least 3 dB above
                the untrained model's on the same frames, one K1 and one K2 a
                step and one K1 a validation frame; then `cli animate --ckpt`
                serves the trained checkpoint (unsharp enhancer, .mp4 with
                the wav, or the PNG fallback) and its frames equal
                `animate_sequence` on the trainer's own model;
  4c. fit    — the subject trained again as in 4b at TrainConfig seed
                --seed + 1 (at seed 0 its NeRF goes transparent, which 4b
                records as its opacity, and a transparent NeRF gives a fit
                no gradient); its checkpoint fitted to one image (`cli
                fit`): its own val frame 0 rendered with that frame's codes
                at a known camera offset, iden then off by 0.1 in the base
                codes; first one iteration's gradients on each FitVar
                through K1/K2 (K2 with input gradients) against the plain
                path, and K2's input gradients against its plain version,
                carried to the camera; then 300 iterations on the card
                (iters + 1 K1 and iters K2 launches, each K2 with input
                gradients, no K5; the head loss must fall; ms an iteration;
                K1 and K2 at B=1, K2's launches apart, 10 iterations
                profiled: device time, idle share); then `cli render` orbits
                the fitted subject (45 views, one K1 each) and `cli animate
                --latents` serves it (frames equal `animate_sequence` with
                the fitted codes);
  4d. vq     — the Standardized Space stage 1 at full width (VQConfig
                defaults, B=4, 112^2 crops): 4c's subject renders its 40
                train and 8 val frames through K1, which the port's
                `build_vq_data` turns into 256^2 frames, crops and AU labels;
                one step on the card against the same weights and batch on
                the CPU (loss, code indices, recon, every gradient leaf);
                200 steps on the card (finite metrics, rec_loss falling;
                ms/step by CUDA events, 10 steps profiled: device time, idle
                share); `reconstruct_split` of the val frames (ms/frame);
                then `cli train-vq` (1 epoch, a checkpoint) and `cli eval-vq
                --ckpt` (one PNG a frame, metrics equal to
                `reconstruct_split` in process on that checkpoint);
  4e. stage2 — the Standardized Space stage 2 over 4d's `cli train-vq`
                checkpoint, the subject's renders as motion frames, on a
                seeded wav: wav2vec2-base (seeded) on the card against the
                CPU; one CodeTalker step (4 frames) on the card against the
                CPU (loss, code indices, every gradient leaf); 50 steps on an
                8-frame clip (the loss falls; ms/step by CUDA events, 5 steps
                profiled: device time, idle share); `predict` of 16 frames
                (ms a frame); `cli infer-stage2` with the encoder as a local
                HF directory, the VQ and the stage-2 checkpoints, equal to the
                in-process predict; LVE / FDD;
  4f. coeff  — SadTalker's audio -> expression path: a seeded netG written as
                a SadTalker safetensors file; `cli infer-coeff` from a wav and
                from --text, equal to the in-process Audio2Coeff, and the card
                against the CPU; one audio2exp and one disexp step on the card
                against the CPU; the expressions driving 4c's fitted subject
                through `animate_sequence(expr_seq=...)` (K1 launches
                counted);
  4g. preprocess — subject preprocessing: BiSeNet at 512^2 (B=2), FAN
                with 1 and 4 stacks at 256^2 and ReconNet at 224^2 on the card
                against the CPU (f32, TF32 off, the same seeded weights), and
                render_nl3dmm at the 7x7 mesh, 512^2, B=4 (winners, image,
                gradients to the codes and the camera); `cli preprocess
                --strict --featmap-size 64` of 16 frames of 512^2 and a
                seeded wav (BiSeNet, FAN, the NL3DMM fit at (10, 20)
                iterations, netG), equal to preprocess_subject in process
                (each stage timed; the fit's loss falls); `cli train --data`
                on its .npz for one epoch (K1 and K2 launches counted); the
                full-size rasterizer (render_nl3dmm forward and backward on a
                186 x 186 grid, 68,450 faces, B=1, 512^2: ms and peak
                bytes); at most PREP_LIMIT_S seconds;
  5. fused upsampler — serve 8 Reso64 frames through `animate_sequence`
                with `HeadNeRF(use_fused=True, use_fused_upsampler=True)`
                (K1 and K5-fwd launches counted, frames held against the
                plain render path); one Reso64 B=2 gradient of the merge +
                bg MSE loss through K1/K2/K5-fwd/K5-bwd (launches counted)
                against the plain autograd path, every parameter leaf;
  6. probe    — the xᵀ·g probe kernel in its four operand modes at the
                probe's shapes against their plain versions, timed per call
                eagerly and from a CUDA graph beside `torch.matmul` of the
                same bf16 product (and `torch.mm(..., out_dtype=f32)`);
  7. mesh     — `cli train --data-parallel 2 --ray-parallel 2` at Reso64
                (B=2, VGG on, one epoch of the synthetic dataset): 4 ranks
                sharing the one card over gloo, K1 and K2 launches counted on
                every rank, params identical on every rank, one checkpoint;
                one deterministic step on 2 x 2, 1 x 2 and 2 x 1 meshes
                through K4 against the single-rank step through K3; a 1 x 1
                mesh on NCCL: its step against the single-rank step (the
                mesh path's own overhead) and K4 at the 2 x 2 shard shape
                [1, 2048] against its plain version, timed;
  8. records  — a per-stage time breakdown of one serving chunk (the
                plain and the fused decoder pair side by side), the
                `kernels` line, the card's name and power limit, and last
                the `{"ok": true, "device": ...}` line.
Without CUDA it exits 1 before printing any result. A watchdog ends the run
with a traceback and exit code 1 after TIME_LIMIT_S seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import math
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

# K2 against its plain version. Both recompute the forward with f32 sums in
# another order; a pre-activation within rounding of 0 then lands on the
# other side of a ReLU, and a flipped mask passes or stops a whole gradient
# element for every lower layer of that point. Summed over the points, each
# weight and bias gradient stays within BWD_RTOL of its own max|ref| (the
# card test at R=64, with fewer points to average over, saw 1.3e-2 on w0p);
# d_zd and d_zv come from the composite alone. d_pe is per point: one flip
# can move a point's d_pe by its own size, so it is held by relative L2
# error. That the chain itself is right is checked apart, at the same shape:
# every gradient activation, d_pe and three weight/bias gradients that the
# kernel wrote, against PyTorch recomputing them from the kernel's own stash
# (the same bf16 values in, so only f32 summation order differs and a bf16
# rounding flip moves an element by 2^-8 of itself): STASH_REL_L2
BWD_RTOL = 2e-2
D_PE_REL_L2 = 5e-2
STASH_REL_L2 = 1e-3
# one deterministic train step through the kernels against the plain path
# (bf16 too, but rounding each matmul output to bf16 before its bias, where
# the kernels keep f32): relative error of the total loss, and relative L2
# error of every gradient leaf, which also carries the ReLU mask flips above
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_REL_L2 = 3e-2

# K5 (the fused upsampler kernels) against their plain versions, bf16; the
# card tests (tests/test_torch_cuda.py) give each bound's reasoning. Both
# round at the same places, so a different f32 summation order flips at
# most a bf16 rounding (2^-8 of an element), which later layers carry:
# outputs within UPS_RTOL of their own max|ref|. Backward: a pre-activation
# within rounding of 0 can land on the other side of a leaky ReLU and scale
# a gradient element by 0.2 instead of 1; in a weight gradient one such
# flip moves one column by 0.8 |h g| (2.5e-2 of max|ref| at 3,072 pixels,
# 1.0e-2 at 64x64 B=2), so weight and bias gradients are held by max error
# over max|ref| (UPS_BWD_RTOL) and by relative L2 (UPS_BWD_REL_L2), the
# per-pixel g_net by relative L2; g_rgb, from the linear stencils alone in
# the same f32 order on both sides, within UPS_GRGB_RTOL
UPS_RTOL = 1e-2
UPS_BWD_RTOL = 5e-2
UPS_BWD_REL_L2 = 1e-2
UPS_GNET_REL_L2 = 2e-2
UPS_GRGB_RTOL = 1e-5
# the xᵀ·g probe against its plain version, each over max|ref|: `loaded`
# multiplies the same bf16 values in f32 in another order; the other modes
# first form x' = bf16(relu(x·w)), where another f32 summation order can
# round an element to the neighbouring bf16 value (2^-8 of itself) or, at
# the ReLU's edge, to 0
PROBE_RTOL = {"loaded": 1e-5, "computed": 2e-3, "scratch": 2e-3, "f32": 2e-3}
# one Reso64 B=2 gradient through K1/K2/K5 against the plain autograd path
# (the NeRFMLP + composite and the NeuralRenderer decoder, which round each
# product to bf16 before its bias where the kernels keep f32): the loss
# within STEP_LOSS_RTOL, every gradient leaf within UPS_GRAD_REL_L2
# relative L2 (the ReLU flips of K2 and the leaky-ReLU flips of K5 reach
# every leaf)
UPS_GRAD_REL_L2 = 3e-2

KERNELS = ("fused_render_fwd", "fused_render_bwd", "fused_upsampler_fwd", "fused_upsampler_bwd",
           "probe_xtg")
# K2's kernels, by the names the profiler gives them
K2_PARTS = ("ray_kernel", "xtg_jobs_kernel", "xtg_reduce")
# the whole run's time limit: about twice the smoke's longest command time
# on the H100 so far (181-215 s). A kernel that never ends, or a rank that
# waits forever, then ends the run with every thread's traceback and exit
# code 1
TIME_LIMIT_S = 450
FRAMES = 8   # served at Reso64 in chunks of 4: two K1 launches
DEVICE = "cuda"        # of the training phases
TRAIN_EPOCHS = 2        # cli train at Reso64: 8 synthetic frames, B=2 -> 4 steps an epoch,
TRAIN_FRAMES = 8        # and 2 validation frames rendered one at a time after each epoch
VAL_FRAMES = 2
# the subject phase: coherent_subject at Reso64, B=2 -> 20 steps an epoch;
# validation (8 val + 8 train-eval frames) after epochs 4 and 9
SUBJECT_FRAMES, SUBJECT_VAL_FRAMES = 40, 8
SUBJECT_EPOCHS, SUBJECT_VAL_EVERY = 10, 5
# what 200 steps must gain on the train-eval frames over the untrained
# model (the JAX run gained ~11 dB by then: TRAIN_r05.json, epoch 9)
SUBJECT_GAIN_DB = 3.0


def log(msg: str) -> None:
    print(msg, flush=True)


def train_config():
    """The configuration the training phases drive: Reso64 at full width."""
    from nerf3dtalker_tpu_torch.config import reso64

    return reso64()


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


def cuda_ms_per_call(fn, calls: int = 200, reps: int = 5) -> float:
    """Median over `reps` of the CUDA-event time of `calls` back-to-back
    calls of fn(), divided by `calls`: for launches shorter than a launch's
    own overhead."""
    return cuda_ms(lambda: [fn() for _ in range(calls)], reps=reps) / calls


@contextlib.contextmanager
def trainers_built():
    """The Trainers built inside the block (a `cli train` call's), each
    with its own launch counts (`Trainer.kernel_launches`: the train steps,
    the steps before its CUDA graph's capture, validation)."""
    from nerf3dtalker_tpu_torch.train.trainer import Trainer

    made, init = [], Trainer.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    Trainer.__init__ = record
    try:
        yield made
    finally:
        Trainer.__init__ = init


def trainer_launches(trainers, captures: int = 1):
    """[K1, K2] by path over `trainers`, and whether each trainer captured
    `captures` CUDA graphs of one K1 and one K2 each."""
    from nerf3dtalker_tpu_torch.train.trainer import GRAPH_WARMUP_STEPS

    by_path = {"train_steps": [0, 0], "graph_warmup": [0, 0], "validation": [0, 0]}
    graphs_ok = True
    for t in trainers:
        for path, counts in t.kernel_launches.items():
            by_path[path] = [a + b for a, b in zip(by_path[path], counts)]
        graphs_ok &= len(t.graph_records) == captures and all(
            g["launches"] == {"fused_render_fwd": 1, "fused_render_bwd": 1, "input_grads": 0}
            for g in t.graph_records)
        graphs_ok &= t.kernel_launches["graph_warmup"] == [GRAPH_WARMUP_STEPS * captures] * 2
    return by_path, graphs_ok


def phase_build():
    from nerf3dtalker_tpu_torch.ops.kernels import build

    nvcc = build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    records = build.build_all(KERNELS)
    secs = time.perf_counter() - t0
    ptxas = {}
    for r in records:
        ptxas[r["name"]] = [ln.strip() for ln in r["log"].splitlines()
                            if "registers" in ln or "spill" in ln or "smem" in ln
                            or "entry function" in ln]
        log(f"build {r['name']}: {r['seconds']:.1f} s; " + " | ".join(
            ln for ln in ptxas[r["name"]] if "entry function" not in ln))
    log(f"build: {len(records)} kernel(s) in {secs:.1f} s (concurrently) with {version}")
    return {"nvcc": version, "build_s": secs, "ptxas": ptxas}


def ptxas_count(lines, pattern: str):
    """The first integer that `pattern` (a regex with one group) finds in
    the compiler's lines, or None (a kernel loaded from an earlier build)."""
    import re

    for ln in lines:
        m = re.search(pattern, ln)
        if m:
            return int(m.group(1))
    return None


def ptxas_by_entry(lines, key: str):
    """(registers, spill-store bytes) of the first kernel whose mangled
    name holds `key`, from the compiler's lines (an entry's "Compiling entry
    function" line comes before its spill and register lines); (None, None)
    for a kernel loaded from an earlier build."""
    import re

    regs = spill = None
    inside = False
    for ln in lines:
        if "entry function" in ln:
            if inside and regs is not None:
                break
            inside = key in ln
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            regs = int(m.group(1))
    return regs, spill


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations at the bf16 peak
    and the bytes at the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def base_camera(B: int):
    """(xy, Rmat, Tvec, inv_inmat) of B Reso64 frames at the base camera,
    on the card."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

    xy, _ = ray_grid(64)
    cam = base_cam(64)

    def t(a, *reps):
        return torch.as_tensor(np.tile(a, reps), device="cuda")

    return t(xy, B, 1, 1), t(cam.Rmat, B, 1, 1), t(cam.Tvec, B, 1), t(cam.inv_inmat, B, 1, 1)


def rays_and_pe(xy, Rmat, Tvec, inv_inmat, noise=None):
    """(pe, z_dists, zvals) of Reso64 rays, made by the port's own functions
    as HeadNeRF makes them, stratified with `noise` [B, R, 65] if given."""
    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.ops.embedding import positional_encoding_rays
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.rays import gen_rays, sample_points, stratified_zvals

    cfg = reso64()
    rays = gen_rays(xy, Rmat, Tvec, inv_inmat)
    zb = stratified_zvals(rays, cfg.num_sample_coarse, cfg.world_z1, cfg.world_z2, noise)
    sp = sample_points(rays, zb)
    pe = positional_encoding_rays(rays.origins, rays.directions, rays.lengths, sp.zvals,
                                  cfg.vp_n_freqs, cfg.vp_include_input,
                                  pad_to=fr.pe_pad_for(cfg.vp_pe_dims))
    return pe.contiguous(), sp.z_dists.contiguous(), sp.zvals.contiguous()


def fused_render_inputs(seed: int, B: int = 4):
    """Reso64 kernel inputs made by the port's own functions, with a seeded
    MLP whose biases are nonzero and seeded codes."""
    import torch

    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    cfg = reso64()
    dev = torch.device("cuda")
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
    return (*rays_and_pe(*base_camera(B)), packed)


def phase_kernels(seed: int, ptxas_lines):
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
    flops = 2.0 * B * R * ns * mlp_macs(packed)
    nbytes = tensor_bytes(pe, zd, zv, *packed.values(), *out)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"fused_render_fwd B={B} R={R}: {ms:.3f} ms (plain {plain_ms:.3f} ms); "
        f"{flops / 1e12:.4f} TFLOP, {nbytes / 1e6:.1f} MB -> bound {bound_ms:.3f} ms "
        f"by {bound_by}; {flops / ms / 1e9:.1f} TFLOP/s achieved")

    # what the design does: the weight stream a launch reads from L2 as the
    # design computes it (once per block's pair of rays; no cluster shares
    # it; not a measured count), the ring, the compiler's registers, and K1
    # at the K4 shard [1, 2048]
    design = fr.fused_render_fwd_design()
    sharing = design["rays_per_block"]
    l2_bytes = -(-B * R // sharing) * design["stream_bytes"]
    regs = ptxas_count(ptxas_lines, r"Used (\d+) registers")
    spill = ptxas_count(ptxas_lines, r"(\d+) bytes spill stores")
    shard = [t[:1, :2048].contiguous() for t in (pe, zd, zv)]
    w_shard = {k: (v[:1].contiguous() if k in ("b0", "b5", "br1") else v)
               for k, v in packed.items()}
    with torch.no_grad():
        ms_shard = cuda_ms(lambda: fr.fused_render_fwd(*shard, w_shard), reps=10)
    log(f"fused_render_fwd design: {design['rays_per_block']} rays a block "
        f"({design['resident_blocks']} resident), cluster size 1, a ring of "
        f"{design['stages']} slots of {design['chunk_rows']}-row chunks; the stream "
        f"{design['chunks']} chunks, {design['stream_bytes']:,} B, read from L2 once per "
        f"{sharing} rays: {l2_bytes / 1e9:.2f} GB a launch at B={B} (design model, not "
        f"measured); {regs} registers a thread, {spill} B spilled, "
        f"{design['smem_bytes']:,} B of shared memory a block")
    log(f"fused_render_fwd at the K4 shard [1, 2048]: {ms_shard:.3f} ms (B={B}: {ms:.3f} ms)")
    return {"name": "fused_render_fwd", "route": "cuda",
            "source": "nerf3dtalker_tpu_torch/csrc/fused_render_fwd.cu",
            "replaces": "nerf3dtalker_tpu/ops/pallas/fused_render.py:151",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,   # no single PyTorch call computes MLP + composite
            "ms_shard_1x2048": ms_shard}


def mlp_macs(packed) -> int:
    """Multiply-adds of the point MLP per point: one per weight."""
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    return sum(packed[k].numel() for k in fr._WEIGHTS)


def phase_kernel_bwd(seed: int):
    """K2 at the Reso64 training shape (B=2, R=4096), both variants."""
    import torch

    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    pe, zd, zv, packed = fused_render_inputs(seed, B=2)
    B, R, ns, _ = pe.shape
    g = torch.Generator().manual_seed(seed + 1)
    gf, gb, gd = (torch.randn(*shape, generator=g).cuda()
                  for shape in ((B, R, fr.FEAT), (B, R), (B, R)))
    max_abs = 0.0
    rec = {}
    scratch = torch.empty(fr.scratch_bytes(B, R), dtype=torch.uint8, device="cuda")
    for input_grads in (False, True):
        with torch.no_grad():
            out = fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd, input_grads=input_grads,
                                      scratch=scratch)
            ref = fr.reference_render_bwd(pe, zd, zv, packed, gf, gb, gd, torch.bfloat16,
                                          input_grads=input_grads)
        torch.cuda.synchronize()
        pairs = [(k, out[3][k], ref[3][k]) for k in fr._WEIGHTS + fr._BIASES]
        if input_grads:
            pairs += [("d_zd", out[1], ref[1]), ("d_zv", out[2], ref[2])]
            rel = float((out[0] - ref[0]).norm() / ref[0].norm())
            log(f"fused_render_bwd input_grads=True d_pe: rel L2 {rel:.3e} (tolerance "
                f"{D_PE_REL_L2:.0e}); max_abs_err {float((out[0] - ref[0]).abs().max()):.3e}, "
                f"max|ref| {float(ref[0].abs().max()):.3e}")
            if not (torch.isfinite(out[0]).all() and rel <= D_PE_REL_L2):
                raise AssertionError("fused_render_bwd d_pe disagrees with its plain version")
            # the chain against PyTorch on the kernel's own stash of this launch
            stash = fr.stash_chain_errors(scratch, packed, out[0], out[3], B, R)
            log(f"fused_render_bwd B={B} R={R} chain from its own stash: rel L2 " + ", ".join(
                f"{k} {v:.2e}" for k, v in stash.items()) + f" (tolerance {STASH_REL_L2:.0e})")
            if not max(stash.values()) <= STASH_REL_L2:
                raise AssertionError("fused_render_bwd disagrees with its own stash")
            rec["stash_worst_rel_l2"] = max(stash.values())
        worst = 0.0
        for name, a, b in pairs:
            if not torch.isfinite(a).all():
                raise AssertionError(f"fused_render_bwd: non-finite {name}")
            err, peak = float((a - b).abs().max()), float(b.abs().max())
            worst = max(worst, err / peak)
            max_abs = max(max_abs, err)
            if not err <= BWD_RTOL * peak:
                raise AssertionError(f"fused_render_bwd {name}: max_abs_err {err:.3e} over "
                                     f"{BWD_RTOL:.0e} of max|ref| {peak:.3e}")
        log(f"fused_render_bwd input_grads={input_grads}: every weight/bias gradient"
            f"{' and d_zd, d_zv' if input_grads else ''} within {worst:.2e} of its own "
            f"max|ref| (tolerance {BWD_RTOL:.0e})")
        with torch.no_grad():
            ms = cuda_ms(lambda: fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd,
                                                     input_grads=input_grads), reps=5)
            plain_ms = cuda_ms(lambda: fr.reference_render_bwd(
                pe, zd, zv, packed, gf, gb, gd, torch.bfloat16, input_grads=input_grads),
                reps=3, warmup=1)
        macs = mlp_macs(packed)
        chain = macs - (0 if input_grads else packed["w0p"].numel() + packed["w5p"].numel())
        flops = 2.0 * B * R * ns * (macs + macs + chain)   # recompute + dW + dX
        outs = (out[0], out[1], out[2]) + tuple(out[3].values())
        bound_ms, bound_by = bound(flops, tensor_bytes(pe, zd, zv, gf, gb, gd,
                                                       *packed.values(), *outs))
        scratch_gb = fr.scratch_bytes(B, R) / 1e9
        log(f"fused_render_bwd B={B} R={R} input_grads={input_grads}: {ms:.3f} ms "
            f"(plain {plain_ms:.3f} ms); {flops / 1e12:.4f} TFLOP -> bound {bound_ms:.3f} ms "
            f"by {bound_by}; {flops / ms / 1e9:.1f} TFLOP/s achieved; scratch {scratch_gb:.2f} GB "
            f"(stash written once, read back by the weight-gradient passes)")
        if not input_grads:   # the training path's variant
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            with torch.no_grad():
                kernels, _ = device_ms_by_kernel(lambda: fr.fused_render_bwd(
                    pe, zd, zv, packed, gf, gb, gd, input_grads=False), calls=3)
            # K2's launches: the ray kernel, then the X^T G core's two
            rec["parts_ms"] = {part: sum(v for k, v in kernels.items() if part in k)
                               for part in K2_PARTS} if kernels else None
            log(f"fused_render_bwd B={B} R={R} parts (torch.profiler, device ms per launch): "
                + (json.dumps(rec["parts_ms"]) if kernels else "not measured"))
        else:
            rec["input_grads_ms"] = ms
    del scratch
    return {"name": "fused_render_bwd", "route": "cuda",
            "source": "nerf3dtalker_tpu_torch/csrc/fused_render_bwd.cu",
            "replaces": "nerf3dtalker_tpu/ops/pallas/fused_render.py:522",
            "max_abs_err": max_abs, **rec,
            "library_ms": None}  # no single PyTorch call computes this backward


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
                             np.zeros((1, 127), np.float32), styles[:chunk], cam_d, chunk=chunk)
    diff = np.abs(plain - img[:chunk])
    log(f"serving vs plain render path, first chunk: max_abs {diff.max():.3e} "
        f"(tolerance {FRAME_MAX_ABS:.0e}), mean_abs {diff.mean():.3e} "
        f"(tolerance {FRAME_MEAN_ABS:.0e}); frame mean {img.mean():.4f}")
    if diff.max() > FRAME_MAX_ABS or diff.mean() > FRAME_MEAN_ABS:
        raise AssertionError("fused serving path disagrees with the plain render path")
    return launches, wall * 1e3 / frames


def phase_training(seed: int, workdir: str):
    """`cli train` at Reso64 in-process, with the launch counts of its
    train steps and of its validation renders, each read around the
    trainer's own calls."""
    import shutil

    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import TrainConfig
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.train.step import build_step_fns
    from nerf3dtalker_tpu_torch.train.trainer import Trainer
    from nerf3dtalker_tpu_torch.utils import checkpoints as ckpt

    ckpt_dir = os.path.join(workdir, "ckpt")
    log_dir = os.path.join(workdir, "train_logs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg = train_config()
    argv = ["train", "--featmap-size", str(cfg.featmap_size), "--img-size",
            str(cfg.pred_img_size), "--batch-size", "2", "--device", DEVICE,
            "--epochs", str(TRAIN_EPOCHS), "--seed", str(seed), "--ckpt-dir", ckpt_dir,
            "--log-dir", log_dir]
    # (K1, K2) launches of the trainer the call builds: its train steps (one
    # CUDA graph, each replay counted), the steps before the capture, and
    # its validations
    fr.fused_render_fwd.launches = 0
    fr.fused_render_bwd.launches = 0
    with trainers_built() as trainers:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k1, k2 = fr.fused_render_fwd.launches, fr.fused_render_bwd.launches
    by_path, graphs_ok = trainer_launches(trainers)
    (k1_train, k2_train), (k1_val, k2_val) = by_path["train_steps"], by_path["validation"]
    k1_warm, k2_warm = by_path["graph_warmup"]
    steps = TRAIN_EPOCHS * (TRAIN_FRAMES // 2)
    val_renders = TRAIN_EPOCHS * VAL_FRAMES
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    log(f"training: cli train {TRAIN_EPOCHS} epochs, {steps} steps in {wall:.1f} s (whole cli "
        f"call: data, VGG planes, model build, the step's CUDA graph, steps, validation, "
        f"checkpoints); launches in the train steps K1 {k1_train}, K2 {k2_train} (expected "
        f"{steps} each, replays of the graph), before its capture K1 {k1_warm}, K2 {k2_warm}, "
        f"in validation K1 {k1_val}, K2 {k2_val} (expected {val_renders}, 0); in the whole "
        f"call K1 {k1}, K2 {k2}; graph {json.dumps(trainers[0].graph_records)}")
    for e, r in enumerate(records):
        log(f"training epoch {e} " + json.dumps({k: r[k] for k in (
            "step", "total_loss", "vgg", "finite_step", "sec_per_step", "rays_per_s",
            "SSIM", "PSNR")}))
    if (k1_train, k2_train, k1_val, k2_val) != (steps, steps, val_renders, 0) or not graphs_ok \
            or (k1, k2) != (k1_train + k1_val + k1_warm, k2_train + k2_val + k2_warm):
        raise AssertionError(f"training launches: {by_path}, whole call K1 {k1} K2 {k2}, "
                             f"graphs {trainers[0].graph_records}")
    if len(records) != TRAIN_EPOCHS:
        raise AssertionError(f"{len(records)} epoch records, expected {TRAIN_EPOCHS}")
    for e, r in enumerate(records):
        losses = [r[k] for k in ("bg_loss", "head_loss", "nonhead_loss", "vgg", "total_loss")]
        if not all(map(math.isfinite, losses)) or r["finite_step"] != 1.0:
            raise AssertionError(f"training epoch {e}: {r}")
    # every trainable leaf of both groups moved from its seeded init
    fns = build_step_fns(cfg, TrainConfig(seed=seed), device=DEVICE)
    init = fns.init(seed)
    final = ckpt.load_checkpoint(ckpt_dir, map_location=DEVICE)
    if final["step"] != steps:
        raise AssertionError(f"checkpoint at step {final['step']}, expected {steps}")
    still = [f"{group}.{name}" for group, module in (("nerf", init.nerf), ("audio", init.audio))
             for name, p in module.named_parameters()
             if p.requires_grad and torch.equal(p, final[group][name])]
    n_leaves = sum(len(v) for v in init.params().values())
    log(f"training: {n_leaves - len(still)} of {n_leaves} trainable leaves moved")
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    return {"k1_train": k1_train, "k1_validation": k1_val, "k2": k2_train, "steps": steps,
            "k1_warmup": k1_warm, "k2_warmup": k2_warm, "graph": trainers[0].graph_records}


def phase_subject(seed: int, workdir: str):
    """Train the learnable subject through the trainer (K1/K2), then serve
    its checkpoint through `cli animate --ckpt`."""
    import shutil

    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import TrainConfig
    from nerf3dtalker_tpu_torch.data.dataset import coherent_subject
    from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
    from nerf3dtalker_tpu_torch.train.trainer import Trainer
    from nerf3dtalker_tpu_torch.utils import video
    from nerf3dtalker_tpu_torch.utils.camera import base_cam

    t_phase = time.perf_counter()
    ckpt_dir = os.path.join(workdir, "subject_ckpt")
    log_dir = os.path.join(workdir, "subject_logs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg = train_config()
    train = coherent_subject(cfg, SUBJECT_FRAMES, t0=0)
    val = coherent_subject(cfg, SUBJECT_VAL_FRAMES, t0=SUBJECT_FRAMES)
    train_eval = coherent_subject(cfg, SUBJECT_VAL_FRAMES, t0=0)
    tc = TrainConfig(batch_size=2, epochs=SUBJECT_EPOCHS, lr=2e-4, seed=seed,
                     ckpt_dir=ckpt_dir, log_dir=log_dir, guard_policy="rollback",
                     val_every=SUBJECT_VAL_EVERY)
    t = Trainer(cfg, tc, train, val, device=DEVICE, train_eval_data=train_eval)
    t.init()
    untrained = t.validate()   # the train-eval frames' TRAIN_PSNR before any step
    opacity_untrained = nerf_opacity(t.state.nerf.eval())

    fr.fused_render_fwd.launches = 0
    fr.fused_render_bwd.launches = 0
    t.kernel_launches = {path: [0, 0] for path in t.kernel_launches}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = t.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k1, k2 = fr.fused_render_fwd.launches, fr.fused_render_bwd.launches
    by_path, graphs_ok = trainer_launches([t])
    (k1_train, k2_train), (k1_val, k2_val) = by_path["train_steps"], by_path["validation"]
    k1_warm, k2_warm = by_path["graph_warmup"]
    steps = SUBJECT_EPOCHS * (SUBJECT_FRAMES // 2)
    validated = [h for h in hist if "TRAIN_PSNR" in h]
    val_renders = 2 * SUBJECT_VAL_FRAMES * len(validated)
    ms_step = 1e3 * statistics.median(h["sec_per_step"] for h in hist)
    final = validated[-1] if validated else {}
    nan = float("nan")
    log(f"subject: {SUBJECT_EPOCHS} epochs, {t.state.step} steps in {train_s:.1f} s, step "
        f"{ms_step:.2f} ms (median of the epochs); TRAIN_PSNR untrained "
        f"{untrained['TRAIN_PSNR']:.3f} -> {final.get('TRAIN_PSNR', nan):.3f} dB "
        f"(TRAIN_SSIM {final.get('TRAIN_SSIM', nan):.4f}), val PSNR "
        + ", ".join(f"epoch {h['epoch']} {h['PSNR']:.3f}" for h in validated)
        + f"; launches in the train steps K1 {k1_train}, K2 {k2_train} (expected {steps} "
        f"each, replays of the step's CUDA graph), before its capture K1 {k1_warm}, K2 "
        f"{k2_warm}, in validation K1 {k1_val}, K2 {k2_val} (expected {val_renders}, 0); graph "
        f"{json.dumps(t.graph_records)}")
    for h in hist:
        losses = [h[k] for k in ("bg_loss", "head_loss", "nonhead_loss", "vgg", "total_loss")]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"subject epoch {h['epoch']}: non-finite loss {h}")
    if [h["epoch"] for h in validated] != list(range(SUBJECT_VAL_EVERY - 1, SUBJECT_EPOCHS,
                                                     SUBJECT_VAL_EVERY)):
        raise AssertionError(f"subject: validated epochs {[h['epoch'] for h in validated]}")
    gain = final["TRAIN_PSNR"] - untrained["TRAIN_PSNR"]
    if not gain >= SUBJECT_GAIN_DB:
        raise AssertionError(f"subject: TRAIN_PSNR gained {gain:.3f} dB over the untrained "
                             f"model, expected >= {SUBJECT_GAIN_DB}")
    if (k1_train, k2_train, k1_val, k2_val) != (steps, steps, val_renders, 0) or not graphs_ok \
            or (k1, k2) != (k1_train + k1_val + k1_warm, k2_train + k2_val + k2_warm):
        raise AssertionError(f"subject launches: {by_path}, whole run K1 {k1} K2 {k2}, "
                             f"graphs {t.graph_records}")

    # the NeRF's opacity, recorded: at TrainConfig seed 0 it goes transparent
    opacity = nerf_opacity(t.state.nerf.eval())
    log(f"subject: NeRF opacity of val frame 0 (1 - mean bg_alpha), untrained "
        f"{opacity_untrained:.4f} -> trained {opacity:.4f}")

    # serve the trained checkpoint: the frames that reach write_video
    chunk = 4
    wav = os.path.join(workdir, "subject.wav")
    out = os.path.join(workdir, "subject.mp4")
    write_wav(wav, seed + 1, FRAMES)
    shutil.rmtree(os.path.splitext(out)[0] + "_frames", ignore_errors=True)
    if os.path.exists(out):
        os.remove(out)
    served = []
    write_video = video.write_video
    video.write_video = lambda frames, *a, **kw: (served.append(frames),
                                                  write_video(frames, *a, **kw))
    fr.fused_render_fwd.launches = 0
    try:
        t0 = time.perf_counter()
        rec = cli.main(["animate", "--wav", wav, "--ckpt", ckpt_dir, "--enhancer", "unsharp",
                        "--chunk", str(chunk), "--device", DEVICE, "--out", out])
        serve_s = time.perf_counter() - t0
    finally:
        video.write_video = write_video
    k1_serve = fr.fused_render_fwd.launches
    img = served[0]
    styles = styles_from_mels(t.state.audio.eval(), per_frame_mel_chunks(*read_wav_mono(wav)))
    cam = base_cam(cfg.featmap_size)
    own = video.unsharp_enhancer(animate_sequence(
        t.state.nerf.eval(), np.zeros((1, cfg.shape_code_dims), np.float32),
        np.zeros((1, cfg.appea_code_dims), np.float32), styles,
        {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}, chunk=chunk))
    diff = float(np.abs(own - img).max())
    written = os.path.exists(out)
    fallback = os.path.splitext(out)[0] + "_frames"
    log(f"subject: cli animate --ckpt: {rec['frames']} frames in {serve_s:.1f} s (whole cli "
        f"call), K1 launches {k1_serve} (expected {-(-FRAMES // chunk)}); frames vs "
        f"animate_sequence on the trainer's model, max_abs {diff:.3e} (expected 0); "
        + (f"wrote {out} ({os.path.getsize(out)} bytes)" if written else
           f"no ffmpeg: notice — the PNG fallback went to {fallback}"))
    if img.shape != (FRAMES, cfg.pred_img_size, cfg.pred_img_size, 3) \
            or not np.isfinite(img).all() or img.min() < 0 or img.max() > 1:
        raise AssertionError(f"subject frames: shape {img.shape}, range "
                             f"[{img.min()}, {img.max()}]")
    if diff != 0.0 or k1_serve != -(-FRAMES // chunk):
        raise AssertionError("cli animate --ckpt disagrees with the trainer's model")
    if not written and len([f for f in os.listdir(fallback) if f.endswith(".png")]) != FRAMES:
        raise AssertionError(f"neither {out} nor its PNG fallback was written")
    phase_s = time.perf_counter() - t_phase
    log(f"subject: phase {phase_s:.1f} s")
    return {"steps": steps, "ms_per_step": ms_step, "train_s": train_s, "phase_s": phase_s,
            "untrained_psnr": untrained["TRAIN_PSNR"], "train_psnr": final["TRAIN_PSNR"],
            "train_ssim": final["TRAIN_SSIM"], "val_psnr": [h["PSNR"] for h in validated],
            "opacity_untrained": opacity_untrained, "opacity": opacity,
            "mp4": written, "k1_train": k1_train, "k2": k2_train, "k1_validation": k1_val,
            "k1_warmup": k1_warm, "k2_warmup": k2_warm, "graph": t.graph_records,
            "k1_animate": k1_serve}


# the epoch_program phase: coherent_subject at Reso64, B=2, VGG on: 8 steps
# an epoch; a replayed step against an eager one from the same state and
# seed within the train step's limits (STEP_LOSS_RTOL on the losses,
# STEP_GRAD_REL_L2 relative L2 on every gradient leaf), and a replayed epoch
# against an eager one within STEP_LOSS_RTOL on its losses
EPOCH_FRAMES = 16
EPOCH_TRACE_STEPS = 3


def profiled_group(t, epoch: int):
    """(the group's record, {kernel: launches}, device ms, wall ms) of one
    epoch of `t` under torch.profiler, device activity only."""
    import torch
    from torch.profiler import ProfilerActivity

    with padded_profile([ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = t.train_epoch_group(epoch, 1)[0]
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches, busy = {}, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            busy += us / 1e3
            launches[e.key] = launches.get(e.key, 0) + e.count
    return rec, launches, busy, wall_ms


def named(launches, part: str) -> int:
    return sum(n for k, n in launches.items() if part in k)


def state_leaves(t):
    """{leaf: (its value, Adam's first moment of it)} of a trainer's state;
    the moment is 0 before the first step."""
    import torch

    out = {}
    for g, m in (("nerf", t.state.nerf), ("audio", t.state.audio)):
        for n, p in m.named_parameters():
            if p.requires_grad:
                st = t.state.opt.state.get(p, {})
                out[f"{g}.{n}"] = (p.detach().clone(),
                                   st["exp_avg"].clone() if "exp_avg" in st
                                   else torch.zeros_like(p))
    return out


def epoch_errors(rec_a, rec_b, before, after_a, after_b):
    """Two epochs from one state: the largest relative difference of their
    losses, and by leaf the relative L2 difference of their changes and of
    Adam's first moments after them (a decayed sum of the epoch's
    gradients)."""
    keys = [k for k in rec_a if k.endswith("loss") or k == "vgg"]
    loss = max(abs(rec_a[k] - rec_b[k]) / max(abs(rec_b[k]), 1e-12) for k in keys)
    change = {k: rel_l2(after_a[k][0] - v, after_b[k][0] - v) for k, (v, _) in before.items()}
    moment = {k: rel_l2(after_a[k][1], after_b[k][1]) for k in before}
    return loss, change, moment


def worst(errs):
    k = max(errs, key=errs.get)
    return [k, errs[k]]


def graph_draws_match(shapes, seeds) -> bool:
    """Whether a CUDA graph's uniform draws of `shapes` from a generator
    registered with it equal eager draws, bit for bit, at each seed."""
    import torch

    gen = torch.Generator(device=DEVICE)
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    with torch.cuda.graph(g):
        drawn = [torch.rand(sh, generator=gen, device=DEVICE) for sh in shapes]
    equal = True
    for s in seeds:
        gen.manual_seed(s)
        g.replay()
        gen.manual_seed(s)
        equal &= all(torch.equal(d, torch.rand(sh, generator=gen, device=DEVICE))
                     for d, sh in zip(drawn, shapes))
    return equal


def phase_epoch_program(seed: int, workdir: str):
    """Whole epochs as replays of one CUDA graph of the train step
    (`Trainer.train_epoch_group`) at full width: (a) a graph epoch against an
    eager epoch from the same state and seeds, and the graph's generator
    draws against eager draws; (b) one K1 and one K2 a replayed step, by the
    counters and by torch.profiler; (c) ms/step and the device's idle share
    both ways, the capture's seconds and its pool's bytes; (d) a rollback
    mid-run, after which the next group trains from the checkpoint's state;
    (e) a --native-prefetch epoch with the device cache off; (f) `cli train
    --trace-dir --trace-steps 3` and K1 / K2 in its trace; (g) --tensorboard."""
    import copy
    import dataclasses
    import importlib.util
    import shutil

    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import TrainConfig
    from nerf3dtalker_tpu_torch.data.dataset import coherent_subject, to_tensors
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.train.trainer import (GRAPH_WARMUP_STEPS, Trainer, epoch_order,
                                                      step_seed)
    from nerf3dtalker_tpu_torch.utils import observability as obs

    t_phase = time.perf_counter()
    ckpt_dir = os.path.join(workdir, "epoch_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = train_config()
    steps = EPOCH_FRAMES // 2
    train = coherent_subject(cfg, EPOCH_FRAMES)
    val = coherent_subject(cfg, 2, t0=EPOCH_FRAMES)
    tc = TrainConfig(batch_size=2, epochs=8, lr=2e-4, seed=seed, ckpt_dir=ckpt_dir, log_dir="",
                     guard_policy="rollback", val_every=2)
    fr.fused_render_fwd.launches = 0
    fr.fused_render_bwd.launches = 0
    t = Trainer(cfg, tc, train, val, device=DEVICE)
    t.init()
    out = {"steps_per_epoch": steps}

    # (a) the generator: a graph's draws after manual_seed(s) are an eager
    # step's (the jitter's shape and the dropout's)
    rng_equal = graph_draws_match([(2, cfg.n_rays, cfg.num_sample_coarse + 1), (2, 1280)],
                                  [step_seed(seed, 0, 0), step_seed(seed, 3, 5)])

    # (a) from one state and seed: a step eagerly, eagerly again and as a
    # replay of the graph (its capture comes first), every gradient leaf
    # held as Adam's first moment after one step (0.1 of the gradient);
    # then epoch 0 the same three ways, its losses held. Eager runs differ
    # where the decoder's and the LSTM's backwards sum by atomics; over an
    # epoch Adam carries that into the leaves (eager_vs_eager shows how far)
    snap = {"nerf": {k: v.clone() for k, v in t.state.nerf.state_dict().items()},
            "audio": {k: v.clone() for k, v in t.state.audio.state_dict().items()},
            "opt": copy.deepcopy(t.state.opt.state_dict()), "step": t.state.step}
    before = state_leaves(t)
    idx = torch.as_tensor(epoch_order(EPOCH_FRAMES, seed, 0)[:2], device=DEVICE)
    counts = {k: list(v) for k, v in t.kernel_launches.items()}

    def one_step(use_graph):
        """Epoch 0's first step, counted as the trainer counts its steps."""
        t._load(snap)
        graph = t._step_graph() if use_graph else None
        before_step = t._launch_counts()
        if graph is not None:
            graph.step(idx, step_seed(seed, 0, 0))
            acc = torch.zeros(len(graph.keys), device=DEVICE)
            graph.take(acc)
            losses = dict(zip(graph.keys, acc.tolist()))
        else:
            t.generator.manual_seed(step_seed(seed, 0, 0))
            losses = {k: float(v) for k, v in t.fns.train_step(
                t.state, t.train_data.device_batch(idx), t.generator).items()}
        t._count_launches("train_steps", before_step)
        return losses, state_leaves(t)

    def one_epoch(use_graph):
        t._load(snap)
        t.use_graph = use_graph
        return t.train_epoch_group(0, 1)[0], state_leaves(t)

    out["graph_vs_eager"] = {"generator_draws_equal": rng_equal}
    for what, run in (("step", one_step), ("epoch", one_epoch)):
        (ra, la), (rb, lb), (rg, lg) = run(False), run(False), run(True)
        loss, change, moment = epoch_errors(rg, ra, before, lg, la)
        b_loss, b_change, b_moment = epoch_errors(rb, ra, before, lb, la)
        out["graph_vs_eager"][what] = {
            "loss_rel": loss, "first_moment_rel_l2_max": worst(moment),
            "leaf_change_rel_l2_max": worst(change), "total_loss": [rg["total_loss"],
                                                                   ra["total_loss"]],
            "eager_vs_eager": {"loss_rel": b_loss, "first_moment_rel_l2_max": worst(b_moment),
                               "leaf_change_rel_l2_max": worst(b_change)}}
        if loss > STEP_LOSS_RTOL or (what == "step" and worst(moment)[1] > STEP_GRAD_REL_L2):
            raise AssertionError(f"epoch_program: the graph's {what} against the eager one "
                                 f"{out['graph_vs_eager']}")
    log("epoch_program (a) " + json.dumps(out["graph_vs_eager"]))
    counts_a = {k: [a - b for a, b in zip(v, counts[k])] for k, v in t.kernel_launches.items()}
    if not rng_equal or counts_a["train_steps"] != [3 + 3 * steps] * 2 \
            or counts_a["graph_warmup"] != [GRAPH_WARMUP_STEPS] * 2:
        raise AssertionError(f"epoch_program: generator draws equal {rng_equal}, launches "
                             f"{counts_a}")
    del before, snap

    # (b), (c) replayed and eager epochs, timed, then each under torch.profiler
    t.use_graph = True
    k_before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
    ms_graph = t.train_epoch_group(1, 1)[0]["sec_per_step"] * 1e3
    _, prof_g, busy_g, wall_g = profiled_group(t, 2)
    k_graph = (fr.fused_render_fwd.launches - k_before[0],
               fr.fused_render_bwd.launches - k_before[1])
    t.use_graph = False
    ms_eager = t.train_epoch_group(3, 1)[0]["sec_per_step"] * 1e3
    _, prof_e, busy_e, wall_e = profiled_group(t, 4)
    t.use_graph = True
    graph = t.graph_records[0]
    out["graph"] = {"ms_per_step": ms_graph, "device_ms_per_step": busy_g / steps,
                    "wall_ms_per_step_profiled": wall_g / steps,
                    "idle_share": max(0.0, 1.0 - busy_g / wall_g),
                    "profiler_k1": named(prof_g, "fused_render_fwd_kernel"),
                    "profiler_k2": named(prof_g, "ray_kernel"),
                    "counter_k1_k2": list(k_graph), "capture_s": graph["capture_s"],
                    "warmup_s": graph["warmup_s"], "pool_bytes": graph["pool_bytes"]}
    out["eager"] = {"ms_per_step": ms_eager, "device_ms_per_step": busy_e / steps,
                    "wall_ms_per_step_profiled": wall_e / steps,
                    "idle_share": max(0.0, 1.0 - busy_e / wall_e),
                    "profiler_k1": named(prof_e, "fused_render_fwd_kernel"),
                    "profiler_k2": named(prof_e, "ray_kernel")}
    log("epoch_program (b, c) " + json.dumps({"graph": out["graph"], "eager": out["eager"]}))
    if k_graph != (2 * steps, 2 * steps) or (out["graph"]["profiler_k1"],
                                             out["graph"]["profiler_k2"]) != (steps, steps):
        raise AssertionError(f"epoch_program: a replayed step's launches {out['graph']}")

    # (d) a rollback mid-run: epochs 5 (validated, saved), 6 reported
    # non-finite -> back to epoch 5's checkpoint, then 7 from that state
    t.start_epoch = 5
    clean, resume = t.train_epoch_group, t.resume
    params = [p for group in t.state.opt.param_groups for p in group["params"]]
    opt_ptrs = [v.data_ptr() for p in params for v in t.state.opt.state[p].values()]
    restored = {}

    def flagged(e0, n):
        return [{**m, **({"finite_step": 0.0} if e0 + j == 6 else {})}
                for j, m in enumerate(clean(e0, n))]

    def resume_and_look(path):
        step = resume(path)
        payload = torch.load(os.path.join(path, f"ckpt_{step:08d}.pt"), map_location=DEVICE,
                             weights_only=True)
        restored["step"] = step
        restored["params_equal"] = all(
            torch.equal(v, payload[g][k]) for g, m in (("nerf", t.state.nerf),
                                                       ("audio", t.state.audio))
            for k, v in m.state_dict().items())
        saved = payload["opt"]["state"]     # by the index of the param in the groups
        live = [t.state.opt.state[p] for p in params]
        restored["adam_equal"] = all(torch.equal(st[k], saved[i][k]) for i, st in enumerate(live)
                                     for k in st)
        restored["same_tensors"] = opt_ptrs == [v.data_ptr() for st in live for v in st.values()]
        restored["leaves"] = state_leaves(t)
        return step

    t.train_epoch_group, t.resume = flagged, resume_and_look
    try:
        hist = t.train(epochs=8)
    finally:
        t.train_epoch_group, t.resume = clean, resume
    after_graph = state_leaves(t)
    rec7 = hist[-1]
    payload = torch.load(os.path.join(ckpt_dir, f"ckpt_{restored['step']:08d}.pt"),
                         map_location=DEVICE, weights_only=True)
    t._load(payload)
    t.use_graph = False
    rec7_eager = t.train_epoch_group(7, 1)[0]
    loss_err, change, moment = epoch_errors(rec7, rec7_eager, restored["leaves"], after_graph,
                                            state_leaves(t))
    out["rollback"] = {"epochs": [[h["epoch"], "rollback" in h, "PSNR" in h] for h in hist],
                       "restored_step": restored["step"], "params_equal": restored["params_equal"],
                       "adam_equal": restored["adam_equal"],
                       "graph_tensors_kept": restored["same_tensors"],
                       "next_epoch_vs_eager_loss_rel": loss_err,
                       "next_epoch_leaf_change_rel_l2_max": worst(change),
                       "next_epoch_first_moment_rel_l2_max": worst(moment)}
    log("epoch_program (d) " + json.dumps(out["rollback"]))
    if out["rollback"]["epochs"] != [[5, False, True], [6, True, False], [7, False, True]] \
            or restored["step"] != 6 * steps or not restored["params_equal"] \
            or not restored["adam_equal"] or not restored["same_tensors"] \
            or loss_err > STEP_LOSS_RTOL or worst(moment)[1] > STEP_GRAD_REL_L2:
        raise AssertionError(f"epoch_program: rollback {out['rollback']}")
    t_launches = {k: list(v) for k, v in t.kernel_launches.items()}
    t.close()
    del t, restored, after_graph

    # (e) one --native-prefetch epoch, the device cache off
    t2 = Trainer(cfg, dataclasses.replace(tc, native_prefetch=True, device_cache=False,
                                          ckpt_dir=""), train, device=DEVICE)
    t2.init()
    nxt, equal = t2._prefetcher.next, []

    def checked():
        b = nxt()
        host = to_tensors(train.batch(t2._prefetcher.last_indices), DEVICE)
        equal.append(set(b) == set(host) and all(torch.equal(b[k], host[k]) for k in host))
        return b

    t2._prefetcher.next = checked
    rec = t2.train_one_epoch(0)
    out["native_prefetch"] = {"batches": len(equal), "equal_to_host_loader": all(equal),
                              "launches": t2.kernel_launches, "ms_per_step":
                              rec["sec_per_step"] * 1e3, "total_loss": rec["total_loss"]}
    log("epoch_program (e) " + json.dumps(out["native_prefetch"]))
    if len(equal) != steps or not all(equal) or t2.kernel_launches["train_steps"] != [steps] * 2 \
            or t2.kernel_launches["graph_warmup"] != [0, 0] or not math.isfinite(rec["total_loss"]):
        raise AssertionError(f"epoch_program: native prefetch {out['native_prefetch']}")
    t2_launches = t2.kernel_launches
    t2.close()
    del t2

    # (f) cli train --trace-dir --trace-steps 3 (and (g) --tensorboard with it
    # where the package is installed)
    has_tb = importlib.util.find_spec("tensorboard") is not None
    trace_dir = os.path.join(workdir, "epoch_trace")
    log_dir = os.path.join(workdir, "epoch_logs")
    for d in (trace_dir, log_dir, ckpt_dir):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["train", "--featmap-size", str(cfg.featmap_size), "--img-size",
            str(cfg.pred_img_size), "--epochs", "1", "--seed", str(seed), "--device", DEVICE,
            "--ckpt-dir", ckpt_dir, "--log-dir", log_dir]
    with trainers_built() as trainers:
        cli.main(argv + ["--trace-dir", trace_dir, "--trace-steps", str(EPOCH_TRACE_STEPS)]
                 + ["--tensorboard"] * has_tb)
    with open(os.path.join(trace_dir, obs.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    cli_counts, _ = trainer_launches(trainers, captures=0)
    out["trace"] = {"file_bytes": os.path.getsize(os.path.join(trace_dir, obs.TRACE_FILE)),
                    "k1": sum("fused_render_fwd_kernel" in k for k in kernels),
                    "k2": sum("ray_kernel" in k for k in kernels), "kernels": len(kernels),
                    "launches": cli_counts}
    log("epoch_program (f) " + json.dumps(out["trace"]))
    if (out["trace"]["k1"], out["trace"]["k2"]) != (EPOCH_TRACE_STEPS, EPOCH_TRACE_STEPS):
        raise AssertionError(f"epoch_program: the trace {out['trace']}")
    if has_tb:
        written = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
        out["tensorboard"] = f"event file written: {written}"
        if not written:
            raise AssertionError("epoch_program: --tensorboard wrote no event file")
    else:
        try:
            cli.main(argv + ["--tensorboard"])
        except obs.TensorBoardUnavailable as e:
            out["tensorboard"] = f"raised the clear error: {e}"
        else:
            raise AssertionError("epoch_program: --tensorboard without the package did not raise")
    log(f"epoch_program (g) --tensorboard: {out['tensorboard']}")

    k1, k2 = fr.fused_render_fwd.launches, fr.fused_render_bwd.launches
    parts = [t_launches, t2_launches, cli_counts]
    k1_sum = sum(c[0] for p in parts for c in p.values())
    k2_sum = sum(c[1] for p in parts for c in p.values())
    out["k1"], out["k2"] = k1, k2
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"epoch_program: phase {out['phase_s']:.1f} s; launches K1 {k1}, K2 {k2} (by path "
        f"{json.dumps(parts)})")
    if (k1, k2) != (k1_sum, k2_sum):
        raise AssertionError(f"epoch_program: launches K1 {k1} K2 {k2} against the paths' "
                             f"{k1_sum} {k2_sum}")
    torch.cuda.empty_cache()
    return out


# the fit phase: the subject's checkpoint fitted to its own val frame 0,
# rendered at a known camera offset with the frame's codes, iden then off by
# FIT_IDEN_ERR in the fit's base codes
FIT_ITERS = 300
FIT_PROFILE_ITERS = 10
FIT_VIEWS = 45
FIT_EULER, FIT_T, FIT_IDEN_ERR = (0.05, -0.05, 0.0), (0.1, 0.0, 0.0), 0.1
# the fit's subject must render its face: 1 - mean bg_alpha of its val frame 0
FIT_MIN_OPACITY = 0.2
# one fit iteration's gradients (each FitVar), through K1/K2 (K2 with input
# gradients) against the same graph through their plain versions, both
# bf16: relative L2 of each leaf. Both round at the same places; only ReLU
# mask flips from another f32 summation order separate them. The codes'
# gradients come through the per-batch bias sums, like the train step's
# leaves (STEP_GRAD_REL_L2; measured 8.7e-4 to 1.1e-3). The camera's sum
# d_pe over 262,144 points with much cancellation, which amplifies a flip's
# difference (measured 3.9e-3 and 7.1e-3): FIT_CAM_REL_L2, an order of
# magnitude above. Against the plain autograd path, which rounds in
# other places, only the codes are held (FIT_GRAD_REL_L2): there the
# camera's gradient differs by bf16 rounding alone from 5.6e-2 to 5.3e-1
# over the runs, since each bf16 path is off f64 on the rotation (the
# kernels' by 1.6e-1, the plain path's by 2.8e-2: `python -m
# nerf3dtalker_tpu_torch.scripts.fit_precision`), and it is logged
FIT_GRAD_REL_L2 = 3e-2
FIT_CAM_REL_L2 = 1e-1


def subject_frame_codes(cfg):
    """(codes, frame arrays) of the subject's val frame 0: iden, expr with
    its audio_exp over expr[:64] (as the trainer assembles them), text, illu."""
    import numpy as np

    from nerf3dtalker_tpu_torch.data.dataset import coherent_subject

    frame = {k: v[:1] for k, v in
             coherent_subject(cfg, SUBJECT_VAL_FRAMES, t0=SUBJECT_FRAMES).arrays.items()}
    aexp = frame["audio_exp"]
    return {"iden": frame["iden"], "expr": np.concatenate([aexp, frame["expr"][:, aexp.shape[1]:]],
                                                          -1),
            "text": frame["text"], "illu": frame["illu"]}


def nerf_opacity(model) -> float:
    """1 - mean bg_alpha of the subject's val frame 0 at the base camera,
    audio style zero: 0 when the NeRF has gone transparent."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

    cfg = model.cfg
    codes = subject_frame_codes(cfg)
    cam = base_cam(cfg.featmap_size)
    dev = next(model.parameters()).device
    args = (ray_grid(cfg.featmap_size)[0], np.concatenate([codes["iden"], codes["expr"]], -1),
            np.concatenate([codes["text"], codes["illu"]], -1),
            np.zeros((1, cfg.audio_style_dims)), cam.Rmat, cam.Tvec, cam.inv_inmat)
    with torch.no_grad():
        out = model(*(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in args))
    return 1.0 - float(out["bg_alpha"].mean())


def train_fit_subject(seed: int, workdir: str):
    """The subject the fit phase fits: `coherent_subject` through the
    trainer as the subject phase trains it, at TrainConfig seed `seed` + 1,
    validated and checkpointed once, after the last epoch. At seed 0 the
    subject phase's NeRF goes transparent in its first epoch (that phase
    records its opacity), and a transparent NeRF gives a fit no gradient to
    follow; seed 1's stays opaque. Returns (checkpoint dir, opacity)."""
    import shutil

    from nerf3dtalker_tpu_torch.config import TrainConfig
    from nerf3dtalker_tpu_torch.data.dataset import coherent_subject
    from nerf3dtalker_tpu_torch.train.trainer import Trainer

    ckpt_dir = os.path.join(workdir, "fit_subject_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = train_config()
    tc = TrainConfig(batch_size=2, epochs=SUBJECT_EPOCHS, lr=2e-4, seed=seed + 1,
                     ckpt_dir=ckpt_dir, log_dir="", guard_policy="rollback",
                     val_every=SUBJECT_EPOCHS)
    t = Trainer(cfg, tc, coherent_subject(cfg, SUBJECT_FRAMES, t0=0),
                coherent_subject(cfg, SUBJECT_VAL_FRAMES, t0=SUBJECT_FRAMES), device=DEVICE)
    t.init()
    t0 = time.perf_counter()
    hist = t.train()
    opacity = nerf_opacity(t.state.nerf.eval())
    log(f"fit: its subject, TrainConfig seed {seed + 1}: {SUBJECT_EPOCHS} epochs in "
        f"{time.perf_counter() - t0:.1f} s, val PSNR {hist[-1]['PSNR']:.3f} dB, NeRF opacity "
        f"{opacity:.4f}")
    return ckpt_dir, opacity


def phase_fit(seed: int, workdir: str):
    """Fit a trained subject's checkpoint to one image (`cli fit`), then
    orbit (`cli render`) and serve (`cli animate --latents`) the fitted
    codes."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.kernels import fused_upsampler as fu
    from nerf3dtalker_tpu_torch.train import fitting
    from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
    from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint

    t_phase = time.perf_counter()
    ckpt_dir, subject_opacity = train_fit_subject(seed, workdir)
    if not subject_opacity >= FIT_MIN_OPACITY:
        raise AssertionError(f"fit: the subject's NeRF is transparent (opacity "
                             f"{subject_opacity:.4f}): nothing for a fit to follow")
    state = load_checkpoint(ckpt_dir, map_location="cpu")
    cfg = cli._nerf_config(argparse.Namespace(featmap_size=None, img_size=None), state)
    dev = torch.device(DEVICE)
    model = cli.build_nerf(cfg, seed, dev, state=state)
    del state

    # 1. the target: val frame 0 with its codes, audio style zero, at the
    # camera offset
    codes = subject_frame_codes(cfg)
    cam = base_cam(cfg.featmap_size)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    zero_style = np.zeros((1, cfg.audio_style_dims), np.float32)
    offset = fitting.FitVars(*(torch.zeros(1, n) for n in (100, 79, 127)),
                             torch.tensor([FIT_EULER]), torch.tensor([FIT_T]))
    with torch.no_grad():
        shape, appea, Rmat, Tvec = fitting.apply_fit_vars(
            offset, {k: torch.as_tensor(v) for k, v in codes.items()},
            {k: torch.as_tensor(v) for k, v in cam_d.items()})
        xy = torch.as_tensor(ray_grid(cfg.featmap_size)[0], device=dev)
        out = model(xy, shape.to(dev), appea.to(dev), torch.zeros(1, 64, device=dev),
                    Rmat.to(dev), Tvec.to(dev), torch.as_tensor(cam.inv_inmat, device=dev))
        target = out["merge_img"][0].float().clamp(0, 1).cpu().numpy()
        opacity = 1.0 - float(out["bg_alpha"].mean())
    S = cfg.pred_img_size
    target_npz = os.path.join(workdir, "target.npz")
    base = dict(codes, iden=codes["iden"] + np.float32(FIT_IDEN_ERR))
    np.savez(target_npz, image=target, mask=np.ones((S, S, 1), np.float32), **base)
    log(f"fit: target = val frame 0 of the subject at featmap {cfg.featmap_size}, Δeuler "
        f"{FIT_EULER} rad, ΔT {FIT_T}, audio style zero; its opacity (1 - mean bg_alpha) "
        f"{opacity:.4f}; the fit's base iden off by {FIT_IDEN_ERR}")

    # 2. one iteration's gradients through the kernels, through their
    # plain versions in the same graph, and through the plain path
    problem = fitting.FitProblem(model, target[None], np.ones((1, S, S, 1), np.float32), base,
                                 cam_d, zero_style)
    counts = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches,
              fr.fused_render_bwd.input_grads_launches)
    loss_k, data_k, g_k = problem.gradients(fitting.init_fit_vars(dev))
    parity_launches = (fr.fused_render_fwd.launches - counts[0],
                       fr.fused_render_bwd.launches - counts[1],
                       fr.fused_render_bwd.input_grads_launches - counts[2])
    with kernels_as_plain_versions():
        loss_v, _, g_v = problem.gradients(fitting.init_fit_vars(dev))
    model.use_fused = False
    loss_p, _, g_p = problem.gradients(fitting.init_fit_vars(dev))
    model.use_fused = True

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    names = fitting.FitVars._fields
    errs = {"plain_versions": {n: rel(a, b) for n, a, b in zip(names, g_k, g_v)},
            "plain_path": {n: rel(a, b) for n, a, b in zip(names, g_k, g_p)}}
    norms = {n: float(b.norm()) for n, b in zip(names, g_v)}
    limits = {"plain_versions": {n: FIT_CAM_REL_L2 if n.startswith("delta") else FIT_GRAD_REL_L2
                                 for n in names},
              "plain_path": {n: FIT_GRAD_REL_L2 for n in names if not n.startswith("delta")}}
    loss_rel = {"plain_versions": abs(float(loss_k) - float(loss_v)) / abs(float(loss_v)),
                "plain_path": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))}
    for against in errs:
        log(f"fit gradient at iteration 0, kernels vs {against.replace('_', ' ')} (bf16): loss "
            f"rel {loss_rel[against]:.2e} (tolerance {STEP_LOSS_RTOL:.0e}); rel L2 by FitVar "
            + ", ".join(f"{n} {v:.3e} (|g| {norms[n]:.3e}, tolerance "
                        + (f"{limits[against][n]:.0e})" if n in limits[against] else "none)")
                        for n, v in errs[against].items()))
    log(f"fit gradient: launches K1/K2/K2 with input grads {parity_launches} (expected (1, 1, 1))")
    if parity_launches != (1, 1, 1) or not all(torch.isfinite(g).all() for g in g_k):
        raise AssertionError(f"fit gradient: launches {parity_launches}, or non-finite")
    if max(loss_rel.values()) > STEP_LOSS_RTOL or min(norms.values()) <= 0 or any(
            errs[a][n] > limit for a in limits for n, limit in limits[a].items()):
        raise AssertionError("the fit's gradients through the kernels disagree with the plain "
                             "versions or the plain path")

    # 3. cli fit on the card, counted and timed around fit_single_image
    fitted = os.path.join(workdir, "fitted.npz")
    timed = {}
    fit_fn = fitting.fit_single_image

    def fit_timed(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = fit_fn(*a, **kw)
        ev[1].record()
        ev[1].synchronize()
        timed["ms"] = ev[0].elapsed_time(ev[1])
        return res

    for k in (fr.fused_render_fwd, fr.fused_render_bwd, fu.phase_block_fwd, fu.phase_block_bwd):
        k.launches = 0
    fr.fused_render_bwd.input_grads_launches = 0
    fitting.fit_single_image = fit_timed
    try:
        t0 = time.perf_counter()
        rec = cli.main(["fit", "--ckpt", ckpt_dir, "--data", target_npz, "--iters",
                        str(FIT_ITERS), "--device", DEVICE, "--out", fitted])
        fit_wall = time.perf_counter() - t0
    finally:
        fitting.fit_single_image = fit_fn
    k1, k2, k2_ig = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches,
                     fr.fused_render_bwd.input_grads_launches)
    k5 = fu.phase_block_fwd.launches + fu.phase_block_bwd.launches
    ms_iter = timed["ms"] / FIT_ITERS
    with np.load(fitted) as z:
        fit_vals = {k: z[k] for k in z.files}
    head_ratio = rec["head_loss"] / float(data_k["head_loss"])
    log(f"fit: cli fit --iters {FIT_ITERS}: {timed['ms'] / 1e3:.2f} s in fit_single_image "
        f"(CUDA events; the {FIT_ITERS} iterations and the final forward), {ms_iter:.2f} ms an "
        f"iteration; whole cli call {fit_wall:.1f} s; launches K1 {k1} (expected "
        f"{FIT_ITERS + 1}), K2 {k2} with input grads {k2_ig} (expected {FIT_ITERS}), K5 {k5} "
        f"(expected 0); head loss {float(data_k['head_loss']):.5f} at iteration 0 -> "
        f"{rec['head_loss']:.5f} ({head_ratio:.4f} of it); total {rec['total_loss']:.5f}; "
        f"fitted Δeuler {fit_vals['delta_euler'][0].tolist()} (target {FIT_EULER}), ΔT "
        f"{fit_vals['delta_tvec'][0].tolist()} (target {FIT_T}), mean iden offset "
        f"{float(fit_vals['iden_offset'].mean()):+.4f} (base off by +{FIT_IDEN_ERR})")
    losses = [rec[k] for k in ("bg_loss", "head_loss", "nonhead_loss", "total_loss")]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"fit: non-finite loss {rec}")
    if (k1, k2, k2_ig, k5) != (FIT_ITERS + 1, FIT_ITERS, FIT_ITERS, 0):
        raise AssertionError(f"fit launched K1 {k1}, K2 {k2} ({k2_ig} with input grads), K5 {k5}")
    if not head_ratio < 1.0:
        raise AssertionError(f"fit: the head loss did not fall ({head_ratio:.4f} of iteration 0)")
    if set(fit_vals) != set(fitting.FitVars._fields) | {"iden", "expr", "text", "illu"}:
        raise AssertionError(f"fitted.npz keys {sorted(fit_vals)}")

    # where an iteration's time goes: K1 and K2 at B=1 (K2 with input
    # grads, its three launches apart), the plain decoder pair forward and
    # backward, and 10 profiled iterations (device time, idle share)
    parts = fit_breakdown(model, problem, seed)

    # 4. cli render: the orbit of the fitted subject
    views = os.path.join(workdir, "novel_views.npy")
    fr.fused_render_fwd.launches = 0
    t0 = time.perf_counter()
    rrec = cli.main(["render", "--ckpt", ckpt_dir, "--latents", fitted, "--views",
                     str(FIT_VIEWS), "--device", DEVICE, "--out", views])
    render_wall = time.perf_counter() - t0
    k1_render = fr.fused_render_fwd.launches
    frames = np.load(views)
    log(f"fit: cli render --views {FIT_VIEWS}: {render_wall:.1f} s (whole cli call), K1 "
        f"launches {k1_render} (expected {FIT_VIEWS}), frames {list(frames.shape)} in "
        f"[{frames.min():.4f}, {frames.max():.4f}]")
    if k1_render != FIT_VIEWS or frames.shape != (FIT_VIEWS, S, S, 3) \
            or not np.isfinite(frames).all() or frames.min() < 0 or frames.max() > 1 \
            or rrec["shape"] != list(frames.shape):
        raise AssertionError("cli render of the fitted subject")
    del frames
    os.remove(views)

    # 5. cli animate serves the fitted codes: the frames equal
    # animate_sequence on the checkpoint's models with those codes
    chunk = 4
    wav = os.path.join(workdir, "fit.wav")
    out = os.path.join(workdir, "fit_frames.npy")
    write_wav(wav, seed + 2, FRAMES)
    fr.fused_render_fwd.launches = 0
    cli.main(["animate", "--wav", wav, "--ckpt", ckpt_dir, "--latents", fitted, "--chunk",
              str(chunk), "--device", DEVICE, "--out", out])
    k1_animate = fr.fused_render_fwd.launches
    served = np.load(out)
    served_model, a2s = cli.build_models(cfg, seed, dev, state=load_checkpoint(
        ckpt_dir, map_location="cpu"))
    shape_np, appea_np = cli._codes_from_latents(fitted)
    own = animate_sequence(served_model, shape_np, appea_np,
                           styles_from_mels(a2s, per_frame_mel_chunks(*read_wav_mono(wav))),
                           cam_d, chunk=chunk)
    diff = float(np.abs(own - served).max())
    log(f"fit: cli animate --latents: {len(served)} frames, K1 launches {k1_animate} (expected "
        f"{-(-FRAMES // chunk)}); frames vs animate_sequence with the fitted codes, max_abs "
        f"{diff:.3e} (expected 0)")
    if served.shape != (FRAMES, S, S, 3) or diff != 0.0 or k1_animate != -(-FRAMES // chunk):
        raise AssertionError("cli animate --latents disagrees with animate_sequence")
    phase_s = time.perf_counter() - t_phase
    log(f"fit: phase {phase_s:.1f} s")
    return {"subject_opacity": subject_opacity, "opacity": opacity, "grad_rel_l2": errs,
            "grad_loss_rel": loss_rel,
            "iters": FIT_ITERS, "ms_per_iter": ms_iter, "fit_s": timed["ms"] / 1e3,
            "cli_fit_wall_s": fit_wall, "head_loss_0": float(data_k["head_loss"]),
            "head_loss_final": rec["head_loss"], "head_loss_ratio": head_ratio,
            "delta_euler": fit_vals["delta_euler"][0].tolist(),
            "delta_tvec": fit_vals["delta_tvec"][0].tolist(), "breakdown": parts,
            "render_wall_s": render_wall, "phase_s": phase_s, "ckpt_dir": ckpt_dir,
            "fitted": fitted,
            "k1_fit": k1, "k2_fit": k2, "k1_render": k1_render, "k1_animate": k1_animate}


@contextlib.contextmanager
def kernels_as_plain_versions():
    """`FusedRender` with its forward and backward through the kernels'
    plain versions (`reference_render`, `reference_render_bwd`: the same
    signatures) for the block; nothing is launched or counted there."""
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    kernels = fr.fused_render_fwd, fr.fused_render_bwd
    fr.fused_render_fwd, fr.fused_render_bwd = fr.reference_render, fr.reference_render_bwd
    try:
        yield
    finally:
        fr.fused_render_fwd, fr.fused_render_bwd = kernels


def fit_breakdown(model, problem, seed: int):
    """CUDA-event times of one fit iteration and its parts at Reso64 B=1,
    K2's three launches by torch.profiler, and a profile of
    FIT_PROFILE_ITERS iterations (device time by kernel, idle share)."""
    import torch

    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.train import fitting

    fit = fitting.init_fit_vars(DEVICE)
    opt, sched = fitting.make_fit_optimizer(fit, 0.01, FIT_ITERS)

    def iteration():
        fitting.fit_iteration(problem, fit, opt, sched)

    ms_iter = cuda_ms(iteration, reps=10, warmup=3)
    g = torch.Generator().manual_seed(seed + 3)
    with torch.no_grad():
        shape, appea, Rmat, Tvec = fitting.apply_fit_vars(fit, problem.codes, problem.cam)
        pe, zd, zv = rays_and_pe(problem.xy, Rmat, Tvec, problem.cam["inv_inmat"])
        packed = fr.pack_weights(dict(model.fg_CD_predictor.named_parameters()), shape, appea,
                                 problem.audio_style)
        packed = {k: (v.to(torch.bfloat16) if k.startswith("w") else v.float()).contiguous()
                  for k, v in packed.items()}
        B, R, ns, _ = pe.shape
        gf, gb, gd = (torch.randn(*sh, generator=g).to(DEVICE)
                      for sh in ((B, R, fr.FEAT), (B, R), (B, R)))
        k1_ms = cuda_ms(lambda: fr.fused_render_fwd(pe, zd, zv, packed), reps=10)
        k2_ms = cuda_ms(lambda: fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd,
                                                    input_grads=True), reps=10)
        k2_plain_ms = cuda_ms(lambda: fr.reference_render_bwd(
            pe, zd, zv, packed, gf, gb, gd, torch.bfloat16, input_grads=True), reps=3, warmup=1)
        kernels = device_launches_by_kernel(lambda: fr.fused_render_bwd(
            pe, zd, zv, packed, gf, gb, gd, input_grads=True), calls=3)
    # device ms of each of K2's three launches, per launch the profiler
    # recorded
    k2_parts = None
    if kernels:
        k2_parts = {}
        for part in K2_PARTS:
            ms, n = (sum(v[i] for k, v in kernels.items() if part in k) for i in (0, 1))
            k2_parts[part] = ms / n if n else None
        k2_parts["launches_recorded_per_call"] = sum(
            v[1] for k, v in kernels.items() if any(part in k for part in K2_PARTS)) / 3
    macs = mlp_macs(packed)
    flops = 2.0 * B * R * ns * 3 * macs   # recompute + dW + dX
    outs_bytes = 4 * (pe.numel() + zd.numel() + zv.numel()) + sum(
        4 * v.numel() for v in packed.values())
    k2_bound, k2_bound_by = bound(flops, tensor_bytes(pe, zd, zv, gf, gb, gd, *packed.values())
                                  + outs_bytes)
    nr = model.neural_render
    S = model.cfg.featmap_size
    merge = torch.randn(1, S, S, model.cfg.featmap_nc, generator=g).to(DEVICE).requires_grad_()

    def decoder():   # the fit differentiates the merge pass only; the weights are frozen
        with fitting.frozen(nr):
            loss = nr(merge).float().sum() + nr(nr.bg_featmap).float().sum()
            torch.autograd.grad(loss, [merge])

    parts = {"iteration": ms_iter, "K1 fused_render_fwd B=1": k1_ms,
             "K2 fused_render_bwd B=1 input_grads": k2_ms,
             "decoder_x2_fwd_merge_bwd B=1": cuda_ms(decoder, reps=5)}
    rec = {"ms": parts, "k2_parts_ms": k2_parts, "k2_plain_ms": k2_plain_ms,
           "k2_bound_ms": k2_bound, "k2_bound_by": k2_bound_by}
    log("fit_breakdown " + json.dumps(rec))
    rec["profile"] = prof = profile_steps(iteration, steps=FIT_PROFILE_ITERS, label="fit_profile")
    if prof:   # K2's launches inside the fit's own iterations
        rec["k2_parts_in_fit_ms"] = {part: sum(v for k, v in prof["kernels_ms_per_step"].items()
                                               if part in k) for part in K2_PARTS}
        log("fit_profile K2 parts, device ms an iteration: " + json.dumps(rec["k2_parts_in_fit_ms"]))
    return rec


# the vq phase: the Standardized Space stage 1 at full width (VQConfig
# defaults: img 256, hidden 512, 6 + 6 layers, codebooks 8192 / 500), B=4,
# on 112^2 crops of the fit subject's renders
VQ_BATCH = 4
VQ_STEPS = 200
VQ_TIMED_FROM = 20        # ms/step over the steps after these
VQ_PROFILE_STEPS = 10
# one deterministic step on the card against the same weights and batch on
# the CPU, both f32 (cuDNN's TF32 off for this comparison): the total loss
# within VQ_LOSS_RTOL relative; at least VQ_INDEX_AGREE of the image-code
# indices equal (an argmin near a tie can flip: the codebook entries are
# ~1/8192 next to ||z||^2 of O(10-100), so the f32 rounding of the sum
# decides between two codes a few ulps apart); where all of a frame's
# indices agree, its recon within VQ_RECON_RTOL of max|ref|; every leaf's
# gradient within VQ_GRAD_REL_L2 relative L2, the image codebook without
# the rows that flipped indices touch (a flipped token's straight-through
# code pulls another row), and the bias of a conv that feeds an instance
# norm (`vq_trainer.norm_fed_convs`) relative to the mass of the terms its
# gradient sums (`bias_term_mass` on the CPU): the norm takes each channel's
# mean out, so that sum cancels, to 0 for the AU classifiers' convs and to
# what the leaky ReLU's knee leaves for the squasher's and the expander's,
# and its rounding scales with the terms, not the sum (on the CPU, f32
# against f64 at the card test's config, `tests/_vq_bias_conditioning.py`:
# the classifiers' <= 2.7e-8 of the mass, the squasher's 8.9e-5 - 3.1e-3,
# the expander's 1.7e-4 - 7.3e-3; the expander's 9.5e-2 of its own size on
# the first card run). The encoder stem's two biases (`VQ_STEM_BIASES`) are
# sums that cancel as well: a shift of the stem's output reaches the
# squasher's norm through linear maps and ReLU knees only, so f32 leaves
# them an error that is large against their own size on either side
# (stem1's card-vs-CPU f32 gradient was 8.0e-3 of its size on one card run
# and 1.9e-2 on the next), while their size is too small a share of their
# terms' mass for a limit on that mass to catch a wrong gradient. They are
# held to VQ_GRAD_REL_L2 of their own size in one more step, in f64 on both
# sides on the same weights and batch; the log prints their size over the
# mass and the f32 errors against the CPU's f64 gradient, so that the
# margin shows on every run
VQ_LOSS_RTOL = 1e-3
VQ_INDEX_AGREE = 0.99
VQ_RECON_RTOL = 1e-2
VQ_GRAD_REL_L2 = 1e-2
# `cli eval-vq --ckpt` against `reconstruct_split` in this process on the
# checkpoint's weights: the same calls on the same card, so equal but for a
# sum order the card might change between two runs of one kernel
VQ_CLI_RTOL = 1e-6
VQ_STEM_BIASES = ("vq.encoder.stem0.bias", "vq.encoder.stem1.bias")


@contextlib.contextmanager
def tf32_off():
    """cuDNN's and cuBLAS's TF32 off for a card-vs-CPU comparison."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield saved
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def vq_step_on(vq, au, batch):
    """(total loss, out, {name: gradient}, {name: term mass}) of one stage-1
    step's loss on the modules' device; the mass is `bias_term_mass`'s for
    the biases of `norm_fed_convs` and `VQ_STEM_BIASES`."""
    from nerf3dtalker_tpu_torch.train.vq_trainer import bias_term_mass, norm_fed_convs, vq_loss

    for m in (vq, au):
        m.zero_grad(set_to_none=True)
    convs = {**norm_fed_convs(vq, au), VQ_STEM_BIASES[0]: vq.encoder.stem0,
             VQ_STEM_BIASES[1]: vq.encoder.stem1}
    with bias_term_mass(convs) as mass:
        total, _, out = vq_loss(vq, au, batch)
        total.backward()
    grads = {f"vq.{k}": p.grad for k, p in vq.named_parameters()}
    grads.update({f"au.{k}": p.grad for k, p in au.named_parameters()})
    return float(total.detach()), out, grads, mass


def vq_stem_f64(card, cpu, batch, grads_g, grads_c):
    """The gradients of `VQ_STEM_BIASES` from one stage-1 step in f64 on
    the card's modules (`card`: vq, au) and on their CPU copies (`cpu`),
    copied to f64, on `batch`: ({bias: {f64_card_vs_cpu: relative L2,
    size_over_mass: the CPU's f64 gradient over its terms' mass,
    f32_card_to_own / f32_cpu_to_own / f32_card_to_mass: the f32 step's
    gradients (`grads_g`, `grads_c`) against the CPU's f64 one}}, the
    share of image-code indices the two f64 steps agree on, seconds)."""
    import copy

    t0 = time.perf_counter()
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    got = {}
    for side, mods in (("card", card), ("cpu", cpu)):
        vq64, au64 = (copy.deepcopy(m).double() for m in mods)
        dev = next(vq64.parameters()).device
        _, out, grads, mass = vq_step_on(vq64, au64, {k: v.to(dev) for k, v in batch64.items()})
        got[side] = ({k: grads[k].cpu() for k in VQ_STEM_BIASES}, out.indices.cpu(),
                     {k: mass[k].cpu() for k in VQ_STEM_BIASES})
        del vq64, au64, out, grads, mass
    (g, idx_g, _), (c, idx_c, m_c) = got["card"], got["cpu"]
    stem = {}
    for k in VQ_STEM_BIASES:
        own, mass = c[k].norm(), m_c[k].norm()
        f32_card = (grads_g[k].cpu().double() - c[k]).norm()
        stem[k] = {"f64_card_vs_cpu": float((g[k] - c[k]).norm() / own),
                   "size_over_mass": float(own / mass),
                   "f32_card_to_own": float(f32_card / own),
                   "f32_cpu_to_own": float((grads_c[k].double() - c[k]).norm() / own),
                   "f32_card_to_mass": float(f32_card / mass)}
    return stem, float((idx_g == idx_c).float().mean()), time.perf_counter() - t0


def phase_vq(seed: int, workdir: str, ckpt_dir: str):
    """The Standardized Space stage 1 on the fit subject's renders: one step
    on the card against the CPU, 200 steps (timed, profiled), the
    reconstruction of the val split, and `cli train-vq` / `cli eval-vq`."""
    import copy
    import shutil

    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import VQConfig
    from nerf3dtalker_tpu_torch.data.dataset import coherent_subject, talking_signals
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.scripts import train_r05, vq_run
    from nerf3dtalker_tpu_torch.train.trainer import Trainer
    from nerf3dtalker_tpu_torch.train.vq_eval import reconstruct_split
    from nerf3dtalker_tpu_torch.train.vq_trainer import BATCH_KEYS, build_vq_step, to_batch
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint

    t_phase = time.perf_counter()

    def at():   # seconds into the phase
        return f"[{time.perf_counter() - t_phase:.1f} s]"

    # 1. the subject's 40 train and 8 val frames rendered through K1
    cfg = train_config()
    train = coherent_subject(cfg, SUBJECT_FRAMES, t0=0)
    val = coherent_subject(cfg, SUBJECT_VAL_FRAMES, t0=SUBJECT_FRAMES)
    t = Trainer.from_checkpoint(ckpt_dir, train, val, device=DEVICE)
    fr.fused_render_fwd.launches = 0
    _, train_renders = train_r05.eval_split(t, train)
    _, val_renders = train_r05.eval_split(t, val)
    k1_renders = fr.fused_render_fwd.launches
    del t
    renders_s = time.perf_counter() - t_phase
    a_tr, b_tr = talking_signals(SUBJECT_FRAMES, t0=0)
    a_va, b_va = talking_signals(SUBJECT_VAL_FRAMES, t0=SUBJECT_FRAMES)
    renders = {"train_render": train_renders, "train_gt": train.arrays["images"],
               "train_mask": train.arrays["head_mask"], "val_render": val_renders,
               "val_gt": val.arrays["images"], "val_mask": val.arrays["head_mask"],
               "a_train": a_tr, "b_train": b_tr, "a_val": a_va, "b_val": b_va}
    data = vq_run.build_vq_data(renders, "train")
    vdata = vq_run.build_vq_data(renders, "val")
    vcfg = VQConfig(img_size=int(data["gen_img"].shape[1]))
    log(f"vq {at()}: the fit subject rendered its {SUBJECT_FRAMES} train and "
        f"{SUBJECT_VAL_FRAMES} val frames through K1 ({k1_renders} launches, expected "
        f"{(SUBJECT_FRAMES + SUBJECT_VAL_FRAMES) // 2}) in {renders_s:.1f} s (the trainer "
        f"rebuilt from the checkpoint included); VQ data {list(data['gen_img'].shape)}, "
        f"crops {list(data['crops'].shape)}; VQConfig defaults at img {vcfg.img_size}")
    if k1_renders != (SUBJECT_FRAMES + SUBJECT_VAL_FRAMES) // 2:
        raise AssertionError(f"vq renders: K1 launches {k1_renders}")

    # 2. one step on the card against the CPU, the same weights and batch
    dev = torch.device(DEVICE)
    init, train_step, _ = build_vq_step(vcfg, device=dev)
    batch = to_batch(data, dev, slice(0, VQ_BATCH))
    state = init(torch.Generator().manual_seed(seed), batch)
    ref_vq, ref_au = (copy.deepcopy(m).cpu() for m in (state.vq, state.au))
    with tf32_off() as tf32:
        loss_g, out_g, grads_g, _ = vq_step_on(state.vq, state.au, batch)
    t0 = time.perf_counter()
    loss_c, out_c, grads_c, mass_c = vq_step_on(ref_vq, ref_au,
                                                {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    idx_g, idx_c = out_g.indices.cpu(), out_c.indices
    same = idx_g == idx_c
    agree = float(same.float().mean())
    whole = same.all(dim=1)
    recon_err = (float((out_g.recon.detach().cpu()[whole] - out_c.recon.detach()[whole]).abs().max()
                       / out_c.recon.detach()[whole].abs().max()) if whole.any() else float("nan"))
    flipped_rows = torch.unique(torch.cat([idx_g[~same], idx_c[~same]]))
    errs = {}
    for k, gc in grads_c.items():
        if k in VQ_STEM_BIASES:   # held in f64 below
            continue
        gg, scale = grads_g[k].cpu(), gc.norm()
        if k == "vq.quantize.embedding" and len(flipped_rows):
            keep = torch.ones(len(gc), dtype=torch.bool)
            keep[flipped_rows] = False
            gg, gc, scale = gg[keep], gc[keep], gc[keep].norm()
        if k in mass_c:   # a sum that cancels: against the mass of its terms
            scale = mass_c[k].norm()
        errs[k] = float((gg - gc).norm() / scale.clamp_min(1e-30))
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"vq {at()} step, card vs CPU (f32; cuDNN and matmul TF32 off for this comparison, "
        f"{tf32[0]} and {tf32[1]} by default): loss {loss_g:.6f} vs {loss_c:.6f}, "
        f"rel {loss_rel:.2e} (tolerance {VQ_LOSS_RTOL:.0e}); image-code indices equal "
        f"{agree:.5f} (limit {VQ_INDEX_AGREE}), {int((~same).sum())} flipped of {same.numel()}, "
        f"codebook rows left out {len(flipped_rows)}; frames with every index equal "
        f"{int(whole.sum())} of {len(whole)}, their recon {recon_err:.2e} of max|ref| (tolerance "
        f"{VQ_RECON_RTOL:.0e}); gradient rel L2, worst leaves "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst)
        + f" (tolerance {VQ_GRAD_REL_L2:.0e}, {len(errs)} leaves); the CPU step {cpu_s:.1f} s")
    if not (loss_rel <= VQ_LOSS_RTOL and agree >= VQ_INDEX_AGREE
            and (not whole.any() or recon_err <= VQ_RECON_RTOL)
            and max(errs.values()) <= VQ_GRAD_REL_L2):
        raise AssertionError("vq: the step on the card disagrees with the CPU")

    # the stem's biases: the same step in f64 on both sides
    stem, agree64, stem64_s = vq_stem_f64((state.vq, state.au), (ref_vq, ref_au), batch,
                                          grads_g, grads_c)
    rel64 = ", ".join(f"{k} {v['f64_card_vs_cpu']:.2e}" for k, v in stem.items())
    log(f"vq {at()} the encoder stem's biases, the step in f64 on the card against f64 on the "
        f"CPU: relative L2 {rel64} (tolerance {VQ_GRAD_REL_L2:.0e}); image-code indices equal "
        f"{agree64:.5f}; against the CPU's f64 gradient: {json.dumps(stem)}; both f64 steps "
        f"{stem64_s:.1f} s")
    if not max(v["f64_card_vs_cpu"] for v in stem.values()) <= VQ_GRAD_REL_L2:
        raise AssertionError("vq: the stem biases' f64 gradient on the card disagrees with the CPU")
    del ref_vq, ref_au, grads_c, grads_g, out_g, out_c

    # 3. 200 steps on the card: every metric finite, rec_loss falling
    dev_data = to_batch(data, dev)
    order = torch.as_tensor(vq_run.orders(len(data["gen_img"]), VQ_BATCH, VQ_STEPS, seed),
                            device=dev)
    history = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, idx in enumerate(order):
        if i == VQ_TIMED_FROM:
            ev[0].record()
        state, m = train_step(state, {k: v[idx] for k, v in dev_data.items()})
        history.append(m)
    ev[1].record()
    ev[1].synchronize()
    steps_s = time.perf_counter() - t0
    ms_step = ev[0].elapsed_time(ev[1]) / (VQ_STEPS - VQ_TIMED_FROM)
    hist = {k: [float(h[k]) for h in history] for k in history[0]}
    finite = all(math.isfinite(v) for vals in hist.values() for v in vals)
    log(f"vq {at()}: {VQ_STEPS} steps in {steps_s:.1f} s; {ms_step:.2f} ms a step (CUDA "
        f"events, steps "
        f"{VQ_TIMED_FROM}-{VQ_STEPS}); rec_loss {hist['rec_loss'][0]:.5f} -> "
        f"{hist['rec_loss'][-1]:.5f}, quant_loss {hist['quant_loss'][0]:.4f} -> "
        f"{hist['quant_loss'][-1]:.4f}, au_loss {hist['au_loss'][0]:.4f} -> "
        f"{hist['au_loss'][-1]:.4f}, perplexity {hist['perplexity'][-1]:.1f}")
    if not finite or not hist["rec_loss"][-1] < hist["rec_loss"][0]:
        raise AssertionError("vq: a non-finite metric, or rec_loss did not fall")
    b = {k: v[:VQ_BATCH] for k, v in dev_data.items()}
    profile = profile_steps(lambda: train_step(state, b), steps=VQ_PROFILE_STEPS,
                            label="vq_profile", host_ops=False)

    # 4. the val split reconstructed (ms a frame), then the CLI round trip
    reconstruct_split(state.vq, state.au, vdata)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    rec_metrics = reconstruct_split(state.vq, state.au, vdata)
    ev[1].record()
    ev[1].synchronize()
    ms_frame = ev[0].elapsed_time(ev[1]) / len(vdata["gen_img"])
    log(f"vq {at()}: reconstruct_split of the {len(vdata['gen_img'])} val frames, "
        f"{ms_frame:.2f} ms a "
        f"frame (CUDA events; the host's copies included); rec_psnr {rec_metrics['rec_psnr']:.3f} "
        f"dB, rec_l1 {rec_metrics['rec_l1']:.5f} after {VQ_STEPS} steps")
    own_vq, own_au = state.vq, state.au   # the checkpoint's config and crop: reloaded below
    del state, dev_data
    split, vsplit = (os.path.join(workdir, n) for n in ("vq_train.npz", "vq_val.npz"))
    np.savez(split, **{k: data[k] for k in BATCH_KEYS})
    np.savez(vsplit, **{k: vdata[k] for k in BATCH_KEYS})
    ck, gen_plus = (os.path.join(workdir, n) for n in ("vq_ckpt", "gen+"))
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(gen_plus, ignore_errors=True)
    t0 = time.perf_counter()
    trec = cli.main(["train-vq", "--data", split, "--img-size", str(vcfg.img_size), "--epochs",
                     "1", "--batch-size", str(VQ_BATCH), "--seed", str(seed), "--ckpt-dir", ck,
                     "--device", DEVICE])
    erec = cli.main(["eval-vq", "--data", vsplit, "--ckpt", ck, "--out", gen_plus,
                     "--device", DEVICE])
    cli_s = time.perf_counter() - t0
    payload = load_checkpoint(ck, map_location="cpu")
    if VQConfig(**payload["config"]) != vcfg or payload["crop_size"] != data["crops"].shape[2]:
        raise AssertionError("vq: cli train-vq wrote another config than the phase's")
    own_vq.load_state_dict(payload["vq"])
    own_au.load_state_dict(payload["au"])
    own_metrics = reconstruct_split(own_vq, own_au, vdata)
    pngs = sorted(os.listdir(gen_plus))
    diffs = {k: abs(erec[k] - v) / max(abs(v), 1e-30) for k, v in own_metrics.items()}
    log(f"vq {at()}: cli train-vq (1 epoch, {len(data['gen_img']) // VQ_BATCH} steps, last "
        f"total_loss "
        f"{trec['total_loss']:.4f}) then cli eval-vq --ckpt: {len(pngs)} PNGs (expected "
        f"{len(vdata['gen_img'])}), rec_psnr {erec['rec_psnr']:.3f} dB, rec_l1 "
        f"{erec['rec_l1']:.5f}; against reconstruct_split in process on the checkpoint's state, "
        f"relative {diffs} (tolerance {VQ_CLI_RTOL:.0e}); both commands {cli_s:.1f} s")
    if len(pngs) != len(vdata["gen_img"]) or max(diffs.values()) > VQ_CLI_RTOL \
            or not all(map(math.isfinite, (erec["rec_psnr"], erec["rec_l1"], trec["total_loss"]))):
        raise AssertionError("vq: the CLI round trip")
    phase_s = time.perf_counter() - t_phase
    log(f"vq: phase {phase_s:.1f} s")
    return {"k1_renders": k1_renders, "step_parity": {
                "loss_rel": loss_rel, "index_agreement": agree, "flipped": int((~same).sum()),
                "recon_rel": recon_err, "grad_rel_l2_max": max(errs.values()),
                "worst": dict(worst), "cudnn_tf32_default": tf32[0], "stem_f64": stem},
            "steps": VQ_STEPS, "ms_per_step": ms_step, "rec_loss": [hist["rec_loss"][0],
                                                                    hist["rec_loss"][-1]],
            "profile": profile, "reconstruct_ms_per_frame": ms_frame,
            "reconstruct": rec_metrics, "cli": {"train_vq": trec, "eval_vq": {
                k: erec[k] for k in own_metrics}}, "phase_s": phase_s,
            "ckpt": ck, "train_frames": data["gen_img"]}


# ---- the audio-to-motion front ends: Standardized Space stage 2 (wav2vec2
# -> CodeTalker -> the frozen stage 1) and SadTalker's audio -> expression

# stage 2 over the `vq` phase's `cli train-vq` checkpoint (VQConfig
# defaults: 2,048 codes of 64 a 256^2 frame, V3 = 196,608), CodeTalker at
# its class defaults (feature 64, 4 heads, 1 layer, period 25, 8 subjects),
# wav2vec2-base seeded; the fit subject's renders are the motion frames
S2_PARITY_FRAMES = 4      # the card-vs-CPU step
S2_CLIP_FRAMES = 8        # the training clip
S2_STEPS = 50
S2_TIMED_FROM = 5
S2_PROFILE_STEPS = 5
S2_PREDICT_FRAMES = 16
# wav2vec2-base on the card against the CPU, f32 with TF32 off: the last
# layer's relative L2 (12 post-LN layers of f32 sums in other orders)
W2V_REL_L2 = 1e-3
# one stage-2 step on the card against the CPU (f32, TF32 off; the code
# head drawn nonzero for this check, since its zero init leaves every other
# leaf's gradient 0): the loss relative; at least S2_INDEX_AGREE of the
# predicted codes' indices equal (an argmin near a tie can flip); every
# CodeTalker leaf's gradient by relative L2. A leaf whose gradient is 0 in
# exact arithmetic (a key projection's bias: softmax is invariant to a
# shift of a row; the cross-attention's q and k: the vocaset mask leaves
# one key a row) is held under S2_ZERO_GRAD of the largest leaf's gradient
# norm on both sides instead
S2_LOSS_RTOL = 1e-3
S2_INDEX_AGREE = 0.99
S2_GRAD_REL_L2 = 1e-2
S2_ZERO_GRAD = 1e-4
S2_ZERO_GRAD_LEAVES = ("dec_0.self_k.bias", "dec_0.cross_q.weight", "dec_0.cross_q.bias",
                       "dec_0.cross_k.weight", "dec_0.cross_k.bias")
# `cli infer-stage2` against the in-process predict on the same card
S2_CLI_ATOL = 1e-6
# the coeff phase: SadTalker's netG (a single width) seeded, as a
# SadTalker-layout safetensors file; the CLI against the in-process
# Audio2Coeff (same card, same calls); the card against the CPU (TF32 off)
# within COEFF_RTOL of max|ref|; one audio2exp and one disexp step on the
# card against the CPU: the loss relative, each leaf's gradient by relative
# L2
COEFF_CLI_ATOL = 1e-6
COEFF_RTOL = 1e-4
COEFF_LOSS_RTOL = 1e-3
COEFF_GRAD_REL_L2 = 1e-2
COEFF_TEXT = "the quick brown fox jumps over the lazy dog"


def write_safetensors(path: str, tensors) -> None:
    """Write numpy arrays ({name: array}; floats, signed ints) as a
    safetensors file in name order, for the fixtures of `stage2` and
    `coeff` (the card's machine has no `safetensors` package):
    an 8-byte little-endian header length, the JSON header, then the raw
    little-endian bytes."""
    import struct

    import numpy as np

    names = {"f8": "F64", "f4": "F32", "f2": "F16", "i8": "I64", "i4": "I32"}
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        raw = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": names[a.dtype.str[1:]], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)      # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)


def write_hf_wav2vec2(enc, directory: str) -> None:
    """`enc` as a local HF `Wav2Vec2Model` directory (config.json +
    model.safetensors), the position conv weight-normed over dim 2 in the
    newer spelling: g = |w| over dims 0 and 1 at each tap, v = w."""
    import numpy as np

    from nerf3dtalker_tpu_torch.models.vq.wav2vec import HF_POS_CONV, hf_names

    c = enc.cfg
    sd = {k: v.detach().cpu().numpy() for k, v in enc.state_dict().items()}
    out = {hf: sd[port] for port, hf in hf_names(c).items()}
    w = sd["pos_conv.weight"]
    out[f"{HF_POS_CONV}.parametrizations.weight.original0"] = np.sqrt(
        (w.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True)).astype(np.float32)
    out[f"{HF_POS_CONV}.parametrizations.weight.original1"] = w
    os.makedirs(directory, exist_ok=True)
    write_safetensors(os.path.join(directory, "model.safetensors"), out)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"architectures": ["Wav2Vec2Model"], "conv_dim": list(c.conv_dim),
                   "conv_kernel": list(c.conv_kernel), "conv_stride": list(c.conv_stride),
                   "conv_bias": c.conv_bias, "hidden_size": c.hidden_size,
                   "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
                   "intermediate_size": c.intermediate_size,
                   "num_conv_pos_embeddings": c.num_conv_pos_embeddings,
                   "num_conv_pos_embedding_groups": c.num_conv_pos_embedding_groups,
                   "feat_extract_norm": "group", "do_stable_layer_norm": False}, f)


def grad_rel_l2(grads_g, grads_c, zero_leaves=()):
    """{leaf: relative L2 of the card's gradient against the CPU's}; a leaf
    of `zero_leaves` (0 in exact arithmetic) by the larger of its two norms
    over the largest leaf norm of the CPU's."""
    scale = max(float(g.norm()) for g in grads_c.values())
    errs = {}
    for k, gc in grads_c.items():
        gg = grads_g[k].cpu()
        errs[k] = (max(float(gg.norm()), float(gc.norm())) / scale if k in zero_leaves
                   else float((gg - gc).norm() / gc.norm().clamp_min(1e-30)))
    return errs


def phase_stage2(seed: int, workdir: str, vq_ckpt: str, frames):
    """The Standardized Space stage 2 on the `vq` phase's checkpoint:
    wav2vec2-base card vs CPU, one stage-2 step card vs CPU, 50 steps on the
    card (timed, profiled), `predict` of 16 frames (ms a frame), `cli
    infer-stage2` against the in-process predict, LVE / FDD. `frames` are
    the fit subject's train renders [N, 256, 256, 3]."""
    import copy
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import VQConfig
    from nerf3dtalker_tpu_torch.data.mel import read_wav_mono
    from nerf3dtalker_tpu_torch.models.vq import wav2vec as w2v
    from nerf3dtalker_tpu_torch.models.vq.stage1 import VQAutoEncoder
    from nerf3dtalker_tpu_torch.models.vq.stage2 import CodeTalker
    from nerf3dtalker_tpu_torch.train import stage2_trainer as s2t
    from nerf3dtalker_tpu_torch.train.vq_eval import eval_stage2, frame_vq_apply
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()

    def at():   # seconds into the phase
        return f"[{time.perf_counter() - t_phase:.1f} s]"

    dev = torch.device(DEVICE)
    T = S2_PREDICT_FRAMES
    wav_path = os.path.join(workdir, "stage2.wav")
    write_wav(wav_path, seed + 3, T)
    pcm, _ = read_wav_mono(wav_path)
    # normalized on the card, as `cli infer-stage2` normalizes it
    wav_g = w2v.normalize_wav(torch.as_tensor(pcm[None], dtype=torch.float32, device=dev))
    wav_c = wav_g.cpu()

    # 1. wav2vec2-base, seeded, on the card against the CPU
    enc_c = w2v.Wav2Vec2Encoder(device="cpu",
                                generator=torch.Generator().manual_seed(seed)).eval()
    enc_g = copy.deepcopy(enc_c).to(dev)
    with torch.no_grad(), tf32_off():
        h_c = enc_c(wav_c)
        h_g = enc_g(wav_g)
    w2v_rel = float((h_g.cpu() - h_c).norm() / h_c.norm())
    hf_dir = os.path.join(workdir, "wav2vec2_base_hf")
    write_hf_wav2vec2(enc_c, hf_dir)
    del enc_c, enc_g, h_c, h_g
    enc = w2v.load_hf_wav2vec2(hf_dir, dev)     # what `cli infer-stage2 --hf-wav2vec` loads
    with torch.no_grad():
        w2v_ms = cuda_ms(lambda: enc(wav_g), reps=5)
        states = enc(wav_g)                             # [1, S, 768] at 50 Hz
        feats = w2v.encode_audio(enc, wav_g, T)         # [1, T, 768]
    del enc
    log(f"stage2 {at()}: wav2vec2-base ({len(pcm)} samples -> {states.shape[1]} states) card "
        f"vs CPU, f32 with TF32 off: relative L2 {w2v_rel:.2e} at the last layer (tolerance "
        f"{W2V_REL_L2:.0e}); {w2v_ms:.2f} ms a call on the card (CUDA events)")
    if not w2v_rel <= W2V_REL_L2:
        raise AssertionError("stage2: wav2vec2 on the card disagrees with the CPU")

    # 2. one stage-2 step on the card against the CPU, the same weights and batch
    payload = load_checkpoint(vq_ckpt, map_location="cpu")
    vcfg = VQConfig(**payload["config"])
    vq_c = VQAutoEncoder(vcfg, device="cpu")
    vq_c.load_state_dict(payload["vq"])
    vq_g = copy.deepcopy(vq_c).to(dev)
    ap_c, ap_g = frame_vq_apply(vq_c), frame_vq_apply(vq_g)
    L, V3 = ap_g["codes_per_frame"], ap_g["vertice_dim"]
    s2cfg = dataclasses.replace(vcfg, face_quan_num=L)
    model_c = CodeTalker(s2cfg, vertice_dim=V3, device="cpu",
                         generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        model_c.feat_map.weight.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(seed))
    model_g = copy.deepcopy(model_c).to(dev)
    motion = torch.as_tensor(np.ascontiguousarray(frames[:S2_CLIP_FRAMES])).reshape(1, -1, V3)
    onehot = torch.nn.functional.one_hot(torch.tensor([0]), model_c.dims["n_subjects"]).float()
    batch_c = {"audio_feats": states.cpu(), "motion": motion[:, :S2_PARITY_FRAMES],
               "onehot": onehot}
    with tf32_off():
        loss_g, _, idx_g = s2t.stage2_step_loss(model_g, ap_g,
                                                {k: v.to(dev) for k, v in batch_c.items()})
        loss_g.backward()
    t0 = time.perf_counter()
    loss_c, _, idx_c = s2t.stage2_step_loss(model_c, ap_c, batch_c)
    loss_c.backward()
    cpu_s = time.perf_counter() - t0
    same = idx_g.cpu() == idx_c
    agree = float(same.float().mean())
    errs = grad_rel_l2({k: p.grad for k, p in model_g.named_parameters()},
                       {k: p.grad for k, p in model_c.named_parameters()}, S2_ZERO_GRAD_LEAVES)
    loss_g, loss_c = float(loss_g.detach()), float(loss_c.detach())
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    worst = dict(sorted(((k, v) for k, v in errs.items() if k not in S2_ZERO_GRAD_LEAVES),
                        key=lambda kv: -kv[1])[:4])
    zero = {k: errs[k] for k in S2_ZERO_GRAD_LEAVES}
    log(f"stage2 {at()}: one step ({S2_PARITY_FRAMES} frames, {L} codes a frame, V3 {V3}) card "
        f"vs CPU (f32, TF32 off): loss {loss_g:.6f} vs {loss_c:.6f}, rel "
        f"{loss_rel:.2e} (tolerance {S2_LOSS_RTOL:.0e}); code indices equal {agree:.5f} (limit "
        f"{S2_INDEX_AGREE}), {int((~same).sum())} flipped of {same.numel()}; gradient rel L2, "
        f"worst {json.dumps(worst)} (tolerance {S2_GRAD_REL_L2:.0e}, {len(errs)} leaves); "
        f"the zero-gradient leaves over the largest norm {json.dumps(zero)} (limit "
        f"{S2_ZERO_GRAD:.0e}); the CPU step {cpu_s:.1f} s")
    if not (loss_rel <= S2_LOSS_RTOL and agree >= S2_INDEX_AGREE
            and max(worst.values()) <= S2_GRAD_REL_L2 and max(zero.values()) <= S2_ZERO_GRAD):
        raise AssertionError("stage2: the step on the card disagrees with the CPU")
    del vq_c, ap_c, model_c, model_g, loss_g, loss_c

    # 3. 50 steps on the card from CodeTalker's own init (zero code head)
    init, train_step, predict = s2t.build_stage2_step(s2cfg, ap_g, V3, device=dev)
    state = init(torch.Generator().manual_seed(seed + 1), None)
    batch = {"audio_feats": states, "motion": motion.to(dev), "onehot": onehot.to(dev)}
    history = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(S2_STEPS):
        if i == S2_TIMED_FROM:
            ev[0].record()
        state, m = train_step(state, batch)
        history.append(m)
    ev[1].record()
    ev[1].synchronize()
    steps_s = time.perf_counter() - t0
    ms_step = ev[0].elapsed_time(ev[1]) / (S2_STEPS - S2_TIMED_FROM)
    hist = {k: [float(h[k]) for h in history] for k in history[0]}
    finite = all(math.isfinite(v) for vals in hist.values() for v in vals)
    log(f"stage2 {at()}: {S2_STEPS} steps on the {S2_CLIP_FRAMES}-frame clip in {steps_s:.1f} s; "
        f"{ms_step:.2f} ms a step (CUDA events, steps {S2_TIMED_FROM}-{S2_STEPS}); total_loss "
        f"{hist['total_loss'][0]:.5f} -> {hist['total_loss'][-1]:.5f} (loss_motion "
        f"{hist['loss_motion'][0]:.5f} -> {hist['loss_motion'][-1]:.5f}, loss_reg "
        f"{hist['loss_reg'][0]:.5f} -> {hist['loss_reg'][-1]:.5f})")
    if not finite or not hist["total_loss"][-1] < hist["total_loss"][0]:
        raise AssertionError("stage2: a non-finite loss, or the total loss did not fall")
    profile = profile_steps(lambda: train_step(state, batch), steps=S2_PROFILE_STEPS,
                            label="stage2_profile", host_ops=False)

    # 4. predict: T frames autoregressively
    model = state.model.eval()
    onehot_g = onehot.to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    pred = predict(model, feats, onehot_g, T)
    ev[1].record()
    ev[1].synchronize()
    ms_frame = ev[0].elapsed_time(ev[1]) / T
    pred = pred.cpu().numpy()
    log(f"stage2 {at()}: predict of {T} frames, {ms_frame:.2f} ms a frame (CUDA events; "
        f"CodeTalker over the {T}-frame buffer, quantize and one frame's decode a step); frames "
        f"finite {bool(np.isfinite(pred).all())}, range [{pred.min():.3f}, {pred.max():.3f}]")
    if pred.shape != (1, T, V3) or not np.isfinite(pred).all():
        raise AssertionError("stage2: predict")

    # 5. cli infer-stage2 on the checkpoints, against the in-process predict
    s2_ck = os.path.join(workdir, "stage2_ckpt")
    shutil.rmtree(s2_ck, ignore_errors=True)
    save_checkpoint(s2_ck, s2t.codetalker_payload(model), state.step)
    out = os.path.join(workdir, "stage2_frames.npy")
    t0 = time.perf_counter()
    rec = cli.main(["infer-stage2", "--wav", wav_path, "--frames", str(T), "--hf-wav2vec", hf_dir,
                    "--vq-ckpt", vq_ckpt, "--ckpt", s2_ck, "--device", DEVICE, "--out", out])
    cli_s = time.perf_counter() - t0
    got = np.load(out)
    diff = float(np.abs(got - pred).max())
    gt = np.asarray(frames[:T], np.float32).reshape(T, -1, 3)
    metrics = eval_stage2(predict, model, feats, onehot_g, T, verts_gt=gt,
                          template=gt.mean(0))
    log(f"stage2 {at()}: cli infer-stage2 --hf-wav2vec --vq-ckpt --ckpt: {rec['frames']} frames "
        f"of {rec['img_size']}^2 in {cli_s:.1f} s, finite {rec['finite']}; against the "
        f"in-process predict max_abs {diff:.3e} (tolerance {S2_CLI_ATOL:.0e}); LVE "
        f"{metrics['LVE']:.5f}, FDD {metrics['FDD']:.5f} (the predicted frames as {V3 // 3} "
        f"'vertices' against the subject's first {T} renders, template their mean)")
    if got.shape != (1, T, V3) or not rec["finite"] or diff > S2_CLI_ATOL:
        raise AssertionError("stage2: cli infer-stage2 disagrees with predict")
    phase_s = time.perf_counter() - t_phase
    log(f"stage2: phase {phase_s:.1f} s")
    return {"wav2vec2": {"rel_l2": w2v_rel, "ms": w2v_ms, "samples": len(pcm)},
            "step_parity": {"loss_rel": loss_rel, "index_agreement": agree,
                            "flipped": int((~same).sum()), "grad_rel_l2_worst": worst,
                            "zero_grad_leaves": zero},
            "steps": S2_STEPS, "ms_per_step": ms_step,
            "total_loss": [hist["total_loss"][0], hist["total_loss"][-1]],
            "profile": profile, "predict_ms_per_frame": ms_frame, "cli_s": cli_s,
            "cli_max_abs": diff, "LVE": metrics["LVE"], "FDD": metrics["FDD"],
            "phase_s": phase_s}


def coeff_step_grads(step, state, module, batch):
    """(loss, {leaf: gradient}) of one trainer step on `module`'s device;
    the gradients are those the step's optimizer used (read after it)."""
    state, m = step(state, batch)
    grads = {k: p.grad for k, p in module.named_parameters() if p.grad is not None}
    grads.update({k: b.grad for k, b in module.named_buffers() if b.grad is not None})
    return float(m["exp_loss"]), grads


def phase_coeff(seed: int, workdir: str, ckpt_dir: str, fitted: str):
    """SadTalker's audio -> expression path: a seeded netG as a SadTalker
    safetensors file, `cli infer-coeff` from a wav and from text against the
    in-process Audio2Coeff and the CPU, one audio2exp and one disexp step
    card vs CPU, and the expressions driving `animate_sequence(expr_seq=...)`
    of the fit subject (its K1 launches counted)."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
    from nerf3dtalker_tpu_torch.models.audio import SimpleWrapperV2
    from nerf3dtalker_tpu_torch.models.audio2coeff import Audio2Coeff
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.train import audio2exp_trainer, disexp_trainer
    from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
    from nerf3dtalker_tpu_torch.utils.camera import base_cam
    from nerf3dtalker_tpu_torch.utils.checkpoints import load_checkpoint

    t_phase = time.perf_counter()

    def at():
        return f"[{time.perf_counter() - t_phase:.1f} s]"

    dev = torch.device(DEVICE)
    # 1. a seeded netG in SadTalker's layout
    netg = SimpleWrapperV2(device="cpu", generator=torch.Generator().manual_seed(seed))
    st_path = os.path.join(workdir, "sadtalker_netg.safetensors")
    write_safetensors(st_path, {f"audio2exp.audio2exp_model.netG.{k}": v.numpy()
                                for k, v in netg.state_dict().items()})

    # 2. cli infer-coeff from a wav and from text
    wav = os.path.join(workdir, "coeff.wav")
    write_wav(wav, seed + 4, FRAMES)
    runs = {}
    t0 = time.perf_counter()
    for source, flags in (("wav", ["--wav", wav]), ("text", ["--text", COEFF_TEXT])):
        out = os.path.join(workdir, f"coeffs_{source}.npz")
        rec = cli.main(["infer-coeff", *flags, "--safetensors", st_path, "--seed", str(seed),
                        "--device", DEVICE, "--out", out])
        with np.load(out) as z:
            runs[source] = {k: z[k] for k in z.files}
        runs[source]["rec"] = rec
    cli_s = time.perf_counter() - t0
    a2c_g = Audio2Coeff.from_safetensors(st_path, dev)
    a2c_c = Audio2Coeff.from_safetensors(st_path, "cpu")
    cli_diff, cpu_rel = {}, {}
    for source, r in runs.items():
        ref_exp, zeros_pose = np.zeros(64, np.float32), np.zeros((len(r["mels"]), 6), np.float32)
        own = a2c_g.generate(r["mels"], ref_exp, r["ratios"], zeros_pose)
        cli_diff[source] = float(np.abs(own["exp"] - r["exp"]).max())
        with tf32_off():
            g = a2c_g.generate(r["mels"], ref_exp, r["ratios"])["exp"]
        c = a2c_c.generate(r["mels"], ref_exp, r["ratios"])["exp"]
        cpu_rel[source] = float(np.abs(g - c).max() / np.abs(c).max())
    ms_g = cuda_ms(lambda: a2c_g.generate(runs["text"]["mels"], np.zeros(64, np.float32),
                                          runs["text"]["ratios"]), reps=5)
    log(f"coeff {at()}: cli infer-coeff --wav ({len(runs['wav']['exp'])} frames) and --text "
        f"({len(runs['text']['exp'])} frames) in {cli_s:.1f} s; exp against the in-process "
        f"Audio2Coeff max_abs {json.dumps(cli_diff)} (tolerance {COEFF_CLI_ATOL:.0e}); the card "
        f"against the CPU (TF32 off) {json.dumps(cpu_rel)} of max|ref| (tolerance "
        f"{COEFF_RTOL:.0e}); generate of {len(runs['text']['exp'])} frames {ms_g:.2f} ms "
        f"(CUDA events, the host's copies included)")
    if max(cli_diff.values()) > COEFF_CLI_ATOL or max(cpu_rel.values()) > COEFF_RTOL \
            or any(r["exp"].shape != (len(r["mels"]), 64) for r in runs.values()):
        raise AssertionError("coeff: cli infer-coeff")

    # 3. one audio2exp and one disexp step on the card against the CPU
    T = len(runs["wav"]["mels"])
    rng = np.random.default_rng(seed)
    a2e = {"mels": np.stack([runs["wav"]["mels"]] * 2).astype(np.float32),
           "expr79": rng.standard_normal((2, T, 79)).astype(np.float32),
           "expr79_0": rng.standard_normal((2, 79)).astype(np.float32),
           "ratios": np.stack([runs["wav"]["ratios"][:, 0]] * 2).astype(np.float32)}
    dis = {"mels": runs["wav"]["mels"].astype(np.float32), "auds_exp": runs["wav"]["exp"],
           "sad_exp": rng.standard_normal((T, 64)).astype(np.float32)}
    checks = {}
    for name, builder, batch in (("audio2exp", audio2exp_trainer.build_audio2exp_step, a2e),
                                 ("disexp", disexp_trainer.build_disexp_step, dis)):
        # the same init on both: drawn on the CPU from the same seed
        res = {}
        init_c, step_c = builder(device="cpu")[:2]
        state_c = init_c(torch.Generator().manual_seed(seed), None)
        init_g, step_g = builder(device=dev)[:2]
        state_g = init_g(torch.Generator().manual_seed(seed), None)
        trained = (lambda s: s.netg) if name == "audio2exp" else (lambda s: s.fus)
        with tf32_off():
            res["g"] = coeff_step_grads(step_g, state_g, trained(state_g),
                                        {k: torch.as_tensor(v, device=dev)
                                         for k, v in batch.items()})
        res["c"] = coeff_step_grads(step_c, state_c, trained(state_c),
                                    {k: torch.as_tensor(v) for k, v in batch.items()})
        errs = grad_rel_l2(res["g"][1], res["c"][1])
        loss_rel = abs(res["g"][0] - res["c"][0]) / abs(res["c"][0])
        checks[name] = {"loss_rel": loss_rel, "leaves": len(errs),
                        "grad_rel_l2_max": max(errs.values()),
                        "worst": max(errs, key=errs.get)}
    log(f"coeff {at()}: one step card vs CPU (f32, TF32 off; the gradients each optimizer "
        f"used): {json.dumps(checks)} (loss tolerance {COEFF_LOSS_RTOL:.0e}, gradients "
        f"{COEFF_GRAD_REL_L2:.0e} relative L2)")
    if any(c["loss_rel"] > COEFF_LOSS_RTOL or c["grad_rel_l2_max"] > COEFF_GRAD_REL_L2
           for c in checks.values()):
        raise AssertionError("coeff: a trainer step on the card disagrees with the CPU")

    # 4. the expressions drive the fit subject through K1
    state = load_checkpoint(ckpt_dir, map_location="cpu")
    cfg = cli._nerf_config(argparse.Namespace(featmap_size=None, img_size=None), state)
    model, a2s = cli.build_models(cfg, seed, dev, state=state)
    del state
    shape_np, appea_np = cli._codes_from_latents(fitted)
    cam = base_cam(cfg.featmap_size)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    mels = per_frame_mel_chunks(*read_wav_mono(wav))
    styles = styles_from_mels(a2s, mels)
    exp = runs["wav"]["exp"]
    chunk = 4
    fr.fused_render_fwd.launches = 0
    frames = animate_sequence(model, shape_np, appea_np, styles, cam_d, expr_seq=exp,
                              chunk=chunk)
    k1 = fr.fused_render_fwd.launches
    base = animate_sequence(model, shape_np, appea_np, styles, cam_d, chunk=chunk)
    moved = float(np.abs(frames - base).mean())
    log(f"coeff {at()}: animate_sequence(expr_seq=exp) of the fit subject: {len(frames)} frames "
        f"{list(frames.shape[1:3])}, range [{frames.min():.3f}, {frames.max():.3f}], K1 launches "
        f"{k1} (expected {-(-len(exp) // chunk)}); mean |frames - frames without expr_seq| "
        f"{moved:.4f}")
    if frames.shape[0] != len(exp) or not np.isfinite(frames).all() or frames.min() < 0 \
            or frames.max() > 1 or k1 != -(-len(exp) // chunk):
        raise AssertionError("coeff: animate_sequence(expr_seq=...)")
    phase_s = time.perf_counter() - t_phase
    log(f"coeff: phase {phase_s:.1f} s")
    return {"cli_s": cli_s, "cli_max_abs": cli_diff, "cpu_rel": cpu_rel, "generate_ms": ms_g,
            "steps": checks, "k1_animate": k1, "expr_moved": moved, "phase_s": phase_s}


# the preprocess phase: 16 frames of 512^2 (Reso64's image size) and a
# 16-frame wav through `cli preprocess --strict --featmap-size 64`, then
# `cli train --data` on what it wrote (15 train frames: 7 steps of B=2, one
# validation frame)
PREP_FRAMES = 16
PREP_TRAIN_STEPS = (PREP_FRAMES - max(1, PREP_FRAMES // 10)) // 2
PREP_LIMIT_S = 45.0
# card against CPU (f32, TF32 off; BiSeNet B=2, FAN and ReconNet B=1, the
# CPU's forward being most of the check's time): network outputs by
# relative L2, the parsing argmax and the decoded landmarks by the share
# that agrees
PREP_NET_REL_L2 = 1e-4
PREP_ARGMAX_AGREE = 0.99
PREP_LM_AGREE = 0.95
# render_nl3dmm card against CPU: winners on >= 99.9 % of the pixels, the
# image by max|err| / max|ref|, the gradients by relative L2
PREP_FACE_AGREE = 0.999
PREP_IMAGE_RTOL = 1e-5
PREP_GRAD_REL_L2 = 1e-3
# the CLI's .npz against preprocess_subject in process (same card, seeds)
PREP_CLI_ATOL = 1e-6
# the full-size rasterizer: a 186 x 186 grid, 34,596 points and 68,450
# faces (the size class of the NL3DMM's 34,650 points), B=1 at 512^2
FULL_MESH_GRID = 186


def seeded_weights_(module, seed: int):
    """Every weight and buffer of `module` drawn from `seed` (fast, not the
    flax init): conv / linear weights N(0, 1/fan_in), BatchNorm weights
    1 + N(0, 0.1^2), running means N(0, 0.1^2), variances in [0.5, 1.5],
    other vectors N(0, 0.05^2)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            noise = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                v = torch.rand(t.shape, generator=g) + 0.5
            elif name.endswith("running_mean"):
                v = 0.1 * noise
            elif t.dim() > 1:
                v = noise / math.sqrt(t[0].numel())
            elif name.endswith("weight"):
                v = 1.0 + 0.1 * noise
            else:
                v = 0.05 * noise
            t.copy_(v.to(t.device))
    return module


def rel_l2(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def nl3dmm_on(G: int, seed: int, device):
    """(geo, tex) NL3DMM modules at a G x G mesh on `device`: the frontal
    grid as geo_fc3's bias, small seeded weights."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.models.face3d.nl3dmm import Linear3DMMTexture, NonLinear3DMM
    from nerf3dtalker_tpu_torch.utils.device import uninitialized

    geo = uninitialized(lambda d: NonLinear3DMM(point_num=G * G, device=d), device)
    tex = uninitialized(lambda d: Linear3DMMTexture(point_num=G * G, device=d), device)
    g = torch.Generator(device=device).manual_seed(seed)
    xs, ys = np.meshgrid(np.linspace(-0.5, 0.5, G), np.linspace(-0.5, 0.5, G))
    grid = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1).astype(np.float32)
    with torch.no_grad():
        geo.geo_fc2.weight.normal_(0.0, 179 ** -0.5, generator=g)
        geo.geo_fc2.bias.normal_(0.0, 0.05, generator=g)
        geo.geo_fc3.weight.normal_(0.0, 0.02 / 32, generator=g)
        geo.geo_fc3.bias.copy_(torch.as_tensor(grid))
        tex.b_tex.normal_(0.0, 0.01, generator=g)
        tex.mu_tex.uniform_(0.3, 0.7, generator=g)
        tex.sig_tex.uniform_(0.5, 1.5, generator=g)
    return geo.requires_grad_(False), tex.requires_grad_(False)


def nl3dmm_inmat(S: int, B: int, device):
    """`build_appliers`' intrinsics at S^2 (focal 1.2 S, the centre), B
    times."""
    import torch

    f = S * 1.2
    return torch.tensor([[[f, 0.0, S / 2], [0.0, f, S / 2], [0.0, 0.0, 1.0]]],
                        device=device).repeat(B, 1, 1)


def nl3dmm_grads(geo, tex, codes, faces, lm_index, S: int, weights):
    """(render, {leaf: gradient}) of sum(image * w_img) + sum(lm2d * w_lm)
    through render_nl3dmm, the gradients w.r.t. the four codes and the
    camera (Euler angles, translation)."""
    import torch

    from nerf3dtalker_tpu_torch.models.face3d.nl3dmm import render_nl3dmm
    from nerf3dtalker_tpu_torch.utils.rotations import euler_to_rmat

    dev = geo.geo_fc2.weight.device
    leaves = {k: v.to(dev).clone().requires_grad_(True) for k, v in codes.items()}
    inmat = nl3dmm_inmat(S, leaves["iden"].shape[0], dev)
    r = render_nl3dmm(geo, tex, leaves["iden"], leaves["expr"], leaves["text"],
                      leaves["gamma"], euler_to_rmat(leaves["euler"]), leaves["tvec"], inmat,
                      faces.to(dev), lm_index.to(dev), S, S)
    loss = (r.image * weights[0].to(dev)).sum() + (r.lm2d * weights[1].to(dev)).sum()
    return r, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def nl3dmm_codes(B: int, seed: int, tz: float = 5.0):
    import torch

    g = torch.Generator().manual_seed(seed)
    return {"iden": 0.3 * torch.randn(B, 100, generator=g),
            "expr": 0.3 * torch.randn(B, 79, generator=g),
            "text": 0.3 * torch.randn(B, 100, generator=g),
            "gamma": 0.2 * torch.randn(B, 27, generator=g),
            "euler": 0.3 * torch.rand(B, 3, generator=g) - 0.15,
            "tvec": torch.tensor([[0.0, 0.0, tz]]) + 0.4 * torch.rand(B, 3, generator=g) - 0.2}


def phase_preprocess(seed: int, workdir: str):
    """Subject preprocessing: the networks and the NL3DMM render on the card
    against the CPU; `cli preprocess --strict` on 16 frames of 512^2 against
    preprocess_subject in process (stage times, the fit's loss); `cli train
    --data` on its .npz through K1/K2; the full-size rasterizer's time and
    peak memory."""
    import shutil

    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.data.dataset import REQUIRED_KEYS, coherent_subject
    from nerf3dtalker_tpu_torch.data.mel import read_wav_mono
    from nerf3dtalker_tpu_torch.data.preprocess import (
        build_appliers,
        grid_mesh,
        linear_resize,
        preprocess_subject,
    )
    from nerf3dtalker_tpu_torch.models.bisenet import BiSeNet
    from nerf3dtalker_tpu_torch.models.face3d.rasterizer import (
        project_perspective,
        rasterize_mesh,
    )
    from nerf3dtalker_tpu_torch.models.fan import FAN, decode_heatmaps
    from nerf3dtalker_tpu_torch.models.resnets import ReconNet
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.train.trainer import Trainer
    from nerf3dtalker_tpu_torch.utils.device import uninitialized

    t_phase = time.perf_counter()

    def at():
        return f"[{time.perf_counter() - t_phase:.1f} s]"

    dev = torch.device(DEVICE)
    cfg = train_config()
    S = cfg.pred_img_size
    frames = coherent_subject(cfg, num_frames=PREP_FRAMES, seed=seed).arrays["images"]
    frames_path = os.path.join(workdir, "prep_frames.npy")
    np.save(frames_path, frames)
    wav = os.path.join(workdir, "prep.wav")
    write_wav(wav, seed + 5, PREP_FRAMES)

    # 1. the networks on the card against the CPU, the same weights
    x512 = torch.as_tensor(frames[:2]).permute(0, 3, 1, 2).contiguous()
    x256 = linear_resize(x512[:1], (256, 256))
    x224 = linear_resize(x512[:1], (224, 224))
    nets = {}
    for name, factory, x in (("bisenet_512", lambda d: BiSeNet(device=d), x512),
                             ("fan1_256", lambda d: FAN(n_stacks=1, device=d), x256),
                             ("fan4_256", lambda d: FAN(n_stacks=4, device=d), x256),
                             ("recon_224", lambda d: ReconNet(device=d), x224)):
        cpu = seeded_weights_(uninitialized(factory, "cpu"), seed + len(nets)).eval()
        card = uninitialized(factory, dev)
        card.load_state_dict(cpu.state_dict())
        card.eval()
        with torch.no_grad(), tf32_off():
            out_g = card(x.to(dev))
            out_c = cpu(x)
        out_g = out_g if isinstance(out_g, tuple) else (out_g,)
        out_c = out_c if isinstance(out_c, tuple) else (out_c,)
        rec = {"rel_l2": max(rel_l2(g, c) for g, c in zip(out_g, out_c))}
        if name.startswith("bisenet"):
            rec["argmax_agree"] = float((out_g[0].argmax(1).cpu() == out_c[0].argmax(1))
                                        .float().mean())
        if name.startswith("fan"):
            lg, lc = decode_heatmaps(out_g[0]).cpu(), decode_heatmaps(out_c[0])
            rec["landmarks_agree"] = float((lg == lc).all(-1).float().mean())
        nets[name] = rec
        del card, cpu
    log(f"preprocess {at()}: networks on the card against the CPU (f32, TF32 off, seeded "
        f"weights; BiSeNet B=2, FAN and ReconNet B=1): {json.dumps(nets)} (relative L2 "
        f"tolerance {PREP_NET_REL_L2:.0e}, argmax {PREP_ARGMAX_AGREE}, landmarks "
        f"{PREP_LM_AGREE})")
    if any(r["rel_l2"] > PREP_NET_REL_L2 or r.get("argmax_agree", 1) < PREP_ARGMAX_AGREE
           or r.get("landmarks_agree", 1) < PREP_LM_AGREE for r in nets.values()):
        raise AssertionError("preprocess: a network on the card disagrees with the CPU")

    # 2. render_nl3dmm at the 7 x 7 mesh, 512^2, B=4: card against CPU
    G, B = 7, 4
    faces, lm_index = grid_mesh(G), torch.arange(68) % (G * G)
    codes = nl3dmm_codes(B, seed)
    gw = torch.Generator().manual_seed(seed + 1)
    weights = (torch.randn(B, S, S, 3, generator=gw), torch.randn(B, 68, 2, generator=gw))
    geo_g, tex_g = nl3dmm_on(G, seed, dev)
    geo_c, tex_c = nl3dmm_on(G, seed, "cpu")
    geo_c.load_state_dict(geo_g.state_dict())
    tex_c.load_state_dict(tex_g.state_dict())
    with tf32_off():
        r_g, gr_g = nl3dmm_grads(geo_g, tex_g, codes, faces, lm_index, S, weights)
    r_c, gr_c = nl3dmm_grads(geo_c, tex_c, codes, faces, lm_index, S, weights)
    with torch.no_grad():      # the winners of each side's own vertices
        fi_g, fi_c = (rasterize_mesh(project_perspective(r.verts_cam, nl3dmm_inmat(S, B, dev_)),
                                     faces.to(dev_), S, S).face_idx.cpu()
                      for r, dev_ in ((r_g, dev), (r_c, "cpu")))
    render = {"face_idx_agree": float((fi_g == fi_c).float().mean()),
              "coverage": float(r_c.mask.mean()),
              "image_rel": float((r_g.image.detach().cpu() - r_c.image.detach()).abs().max()
                                 / r_c.image.detach().abs().max()),
              "lm2d_rel": float((r_g.lm2d.detach().cpu() - r_c.lm2d.detach()).abs().max()
                                 / r_c.lm2d.detach().abs().max()),
              "grad_rel_l2": {k: rel_l2(gr_g[k], gr_c[k]) for k in gr_c}}
    log(f"preprocess {at()}: render_nl3dmm {G}x{G} mesh, {S}^2, B={B}, card against CPU: "
        f"{json.dumps(render)} (winners {PREP_FACE_AGREE}, image {PREP_IMAGE_RTOL:.0e}, "
        f"gradients {PREP_GRAD_REL_L2:.0e} relative L2)")
    if render["face_idx_agree"] < PREP_FACE_AGREE or render["image_rel"] > PREP_IMAGE_RTOL \
            or max(render["grad_rel_l2"].values()) > PREP_GRAD_REL_L2 \
            or not 0 < render["coverage"] < 1:
        raise AssertionError("preprocess: render_nl3dmm on the card disagrees with the CPU")
    del geo_g, tex_g, geo_c, tex_c, r_g, r_c

    # 3. cli preprocess --strict, and the same run in process, its stages timed
    out = os.path.join(workdir, "prep_subject.npz")
    t0 = time.perf_counter()
    rec = cli.main(["preprocess", "--frames", frames_path, "--wav", wav, "--featmap-size",
                    str(cfg.featmap_size), "--seed", str(seed), "--strict", "--device", DEVICE,
                    "--out", out])
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    app = build_appliers(S, seed=seed, fit_iters=(10, 20), device=dev)
    build_s = time.perf_counter() - t0
    stage_ms, fits = {}, []

    def timed(name, fn, per):
        def run(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            y = fn(*args)
            b.record()
            b.synchronize()
            stage_ms[name] = a.elapsed_time(b) / per(y, *args)
            if name == "fit":
                fits.append((y, args))
            return y
        return run

    pcm, _ = read_wav_mono(wav)
    per_frame = lambda y, *a: len(a[0])   # noqa: E731
    arrays = preprocess_subject(
        frames, pcm, featmap_size=cfg.featmap_size, seed=seed, strict=True,
        bisenet_apply=timed("bisenet", app["bisenet_apply"], per_frame),
        fan_apply=timed("fan", app["fan_apply"], per_frame),
        netg_apply=timed("netg", app["netg_apply"], per_frame),
        fit3dmm_fn=timed("fit", app["fit3dmm_fn"], lambda y, *a: 30))
    fit, fit_args = fits[0]
    loss0 = app["fit3dmm_fn"](*fit_args, iters=(0, 0)).losses["total_loss"]
    with np.load(out) as z:
        cli_arrays = {k: z[k] for k in z.files}
    cli_diff = {k: float(np.abs(cli_arrays[k] - v).max()) for k, v in arrays.items()}
    checks = {"keys_missing": sorted(set(REQUIRED_KEYS) - set(cli_arrays)),
              "all_finite": all(bool(np.isfinite(v).all()) for v in cli_arrays.values()),
              "tvec_z": [float(v) for v in cli_arrays["Tvec"][:3, 2]],
              "audio_exp_max": float(np.abs(cli_arrays["audio_exp"]).max()),
              "fit_loss": [loss0, fit.losses["total_loss"]],
              "head_mask_mean": float(cli_arrays["head_mask"].mean()),
              "cli_max_abs": max(cli_diff.values()), "worst": max(cli_diff, key=cli_diff.get)}
    stages = {k + ("_ms_per_iteration" if k == "fit" else "_ms_per_frame"): v
              for k, v in stage_ms.items()}
    log(f"preprocess {at()}: cli preprocess --strict of {PREP_FRAMES} frames {S}^2 in "
        f"{cli_s:.1f} s (the networks' seeded init included); in process build_appliers "
        f"{build_s:.1f} s, stages (CUDA events, host copies included) {json.dumps(stages)}; "
        f"{json.dumps(checks)} (the CLI against the in-process run: tolerance "
        f"{PREP_CLI_ATOL:.0e})")
    if checks["keys_missing"] or not checks["all_finite"] \
            or np.allclose(cli_arrays["Tvec"][:, 2], 12.0) or checks["audio_exp_max"] == 0 \
            or not loss0 > fit.losses["total_loss"] or checks["cli_max_abs"] > PREP_CLI_ATOL \
            or len(cli_arrays["images"]) != PREP_FRAMES:
        raise AssertionError("preprocess: cli preprocess --strict")
    del app

    # 4. cli train --data on the subject: one K1 and one K2 a step
    ckpt_dir, log_dir = os.path.join(workdir, "prep_ckpt"), os.path.join(workdir, "prep_logs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(log_dir, ignore_errors=True)
    fr.fused_render_fwd.launches = 0
    fr.fused_render_bwd.launches = 0
    t0 = time.perf_counter()
    with trainers_built() as trainers:
        train_rec = cli.main(["train", "--data", out, "--featmap-size", str(cfg.featmap_size),
                              "--img-size", str(S), "--epochs", "1", "--batch-size", "2",
                              "--seed", str(seed), "--device", DEVICE, "--ckpt-dir", ckpt_dir,
                              "--log-dir", log_dir])
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    by_path, graphs_ok = trainer_launches(trainers)
    (k1_train, k2_train), (k1_val, k2_val) = by_path["train_steps"], by_path["validation"]
    k1_warm, k2_warm = by_path["graph_warmup"]
    losses = {k: train_rec[k] for k in ("bg_loss", "head_loss", "nonhead_loss", "vgg",
                                        "total_loss")}
    log(f"preprocess {at()}: cli train --data on the subject, 1 epoch in {train_s:.1f} s: "
        f"launches in the train steps K1 {k1_train}, K2 {k2_train} (expected "
        f"{PREP_TRAIN_STEPS} each, graph replays), before the graph's capture K1 {k1_warm}, "
        f"K2 {k2_warm}, in validation K1 {k1_val}, K2 {k2_val} (expected 1, 0); "
        f"{json.dumps(losses)}")
    if (k1_train, k2_train, k1_val, k2_val) != (PREP_TRAIN_STEPS, PREP_TRAIN_STEPS, 1, 0) \
            or not graphs_ok or (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches) \
            != (k1_train + k1_val + k1_warm, k2_train + k2_val + k2_warm) \
            or not all(map(math.isfinite, losses.values())) or train_rec["finite_step"] != 1.0:
        raise AssertionError("preprocess: cli train --data on the preprocessed subject")

    # 5. the full-size rasterizer: render_nl3dmm's forward and backward, B=1
    Gf = FULL_MESH_GRID
    geo, tex = nl3dmm_on(Gf, seed, dev)
    faces_f, lm_f = grid_mesh(Gf), torch.arange(68) % (Gf * Gf)
    codes_f = nl3dmm_codes(1, seed + 2, tz=2.5)
    gwf = torch.Generator().manual_seed(seed + 3)
    weights_f = (torch.randn(1, S, S, 3, generator=gwf), torch.randn(1, 68, 2, generator=gwf))
    run = lambda: nl3dmm_grads(geo, tex, codes_f, faces_f, lm_f, S, weights_f)  # noqa: E731
    r_full, _ = run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full_ms = cuda_ms(run, reps=1, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    full = {"points": Gf * Gf, "faces": len(faces_f), "image": S, "batch": 1,
            "ms_fwd_bwd": full_ms, "peak_bytes": peak, "peak_above_weights_bytes": peak - base,
            "coverage": float(r_full.mask.mean())}
    log(f"preprocess {at()}: full-size rasterizer (render_nl3dmm forward + backward to the "
        f"codes and the camera; plain PyTorch, chunk 512): {json.dumps(full)}")
    del geo, tex, r_full
    phase_s = time.perf_counter() - t_phase
    log(f"preprocess: phase {phase_s:.1f} s (limit {PREP_LIMIT_S:.0f} s)")
    if phase_s > PREP_LIMIT_S:
        raise AssertionError(f"preprocess: phase took {phase_s:.1f} s")
    return {"nets": nets, "render_7x7": render, "cli_s": cli_s, "build_s": build_s,
            "stage_ms": stage_ms, "checks": checks, "train_s": train_s,
            "k1_train": k1_train, "k2_train": k2_train, "k1_validation": k1_val,
            "k1_warmup": k1_warm, "k2_warmup": k2_warm, "full_rasterizer": full,
            "phase_s": phase_s}


def _train_setup(seed: int, use_fused: bool = True):
    """Step functions, a fresh state and one batch at Reso64 (B=2, VGG with
    precomputed target planes), as the trainer builds them."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.config import TrainConfig
    from nerf3dtalker_tpu_torch.data.dataset import synthetic_dataset
    from nerf3dtalker_tpu_torch.models.perceptual import load_vgg16
    from nerf3dtalker_tpu_torch.train.step import build_step_fns

    cfg, tc = train_config(), TrainConfig(seed=seed)
    vgg = load_vgg16(seed=0, device=DEVICE)
    data = synthetic_dataset(cfg, num_frames=2, seed=seed)
    data.precompute_gt_vgg(vgg, compute_dtype=torch.bfloat16)
    data.to_device(2, DEVICE)
    fns = build_step_fns(cfg, tc, steps_per_epoch=4, vgg=vgg, device=DEVICE,
                         use_fused=use_fused)
    return fns, fns.init(seed), data.device_batch(np.arange(2)), vgg


def phase_train_parity(seed: int):
    """One deterministic train step (no jitter, no dropout) through K1/K2
    against the plain path on the same weights and batch."""
    import torch

    fused_fns, fused_state, batch, _ = _train_setup(seed, use_fused=True)
    plain_fns, plain_state, _, _ = _train_setup(seed, use_fused=False)
    lf, gf = fused_fns.loss_and_grads(fused_state, batch)
    lp, gp = plain_fns.loss_and_grads(plain_state, batch)
    loss_f, loss_p = float(lf["total_loss"].detach()), float(lp["total_loss"].detach())
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    names = {"nerf": [n for n, p in fused_state.nerf.named_parameters() if p.requires_grad],
             "audio": [n for n, p in fused_state.audio.named_parameters() if p.requires_grad]}
    worst, worst_name, errs = 0.0, "", {}
    for group in ("nerf", "audio"):
        for name, a, b in zip(names[group], gf[group], gp[group]):
            if not torch.isfinite(a).all():
                raise AssertionError(f"train step: non-finite gradient {group}.{name}")
            rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
            errs[f"{group}.{name}"] = rel
            if rel > worst:
                worst, worst_name = rel, f"{group}.{name}"
    log(f"train step, kernels vs plain path: total loss {loss_f:.6f} vs "
        f"{loss_p:.6f} (rel {loss_rel:.2e}, tolerance {STEP_LOSS_RTOL:.0e}); "
        f"worst gradient leaf {worst_name} rel L2 {worst:.3e} (tolerance "
        f"{STEP_GRAD_REL_L2:.0e}); audio path: " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items() if k.startswith("audio.linear3")
            or k == "nerf.fg_CD_predictor.fea_0_kernel"))
    if loss_rel > STEP_LOSS_RTOL or worst > STEP_GRAD_REL_L2:
        raise AssertionError("the train step through the kernels disagrees with the plain path")
    return {"loss_rel": loss_rel, "worst_grad_rel_l2": worst, "worst_leaf": worst_name}


def phase_train_breakdown(seed: int):
    """Steady-state train step at Reso64 B=2 and its parts, CUDA events."""
    import torch

    from nerf3dtalker_tpu_torch.models.perceptual import vgg_perceptual_loss
    from nerf3dtalker_tpu_torch.models.phase_renderer import extract_phase_params
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.kernels.fused_upsampler import fused_upsampler
    from nerf3dtalker_tpu_torch.train.step import apply_update, assemble_codes
    from nerf3dtalker_tpu_torch.utils.guards import all_finite

    fns, state, batch, vgg = _train_setup(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    B, cfg = 2, state.nerf.cfg
    ms_step = cuda_ms(lambda: fns.train_step(state, batch, gen), reps=10, warmup=3)

    nerf, audio, nr = state.nerf, state.audio, state.nerf.neural_render
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    with torch.no_grad():
        style = audio(batch["mels"])
        shape_code, appea_code = assemble_codes(batch, batch["audio_exp"])
        noise = torch.rand(B, cfg.n_rays, cfg.num_sample_coarse + 1, generator=g, device=DEVICE)
        pe, zd, zv = rays_and_pe(batch["xy"], batch["Rmat"], batch["Tvec"], batch["inv_inmat"],
                                 noise)
        packed = fr.pack_weights(dict(nerf.fg_CD_predictor.named_parameters()), shape_code,
                                 appea_code, style)
        feat, bg_alpha, _ = fr.fused_render_fwd(pe, zd, zv, packed)
    gfeat = torch.randn(feat.shape, generator=g, device=DEVICE)
    gb = torch.randn(B, cfg.n_rays, generator=g, device=DEVICE)
    gd = torch.zeros(B, cfg.n_rays, device=DEVICE)   # the loss does not read depth
    S = cfg.featmap_size
    merge = (feat.reshape(B, S, S, cfg.featmap_nc) + bg_alpha.reshape(B, S, S, 1)
             * nr.bg_featmap).detach().requires_grad_()
    nr_params = list(nr.parameters())
    img = cfg.pred_img_size
    pred = torch.rand(B, img, img, 3, generator=g, device=DEVICE, requires_grad=True)
    planes = [batch[f"vgg_f{i}"] for i in range(4)]
    a_params = [p for p in audio.parameters() if p.requires_grad]
    grads = {k: [torch.zeros_like(p) for p in v] for k, v in state.params().items()}

    def decoder():
        loss = nr(merge).sum() + nr(nr.bg_featmap).sum()
        torch.autograd.grad(loss, [merge] + nr_params)

    def decoder_fused():    # through K5-fwd and K5-bwd
        pp = extract_phase_params(nr, 3)
        loss = (fused_upsampler(merge, pp, 3, torch.bfloat16).sum()
                + fused_upsampler(nr.bg_featmap, pp, 3, torch.bfloat16).sum())
        torch.autograd.grad(loss, [merge] + nr_params)

    def vgg_step():
        loss = vgg_perceptual_loss(vgg, pred, target_feats=planes, compute_dtype=torch.bfloat16)
        torch.autograd.grad(loss, [pred])

    def audio_step():
        torch.autograd.grad(audio(batch["mels"], g).sum(), a_params)

    def optimizer():
        apply_update(state, grads, all_finite(grads["nerf"] + grads["audio"]))

    with torch.no_grad():
        parts = {"K1 fused_render_fwd": cuda_ms(lambda: fr.fused_render_fwd(pe, zd, zv, packed),
                                                reps=5),
                 "K2 fused_render_bwd": cuda_ms(lambda: fr.fused_render_bwd(
                     pe, zd, zv, packed, gfeat, gb, gd, input_grads=False), reps=5)}
    parts["decoder_x2_fwd_bwd"] = cuda_ms(decoder, reps=5)
    parts["decoder_x2_fused_upsampler_fwd_bwd"] = cuda_ms(decoder_fused, reps=5)
    parts["vgg_fwd_bwd"] = cuda_ms(vgg_step, reps=5)
    parts["audio2style_fwd_bwd"] = cuda_ms(audio_step, reps=5)
    parts["adam_fused_two_groups"] = cuda_ms(optimizer, reps=5)
    rays_per_s = B * cfg.n_rays / (ms_step / 1e3)
    rec = {"batch": B, "ms_per_step": ms_step, "rays_per_s": rays_per_s, "parts_ms": parts,
           "parts_sum_ms": sum(parts.values()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("train_breakdown " + json.dumps(rec))
    rec["profile"] = profile_steps(lambda: fns.train_step(state, batch, gen), steps=3)
    return rec


# torch.profiler keeps a kernel only if its device timestamp, mapped onto
# the host's clock, falls inside the session's window, and on the card's
# machine that mapping strays by milliseconds up to 150 ms as a process
# ages: a short window then loses some or all of its kernels. Each session
# sleeps this long, the device idle, after it starts and before it stops
# (`nerf3dtalker_tpu_torch/scripts/profiler_window.py`: 3 matmuls, no
# padding, lost all from 50 s of age on; 0.3 s, most; 2 s kept all 3 at
# every age to 170 s). The measured windows lie inside.
PROFILE_PAD_S = 2.0


@contextlib.contextmanager
def padded_profile(activities):
    """A torch.profiler session over `activities` padded by PROFILE_PAD_S on
    each side."""
    import torch
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def device_ms_by_kernel(fn, calls: int, host_ops: bool = True):
    """(device ms by kernel name per call of fn over `calls` calls, the
    window's wall ms) from torch.profiler after one warm call; the kernel
    dict is empty when the profiler records no device time. `host_ops=False`
    records the device's activity alone (the VQ step's thousands of host
    ops a step take seconds to record and sort)."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with padded_profile(activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        # a user annotation on the device (the fused optimizer's step) spans
        # kernels that are counted themselves
        if us > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / calls
    return kernels, wall_ms


def profile_steps(step, steps: int, label: str = "train_profile", host_ops: bool = True):
    """Device time by kernel over `steps` steady steps (torch.profiler), and
    the device's busy share of the window's wall time. The profiler's own
    host overhead lengthens the window, so the idle share is an upper
    bound. Returns None when the profiler records no device time."""
    kernels, wall_ms = device_ms_by_kernel(step, steps, host_ops)
    if not kernels:
        log(f"{label}: the profiler recorded no device time (not measured)")
        return None
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    rec = {"steps": steps, "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy,
           "device_idle_share": max(0.0, 1.0 - busy * steps / wall_ms),
           "kernels_ms_per_step": {k[:90]: v for k, v in top}}
    log(f"{label} " + json.dumps(rec))
    return rec


# ---- the fused upsampler (K5)

def upsampler_weights(seed: int):
    """Block weight lists of a seeded Reso64 NeuralRenderer (nonzero
    biases) in the kernels' operand types, on the card."""
    import torch

    from nerf3dtalker_tpu_torch.models.neural_renderer import NeuralRenderer
    from nerf3dtalker_tpu_torch.models.phase_renderer import extract_phase_params
    from nerf3dtalker_tpu_torch.ops.kernels import fused_upsampler as fu

    g = torch.Generator().manual_seed(seed + 2)
    nr = NeuralRenderer(feat_nc=256, min_feat=32, featmap_size=64, img_size=512)
    nr.reset_parameters(g)
    with torch.no_grad():
        for name, p in nr.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=g)
    pp = {k: v.detach() for k, v in extract_phase_params(nr.to("cuda"), 3).items()}
    return [[(w.to(torch.bfloat16) if w.dim() == 2 else w.float()).contiguous()
             for w in fu.block_weight_list(pp, i)] for i in range(3)]


def upsampler_flops(i: int, B: int, C: int, Cn: int, backward: bool, hw: int = 64 * 64) -> float:
    """Operations of block i's products (2 per multiply-add) for B Reso64
    images: D1 and D2 on the level-i pixels, feat_layer and the rgb head on
    the level-(i+1) ones (and rgb_0 for block 0). The backward recomputes
    the three products, runs the input-gradient chain (g_up, g_h1, g_net,
    g_nn and g_rgb_0) and forms one weight gradient per weight and pixel.
    The stencils' few adds per element are not counted."""
    ni = B * 4 ** i * hw
    nf = 4 * ni
    dense = ni * (C * 2 * C + 2 * C * 4 * C) + nf * C * Cn
    heads = nf * Cn * 3 + (ni * C * 3 if i == 0 else 0)
    if not backward:
        return 2.0 * (dense + heads)
    chain = nf * Cn * C + ni * 4 * C * 2 * C + ni * 2 * C * C + heads
    return 2.0 * (dense + chain + dense + heads)


# K5-bwd's launches, by the names the profiler gives them: the recompute
# pass (the tile kernel in its backward mode), the chain pass, the X^T G
# core's two
K5B_PARTS = ("tile_kernel", "chain_kernel", "xtg_jobs_kernel", "xtg_reduce")
# the scratch of one K5-bwd launch at B=2 before this design (13 launches
# through a stash of 12 intermediates), GB, blocks 0..2
K5B_SCRATCH_13_LAUNCHES_GB = (0.133, 0.260, 0.516)


def device_launches_by_kernel(fn, calls: int):
    """{kernel name: (device ms, launches) per call of fn} over `calls`
    calls (torch.profiler, after one warm call); empty when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with padded_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            ms, n = out.get(e.key, (0.0, 0.0))
            out[e.key] = (ms + us / 1e3 / calls, n + e.count / calls)
    return out


def phase_upsampler_kernels(seed: int, ptxas):
    """K5-fwd and K5-bwd at each Reso64 decoder block, at the serving merge
    pass (B=4; forward only), the training merge pass (B=2) and the bg pass
    (B=1), held against the plain versions and timed; each block's input is
    the plain decoder's output of the block before, from a seeded featmap.
    Logs K5-fwd's design per block and batch (tiles, the persistent grid,
    tiles a block, the stream, registers and spills from the build log) and
    K5-bwd's launches timed apart by torch.profiler at B=2."""
    import torch

    from nerf3dtalker_tpu_torch.ops.kernels import fused_upsampler as fu

    wls = upsampler_weights(seed)
    g = torch.Generator().manual_seed(seed + 3)
    bf = torch.bfloat16
    net = torch.randn(4, 1, 64, 64, 256, generator=g).to("cuda", bf)
    rgb = torch.zeros(4, 1, 64, 64, 3, dtype=bf, device="cuda")
    ins = []
    with torch.no_grad():
        for i in range(3):
            ins.append((net, rgb))
            net, rgb = fu.reference_block_fwd(net, rgb, wls[i], i, bf)
    recs = {"fwd": {}, "bwd": {}}
    worst = {"fwd": 0.0, "bwd": 0.0}
    designs, parts, scratch_gb, fwd_device = {}, {}, {}, {}
    for B in (4, 2, 1):
        for i in range(3):
            C, Cn = fu.KERNEL_DIMS[i]
            net, rgb = (t[:B].contiguous() for t in ins[i])
            wl = wls[i]
            with torch.no_grad():
                out = fu.phase_block_fwd(net, rgb, wl, i)
                ref = fu.reference_block_fwd(net, rgb, wl, i, bf)
            torch.cuda.synchronize()
            for name, a, b in zip(("net_next", "rgb_next"), out, ref):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"fused_upsampler_fwd block {i} B={B}: non-finite {name}")
                err, peak = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
                worst["fwd"] = max(worst["fwd"], err)
                if not err <= UPS_RTOL * peak:
                    raise AssertionError(f"fused_upsampler_fwd block {i} B={B} {name}: max_abs_err "
                                         f"{err:.3e} over {UPS_RTOL:.0e} of max|ref| {peak:.3e}")
            with torch.no_grad():
                ms = cuda_ms(lambda: fu.phase_block_fwd(net, rgb, wl, i), reps=10)
                plain_ms = cuda_ms(lambda: fu.reference_block_fwd(net, rgb, wl, i, bf), reps=3,
                                   warmup=1)
            flops = upsampler_flops(i, B, C, Cn, False)
            nbytes = tensor_bytes(net, rgb if i else None, *wl, *out)
            bound_ms, bound_by = bound(flops, nbytes)
            recs["fwd"][(B, i)] = (ms, plain_ms, bound_ms, flops, nbytes)
            log(f"fused_upsampler_fwd block {i} ({C}->{Cn}) B={B}: {ms:.3f} ms (plain "
                f"{plain_ms:.3f} ms), bound {bound_ms:.3f} ms by {bound_by}; outputs within "
                f"{UPS_RTOL:.0e} of max|ref|")
            if B == 4:   # the serving pass: the kernel's device time apart from the wrapper's
                with torch.no_grad():
                    by_name = device_launches_by_kernel(
                        lambda: fu.phase_block_fwd(net, rgb, wl, i), calls=3)
                if not any("tile_kernel" in n for n in by_name):
                    raise AssertionError(f"fused_upsampler_fwd block {i}: torch.profiler recorded "
                                         f"no device time of the kernel")
                fwd_device[f"block{i}"] = round(sum(v[0] for n, v in by_name.items()
                                                    if "tile_kernel" in n), 4)
                log(f"fused_upsampler_fwd block {i} B=4 device ms (torch.profiler): "
                    + json.dumps({n[:50]: round(v[0], 4) for n, v in by_name.items()}))
            d = fu.fwd_design(B, 64, 64, i, C, Cn)
            # the instantiation this launch takes: a pair of blocks a tile (SPLIT) or one
            split = int(d["cluster_size"] == 2)
            regs, spill = ptxas_by_entry(ptxas["fused_upsampler_fwd"],
                                         f"tile_kernelILi{C}ELi{Cn}ELb0ELb{split}E")
            pairs = d["grid_blocks"] // d["cluster_size"]
            d.update(tiles_per_cluster=-(-d["tiles"] // pairs), registers=regs,
                     spill_store_bytes=spill)
            designs[f"B{B}_block{i}"] = d
            log(f"fused_upsampler_fwd design block {i} B={B}: {d['tiles']} tiles of 8x8 on "
                f"{d['grid_blocks']} persistent blocks ({d['resident_blocks']} resident, "
                f"{d['tiles_per_cluster']} tiles a cluster at most), cluster size "
                f"{d['cluster_size']}, "
                f"{d['chunks_per_tile']} stream chunks a tile ({d['stream_bytes']:,} B), "
                f"D2 chunks of {d['d2_channels_per_chunk']} channels, {d['smem_bytes']:,} B of "
                f"shared memory, {regs} registers a thread, {spill} B spilled")
            if B == 4:
                continue
            go = torch.Generator().manual_seed(seed + 10 * i + B)
            gn = torch.randn(out[0].shape, generator=go).to("cuda", bf)
            gr = torch.randn(out[1].shape, generator=go).to("cuda", bf)
            with torch.no_grad():
                kg = fu.phase_block_bwd(net, rgb, wl, i, gn, gr)
                rg = fu.reference_block_bwd(net, rgb, wl, i, gn, gr, bf)
            torch.cuda.synchronize()
            rel = float((kg[0] - rg[0]).norm() / rg[0].norm())
            rgb_err = float((kg[1] - rg[1]).abs().max())
            w_max, w_l2 = 0.0, 0.0
            for k, (a, b) in enumerate(zip(kg[2], rg[2])):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"fused_upsampler_bwd block {i} B={B}: non-finite "
                                         f"weight {k}")
                err, peak = float((a - b).abs().max()), float(b.abs().max())
                l2 = float((a - b).norm() / b.norm().clamp_min(1e-30))
                worst["bwd"] = max(worst["bwd"], err)
                w_max, w_l2 = max(w_max, err / peak), max(w_l2, l2)
                if not (err <= UPS_BWD_RTOL * peak and l2 <= UPS_BWD_REL_L2):
                    raise AssertionError(f"fused_upsampler_bwd block {i} B={B} weight {k}: "
                                         f"max_abs_err {err:.3e} (max|ref| {peak:.3e}), "
                                         f"rel L2 {l2:.3e}")
            if not (torch.isfinite(kg[0]).all() and rel <= UPS_GNET_REL_L2
                    and rgb_err <= UPS_GRGB_RTOL * float(rg[1].abs().max())):
                raise AssertionError(f"fused_upsampler_bwd block {i} B={B}: g_net rel L2 "
                                     f"{rel:.3e}, g_rgb max_abs_err {rgb_err:.3e}")
            with torch.no_grad():
                ms = cuda_ms(lambda: fu.phase_block_bwd(net, rgb, wl, i, gn, gr), reps=5)
                plain_ms = cuda_ms(lambda: fu.reference_block_bwd(net, rgb, wl, i, gn, gr, bf),
                                   reps=3, warmup=1)
            flops = upsampler_flops(i, B, C, Cn, True)
            nbytes = tensor_bytes(net, gn, gr, *wl, kg[0], kg[1] if i else None, *kg[2])
            bound_ms, bound_by = bound(flops, nbytes)
            recs["bwd"][(B, i)] = (ms, plain_ms, bound_ms, flops, nbytes)
            scratch_gb[f"B{B}_block{i}"] = fu.scratch_bytes(B, 64, 64, i, C, Cn) / 1e9
            if B == 2:   # the training merge pass: the backward's launches apart
                with torch.no_grad():
                    by_name = device_launches_by_kernel(
                        lambda: fu.phase_block_bwd(net, rgb, wl, i, gn, gr), calls=3)
                if not by_name:
                    raise AssertionError(f"fused_upsampler_bwd block {i}: torch.profiler recorded "
                                         f"no device time, so its launches are not counted")
                own = {part: [sum(v[k] for n, v in by_name.items() if part in n) for k in (0, 1)]
                       for part in K5B_PARTS}
                other = {n[:50]: round(v[0], 4) for n, v in by_name.items()
                         if not any(part in n for part in K5B_PARTS)}
                parts[f"block{i}"] = {part: round(v[0], 4) for part, v in own.items()}
                n_launch = sum(v[1] for v in own.values())
                log(f"fused_upsampler_bwd block {i} B=2 launches (torch.profiler, device ms per "
                    f"backward): " + (json.dumps(parts[f"block{i}"]) + f"; {n_launch:g} K5 launches "
                    f"a backward; the wrapper's PyTorch ops (stream gather, fills): "
                    + json.dumps(other)))
                if not 0 < n_launch <= 6:
                    raise AssertionError(f"fused_upsampler_bwd block {i}: {n_launch} launches")
            log(f"fused_upsampler_bwd block {i} ({C}->{Cn}) B={B}: {ms:.3f} ms (plain "
                f"{plain_ms:.3f} ms), bound {bound_ms:.3f} ms by {bound_by}; g_net rel L2 "
                f"{rel:.2e}, g_rgb max_abs_err {rgb_err:.1e}, weights worst max_err/max|ref| "
                f"{w_max:.2e}, worst rel L2 {w_l2:.2e}; scratch "
                f"{scratch_gb[f'B{B}_block{i}']:.3f} GB"
                + (f" (13-launch design: {K5B_SCRATCH_13_LAUNCHES_GB[i]:.3f} GB)" if B == 2 else ""))

    def entry(kind, B, name, line):
        blocks = [recs[kind][(B, i)] for i in range(3)]
        by_shape = {f"B{b}": [round(r[0], 4) for r in (recs[kind][(b, i)] for i in range(3))]
                    for b in sorted({k[0] for k in recs[kind]}, reverse=True)}
        return {"name": name, "route": "cuda",
                "source": f"nerf3dtalker_tpu_torch/csrc/{name}.cu",
                "replaces": f"nerf3dtalker_tpu/ops/pallas/fused_upsampler.py:{line}",
                "max_abs_err": worst[kind],
                # one decoder pass: the three block launches at B; the bound
                # is the sum of the blocks' bounds, named by the larger of
                # the pass's operations and bytes terms
                "ms": sum(r[0] for r in blocks), "plain_ms": sum(r[1] for r in blocks),
                "bound_ms": sum(r[2] for r in blocks),
                "bound_by": bound(sum(r[3] for r in blocks), sum(r[4] for r in blocks))[1],
                "library_ms": None,  # no PyTorch call computes an upsampler block
                "pass_batch": B, "ms_per_block_by_batch": by_shape}

    k5f = entry("fwd", 4, "fused_upsampler_fwd", 237)
    k5f.update(design=designs, device_ms_by_block_B4=fwd_device)
    k5b = entry("bwd", 2, "fused_upsampler_bwd", 295)
    k5b.update(parts_ms=parts or None, scratch_gb=scratch_gb)
    return k5f, k5b


def phase_serving_upsampler(seed: int, frames: int, workdir: str):
    """8 Reso64 frames through `animate_sequence` with the fused upsampler
    on (K1 + K5-fwd), counted, and held against the plain render path."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.data.mel import per_frame_mel_chunks, read_wav_mono
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.kernels import fused_upsampler as fu
    from nerf3dtalker_tpu_torch.train.animate import animate_sequence, styles_from_mels
    from nerf3dtalker_tpu_torch.utils.camera import base_cam

    chunk = 4
    wav = os.path.join(workdir, "speech_upsampler.wav")
    write_wav(wav, seed, frames)
    model, a2s = cli.build_models(reso64(), seed, torch.device("cuda"))
    model.use_fused_upsampler = True
    styles = styles_from_mels(a2s, per_frame_mel_chunks(*read_wav_mono(wav)))[:frames]
    cam = base_cam(64)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    codes = (np.zeros((1, 179), np.float32), np.zeros((1, 127), np.float32))
    animate_sequence(model, *codes, styles[:chunk], cam_d, chunk=chunk)      # warm-up: one chunk
    fr.fused_render_fwd.launches = 0
    fu.phase_block_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = animate_sequence(model, *codes, styles, cam_d, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k5 = fr.fused_render_fwd.launches, fu.phase_block_fwd.launches
    passes = 2 * -(-frames // chunk)
    log(f"serving, fused upsampler: {len(img)} frames, {wall * 1e3 / frames:.2f} ms/frame "
        f"(animate_sequence wall time); fused_render_fwd launches {k1} (expected "
        f"{passes // 2}), fused_upsampler_fwd launches {k5} (expected {3 * passes}: 3 blocks x "
        f"2 passes x {passes // 2} chunks)")
    if (k1, k5) != (passes // 2, 3 * passes):
        raise AssertionError(f"fused upsampler serving launched K1 {k1}, K5-fwd {k5}")
    if img.shape != (frames, 512, 512, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad frames: shape {img.shape}")
    model.use_fused = model.use_fused_upsampler = False
    plain = animate_sequence(model, *codes, styles, cam_d, chunk=chunk)
    diff = np.abs(plain - img)
    log(f"serving, fused upsampler vs plain render path, {frames} frames: max_abs "
        f"{diff.max():.3e} (tolerance {FRAME_MAX_ABS:.0e}), mean_abs {diff.mean():.3e} "
        f"(tolerance {FRAME_MEAN_ABS:.0e}); frame mean {img.mean():.4f}")
    if diff.max() > FRAME_MAX_ABS or diff.mean() > FRAME_MEAN_ABS:
        raise AssertionError("the fused upsampler serving path disagrees with the plain "
                             "render path")
    return {"k1": k1, "k5": k5, "ms_per_frame": wall * 1e3 / frames,
            "max_abs": float(diff.max()), "mean_abs": float(diff.mean())}


def phase_gradient_upsampler(seed: int):
    """One Reso64 B=2 gradient of the merge + bg MSE loss (the JAX test's
    loss) through K1/K2 and K5-fwd/K5-bwd, counted, against the plain
    autograd path on the same weights and inputs."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.kernels import fused_upsampler as fu

    B = 2
    model = HeadNeRF(reso64(), compute_dtype=torch.bfloat16, use_fused=True,
                     use_fused_upsampler=True, device="cuda",
                     generator=torch.Generator().manual_seed(seed))
    xy, Rm, Tv, iv = base_camera(B)
    rng = np.random.default_rng(seed)
    codes = [torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32) * 0.1, device="cuda")
             for n in (179, 127, 64)]
    names, leaves = zip(*model.named_parameters())

    def run():
        out = model(xy, *codes, Rm, Tv, iv)
        loss = ((out["merge_img"] - 0.4) ** 2).mean() + ((out["bg_img"] - 1.0) ** 2).mean()
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    counters = (fr.fused_render_fwd, fr.fused_render_bwd, fu.phase_block_fwd, fu.phase_block_bwd)
    for c in counters:
        c.launches = 0
    loss_f, grads_f = run()
    torch.cuda.synchronize()
    k1, k2, k5f, k5b = (c.launches for c in counters)
    log(f"gradient, fused upsampler (Reso64 B={B}, merge + bg MSE): launches K1 {k1}, K2 {k2}, "
        f"K5-fwd {k5f}, K5-bwd {k5b} (expected 1, 1, 6, 6)")
    if (k1, k2, k5f, k5b) != (1, 1, 6, 6):
        raise AssertionError(f"fused upsampler gradient launched K1 {k1}, K2 {k2}, K5-fwd {k5f}, "
                             f"K5-bwd {k5b}")
    model.use_fused = model.use_fused_upsampler = False
    loss_p, grads_p = run()
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    worst, worst_name, errs = 0.0, "", {}
    for name, a, b in zip(names, grads_f, grads_p):
        if not torch.isfinite(a).all():
            raise AssertionError(f"fused upsampler gradient: non-finite {name}")
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        errs[name] = rel
        if rel > worst:
            worst, worst_name = rel, name
    dec = {k: v for k, v in errs.items() if k.startswith("neural_render.")}
    log(f"gradient, kernels vs plain path: loss {loss_f:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, "
        f"tolerance {STEP_LOSS_RTOL:.0e}); worst leaf {worst_name} rel L2 {worst:.3e} (tolerance "
        f"{UPS_GRAD_REL_L2:.0e}); worst decoder leaf {max(dec, key=dec.get)} "
        f"{max(dec.values()):.3e}; fea_0_kernel {errs['fg_CD_predictor.fea_0_kernel']:.3e}")
    if loss_rel > STEP_LOSS_RTOL or worst > UPS_GRAD_REL_L2:
        raise AssertionError("the fused upsampler gradient disagrees with the plain autograd path")
    return {"k1": k1, "k2": k2, "k5f": k5f, "k5b": k5b, "loss_rel": loss_rel,
            "worst_grad_rel_l2": worst, "worst_leaf": worst_name}


def phase_breakdown(seed: int):
    """CUDA-event times of each stage of one Reso64 chunk (B=4)."""
    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.config import reso64
    from nerf3dtalker_tpu_torch.models.phase_renderer import extract_phase_params
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.ops.kernels.fused_upsampler import fused_upsampler

    cfg = reso64()
    dev = torch.device("cuda")
    model, a2s = cli.build_models(cfg, seed, dev)
    B = 4
    xy_b, Rm, Tv, iv = base_camera(B)
    codes = [torch.zeros(B, n, device=dev) for n in (179, 127)] + [torch.zeros(B, 64, device=dev)]
    mels = torch.randn(8, 80, 16, generator=torch.Generator().manual_seed(seed)).to(dev)
    st = {}
    with torch.no_grad():
        def rays_pe():
            st["in"] = rays_and_pe(xy_b, Rm, Tv, iv)

        def pack():
            st["w"] = fr.pack_weights(dict(model.fg_CD_predictor.named_parameters()), *codes)

        def pack_stream():   # K1's weight stream, as its wrapper lays it out every call
            if "w_bf16" not in st:
                st["w_bf16"] = {k: v.to(torch.bfloat16) for k, v in st["w"].items()}
            fr.pack_stream(st["w_bf16"])

        def kernel():
            st["out"] = fr.fused_render_fwd(*st["in"], st["w"])

        def merge_map():
            feat, bg_alpha, _ = st["out"]
            return (feat.reshape(B, 64, 64, 256) + bg_alpha.reshape(B, 64, 64, 1)
                    * model.neural_render.bg_featmap)

        def decoder():
            model.neural_render(merge_map())
            model.neural_render(model.neural_render.bg_featmap)

        def decoder_fused():    # the two passes of HeadNeRF(use_fused_upsampler=True)
            pp = extract_phase_params(model.neural_render, 3)
            fused_upsampler(merge_map(), pp, 3, torch.bfloat16)
            fused_upsampler(model.neural_render.bg_featmap, pp, 3, torch.bfloat16)

        def chunk():
            model(xy_b, codes[0], codes[1], codes[2], Rm, Tv, iv)

        times = {name: cuda_ms(fn, reps=5) for name, fn in
                 (("rays_pe", rays_pe), ("pack_weights", pack), ("pack_stream", pack_stream),
                  ("fused_render_fwd", kernel),
                  ("decoder_x2", decoder), ("decoder_x2_fused_upsampler", decoder_fused),
                  ("chunk_total", chunk),
                  ("audio2style_8_frames", lambda: a2s(mels)))}
    log("breakdown " + json.dumps({"chunk": B, "ms": times}))


# ---- the xᵀ·g probe

def graph_ms_per_call(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of fn with the host out of the way: `calls`
    calls captured in one CUDA graph, the median CUDA-event time of `reps`
    replays, divided by `calls`."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm outside the capture (build, attributes)
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps=reps) / calls


def phase_probe(seed: int):
    """The probe's four modes at N=1024, K=384, H=384 against their plain
    versions, each timed per call two ways (200 back-to-back eager calls,
    host included; 20 calls replayed from a CUDA graph, device only), beside
    `torch.matmul(x.T, g)` (bf16 out) and, where this torch has it,
    `torch.mm(x.T, g, out_dtype=torch.float32)`, the probe's own function."""
    import torch

    from nerf3dtalker_tpu_torch.ops.kernels import probe_xtg as px

    g = torch.Generator().manual_seed(seed + 20)
    bf = torch.bfloat16
    x = torch.randn(px.N, px.K, generator=g).to(DEVICE, bf)
    gg = torch.randn(px.N, px.H, generator=g).to(DEVICE, bf)
    w = (torch.randn(px.K, px.H, generator=g) * 0.05).to(DEVICE, bf)
    px.probe_xtg.launches = 0
    rec = {"ms_by_mode": {}, "graph_ms_by_mode": {}, "plain_ms_by_mode": {},
           "bound_ms_by_mode": {}, "err_by_mode": {}}
    worst = 0.0
    for mode in px.MODES:
        with torch.no_grad():
            out = px.probe_xtg(x, gg, w, mode)
            ref = px.reference_xtg(x, gg, w, mode)
        torch.cuda.synchronize()
        err, peak = float((out - ref).abs().max()), float(ref.abs().max())
        if not (torch.isfinite(out).all() and err <= PROBE_RTOL[mode] * peak):
            raise AssertionError(f"probe_xtg {mode}: max_abs_err {err:.3e} over "
                                 f"{PROBE_RTOL[mode]:.0e} of max|ref| {peak:.3e}")
        worst = max(worst, err)
        ms = cuda_ms_per_call(lambda: px.probe_xtg(x, gg, w, mode))
        graph_ms = graph_ms_per_call(lambda: px.probe_xtg(x, gg, w, mode))
        plain_ms = cuda_ms_per_call(lambda: px.reference_xtg(x, gg, w, mode), calls=20)
        flops = 2.0 * px.N * px.K * px.H * (1 if mode == "loaded" else 2)
        bound_ms, bound_by = bound(flops, tensor_bytes(x, gg, None if mode == "loaded" else w,
                                                       out))
        rec["ms_by_mode"][mode], rec["plain_ms_by_mode"][mode] = ms, plain_ms
        rec["graph_ms_by_mode"][mode] = graph_ms
        rec["bound_ms_by_mode"][mode], rec["err_by_mode"][mode] = bound_ms, err / peak
        log(f"probe_xtg {mode}: {ms * 1e3:.2f} us eager, {graph_ms * 1e3:.2f} us from a graph "
            f"(plain {plain_ms * 1e3:.2f} us), bound {bound_ms * 1e3:.3f} us by {bound_by}; "
            f"max_abs_err {err:.3e} = {err / peak:.2e} of max|ref| (tolerance "
            f"{PROBE_RTOL[mode]:.0e})")
    launches = px.probe_xtg.launches
    # `loaded` against torch.matmul in turns (probe, matmul, matmul, probe, twice), each way:
    # eager calls are host-bound, and the host's load moves during a run
    matmul = lambda: torch.matmul(x.T, gg)
    loaded = lambda: px.probe_xtg(x, gg, w, "loaded")
    turns = {"eager": ([], []), "graph": ([], [])}
    for _ in range(2):
        for fn, k in ((loaded, 0), (matmul, 1), (matmul, 1), (loaded, 0)):
            turns["eager"][k].append(cuda_ms_per_call(fn))
            turns["graph"][k].append(graph_ms_per_call(fn))
    rec["ms_by_mode"]["loaded"] = statistics.median(turns["eager"][0])
    rec["graph_ms_by_mode"]["loaded"] = statistics.median(turns["graph"][0])
    lib_ms, lib_graph_ms = (statistics.median(turns[k][1]) for k in ("eager", "graph"))
    try:   # bf16 in, f32 out: the probe's own function, where torch.mm takes out_dtype
        mm_f32 = lambda: torch.mm(x.T, gg, out_dtype=torch.float32)
        lib_f32 = mm_f32()
        lib_f32_ms, lib_f32_graph_ms = cuda_ms_per_call(mm_f32), graph_ms_per_call(mm_f32)
    except (TypeError, RuntimeError) as exc:
        lib_f32, lib_f32_ms, lib_f32_graph_ms = None, None, None
        log(f"probe_xtg: torch.mm(..., out_dtype=torch.float32) not available ({exc})")
    log(f"probe_xtg: torch.matmul(x.T, g) bf16 -> bf16 {lib_ms * 1e3:.2f} us eager, "
        f"{lib_graph_ms * 1e3:.2f} us from a graph (medians of 8 turns beside `loaded`)"
        + ("" if lib_f32 is None else f"; torch.mm(x.T, g, out_dtype=f32) {lib_f32_ms * 1e3:.2f} "
           f"us eager, {lib_f32_graph_ms * 1e3:.2f} us from a graph")
        + f"; loaded in the same turns {rec['ms_by_mode']['loaded'] * 1e3:.2f} us eager, "
        f"{rec['graph_ms_by_mode']['loaded'] * 1e3:.2f} us from a graph; launches {launches} "
        "(the probe is on no path of the system)")
    rec.update(library_eager_ms=lib_ms, library_graph_ms=lib_graph_ms,
               library_f32_eager_ms=lib_f32_ms, library_f32_graph_ms=lib_f32_graph_ms)
    loaded_bound, loaded_by = bound(2.0 * px.N * px.K * px.H, tensor_bytes(x, gg) + px.K * px.H * 4)
    return {"name": "probe_xtg", "route": "cuda",
            "source": "nerf3dtalker_tpu_torch/csrc/probe_xtg.cu",
            "replaces": "scripts/probe_mosaic_bf16T.py:57",
            "launches": launches,
            "launches_by_path": {"probe (on no path of the system)": launches},
            "max_abs_err": worst, "ms": rec["ms_by_mode"]["loaded"],
            "plain_ms": rec["plain_ms_by_mode"]["loaded"], "bound_ms": loaded_bound,
            "bound_by": loaded_by, "library_ms": lib_ms, **rec}


# ---- training on a (data, rays) mesh: K4

MESH_FRAMES = 8      # cli train's synthetic dataset: 4 steps of B=2 an epoch
MESH_VAL = 2         # validation frames: one batch of the data axis (2), a frame a rank


def phase_mesh_train(seed: int, workdir: str):
    """`cli train --data-parallel 2 --ray-parallel 2` at Reso64, B=2, VGG on,
    one epoch: 4 ranks share the card over gloo. Each rank counts its K1 and
    K2 launches around the trainer's own train steps and validation; the
    run reports them and whether every rank's params are bit-identical."""
    import shutil

    import torch

    from nerf3dtalker_tpu_torch import cli
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    ckpt_dir = os.path.join(workdir, "mesh_ckpt")
    log_dir = os.path.join(workdir, "mesh_logs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg = train_config()
    argv = ["train", "--featmap-size", str(cfg.featmap_size), "--img-size",
            str(cfg.pred_img_size), "--batch-size", "2", "--device", DEVICE, "--epochs", "1",
            "--seed", str(seed), "--ckpt-dir", ckpt_dir, "--log-dir", log_dir,
            "--data-parallel", "2", "--ray-parallel", "2"]
    for c in (fr.fused_render_fwd, fr.fused_render_bwd, fr.fused_render_spmd):
        c.launches = 0     # the ranks are new processes: theirs start at 0 too
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = cli.main(argv)
    wall = time.perf_counter() - t0
    steps = MESH_FRAMES // 2
    by_rank = rec["mesh"]["launches_by_rank"]
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".pt"))
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    log(f"mesh training: cli train 2 x 2 (4 ranks sharing one card over gloo), 1 epoch, {steps} "
        f"steps in {wall:.1f} s (whole cli call: spawning the ranks, data, VGG planes, model "
        f"build, steps, validation, checkpoint); {rec['sec_per_step'] * 1e3:.1f} ms/step on rank "
        f"0 (a functional figure of 4 ranks on one card, not a scaling one); launches per rank "
        f"[K1, K2 in the train steps; K1, K2 in validation] {by_rank} (expected "
        f"{[steps, steps, 1, 0]} each); params identical on every rank: "
        f"{rec['mesh']['params_identical']}; checkpoints {ckpts}")
    log("mesh training epoch " + json.dumps({k: rec[k] for k in (
        "total_loss", "vgg", "finite_step", "sec_per_step", "rays_per_s", "SSIM", "PSNR")}))
    if any(r != [steps, steps, 1, 0] for r in by_rank) or len(by_rank) != 4:
        raise AssertionError(f"mesh training launches by rank: {by_rank}")
    if not rec["mesh"]["params_identical"]:
        raise AssertionError("the ranks' params differ after the mesh epoch")
    if len(ckpts) != 1 or len(lines) != 1:
        raise AssertionError(f"mesh training wrote checkpoints {ckpts}, {len(lines)} metrics lines")
    losses = [rec[k] for k in ("bg_loss", "head_loss", "nonhead_loss", "vgg", "total_loss")]
    if not all(map(math.isfinite, losses)) or rec["finite_step"] != 1.0:
        raise AssertionError(f"mesh training epoch: {rec}")
    return {"launches_by_rank": by_rank, "wall_s": wall, "ms_per_step": rec["sec_per_step"] * 1e3}


def _parity_batch(seed: int):
    """The global Reso64 B=2 batch of `_train_setup` (with its VGG planes),
    on the host."""
    import numpy as np
    import torch

    from nerf3dtalker_tpu_torch.data.dataset import synthetic_dataset, to_tensors
    from nerf3dtalker_tpu_torch.models.perceptual import load_vgg16

    data = synthetic_dataset(train_config(), num_frames=2, seed=seed)
    data.precompute_gt_vgg(load_vgg16(seed=0, device=DEVICE), compute_dtype=torch.bfloat16)
    return to_tensors(data.batch(np.arange(2)), "cpu")


def _grad_errors(loss_ref: float, grads_ref, loss: float, grads, names):
    """(loss rel error, worst leaf rel L2, its name) of a step against the
    single-rank one."""
    import torch

    worst, worst_name = -1.0, ""
    for group in ("nerf", "audio"):
        for name, a, b in zip(names[group], grads[group], grads_ref[group]):
            a = a.to(b.device)
            if not torch.isfinite(a).all():
                raise AssertionError(f"mesh step: non-finite gradient {group}.{name}")
            rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
            if rel > worst:
                worst, worst_name = rel, f"{group}.{name}"
    return abs(loss - loss_ref) / abs(loss_ref), worst, worst_name


def phase_mesh_parity(seed: int, workdir: str):
    """One deterministic step on a 2 x 2 mesh (4 ranks) and on 1 x 2 and
    2 x 1 meshes (2 ranks), through K4, against the single-rank step through
    K3 on the same batch and weights (both from the seeded init)."""
    import dataclasses

    import torch

    from nerf3dtalker_tpu_torch.parallel import selfcheck

    batch = _parity_batch(seed)
    step = {"nerf_cfg": dataclasses.asdict(train_config()), "train_cfg": {"seed": seed},
            "seed": seed, "steps_per_epoch": 4, "vgg": True, "batch": batch, "save": True}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    waits = [selfcheck.start({"device": DEVICE, "meshes": [(2, 2)], "step": step}, 4,
                             os.path.join(workdir, "mesh_parity")),
             selfcheck.start({"device": DEVICE, "meshes": [(1, 2), (2, 1)], "step": step}, 2,
                             os.path.join(workdir, "mesh_parity"))]
    fns, state, local_batch, _ = _train_setup(seed, use_fused=True)
    lr, gr = fns.loss_and_grads(state, local_batch)
    loss_ref = float(lr["total_loss"].detach())
    names = {"nerf": [n for n, p in state.nerf.named_parameters() if p.requires_grad],
             "audio": [n for n, p in state.audio.named_parameters() if p.requires_grad]}
    results = {}    # mesh shape -> each rank's results
    for wait in waits:
        ranks = wait()
        for shape in ranks[0]:
            results[shape] = [r[shape] for r in ranks]
    log(f"mesh parity: ranks ran in {time.perf_counter() - t0:.1f} s (spawn, init, one step)")
    out = {}
    for shape in ((2, 2), (1, 2), (2, 1)):
        steps = [r["step"] for r in results[shape]]
        k4 = sum(s["launches"]["fused_render_spmd"] for s in steps)
        loss_rel, worst, worst_name = _grad_errors(loss_ref, gr, steps[0]["losses"]["total_loss"],
                                                   steps[0]["grads"], names)
        same = all(s["grads_identical"] for s in steps)
        log(f"mesh step {shape[0]} x {shape[1]} through K4 vs single-rank step through K3: "
            f"total loss {steps[0]['losses']['total_loss']:.6f} vs {loss_ref:.6f} (rel "
            f"{loss_rel:.2e}, tolerance {STEP_LOSS_RTOL:.0e}); worst gradient leaf {worst_name} "
            f"rel L2 {worst:.3e} (tolerance {STEP_GRAD_REL_L2:.0e}); launches per rank "
            f"{[s['launches'] for s in steps]}; gradients bit-identical on every rank: {same}")
        if any(s["launches"] != {"fused_render_fwd": 1, "fused_render_bwd": 1,
                                 "fused_render_spmd": 2} for s in steps):
            raise AssertionError(f"mesh step {shape} launches: {[s['launches'] for s in steps]}")
        if not same:
            raise AssertionError(f"mesh step {shape}: the ranks' gradients differ")
        if loss_rel > STEP_LOSS_RTOL or worst > STEP_GRAD_REL_L2:
            raise AssertionError(f"the {shape} mesh step disagrees with the single-rank step")
        out[f"{shape[0]}x{shape[1]}"] = {"loss_rel": loss_rel, "worst_grad_rel_l2": worst,
                                         "worst_leaf": worst_name, "k4_launches": k4}
    return out


def phase_mesh_nccl(seed: int, workdir: str):
    """A 1 x 1 mesh on NCCL in this process: the mesh step against the
    single-rank step (same weights and batch; the difference is the mesh
    path's own overhead), and K4 at the 2 x 2 shard shape [1, 2048] against
    its plain version, timed beside K1 and K2 alone."""
    import torch
    import torch.distributed as dist

    from nerf3dtalker_tpu_torch.config import TrainConfig
    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
    from nerf3dtalker_tpu_torch.parallel.mesh import init_ranks, make_mesh, shard_batch
    from nerf3dtalker_tpu_torch.train.step import build_step_fns

    store = os.path.join(workdir, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    init_ranks(0, 1, 0, 1, DEVICE, f"file://{store}")
    backend = dist.get_backend()
    try:
        mesh = make_mesh(1, 1, device=DEVICE if DEVICE == "cpu" else None)
        fns, state, batch, vgg = _train_setup(seed, use_fused=True)
        mfns = build_step_fns(state.nerf.cfg, TrainConfig(seed=seed), 4, vgg=vgg, mesh=mesh)
        mstate = mfns.init(seed)
        local = shard_batch(batch, mesh)
        counters = (fr.fused_render_fwd, fr.fused_render_bwd, fr.fused_render_spmd)
        for c in counters:
            c.launches = 0
        lm, gm = mfns.loss_and_grads(mstate, local)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        lr, gr = fns.loss_and_grads(state, batch)
        names = {"nerf": [n for n, p in state.nerf.named_parameters() if p.requires_grad],
                 "audio": [n for n, p in state.audio.named_parameters() if p.requires_grad]}
        loss_rel, worst, worst_name = _grad_errors(float(lr["total_loss"].detach()), gr,
                                                   float(lm["total_loss"].detach()), gm, names)
        if launches != [1, 1, 2] or loss_rel > STEP_LOSS_RTOL or worst > STEP_GRAD_REL_L2:
            raise AssertionError(f"1 x 1 {backend} mesh step: launches {launches}, loss rel "
                                 f"{loss_rel:.2e}, worst leaf {worst_name} {worst:.2e}")
        gen = torch.Generator(device=DEVICE)
        ms = {}
        for name in ("single", "mesh", "mesh", "single"):   # in turns
            f, st, b = (fns, state, batch) if name == "single" else (mfns, mstate, local)
            ms.setdefault(name, []).append(cuda_ms(
                lambda: f.train_step(st, b, gen.manual_seed(seed)), reps=5, warmup=1))
        single, meshed = statistics.median(ms["single"]), statistics.median(ms["mesh"])
        log(f"mesh 1 x 1 on {backend}: step within {worst:.2e} rel L2 of the single-rank step "
            f"(worst leaf {worst_name}), loss rel {loss_rel:.2e}; launches K1/K2/K4 {launches}; "
            f"train step {meshed:.2f} ms vs single-rank {single:.2f} ms (CUDA events, median of 5, "
            f"two turns each): the mesh path's own overhead {meshed - single:+.2f} ms")
        k4 = _k4_at_shard(seed, mesh)
        k4["launches_nccl_step"] = launches[2]
        return {"backend": backend, "ms_mesh_step": meshed, "ms_single_step": single,
                "overhead_ms": meshed - single, "worst_grad_rel_l2": worst,
                "loss_rel": loss_rel, "k4": k4}
    finally:
        dist.destroy_process_group()


def _k4_at_shard(seed: int, mesh):
    """K4 forward + backward on one rank's shard of the 2 x 2 layout at
    Reso64 B=2 ([1, 2048]), its plain version, and K1 / K2 alone there."""
    import torch

    from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

    pe, zd, zv, packed = fused_render_inputs(seed, B=1)
    pe, zd, zv = (t[:, :2048].contiguous() for t in (pe, zd, zv))
    B, R = pe.shape[:2]
    g = torch.Generator().manual_seed(seed + 7)
    feat = packed["wr2"].shape[1]
    cot = [torch.randn(*s, generator=g).to(DEVICE) for s in ((B, R, feat), (B, R), (B, R))]

    def run(fn):
        leaves = {k: v.detach().float().requires_grad_() for k, v in packed.items()}
        outs = fn(pe, zd, zv, leaves, mesh, torch.bfloat16)
        torch.autograd.backward(outs, cot)
        return outs, {k: v.grad for k, v in leaves.items()}

    outs, dw = run(fr.fused_render_spmd)
    routs, rdw = run(fr.reference_render_spmd)
    outs, routs = [o.detach() for o in outs], [o.detach() for o in routs]
    torch.cuda.synchronize()
    max_abs, worst_out, worst_dw = 0.0, 0.0, 0.0
    for name, a, b in zip(("feat", "bg_alpha", "depth"), outs, routs):
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        worst_out, max_abs = max(worst_out, err / peak), max(max_abs, err)
        if not (torch.isfinite(a).all() and err <= KERNEL_RTOL * peak):
            raise AssertionError(f"K4 {name} at [1, 2048]: max_abs_err {err:.3e}, max|ref| {peak:.3e}")
    for k in dw:
        err, peak = float((dw[k] - rdw[k]).abs().max()), float(rdw[k].abs().max())
        worst_dw, max_abs = max(worst_dw, err / peak), max(max_abs, err)
        if not (torch.isfinite(dw[k]).all() and err <= BWD_RTOL * peak):
            raise AssertionError(f"K4 d{k} at [1, 2048]: max_abs_err {err:.3e}, max|ref| {peak:.3e}")
    ms = cuda_ms(lambda: run(fr.fused_render_spmd), reps=5)
    plain_ms = cuda_ms(lambda: run(fr.reference_render_spmd), reps=3, warmup=1)
    with torch.no_grad():
        k1_ms = cuda_ms(lambda: fr.fused_render_fwd(pe, zd, zv, packed), reps=5)
        k2_ms = cuda_ms(lambda: fr.fused_render_bwd(pe, zd, zv, packed, *cot, input_grads=False),
                        reps=5)
    macs = mlp_macs(packed)
    chain = macs - packed["w0p"].numel() - packed["w5p"].numel()
    flops = 2.0 * B * R * pe.shape[2] * (macs + macs + macs + chain)   # fwd; recompute, dW, dX
    dw_bytes = sum(v.numel() * 4 for v in dw.values())
    nbytes = (tensor_bytes(pe, zd, zv, *packed.values(), *outs, *cot) + dw_bytes
              + 2 * dw_bytes)   # the gradients written, then read and written by the all-reduce
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"K4 fused_render_spmd at the 2 x 2 shard [1, 2048], 1 x 1 mesh: forward + backward "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms), bound {bound_ms:.3f} ms by {bound_by}; K1 "
        f"alone {k1_ms:.3f} ms, K2 alone {k2_ms:.3f} ms; outputs within {worst_out:.2e} of "
        f"max|ref| (tolerance {KERNEL_RTOL:.0e}), weight gradients within {worst_dw:.2e} "
        f"(tolerance {BWD_RTOL:.0e})")
    return {"name": "fused_render_spmd", "route": "cuda",
            "source": "nerf3dtalker_tpu_torch/ops/kernels/fused_render.py",
            "replaces": "nerf3dtalker_tpu/ops/pallas/fused_render.py:779",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,   # no PyTorch call computes the MLP render and its backward
            "shard": [B, R], "k1_ms_shard": k1_ms, "k2_ms_shard": k2_ms}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
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

    t_start = time.perf_counter()
    build_info = phase_build()
    k1 = phase_kernels(args.seed, build_info["ptxas"]["fused_render_fwd"])
    k2 = phase_kernel_bwd(args.seed)
    serving_launches, ms_per_frame = phase_serving(args.seed, FRAMES, workdir)
    train = phase_training(args.seed, workdir)
    parity = phase_train_parity(args.seed)
    step = phase_train_breakdown(args.seed)
    epochs = phase_epoch_program(args.seed, workdir)
    subject = phase_subject(args.seed, workdir)
    fit = phase_fit(args.seed, workdir)
    fit_ckpt, fitted = fit.pop("ckpt_dir"), fit.pop("fitted")
    vq = phase_vq(args.seed, workdir, fit_ckpt)
    stage2 = phase_stage2(args.seed, workdir, vq.pop("ckpt"), vq.pop("train_frames"))
    coeff = phase_coeff(args.seed, workdir, fit_ckpt, fitted)
    prep = phase_preprocess(args.seed, workdir)
    k5f, k5b = phase_upsampler_kernels(args.seed, build_info["ptxas"])
    ups_serving = phase_serving_upsampler(args.seed, FRAMES, workdir)
    ups_grad = phase_gradient_upsampler(args.seed)
    phase_breakdown(args.seed)
    probe = phase_probe(args.seed)
    mesh_train = phase_mesh_train(args.seed, workdir)
    mesh_parity = phase_mesh_parity(args.seed, workdir)
    nccl = phase_mesh_nccl(args.seed, workdir)
    k4 = nccl.pop("k4")
    # K4's launches (its K1 + K2 launches) by path: every rank's in the mesh
    # epoch (train steps and validation), the parity steps', the NCCL step's
    k4["launches_by_path"] = {
        "mesh_epoch_2x2": sum(sum(r) for r in mesh_train["launches_by_rank"]),
        **{f"parity_step_{k}": v["k4_launches"] for k, v in mesh_parity.items()},
        "nccl_step_1x1": k4.pop("launches_nccl_step")}
    k4["launches_by_rank_mesh_epoch"] = mesh_train["launches_by_rank"]
    k4["launches"] = sum(k4["launches_by_path"].values())
    # launches on the main paths, each path's counts set to 0 just before it
    # and read just after: K1 in serving, in training (train steps, then
    # validation renders), in serving and in the gradient with the fused
    # upsampler, in the subject's training and its serving; K2 in training,
    # in that gradient and in the subject's training; K5 on the fused two
    k1["launches_by_path"] = {"serving": serving_launches, "train_steps": train["k1_train"],
                              "train_graph_warmup": train["k1_warmup"],
                              "validation": train["k1_validation"],
                              "epoch_program": epochs["k1"],
                              "serving_fused_upsampler": ups_serving["k1"],
                              "gradient_fused_upsampler": ups_grad["k1"],
                              "subject_train_steps": subject["k1_train"],
                              "subject_graph_warmup": subject["k1_warmup"],
                              "subject_validation": subject["k1_validation"],
                              "subject_animate": subject["k1_animate"],
                              "fit": fit["k1_fit"], "render": fit["k1_render"],
                              "fit_animate": fit["k1_animate"], "vq_renders": vq["k1_renders"],
                              "coeff_animate": coeff["k1_animate"],
                              "preprocessed_train_steps": prep["k1_train"],
                              "preprocessed_graph_warmup": prep["k1_warmup"],
                              "preprocessed_validation": prep["k1_validation"]}
    k2["launches_by_path"] = {"train_steps": train["k2"],
                              "train_graph_warmup": train["k2_warmup"],
                              "epoch_program": epochs["k2"],
                              "gradient_fused_upsampler": ups_grad["k2"],
                              "subject_train_steps": subject["k2"],
                              "subject_graph_warmup": subject["k2_warmup"], "fit": fit["k2_fit"],
                              "preprocessed_train_steps": prep["k2_train"],
                              "preprocessed_graph_warmup": prep["k2_warmup"]}
    # K2 at the fit's shape (B=1, input_grads=True): its launches on the fit
    # path all have input gradients
    bd = fit["breakdown"]
    k2["fit_b1_input_grads"] = {"ms": bd["ms"]["K2 fused_render_bwd B=1 input_grads"],
                                "parts_ms_per_launch": bd["k2_parts_ms"],
                                "parts_in_fit_ms": bd.get("k2_parts_in_fit_ms"),
                                "plain_ms": bd["k2_plain_ms"],
                                "bound_ms": bd["k2_bound_ms"], "bound_by": bd["k2_bound_by"]}
    k1["ms_fit_b1"] = bd["ms"]["K1 fused_render_fwd B=1"]
    k5f["launches_by_path"] = {"serving_fused_upsampler": ups_serving["k5"],
                               "gradient_fused_upsampler": ups_grad["k5f"]}
    k5b["launches_by_path"] = {"gradient_fused_upsampler": ups_grad["k5b"]}
    for k in (k1, k2, k5f, k5b):
        k["launches"] = sum(k["launches_by_path"].values())
    log(json.dumps({"serving": {"frames": FRAMES, "ms_per_frame": ms_per_frame},
                    "fused_upsampler": {"serving": ups_serving, "gradient": ups_grad},
                    "training": {"steps": train["steps"], "ms_per_step": step["ms_per_step"],
                                 "rays_per_s": step["rays_per_s"], "parity": parity,
                                 "graph": train["graph"]},
                    "epoch_program": epochs,
                    "subject": subject, "fit": fit, "vq": vq, "stage2": stage2,
                    "coeff": coeff, "preprocess": prep,
                    "mesh": {"epoch_2x2": mesh_train, "parity": mesh_parity, "nccl_1x1": nccl},
                    "build_s": build_info["build_s"], "nvcc": build_info["nvcc"]}))
    log(f"smoke: every phase in {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(json.dumps({"kernels": [k1, k2, k5f, k5b, k4, probe]}))
    log(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
