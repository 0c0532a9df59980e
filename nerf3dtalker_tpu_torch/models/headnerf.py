"""The audio-conditioned HeadNeRF model (port of
`nerf3dtalker_tpu/models/headnerf.py`, reference `HeadNeRFNet`,
NetWorks/HeadNeRFNet.py:10-207).

rays -> stratified samples -> positional encoding -> point MLP -> alpha
composite to a `[B, S, S, feat_nc]` feature map -> neural-render upsampling,
with the background as `fg_feat + bg_alpha * bg_featmap`. With `use_fused`
the PE + MLP + composite go through `ops.kernels.fused_render.fused_render`:
the forward kernel, and under autograd one backward-kernel launch per
forward. With `use_fused_upsampler` the decoder runs phase-stacked through
`ops.kernels.fused_upsampler` (one forward-kernel launch per upsampler block
and pass, one backward-kernel launch each under autograd), when the image
is 2, 4 or 8 times the featmap; off by default, as in the JAX package. The
CUDA kernels are compiled for the flagship dims: on the GPU another config
raises, on the CPU the kernels' plain versions take any dims.
Training passes the stratified jitter as `noise`, drawn from the caller's
generator.

With a `mesh` (`parallel.mesh`, JAX's `fused_mesh`) the batch is this
rank's shard: its frames and its band of rays. Rays, PE and the render run
on the ray shard through K4 (`fused_render_spmd`: K1/K2 on the card, their
plain versions on the CPU); feat, bg_alpha and depth are then gathered over
the rays group (`gather_rays`), and the decoder runs on the whole
[B/D, S, S, C] map, replicated over the rays group.

The reference's three options run on the plain path, as in the JAX package
(its `_fused_ok` sends them there): `include_gaze` appends the gaze (or
zeros) to the shape code, `include_vd` feeds the PE of the ray directions to
rgb_1, and `hier_sampling` adds a second MLP (`fine_fg_CD_predictor`) over
the coarse pass's importance samples (`ops.rays.fine_zvals`) and returns its
image as `fine_merge_img`. The kernels have none of them: on the CPU
`use_fused` with an option takes the plain path, as in JAX; on the GPU it
raises, so that no plain path runs unasked on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.models.nerf_mlp import NeRFMLP
from nerf3dtalker_tpu_torch.models.neural_renderer import NeuralRenderer
from nerf3dtalker_tpu_torch.models.phase_renderer import extract_phase_params
from nerf3dtalker_tpu_torch.ops.compositing import CompositeResult, alpha_composite
from nerf3dtalker_tpu_torch.ops.embedding import positional_encoding, positional_encoding_rays
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
from nerf3dtalker_tpu_torch.ops.kernels.fused_upsampler import fused_upsampler
from nerf3dtalker_tpu_torch.ops.rays import (SamplePoints, fine_zvals, gen_rays, sample_points,
                                             stratified_zvals)
from nerf3dtalker_tpu_torch.parallel.mesh import Mesh, gather_rays
from nerf3dtalker_tpu_torch.utils.device import resolve_device


class HeadNeRF(nn.Module):
    def __init__(self, cfg: NeRFConfig, compute_dtype: torch.dtype = torch.float32,
                 use_fused: bool = False, use_fused_upsampler: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        """Parameters are initialized on the CPU from `generator` (a CPU
        `torch.Generator`; None draws from the global RNG) and then moved to
        `device` (default `cuda`)."""
        super().__init__()
        dev = resolve_device(device)
        if mesh is not None and (not use_fused or use_fused_upsampler or options(cfg)):
            raise ValueError("the mesh path renders through K4 (use_fused=True, no option) and "
                             "the plain decoder (use_fused_upsampler=False), as in the JAX "
                             "package")
        self.mesh = mesh
        self.cfg, self.compute_dtype, self.use_fused = cfg, compute_dtype, use_fused
        self.use_fused_upsampler = use_fused_upsampler
        if use_fused:
            self._refuse_options(dev)

        def mlp():
            return NeRFMLP(vp_channels=cfg.vp_channels, vd_channels=cfg.vd_channels,
                           audio_channels=cfg.audio_style_dims, hidden=cfg.mlp_hidden,
                           out_features=cfg.featmap_nc, compute_dtype=compute_dtype)

        self.fg_CD_predictor = mlp()
        self.fine_fg_CD_predictor = mlp() if cfg.hier_sampling else None
        self.neural_render = NeuralRenderer(
            feat_nc=cfg.featmap_nc, out_dim=3, final_actvn=True, min_feat=32,
            featmap_size=cfg.featmap_size, img_size=cfg.pred_img_size,
            bg_type=cfg.bg_type, compute_dtype=compute_dtype)
        self.fg_CD_predictor.reset_parameters(generator)
        if self.fine_fg_CD_predictor is not None:
            self.fine_fg_CD_predictor.reset_parameters(generator)
        self.neural_render.reset_parameters(generator)
        self.to(dev)

    def _refuse_options(self, device: torch.device) -> None:
        """The kernels have no option: on the GPU `use_fused` with one raises."""
        on = options(self.cfg)
        if on and device.type != "cpu":
            raise ValueError(f"use_fused on {device}: the fused render kernels have no "
                             f"{', '.join(on)}; build this model with use_fused=False")

    def _fused_ok(self, device: torch.device) -> bool:
        """The kernel's gate. On the CPU an option sends the render to the
        plain path (JAX's `_fused_ok`), and the kernel's plain version takes
        any dims; on the GPU an option or other dims than the kernel's
        raise."""
        cfg = self.cfg
        if not self.use_fused:
            return False
        self._refuse_options(device)
        if device.type == "cpu":
            return not options(cfg)
        dims = (cfg.mlp_hidden, cfg.featmap_nc, cfg.num_sample_coarse, cfg.vp_pe_dims)
        if dims != (fr.H, fr.FEAT, fr.NS, 63):
            raise ValueError(
                f"use_fused on {device}: the kernel is compiled for mlp_hidden={fr.H}, "
                f"featmap_nc={fr.FEAT}, num_sample_coarse={fr.NS}, vp_pe_dims=63; "
                f"this config has {dims}")
        return True

    @property
    def _fusedup_ok(self) -> bool:
        """The phase-stacked decoder needs an image 2, 4 or 8 times the
        featmap; otherwise the plain decoder runs, as in the JAX package."""
        cfg = self.cfg
        ratio = cfg.pred_img_size // cfg.featmap_size
        return (self.use_fused_upsampler and cfg.pred_img_size == ratio * cfg.featmap_size
                and ratio in (2, 4, 8))

    def forward(
        self,
        batch_xy: torch.Tensor,      # [B, N_r, 2] pixel coords
        shape_code: torch.Tensor,    # [B, 179] iden|expr
        appea_code: torch.Tensor,    # [B, 127] text|illu
        audio_style: torch.Tensor,   # [B, 64]
        Rmat: torch.Tensor,          # [B, 3, 3]
        Tvec: torch.Tensor,          # [B, 3] or [B, 3, 1]
        inv_inmat: torch.Tensor,     # [B, 3, 3]
        noise: Optional[torch.Tensor] = None,   # [B, N_r, N_s+1] stratified jitter
        gaze: Optional[torch.Tensor] = None,    # [B, eye_gaze_dim] with include_gaze
        fine_u: Optional[torch.Tensor] = None,  # [B, N_r, num_sample_fine+1] uniform draws
    ) -> Dict[str, torch.Tensor]:
        """Without `gaze` a gaze model takes zeros (HeadNeRFNet.py:51-52);
        without `fine_u` the fine samples are deterministic."""
        cfg = self.cfg
        B, S = batch_xy.shape[0], cfg.featmap_size   # B: this rank's frames under a mesh
        if cfg.include_gaze:
            g = gaze if gaze is not None else shape_code.new_zeros((B, cfg.eye_gaze_dim))
            shape_code = torch.cat([shape_code, g.to(shape_code.dtype)], dim=-1)
        rays = gen_rays(batch_xy, Rmat, Tvec, inv_inmat)
        zb = stratified_zvals(rays, cfg.num_sample_coarse, cfg.world_z1, cfg.world_z2, noise)
        sp = sample_points(rays, zb)
        if self._fused_ok(batch_xy.device):
            pe = positional_encoding_rays(
                rays.origins, rays.directions, rays.lengths, sp.zvals,
                cfg.vp_n_freqs, cfg.vp_include_input, pad_to=fr.pe_pad_for(cfg.vp_pe_dims))
            packed = fr.pack_weights(dict(self.fg_CD_predictor.named_parameters()), shape_code,
                                     appea_code, audio_style)
            cdt = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else torch.float32
            args = (pe.contiguous(), sp.z_dists.contiguous(), sp.zvals.contiguous(), packed)
            if self.mesh is None:
                feat, bg_alpha, depth = fr.fused_render(*args, cdt)
            else:   # one gather of the three maps over the rays group
                feat, bg_alpha, depth = fr.fused_render_spmd(*args, self.mesh, cdt)
                maps = gather_rays(torch.cat([feat, bg_alpha[..., None], depth[..., None]], -1),
                                   self.mesh)
                feat, bg_alpha, depth = maps[..., :-2], maps[..., -2], maps[..., -1]
            comp = CompositeResult(feat, bg_alpha, depth, None)
        else:
            comp = self._plain_composite(self.fg_CD_predictor, sp, shape_code, appea_code,
                                         audio_style)
        out = self._render_maps(comp, B, S)
        if cfg.hier_sampling:
            fz = fine_zvals(comp.weights, sp.zvals, cfg.num_sample_fine + 1, fine_u)
            fcomp = self._plain_composite(self.fine_fg_CD_predictor, sample_points(rays, fz),
                                          shape_code, appea_code, audio_style)
            out["fine_merge_img"] = self._render_maps(fcomp, B, S)["merge_img"]
        return out

    def _plain_composite(self, mlp: NeRFMLP, sp: SamplePoints, shape_code, appea_code,
                         audio_style) -> CompositeResult:
        """PE (and, with include_vd, the view-direction PE), the MLP and the
        composite of a set of sample points, in PyTorch ops."""
        cfg = self.cfg
        pe = positional_encoding(sp.pts, cfg.vp_n_freqs, cfg.vp_include_input)
        vd_pe = (positional_encoding(sp.dirs, cfg.vd_n_freqs, cfg.vd_include_input)
                 if cfg.include_vd else None)
        feat, density = mlp(pe, shape_code, appea_code, audio_style, vd_pe)
        return alpha_composite(feat, density[..., 0], sp.z_dists, sp.zvals)

    def _render_maps(self, comp: CompositeResult, B: int, S: int) -> Dict[str, torch.Tensor]:
        """Merge with the bg featmap and decode; two decoder passes (merge,
        bg), through the fused upsampler when it is on, as in the JAX
        package."""
        fg = comp.features.reshape(B, S, S, self.cfg.featmap_nc)
        bg_alpha = comp.bg_alpha.reshape(B, S, S, 1)
        bg_featmap = self.neural_render.bg_featmap
        merge = fg + bg_alpha * bg_featmap
        if self._fusedup_ok:
            n_blocks = self.cfg.n_upsample_blocks
            pp = extract_phase_params(self.neural_render, n_blocks)

            def decode(x):
                return fused_upsampler(x, pp, n_blocks, self.compute_dtype)
        else:
            decode = self.neural_render
        return {
            "merge_img": decode(merge),                    # [B, img, img, 3]
            "bg_img": decode(bg_featmap),                  # [1, img, img, 3]
            "bg_alpha": bg_alpha,
            "depth": comp.depth.reshape(B, S, S),
        }


def options(cfg: NeRFConfig) -> list:
    """The names of the reference options that `cfg` turns on."""
    return [name for name in ("include_gaze", "include_vd", "hier_sampling")
            if getattr(cfg, name)]


def build_code_and_cam(
    base_iden: torch.Tensor,     # [B, 100]
    base_expr: torch.Tensor,     # [B, 79]
    base_text: torch.Tensor,     # [B, 100]
    base_illu: torch.Tensor,     # [B, 27]
    audio_exp: Optional[torch.Tensor] = None,   # [B, 64] SadTalker exp
):
    """Shape/appearance codes; the audio expression overwrites the first 64
    expr dims (reference talker_trainer.py:853)."""
    if audio_exp is not None:
        base_expr = torch.cat([audio_exp, base_expr[:, 64:]], dim=-1)
    shape_code = torch.cat([base_iden, base_expr], dim=-1)
    appea_code = torch.cat([base_text, base_illu], dim=-1)
    return shape_code, appea_code
