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

Not ported yet: hierarchical sampling, gaze and view-direction conditioning
(the constructor raises on them).
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
from nerf3dtalker_tpu_torch.ops.rays import gen_rays, sample_points, stratified_zvals
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
        if cfg.include_vd or cfg.hier_sampling or cfg.include_gaze:
            raise NotImplementedError(
                "hierarchical sampling, gaze and view-direction conditioning "
                "are not ported yet")
        if mesh is not None and (not use_fused or use_fused_upsampler):
            raise ValueError("the mesh path renders through K4 (use_fused=True) and the "
                             "plain decoder (use_fused_upsampler=False), as in the JAX package")
        self.mesh = mesh
        self.cfg, self.compute_dtype, self.use_fused = cfg, compute_dtype, use_fused
        self.use_fused_upsampler = use_fused_upsampler
        self.fg_CD_predictor = NeRFMLP(
            vp_channels=cfg.vp_channels, vd_channels=cfg.vd_channels,
            audio_channels=cfg.audio_style_dims, hidden=cfg.mlp_hidden,
            out_features=cfg.featmap_nc, compute_dtype=compute_dtype)
        self.neural_render = NeuralRenderer(
            feat_nc=cfg.featmap_nc, out_dim=3, final_actvn=True, min_feat=32,
            featmap_size=cfg.featmap_size, img_size=cfg.pred_img_size,
            bg_type=cfg.bg_type, compute_dtype=compute_dtype)
        self.fg_CD_predictor.reset_parameters(generator)
        self.neural_render.reset_parameters(generator)
        self.to(dev)

    def _fused_ok(self, device: torch.device) -> bool:
        """The kernel's gate. The CPU's plain version takes any dims; on the
        GPU a config at other dims than the kernel's raises."""
        cfg = self.cfg
        if not self.use_fused or device.type == "cpu":
            return self.use_fused
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
    ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S = batch_xy.shape[0], cfg.featmap_size   # B: this rank's frames under a mesh
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
            pe = positional_encoding(sp.pts, cfg.vp_n_freqs, cfg.vp_include_input)
            feat, density = self.fg_CD_predictor(pe, shape_code, appea_code, audio_style)
            comp = alpha_composite(feat, density[..., 0], sp.z_dists, sp.zvals)
        return self._render_maps(comp, B, S)

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
