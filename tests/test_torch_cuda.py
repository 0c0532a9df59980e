"""Tests of the port's CUDA kernels on the card. They import no JAX (the
GPU machine has none) and skip without CUDA; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

`--noconftest` skips `tests/conftest.py`, which sets up JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from nerf3dtalker_tpu_torch.config import reso64
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.models.nerf_mlp import NeRFMLP
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
from nerf3dtalker_tpu_torch.ops.kernels import fused_upsampler as fu
from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

# bf16 tolerance: max abs error over each output's own max|ref|. Both
# versions round to bf16 at the same places; a different f32 summation order
# can flip one rounding (2^-8 relative), which propagates through the later
# layers
RTOL = 5e-3
# the backward kernel against its plain version. Both recompute the forward
# with f32 sums in another order; a pre-activation within rounding of 0 then
# lands on the other side of a ReLU, and a flipped mask passes or stops a
# whole gradient element, which the chain carries to every lower layer of
# that point. Summed over the points, the weight and bias gradients stay
# within BWD_RTOL of their own max|ref|; at R=64 fewer points average the
# flips out than on the main path (w0p, the bottom of the chain, was 1.3e-2
# off here). d_zd and d_zv come from the composite alone. d_pe is per
# point, so one flip can move a point's d_pe by its own size: it is held by
# relative L2 error, and the chain itself by the stash test below
BWD_RTOL = 2e-2
D_PE_REL_L2 = 5e-2
# K3 against autograd through the plain forward, both bf16: relative L2
# error of each gradient leaf. Autograd rounds the gradient activations at
# the same casts as K2 (bf16 at every activation), but the two forwards sum
# in another order, so the ReLU mask flips of BWD_RTOL reach every leaf.
# (Held against an f32 forward, this test measured 9.7e-2 on fea_0_kernel:
# bf16 rounding through eight layers, which a bf16 reference shares.)
GRAD_REL_L2 = 3e-2
# the fused upsampler kernels (K5) against their plain versions, bf16. Both
# round to bf16 after every product + bias and every elementwise op; a
# different f32 summation order can flip one rounding (2^-8 of the
# element), which later layers carry: outputs within UPS_RTOL of their own
# max|ref| (measured up to 4.7e-3 on the card). Backward: the two recompute
# the forward with f32 sums in another order, and a pre-activation within
# rounding of 0 that lands on the other side of a leaky ReLU scales a
# gradient element by 0.2 instead of 1. In a weight gradient that moves one
# column by 0.8 |h g| of that pixel: at this test's 3,072 level-1 pixels
# one flip was 2.46e-2 of dw2's max|ref| (0.55 of the error in that one
# column), while the relative L2 error stayed at 2.1e-3. So weight and bias
# gradients are held by max error over max|ref| within UPS_BWD_RTOL and by
# relative L2 within UPS_BWD_REL_L2; g_net is per pixel, held by relative
# L2; g_rgb comes from the linear stencils alone, in f32 and in the same
# order on both sides (measured exact).
UPS_RTOL = 1e-2
UPS_BWD_RTOL = 5e-2
UPS_BWD_REL_L2 = 1e-2
UPS_GNET_REL_L2 = 2e-2
UPS_GRGB_RTOL = 1e-5
# HeadNeRF with K1 + K5 against the plain path (NeRFMLP + composite, the
# NeuralRenderer decoder, which rounds each product to bf16 before its
# bias, where the kernels keep f32): images in [0, 1] within UPS_IMG_ABS;
# every gradient leaf within UPS_HEAD_GRAD_REL_L2 relative L2 (the ReLU and
# leaky-ReLU flips of both kernels reach every leaf)
UPS_IMG_ABS = 5e-2
UPS_HEAD_GRAD_REL_L2 = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_inputs(dev, B=2, R=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    mlp = NeRFMLP(63 + 179, 127, hidden=fr.H, out_features=fr.FEAT)
    mlp.reset_parameters(g)
    with torch.no_grad():   # nonzero biases (the init's are zero), so each is checked
        for name, p in mlp.named_parameters():
            if name.endswith("_bias"):
                p.normal_(0.0, 0.1, generator=g)
    mlp = mlp.to(dev)
    codes = [(torch.randn(B, n, generator=g) * 0.3).to(dev) for n in (179, 127, 64)]
    with torch.no_grad():
        packed = fr.pack_weights(dict(mlp.named_parameters()), *codes)
    pe = torch.randn(B, R, fr.NS, fr.PE_PAD, generator=g)
    pe[..., 63:] = 0
    zd = torch.rand(B, R, fr.NS, generator=g) * 0.1
    zv = torch.sort(torch.randn(B, R, fr.NS, generator=g), -1).values
    return pe.to(dev), zd.to(dev), zv.to(dev), packed


@pytest.mark.cuda
def test_kernel_matches_plain_version(cuda):
    pe, zd, zv, packed = _kernel_inputs(cuda)
    before = fr.fused_render_fwd.launches
    with torch.no_grad():
        out = fr.fused_render_fwd(pe, zd, zv, packed)
        ref = fr.reference_render(pe, zd, zv, packed, torch.bfloat16)
    torch.cuda.synchronize()
    assert fr.fused_render_fwd.launches == before + 1
    _check_fwd(out, ref)


def _check_fwd(out, ref):
    for name, a, b in zip(("feat", "bg_alpha", "depth"), out, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        assert err <= RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,R", [(1, 33), (3, 5), (1, 1), (1, 2048)],
                         ids=["odd_1x33", "3x5", "one_ray", "k4_shard_1x2048"])
def test_kernel_matches_plain_version_at_other_shapes(cuda, B, R):
    """K1 where a block's second ray is absent (33 and 15 rays: a block
    takes two), at one ray, and at the K4 shard [1, 2048] of the 2 x 2
    mesh."""
    pe, zd, zv, packed = _kernel_inputs(cuda, B=B, R=R)
    with torch.no_grad():
        out = fr.fused_render_fwd(pe, zd, zv, packed)
        ref = fr.reference_render(pe, zd, zv, packed, torch.bfloat16)
    torch.cuda.synchronize()
    _check_fwd(out, ref)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    """Every sum in a fixed order: two launches give the same bits."""
    pe, zd, zv, packed = _kernel_inputs(cuda, B=2, R=64)
    with torch.no_grad():
        a = fr.fused_render_fwd(pe, zd, zv, packed)
        b = fr.fused_render_fwd(pe, zd, zv, packed)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_kernel_design_matches_its_weight_stream(cuda):
    """The stream the wrapper packs is the one the kernel was compiled to
    read: as many chunks, as many bytes, as many rows a chunk."""
    _, _, _, packed = _kernel_inputs(cuda, B=1, R=1)
    w = {k: v.to(torch.bfloat16) for k, v in packed.items() if k.startswith("w")}
    design = fr.fused_render_fwd_design()
    assert design["chunks"] == len(fr.stream_layout(w)) == 118
    assert design["stream_bytes"] == fr.pack_stream(w).numel() * 2 == 2_703_360
    assert design["chunk_rows"] == fr.STREAM_ROWS
    assert design["resident_blocks"] >= 1


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    pe, zd, zv, packed = _kernel_inputs(cuda, B=1, R=16)
    with pytest.raises(ValueError, match="bfloat16"):
        fr.fused_render_fwd(pe, zd, zv, packed, torch.float32)
    with pytest.raises(ValueError, match="pe must have shape"):
        fr.fused_render_fwd(pe[..., :32].contiguous(), zd, zv, packed)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_render_fwd(pe.transpose(1, 2).contiguous().transpose(1, 2), zd, zv, packed)
    with pytest.raises(ValueError, match="weight w0p"):
        fr.fused_render_fwd(pe, zd, zv, {**packed, "w0p": packed["w0p"].cpu()})


@pytest.mark.cuda
def test_headnerf_fused_matches_plain_path_on_card(cuda):
    """One Reso64 frame in bf16 through the kernel and through the plain
    NeRFMLP + composite path; images in [0, 1] agree within 5e-2."""
    model = HeadNeRF(reso64(), compute_dtype=torch.bfloat16, use_fused=True, device=cuda,
                     generator=torch.Generator().manual_seed(0)).eval()
    xy, _ = ray_grid(64)
    cam = base_cam(64)
    args = [torch.as_tensor(a, device=cuda) for a in (xy,)]
    args += [torch.zeros(1, n, device=cuda) for n in (179, 127, 64)]
    args += [torch.as_tensor(a, device=cuda) for a in (cam.Rmat, cam.Tvec, cam.inv_inmat)]
    with torch.no_grad():
        fused = model(*args)["merge_img"]
        model.use_fused = False
        plain = model(*args)["merge_img"]
    assert fused.shape == (1, 512, 512, 3)
    assert float((fused - plain).abs().max()) <= 5e-2


@pytest.mark.cuda
def test_headnerf_fused_raises_on_card_at_other_dims(cuda):
    """use_fused at dims the kernel is not compiled for raises on the card
    instead of taking the plain path."""
    cfg = dataclasses.replace(reso64(), mlp_hidden=128)
    model = HeadNeRF(cfg, compute_dtype=torch.bfloat16, use_fused=True,
                     device=cuda, generator=torch.Generator().manual_seed(0)).eval()
    xy, _ = ray_grid(64)
    cam = base_cam(64)
    args = [torch.as_tensor(a, device=cuda) for a in (xy,)]
    args += [torch.zeros(1, n, device=cuda) for n in (179, 127, 64)]
    args += [torch.as_tensor(a, device=cuda) for a in (cam.Rmat, cam.Tvec, cam.inv_inmat)]
    before = fr.fused_render_fwd.launches
    with torch.no_grad(), pytest.raises(ValueError, match="mlp_hidden=384"):
        model(*args)
    assert fr.fused_render_fwd.launches == before


def _cotangents(dev, B, R, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [t.to(dev) for t in (torch.randn(B, R, fr.FEAT, generator=g),
                                torch.randn(B, R, generator=g),
                                torch.randn(B, R, generator=g))]


@pytest.mark.cuda
@pytest.mark.parametrize("input_grads", [False, True])
def test_bwd_kernel_matches_plain_version(cuda, input_grads):
    pe, zd, zv, packed = _kernel_inputs(cuda, B=2, R=64)
    gf, gb, gd = _cotangents(cuda, 2, 64)
    before = fr.fused_render_bwd.launches
    with torch.no_grad():
        out = fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd, input_grads=input_grads)
        ref = fr.reference_render_bwd(pe, zd, zv, packed, gf, gb, gd, torch.bfloat16,
                                      input_grads=input_grads)
    torch.cuda.synchronize()
    assert fr.fused_render_bwd.launches == before + 1
    pairs = [(k, out[3][k], ref[3][k]) for k in ref[3]]
    if input_grads:
        pairs += list(zip(("d_zd", "d_zv"), out[1:3], ref[1:3]))
        assert torch.isfinite(out[0]).all()
        assert _rel_l2(out[0], ref[0]) <= D_PE_REL_L2, f"d_pe: rel L2 {_rel_l2(out[0], ref[0]):.3e}"
    else:
        assert out[:3] == (None, None, None)
    for name, a, b in pairs:
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        assert err <= BWD_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_fused_render_grads_match_autograd_of_plain_forward(cuda):
    """K3 (K1 forward, K2 backward) against autograd through the plain
    forward in bf16: gradients of the MLP parameters and of the three codes."""
    g = torch.Generator().manual_seed(3)
    B, R = 2, 64
    mlp = NeRFMLP(63 + 179, 127, hidden=fr.H, out_features=fr.FEAT)
    mlp.reset_parameters(g)
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            if name.endswith("_bias"):
                p.normal_(0.0, 0.1, generator=g)
    mlp = mlp.to(cuda)
    codes = [(torch.randn(B, n, generator=g) * 0.3).to(cuda) for n in (179, 127, 64)]
    pe, zd, zv, _ = _kernel_inputs(cuda, B=B, R=R)
    gf, gb, gd = _cotangents(cuda, B, R)

    def grads(render, dtype):
        leaves = list(mlp.parameters()) + [c.clone().requires_grad_() for c in codes]
        packed = fr.pack_weights(dict(mlp.named_parameters()), *leaves[-3:])
        feat, bg, depth = render(pe, zd, zv, packed, dtype)
        loss = (feat * gf).sum() + (bg * gb).sum() + (depth * gd).sum()
        return torch.autograd.grad(loss, leaves)

    before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
    fused = grads(fr.fused_render, torch.bfloat16)
    assert (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    plain = grads(fr.reference_render, torch.bfloat16)
    names = [n for n, _ in mlp.named_parameters()] + ["shape_code", "appea_code", "audio_style"]
    for name, a, b in zip(names, fused, plain):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, b) <= GRAD_REL_L2, f"{name}: rel L2 {_rel_l2(a, b):.3e}"


@pytest.mark.cuda
def test_headnerf_fused_training_raises_on_card_at_other_dims(cuda):
    """With gradients on, use_fused at dims the kernels are not compiled for
    raises on the card and launches neither kernel."""
    cfg = dataclasses.replace(reso64(), featmap_size=8, pred_img_size=32, mlp_hidden=128)
    model = HeadNeRF(cfg, compute_dtype=torch.bfloat16, use_fused=True, device=cuda,
                     generator=torch.Generator().manual_seed(0)).train()
    xy, _ = ray_grid(8)
    cam = base_cam(8)
    args = [torch.as_tensor(a, device=cuda) for a in (xy,)]
    args += [torch.zeros(1, n, device=cuda, requires_grad=True) for n in (179, 127, 64)]
    args += [torch.as_tensor(a, device=cuda) for a in (cam.Rmat, cam.Tvec, cam.inv_inmat)]
    before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
    with pytest.raises(ValueError, match="mlp_hidden=384"):
        model(*args)
    assert (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches) == before


# the kernel's gradient chain recomputed in PyTorch from the kernel's own
# stash: the same bf16 values in, so only f32 summation order differs, and
# a bf16 rounding flip moves an element by 2^-8 of itself
STASH_REL_L2 = 1e-3


@pytest.mark.cuda
def test_bwd_kernel_chain_matches_its_own_stash(cuda):
    """Separates K2's arithmetic from the ReLU mask flips that the forward
    recompute's summation order causes: each gradient activation, d_pe and
    three weight/bias gradients against PyTorch on the kernel's stash
    (`fr.stash_chain_errors`)."""
    B, R = 2, 64
    pe, zd, zv, packed = _kernel_inputs(cuda, B=B, R=R)
    gf, gb, gd = _cotangents(cuda, B, R)
    scratch = torch.empty(fr.scratch_bytes(B, R), dtype=torch.uint8, device=cuda)
    with torch.no_grad():
        d_pe, _, _, dw = fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd,
                                             input_grads=True, scratch=scratch)
        errs = fr.stash_chain_errors(scratch, packed, d_pe, dw, B, R)
    assert len(errs) == 14
    for name, err in errs.items():
        assert err <= STASH_REL_L2, f"{name}: rel L2 {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("input_grads", [False, True])
@pytest.mark.parametrize("B,R", [(1, 33), (1, 2048)], ids=["odd_1x33", "k4_shard_1x2048"])
def test_bwd_kernel_matches_plain_version_at_other_shapes(cuda, B, R, input_grads):
    """K2 at an odd ray count (the last split of the weight-gradient pass
    shorter than the others) and at the K4 shard [1, 2048] of the 2 x 2
    mesh, within the same limits as at [2, 64]."""
    pe, zd, zv, packed = _kernel_inputs(cuda, B=B, R=R)
    gf, gb, gd = _cotangents(cuda, B, R)
    with torch.no_grad():
        out = fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd, input_grads=input_grads)
        ref = fr.reference_render_bwd(pe, zd, zv, packed, gf, gb, gd, torch.bfloat16,
                                      input_grads=input_grads)
    torch.cuda.synchronize()
    pairs = [(k, out[3][k], ref[3][k]) for k in ref[3]]
    if input_grads:
        pairs += list(zip(("d_zd", "d_zv"), out[1:3], ref[1:3]))
        assert torch.isfinite(out[0]).all()
        assert _rel_l2(out[0], ref[0]) <= D_PE_REL_L2, f"d_pe: rel L2 {_rel_l2(out[0], ref[0]):.3e}"
    for name, a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        assert err <= BWD_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    pe, zd, zv, packed = _kernel_inputs(cuda, B=2, R=64)
    gf, gb, gd = _cotangents(cuda, 2, 64)
    with torch.no_grad():
        a = fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd, input_grads=True)
        b = fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd, input_grads=True)
    for x, y in zip(a[:3] + tuple(a[3].values()), b[:3] + tuple(b[3].values())):
        assert torch.equal(x, y)


# the X^T G core against torch.matmul in f32 on the same bf16 values: the
# products are exact in f32 on both sides, and only the order of the f32
# sums differs
XTG_RTOL = 1e-5


def _xtg_inputs(dev, shapes, B, rows, seed):
    g = torch.Generator().manual_seed(seed)
    P = B * rows * 64
    return [tuple(torch.randn(P, n, generator=g).to(dev, torch.bfloat16) for n in shape)
            for shape in shapes]


def _xtg_check(name, got, ref):
    assert got.shape == ref.shape and torch.isfinite(got).all(), name
    err, peak = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= XTG_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 384), (384, 384), (384, 192), (192, 256)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_xtg_core_matches_matmul(cuda, shape):
    """One job of each shape K2's weight-gradient pass runs (w0p / w5p,
    the hidden layers, rgb_1, rgb_2), with its bias sums, over two batch
    rows of 33 rows of 64 points (an odd row count: splits of unequal
    length)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    (x, g), = _xtg_inputs(cuda, [shape], B=2, rows=33, seed=7)
    before = fr.xtg_core.launches
    (dw, db), = fr.xtg_core([(x, g, True, False, False)], B=2)
    torch.cuda.synchronize()
    assert fr.xtg_core.launches == before + 1
    _xtg_check("dw", dw, x.float().T @ g.float())
    _xtg_check("db", db, g.float().sum(0))


@pytest.mark.cuda
def test_xtg_core_per_batch_and_narrow_jobs(cuda):
    """Per-batch outputs (each batch row's own sum, as b0 / b5 / br1 in K2)
    and a narrow job (dwd = x7^T d_sigma, dbd) in one launch with a shared
    job."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, rows = 3, 5
    (x1, g1), (x2, g2), (x3, g3) = _xtg_inputs(cuda, [(64, 384), (384, 1), (192, 256)], B, rows,
                                               seed=8)
    outs = fr.xtg_core([(x1, g1, True, True, True), (x2, g2, True, False, False),
                        (x3, g3, False, False, True)], B=B)
    torch.cuda.synchronize()
    for (dw, db), (x, g, bias, pw, pb) in zip(outs, [(x1, g1, True, True, True),
                                                    (x2, g2, True, False, False),
                                                    (x3, g3, False, False, True)]):
        xb, gb = x.float().view(B, -1, x.shape[1]), g.float().view(B, -1, g.shape[1])
        ref_w = torch.stack([a.T @ b for a, b in zip(xb, gb)])
        _xtg_check("dw", dw, ref_w if pw else ref_w.sum(0))
        if bias:
            _xtg_check("db", db, gb.sum(1) if pb else gb.sum(1).sum(0))
        else:
            assert db is None


@pytest.mark.cuda
def test_xtg_core_refuses_a_bad_job(cuda):
    """A job the core does not take (in not a multiple of 64) is refused by
    the launcher, and the wrapper raises instead of returning."""
    (x, g), = _xtg_inputs(cuda, [(32, 384)], B=1, rows=2, seed=9)
    before = fr.xtg_core.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fr.xtg_core([(x, g, True, False, False)], B=1)
    assert fr.xtg_core.launches == before


def _upsampler_block(dev, i, B=2, Hc=24, Wc=16, seed=0):
    """Block i of the Reso64 decoder widths on a 24x16 featmap grid (3x2
    tiles at level 0, 12x8 at level 2: interior halos and all four image
    edges): (net, rgb, weight list, g_net', g_rgb'), seeded."""
    C, Cn = fu.KERNEL_DIMS[i]
    g = torch.Generator().manual_seed(seed + i)
    P = 4 ** i

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    wl = [r(C, 2 * C, scale=C ** -0.5), r(2 * C, scale=0.1), r(2 * C, 4 * C, scale=(2 * C) ** -0.5),
          r(4 * C, scale=0.1), r(C, Cn, scale=C ** -0.5), r(Cn, scale=0.1),
          r(Cn, 3, scale=Cn ** -0.5), r(3, scale=0.1)]
    if i == 0:
        wl += [r(C, 3, scale=C ** -0.5), r(3, scale=0.1)]
    bf = torch.bfloat16
    net, rgb = r(B, P, Hc, Wc, C).to(bf), r(B, P, Hc, Wc, 3, scale=0.5).to(bf)
    gn, gr = r(B, 4 * P, Hc, Wc, Cn).to(bf), r(B, 4 * P, Hc, Wc, 3).to(bf)
    return net.to(dev), rgb.to(dev), [w.to(dev) for w in wl], gn.to(dev), gr.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 1, 2])
def test_upsampler_fwd_kernel_matches_plain_version(cuda, i):
    net, rgb, wl, _, _ = _upsampler_block(cuda, i)
    before = fu.phase_block_fwd.launches
    with torch.no_grad():
        out = fu.phase_block_fwd(net, rgb, wl, i)
        ref = fu.reference_block_fwd(net, rgb, wl, i, torch.bfloat16)
    torch.cuda.synchronize()
    assert fu.phase_block_fwd.launches == before + 1
    for name, a, b in zip(("net_next", "rgb_next"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16, name
        assert torch.isfinite(a).all(), name
        err, peak = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        assert err <= UPS_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 1, 2])
def test_upsampler_bwd_kernel_matches_plain_version(cuda, i):
    net, rgb, wl, gn, gr = _upsampler_block(cuda, i)
    before = fu.phase_block_bwd.launches
    with torch.no_grad():
        g_net, g_rgb, gw = fu.phase_block_bwd(net, rgb, wl, i, gn, gr)
        r_net, r_rgb, rw = fu.reference_block_bwd(net, rgb, wl, i, gn, gr, torch.bfloat16)
    torch.cuda.synchronize()
    assert fu.phase_block_bwd.launches == before + 1
    assert torch.isfinite(g_net).all()
    assert _rel_l2(g_net, r_net) <= UPS_GNET_REL_L2, f"g_net: rel L2 {_rel_l2(g_net, r_net):.3e}"
    assert float((g_rgb - r_rgb).abs().max()) <= UPS_GRGB_RTOL * float(r_rgb.abs().max())
    for k, (a, b) in enumerate(zip(gw, rw)):
        assert a.shape == b.shape and a.dtype == torch.float32, k
        assert torch.isfinite(a).all(), k
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        assert err <= UPS_BWD_RTOL * peak, f"weight {k}: max abs err {err:.3e}, max|ref| {peak:.3e}"
        assert _rel_l2(a, b) <= UPS_BWD_REL_L2, f"weight {k}: rel L2 {_rel_l2(a, b):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 1, 2])
def test_upsampler_kernels_are_deterministic(cuda, i):
    """Two launches of K5-fwd and of K5-bwd give the same bits: every sum
    is in a fixed order (no atomics; the X^T G core adds its splits in
    order)."""
    net, rgb, wl, gn, gr = _upsampler_block(cuda, i)
    with torch.no_grad():
        a = fu.phase_block_fwd(net, rgb, wl, i)
        b = fu.phase_block_fwd(net, rgb, wl, i)
        ga = fu.phase_block_bwd(net, rgb, wl, i, gn, gr)
        gb = fu.phase_block_bwd(net, rgb, wl, i, gn, gr)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip([ga[0], ga[1], *ga[2]], [gb[0], gb[1], *gb[2]]):
        assert torch.equal(x, y)


def _device_kernels(fn):
    """Names of the device kernels one call of fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


@pytest.mark.cuda
def test_upsampler_block0_with_fewer_tiles_than_sms(cuda):
    """Block 0 at B=1 on the Reso64 featmap grid (64 tiles for 132 SMs):
    K5-fwd takes a cluster of two blocks a tile, so its grid covers twice
    the tiles' SMs; both kernels against their plain versions; K5-bwd's
    device launches counted by the profiler (at most 6 of its own)."""
    net, rgb, wl, gn, gr = _upsampler_block(cuda, 0, B=1, Hc=64, Wc=64)
    with torch.no_grad():
        out = fu.phase_block_fwd(net, rgb, wl, 0)
        ref = fu.reference_block_fwd(net, rgb, wl, 0, torch.bfloat16)
        g_net, _, gw = fu.phase_block_bwd(net, rgb, wl, 0, gn, gr)
        r_net, _, rw = fu.reference_block_bwd(net, rgb, wl, 0, gn, gr, torch.bfloat16)
    torch.cuda.synchronize()
    for name, a, b in zip(("net_next", "rgb_next"), out, ref):
        err, peak = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        assert err <= UPS_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"
    assert _rel_l2(g_net, r_net) <= UPS_GNET_REL_L2, f"g_net: rel L2 {_rel_l2(g_net, r_net):.3e}"
    for k, (a, b) in enumerate(zip(gw, rw)):
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        assert err <= UPS_BWD_RTOL * peak, f"weight {k}: max abs err {err:.3e}, max|ref| {peak:.3e}"
        assert _rel_l2(a, b) <= UPS_BWD_REL_L2, f"weight {k}: rel L2 {_rel_l2(a, b):.3e}"
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    fd = fu.fwd_design(1, 64, 64, 0, 256, 128)
    assert fd["tiles"] == 64 < sms
    assert fd["cluster_size"] == 2 and fd["grid_blocks"] == 128 <= fd["resident_blocks"]
    assert fd["grid_blocks"] > sms // 2
    with torch.no_grad():
        names = _device_kernels(lambda: fu.phase_block_bwd(net, rgb, wl, 0, gn, gr))
    own = [n for n in names if "at::" not in n]   # not PyTorch's (the stream gather, fills)
    for part in ("tile_kernel", "chain_kernel", "xtg_jobs_kernel", "xtg_reduce"):
        assert sum(part in n for n in own) == 1, (part, names)
    assert len(own) <= 6, own


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 1, 2])
def test_upsampler_designs_match_the_packed_streams(cuda, i):
    """The kernels' compiled stream layouts (chunks a tile, bytes, channels
    a D2 chunk) against the Python layouts the wrapper packs by, per block."""
    C, Cn = fu.KERNEL_DIMS[i]

    def nbytes(chunks):
        return sum(2 * k * n for _, _, k, n, _ in fu.stream_layout(chunks, C, Cn))

    fwd, rec = fu.tile_stream_chunks(C, Cn, False), fu.tile_stream_chunks(C, Cn, True)
    chain = fu.chain_stream_chunks(C)
    fd = fu.fwd_design(2, 64, 64, i, C, Cn)
    bd = fu.bwd_design(2, 64, 64, i, C, Cn)
    assert (fd["chunks_per_tile"], fd["stream_bytes"]) == (len(fwd), nbytes(fwd))
    assert fd["d2_channels_per_chunk"] == fu.TILE_CFG[(C, Cn)]["KCH"]
    assert (bd["recompute_chunks_per_tile"], bd["recompute_stream_bytes"]) == (len(rec), nbytes(rec))
    assert (bd["chain_chunks_per_tile"], bd["chain_stream_bytes"]) == (len(chain), nbytes(chain))
    assert fd["tiles"] == bd["tiles"] == 2 * (64 << i) ** 2 // 64


@pytest.mark.cuda
def test_upsampler_kernels_raise_on_card_at_other_widths(cuda):
    """Another width, a grid that is not whole tiles, or f32 compute raise
    on the card and launch nothing."""
    net, rgb, wl, gn, gr = _upsampler_block(cuda, 2, B=1, Hc=8, Wc=8)
    before = (fu.phase_block_fwd.launches, fu.phase_block_bwd.launches)
    narrow = [w[..., :16] if w.dim() == 2 and w.shape[1] == 32 else w for w in wl]
    narrow[5] = wl[5][:16]
    narrow[6] = wl[6][:16]
    with pytest.raises(ValueError, match="compiled for"):
        fu.phase_block_fwd(net, rgb, narrow, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        fu.phase_block_fwd(net[:, :, :4, :4].contiguous(), rgb[:, :, :4, :4].contiguous(), wl, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        fu.phase_block_bwd(net.float(), rgb.float(), wl, 2, gn.float(), gr.float(), torch.float32)
    assert (fu.phase_block_fwd.launches, fu.phase_block_bwd.launches) == before


@pytest.mark.cuda
def test_headnerf_fused_upsampler_matches_plain_path_on_card(cuda):
    """HeadNeRF at featmap 16 / image 128 (the Reso64 widths, three blocks)
    in bf16 through K1 + K5 (K2 + K5-bwd under autograd) against the plain
    path: images and the gradient of every parameter."""
    cfg = dataclasses.replace(reso64(), featmap_size=16, pred_img_size=128)
    model = HeadNeRF(cfg, compute_dtype=torch.bfloat16, use_fused=True, use_fused_upsampler=True,
                     device=cuda, generator=torch.Generator().manual_seed(0))
    xy, _ = ray_grid(16)
    cam = base_cam(16)
    g = torch.Generator().manual_seed(1)
    args = [torch.as_tensor(xy, device=cuda)]
    args += [(torch.randn(1, n, generator=g) * 0.1).to(cuda) for n in (179, 127, 64)]
    args += [torch.as_tensor(a, device=cuda) for a in (cam.Rmat, cam.Tvec, cam.inv_inmat)]
    names, leaves = zip(*model.named_parameters())

    def run():
        out = model(*args)
        loss = ((out["merge_img"] - 0.4) ** 2).mean() + ((out["bg_img"] - 1.0) ** 2).mean()
        return out["merge_img"].detach(), torch.autograd.grad(loss, leaves)

    before = (fu.phase_block_fwd.launches, fu.phase_block_bwd.launches)
    img_f, grads_f = run()
    assert (fu.phase_block_fwd.launches - before[0], fu.phase_block_bwd.launches - before[1]) \
        == (6, 6)
    model.use_fused = model.use_fused_upsampler = False
    img_p, grads_p = run()
    assert img_f.shape == (1, 128, 128, 3)
    assert float((img_f - img_p).abs().max()) <= UPS_IMG_ABS
    for name, a, b in zip(names, grads_f, grads_p):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, b) <= UPS_HEAD_GRAD_REL_L2, f"{name}: rel L2 {_rel_l2(a, b):.3e}"


# the xᵀ·g probe against its plain version, over max|ref|: `loaded` sums the
# same bf16 products in f32 in another order; the other modes first form
# x' = bf16(relu(x·w)), where another f32 summation order can round an
# element to the neighbouring bf16 value (2^-8 of itself)
PROBE_RTOL = {"loaded": 1e-5, "computed": 2e-3, "scratch": 2e-3, "f32": 2e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["loaded", "computed", "scratch", "f32"])
def test_probe_kernel_matches_plain_version(cuda, mode):
    from nerf3dtalker_tpu_torch.ops.kernels import probe_xtg as px

    g = torch.Generator().manual_seed(4)
    x, gg = (torch.randn(px.N, n, generator=g).to(cuda, torch.bfloat16) for n in (px.K, px.H))
    w = (torch.randn(px.K, px.H, generator=g) * 0.05).to(cuda, torch.bfloat16)
    before = px.probe_xtg.launches
    out = px.probe_xtg(x, gg, w, mode)
    torch.cuda.synchronize()
    assert px.probe_xtg.launches == before + 1
    ref = px.reference_xtg(x, gg, w, mode)
    assert out.shape == ref.shape and out.dtype == torch.float32 and torch.isfinite(out).all()
    err, peak = float((out - ref).abs().max()), float(ref.abs().max())
    assert err <= PROBE_RTOL[mode] * peak, f"{mode}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.mark.cuda
def test_k4_on_a_1x1_nccl_mesh_matches_k3(cuda, tmp_path):
    """K4 on a one-rank NCCL mesh runs the same K1 and K2 as K3 on the same
    inputs, and NCCL's all-reduce over one rank is the identity: outputs and
    every gradient (MLP parameters and codes) are bit-identical."""
    import torch.distributed as dist

    from nerf3dtalker_tpu_torch.parallel.mesh import init_ranks, make_mesh

    init_ranks(0, 1, 0, 1, "cuda", f"file://{tmp_path / 'store'}")
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1, 1)
        g = torch.Generator().manual_seed(5)
        B, R = 2, 64
        mlp = NeRFMLP(63 + 179, 127, hidden=fr.H, out_features=fr.FEAT)
        mlp.reset_parameters(g)
        mlp = mlp.to(cuda)
        codes = [(torch.randn(B, n, generator=g) * 0.3).to(cuda) for n in (179, 127, 64)]
        pe, zd, zv, _ = _kernel_inputs(cuda, B=B, R=R)
        gf, gb, gd = _cotangents(cuda, B, R)

        def run(render):
            leaves = list(mlp.parameters()) + [c.clone().requires_grad_() for c in codes]
            packed = fr.pack_weights(dict(mlp.named_parameters()), *leaves[-3:])
            outs = render(pe, zd, zv, packed)
            loss = (outs[0] * gf).sum() + (outs[1] * gb).sum() + (outs[2] * gd).sum()
            return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)

        counters = (fr.fused_render_fwd, fr.fused_render_bwd, fr.fused_render_spmd)
        before = [c.launches for c in counters]
        k4 = run(lambda *a: fr.fused_render_spmd(*a, mesh, torch.bfloat16))
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 2]
        k3 = run(lambda *a: fr.fused_render(*a, torch.bfloat16))
        for a, b in zip(k4[0] + list(k4[1]), k3[0] + list(k3[1])):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_bwd_kernel_at_the_fit_shape(cuda):
    """K2 at the fit's shape, one Reso64 image (B=1, R=4096), with the input
    gradients a camera fit needs, within the limits of [2, 64]; the launch
    is counted as one with input gradients."""
    B, R = 1, 4096
    pe, zd, zv, packed = _kernel_inputs(cuda, B=B, R=R)
    gf, gb, gd = _cotangents(cuda, B, R)
    before = fr.fused_render_bwd.input_grads_launches
    with torch.no_grad():
        out = fr.fused_render_bwd(pe, zd, zv, packed, gf, gb, gd, input_grads=True)
        ref = fr.reference_render_bwd(pe, zd, zv, packed, gf, gb, gd, torch.bfloat16,
                                      input_grads=True)
    torch.cuda.synchronize()
    assert fr.fused_render_bwd.input_grads_launches == before + 1
    assert torch.isfinite(out[0]).all()
    assert _rel_l2(out[0], ref[0]) <= D_PE_REL_L2, f"d_pe: rel L2 {_rel_l2(out[0], ref[0]):.3e}"
    pairs = [(k, out[3][k], ref[3][k]) for k in ref[3]]
    pairs += list(zip(("d_zd", "d_zv"), out[1:3], ref[1:3]))
    for name, a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        assert err <= BWD_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


# one fit iteration's gradients (codes and camera) through K1/K2 against the
# plain path, both bf16: relative L2 of each FitVar's gradient. The codes'
# come through the per-batch bias sums, like a train step's leaves
# (GRAD_REL_L2). The camera's sum d_pe over 262,144 points with much
# cancellation, and the two bf16 paths round in different places: against
# f64, K2's d_pe is 8.4e-2 off and the rotation gradient through the
# kernels 1.6e-1 (as through their plain version), through the plain path
# 2.8e-2 (`python -m nerf3dtalker_tpu_torch.scripts.fit_precision`); this
# test measured 1.2e-1 between the two on delta_euler. The camera's limit
# is twice that
FIT_GRAD_REL_L2 = 3e-2
FIT_CAM_GRAD_REL_L2 = 2.5e-1


@pytest.mark.cuda
def test_fit_gradients_through_the_kernels_match_the_plain_path(cuda):
    """One iteration of `fit_single_image` at Reso64: the gradient of the
    fitting objective with respect to each FitVar through K1 and K2 (with
    input gradients) against the plain path on the same bf16 model; the
    target is the model's own render at a camera offset, the base iden off
    by 0.1."""
    from nerf3dtalker_tpu_torch.train import fitting

    cfg = reso64()
    model = HeadNeRF(cfg, compute_dtype=torch.bfloat16, use_fused=True, device=cuda,
                     generator=torch.Generator().manual_seed(1)).eval()
    g = torch.Generator().manual_seed(2)
    codes = {k: torch.randn(1, n, generator=g) * 0.1
             for k, n in (("iden", 100), ("expr", 79), ("text", 100), ("illu", 27))}
    cam = base_cam(cfg.featmap_size)
    cam_d = {"Rmat": cam.Rmat, "Tvec": cam.Tvec, "inv_inmat": cam.inv_inmat}
    offset = fitting.FitVars(*(torch.zeros(1, n) for n in (100, 79, 127)),
                             torch.tensor([[0.05, -0.05, 0.0]]), torch.tensor([[0.1, 0.0, 0.0]]))
    with torch.no_grad():
        shape, appea, R, T = fitting.apply_fit_vars(
            offset, codes, {k: torch.as_tensor(v) for k, v in cam_d.items()})
        args = [torch.as_tensor(a, device=cuda) for a in
                (ray_grid(cfg.featmap_size)[0], shape, appea, torch.zeros(1, 64), R, T,
                 cam.inv_inmat)]
        target = model(*args)["merge_img"].float().clamp(0, 1).cpu().numpy()
    base = {k: v.numpy() for k, v in codes.items()}
    base["iden"] = base["iden"] + 0.1
    problem = fitting.FitProblem(model, target, np.ones_like(target[..., :1]), base, cam_d,
                                 np.zeros((1, 64), np.float32))
    counts = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches,
              fr.fused_render_bwd.input_grads_launches)
    _, _, kernels = problem.gradients(fitting.init_fit_vars(cuda))
    assert (fr.fused_render_fwd.launches - counts[0], fr.fused_render_bwd.launches - counts[1],
            fr.fused_render_bwd.input_grads_launches - counts[2]) == (1, 1, 1)
    model.use_fused = False
    _, _, plain = problem.gradients(fitting.init_fit_vars(cuda))
    for name, a, b in zip(fitting.FitVars._fields, kernels, plain):
        assert torch.isfinite(a).all() and b.norm() > 0, name
        limit = FIT_CAM_GRAD_REL_L2 if name.startswith("delta") else FIT_GRAD_REL_L2
        assert _rel_l2(a, b) <= limit, f"{name}: rel L2 {_rel_l2(a, b):.3e}"


# the Standardized Space stage 1: one step's loss and gradients on the card
# against the same weights and batch on the CPU, both f32, cuDNN's TF32 off
# (chip_smoke.py's VQ_* limits give the reasons): the loss within 1e-3
# relative; at least 99 % of the image-code indices equal (an argmin near a
# tie may flip); every leaf's gradient within 1e-2 relative L2, the image
# codebook without the rows that flipped indices touch, and the bias of a
# conv that feeds an instance norm (`vq_trainer.norm_fed_convs`: its
# gradient is a sum that cancels) relative to the mass of the terms it sums
# (`bias_term_mass` on the CPU)
VQ_LOSS_RTOL = 1e-3
VQ_INDEX_AGREE = 0.99
VQ_GRAD_REL_L2 = 1e-2


@pytest.mark.cuda
def test_vq_step_on_the_card_matches_the_cpu(cuda):
    from nerf3dtalker_tpu_torch.config import VQConfig
    from nerf3dtalker_tpu_torch.train.vq_trainer import (bias_term_mass, init_modules,
                                                          norm_fed_convs, to_batch, vq_loss)

    cfg = VQConfig(img_size=64, hidden_size=128, embed_dim=16, n_embed=1024, n_embed_au=64,
                   num_hidden_layers=2, num_attention_heads=4, intermediate_size=256)
    rng = np.random.default_rng(0)
    S, B = cfg.img_size, 2
    gt = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    data = {"gen_img": np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32),
            "gt_img": gt, "mask": (rng.uniform(0, 1, (B, S, S, 1)) > 0.3).astype(np.float32),
            "crops": rng.uniform(0, 1, (B, 5, 112, 112, 3)).astype(np.float32),
            "au_labels": (rng.uniform(0, 1, (B, 5)) > 0.5).astype(np.float32)}
    states = {dev.type: init_modules(cfg, 112, dev, torch.Generator().manual_seed(0))
              for dev in (cuda, torch.device("cpu"))}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {}
        for dev, (vq, au) in states.items():
            with bias_term_mass(norm_fed_convs(vq, au)) as mass:
                total, _, out = vq_loss(vq, au, to_batch(data, dev))
                total.backward()
            grads = {f"vq.{k}": p.grad.cpu() for k, p in vq.named_parameters()}
            grads.update({f"au.{k}": p.grad.cpu() for k, p in au.named_parameters()})
            res[dev] = float(total.detach()), out.indices.cpu(), grads, mass
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lg, ig, gg, _), (lc, ic, gc, mass) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= VQ_LOSS_RTOL * abs(lc)
    same = ig == ic
    assert same.float().mean() >= VQ_INDEX_AGREE
    flipped = torch.unique(torch.cat([ig[~same], ic[~same]]))
    for k, ref in gc.items():
        got, scale = gg[k], ref.norm()
        if k == "vq.quantize.embedding" and len(flipped):
            keep = torch.ones(len(ref), dtype=torch.bool)
            keep[flipped] = False
            got, ref, scale = got[keep], ref[keep], ref[keep].norm()
        if k in mass:
            scale = mass[k].norm()
        err = float((got - ref).norm() / scale.clamp_min(1e-30))
        assert err <= VQ_GRAD_REL_L2, f"{k}: {err:.3e} of its scale"


# The trainer's CUDA graph of the step against eager steps, from one state
# and seed: a step's losses within GRAPH_LOSS_RTOL and every gradient leaf
# (Adam's first moment after one step, 0.1 of the gradient) within
# GRAPH_GRAD_REL_L2 relative L2, the train step's limits in chip_smoke.py
# (the two differ where the decoder's backward sums by atomics); whole
# epochs' losses within GRAPH_LOSS_RTOL. Over several steps Adam carries
# those atomics into the leaves as far for two eager runs as for a replay
# against an eager run (on an H100, 6.5e-2 relative L2 on an LSTM weight's
# first moment after an epoch of 8 steps at Reso64), so the leaves are held
# at one step
GRAPH_LOSS_RTOL = 1e-2
GRAPH_GRAD_REL_L2 = 3e-2


def _graph_trainer(dev, tmp_path, **kw):
    """A trainer at Reso64 (VGG on), 4 frames: two steps an epoch. At a
    featmap of 8 the atomics' share of a summed bias gradient is larger:
    a replay's `density_bias` gradient was 4.0e-2 relative L2 from an eager
    step's there, 3.7e-3 at most on any leaf at Reso64 (two eager steps
    alike, on an H100)."""
    from nerf3dtalker_tpu_torch.config import TrainConfig
    from nerf3dtalker_tpu_torch.data.dataset import coherent_subject
    from nerf3dtalker_tpu_torch.train.trainer import Trainer

    cfg = reso64()
    t = Trainer(cfg, TrainConfig(batch_size=2, ckpt_dir="", log_dir="", **kw),
                coherent_subject(cfg, 4), device=dev)
    t.init()
    return t


def _moments(t):
    return {f"{g}.{n}": t.state.opt.state[p]["exp_avg"].clone()
            for g, m in (("nerf", t.state.nerf), ("audio", t.state.audio))
            for n, p in m.named_parameters() if p.requires_grad}


def _check_losses(got, want):
    for a, b in zip(got, want):
        for k in ("total_loss", "head_loss", "bg_loss", "vgg"):
            assert abs(a[k] - b[k]) <= GRAPH_LOSS_RTOL * abs(b[k]), (k, a[k], b[k])


@pytest.mark.cuda
def test_step_graph_replays_match_eager_steps(cuda, tmp_path):
    """One step and two epochs through the trainer's CUDA graph against the
    same eagerly from the same state and seeds; one K1 and one K2 counted a
    replay, two of each before the capture; then the state loaded back in
    place (`Trainer._load`) and the graph replayed again from it."""
    import copy

    from nerf3dtalker_tpu_torch.train.trainer import GRAPH_WARMUP_STEPS, epoch_order, step_seed

    t = _graph_trainer(cuda, tmp_path)
    snap = {"nerf": copy.deepcopy(t.state.nerf.state_dict()),
            "audio": copy.deepcopy(t.state.audio.state_dict()),
            "opt": copy.deepcopy(t.state.opt.state_dict()), "step": 0}
    idx = torch.as_tensor(epoch_order(4, 0, 0)[:2], device=cuda)
    t.generator.manual_seed(step_seed(0, 0, 0))
    eager = t.fns.train_step(t.state, t.train_data.device_batch(idx), t.generator)
    m_eager = _moments(t)
    t._load(snap)
    before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
    graph = t._step_graph()
    graph.step(idx, step_seed(0, 0, 0))
    acc = torch.zeros(len(graph.keys), device=cuda)
    graph.take(acc)
    _check_losses([dict(zip(graph.keys, acc.tolist()))],
                  [{k: float(v) for k, v in eager.items()}])
    for k, ref in m_eager.items():
        err = float((_moments(t)[k] - ref).norm() / ref.norm().clamp_min(1e-30))
        assert err <= GRAPH_GRAD_REL_L2, f"{k}: {err:.3e}"
    assert (fr.fused_render_fwd.launches - before[0], fr.fused_render_bwd.launches - before[1]) \
        == (1 + GRAPH_WARMUP_STEPS, 1 + GRAPH_WARMUP_STEPS)
    assert t.kernel_launches["graph_warmup"] == [GRAPH_WARMUP_STEPS] * 2
    assert t.graph_records[0]["launches"] == {"fused_render_fwd": 1, "fused_render_bwd": 1,
                                              "input_grads": 0}
    assert t.graph_records[0]["pool_bytes"] > 0

    t._load(snap)
    got = t.train_epoch_group(0, 2)
    assert t.kernel_launches["train_steps"] == [4, 4] and t.state.step == 4
    t._load(snap)
    t.use_graph = False
    want = t.train_epoch_group(0, 2)
    _check_losses(got, want)
    t._load(snap)
    t.use_graph = True
    _check_losses(t.train_epoch_group(0, 2), want)
    assert len(t.graph_records) == 1 and t.state.step == 4
    t.close()


@pytest.mark.cuda
def test_graph_generator_draws_what_eager_draws(cuda):
    """A generator registered with a CUDA graph: a replay after
    manual_seed(s) draws bit for bit what eager draws seeded s draw (the
    step's jitter and dropout shapes)."""
    gen = torch.Generator(device=cuda)
    shapes = [(2, 4096, 65), (2, 1280)]
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    with torch.cuda.graph(g):
        drawn = [torch.rand(s, generator=gen, device=cuda) for s in shapes]
    for seed in (0, 100003 * 7 + 3, 2**32 - 1):
        gen.manual_seed(seed)
        g.replay()
        gen.manual_seed(seed)
        for d, s in zip(drawn, shapes):
            assert torch.equal(d, torch.rand(s, generator=gen, device=cuda))


@pytest.mark.cuda
def test_bf16_compute_off_raises_on_the_card(cuda, tmp_path):
    with pytest.raises(ValueError, match="bfloat16 only"):
        _graph_trainer(cuda, tmp_path, bf16_compute=False)
