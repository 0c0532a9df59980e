"""Tests of the port's CUDA kernels on the card. They import no JAX (the
GPU machine has none) and skip without CUDA; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

`--noconftest` skips `tests/conftest.py`, which sets up JAX."""

import dataclasses

import pytest
import torch

from nerf3dtalker_tpu_torch.config import reso64
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.models.nerf_mlp import NeRFMLP
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr
from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

# bf16 tolerance: max abs error over each output's own max|ref|. Both
# versions round to bf16 at the same places; a different f32 summation order
# can flip one rounding (2^-8 relative), which propagates through the later
# layers
RTOL = 5e-3


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
    for name, a, b in zip(("feat", "bg_alpha", "depth"), out, ref):
        assert torch.isfinite(a).all(), name
        err, peak = float((a - b).abs().max()), float(b.abs().max())
        assert err <= RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


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
