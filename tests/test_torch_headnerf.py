"""Port parity of `models/headnerf.py` at a tiny config (featmap 8, 16
samples, hidden 64, feat 32, img 32): the port's HeadNeRF with params
bridged from the JAX init, through the fused route (on the CPU, the
kernel's plain version) and the plain route, against JAX
`HeadNeRF(use_fused=True, fused_interpret=True)` and `use_fused=False`.
f32 on the CPU; atol/rtol 1e-4 (eight MLP layers and the decoder sum in
another order than XLA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import headnerf as jax_headnerf

from nerf3dtalker_tpu.config import NeRFConfig as JNeRFConfig
from nerf3dtalker_tpu.models import HeadNeRF as JHeadNeRF
from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF, build_code_and_cam
from nerf3dtalker_tpu_torch.utils import bridge
from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=16,
            mlp_hidden=64)
TOL = 1e-4


def _inputs(B=2, seed=0):
    rng = np.random.default_rng(seed)
    xy, _ = ray_grid(8)
    cam = base_cam(8)
    return dict(
        batch_xy=np.tile(xy, (B, 1, 1)),
        shape_code=(rng.standard_normal((B, 179)) * 0.3).astype(np.float32),
        appea_code=(rng.standard_normal((B, 127)) * 0.3).astype(np.float32),
        audio_style=(rng.standard_normal((B, 64)) * 0.3).astype(np.float32),
        Rmat=np.tile(cam.Rmat, (B, 1, 1)), Tvec=np.tile(cam.Tvec, (B, 1)),
        inv_inmat=np.tile(cam.inv_inmat, (B, 1, 1)),
    )


@pytest.fixture(scope="module")
def jax_params():
    return jax_headnerf(0, **TINY)[1]


@pytest.mark.parametrize("fused", [True, False])
def test_headnerf_matches_jax(jax_params, fused):
    inp = _inputs(seed=1)
    jmodel = JHeadNeRF(JNeRFConfig(**TINY), use_fused=fused, fused_interpret=True)
    ref = jax.jit(jmodel.apply)(jax_params, **{k: jnp.asarray(v) for k, v in inp.items()})
    model = HeadNeRF(NeRFConfig(**TINY), use_fused=fused, device="cpu")
    bridge.load_into(model, bridge.headnerf_state_dict(jax_params))
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in inp.items()})
    for key in ("merge_img", "bg_alpha", "depth", "bg_img"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_fused_gate_raises_on_gpu_at_other_dims():
    """The plain version takes the tiny dims on the CPU; on the GPU only the
    kernel's dims pass the gate. The gate reads the device it is given, so
    no card is needed to check it."""
    model = HeadNeRF(NeRFConfig(**TINY), use_fused=True, device="cpu")
    assert model._fused_ok(torch.device("cpu"))
    with pytest.raises(ValueError, match="mlp_hidden=384"):
        model._fused_ok(torch.device("cuda"))
    model.use_fused = False
    assert not model._fused_ok(torch.device("cuda"))


def test_build_code_and_cam_overwrites_expr():
    rng = np.random.default_rng(2)
    iden, expr, text, illu, aexp = (torch.from_numpy(rng.standard_normal((1, n)))
                                    for n in (100, 79, 100, 27, 64))
    shape, appea = build_code_and_cam(iden, expr, text, illu, aexp)
    assert shape.shape == (1, 179) and appea.shape == (1, 127)
    torch.testing.assert_close(shape[:, 100:164], aexp)
    torch.testing.assert_close(shape[:, 164:], expr[:, 64:])
