"""Port parity of HeadNeRF's reference options at the JAX fitting test's
TINY config (featmap 8, 8 samples, hidden 32, feat 32, img 32): gaze
conditioning, view-direction conditioning and hierarchical sampling (8 fine
samples), each against the JAX `HeadNeRF` on the same numpy-seeded weights
carried across by `utils/bridge.py`. f32 on the CPU; merge_img and
fine_merge_img within 1e-4 (eight MLP layers and the decoder sum in another
order than XLA; measured ~5e-6). The kernels have none of the options: on
the GPU `use_fused=True` with one raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import seeded_headnerf

from nerf3dtalker_tpu_torch.config import NeRFConfig
from nerf3dtalker_tpu_torch.models.headnerf import HeadNeRF
from nerf3dtalker_tpu_torch.utils import bridge
from nerf3dtalker_tpu_torch.utils.camera import ray_grid

TINY = dict(featmap_size=8, featmap_nc=32, pred_img_size=32, num_sample_coarse=8,
            mlp_hidden=32)
OPTIONS = {"include_gaze": {}, "include_vd": {}, "hier_sampling": {"num_sample_fine": 8}}
TOL = 1e-4


def option_config(option):
    return dict(TINY, **{option: True}, **OPTIONS[option])


def _inputs(cam, seed=1):
    rng = np.random.default_rng(seed)
    return dict(batch_xy=ray_grid(8)[0],
                shape_code=(rng.standard_normal((1, 179)) * 0.3).astype(np.float32),
                appea_code=(rng.standard_normal((1, 127)) * 0.3).astype(np.float32),
                audio_style=(rng.standard_normal((1, 64)) * 0.3).astype(np.float32),
                Rmat=cam["Rmat"], Tvec=cam["Tvec"], inv_inmat=cam["inv_inmat"])


def port_model(cfg_kw, params, **kw):
    model = HeadNeRF(NeRFConfig(**cfg_kw), device="cpu", **kw)
    bridge.load_into(model, bridge.headnerf_state_dict(params))
    return model.eval()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax(option, fused):
    """`use_fused=True` on the CPU takes the plain path with an option on,
    as JAX's `_fused_ok` does; both are held to the JAX plain render."""
    cfg_kw = option_config(option)
    jmodel, params, cam = seeded_headnerf(0, **cfg_kw)
    inp = _inputs(cam)
    if option == "include_gaze":
        inp["gaze"] = np.array([[0.2, -0.3]], np.float32)
    ref = _jax_apply(cfg_kw)(params, {k: jnp.asarray(v) for k, v in inp.items()})
    model = port_model(cfg_kw, params, use_fused=fused)
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()})
    keys = ["merge_img", "bg_alpha", "depth"] + (["fine_merge_img"] if option == "hier_sampling"
                                                else [])
    assert set(out) == set(ref)
    for key in keys:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)


_APPLY = {}


def _jax_apply(cfg_kw):
    key = tuple(sorted(cfg_kw.items()))
    if key not in _APPLY:
        jmodel = seeded_headnerf(0, **cfg_kw)[0]
        _APPLY[key] = jax.jit(lambda p, inp: jmodel.apply(p, **inp))
    return _APPLY[key]


def test_gaze_defaults_to_zeros_and_moves_the_render():
    cfg_kw = option_config("include_gaze")
    _, params, cam = seeded_headnerf(0, **cfg_kw)
    model = port_model(cfg_kw, params)
    inp = {k: torch.from_numpy(np.asarray(v)) for k, v in _inputs(cam).items()}
    with torch.no_grad():
        none = model(**inp)["merge_img"]
        zeros = model(**inp, gaze=torch.zeros(1, 2))["merge_img"]
        other = model(**inp, gaze=torch.tensor([[0.5, -0.5]]))["merge_img"]
    torch.testing.assert_close(none, zeros, rtol=0, atol=0)
    assert (other - none).abs().max() > 1e-4


def test_fine_samples_follow_the_uniform_draws():
    """`fine_u` (training's uniform draws) moves the fine render; without it
    the samples are the deterministic linspace."""
    cfg_kw = option_config("hier_sampling")
    _, params, cam = seeded_headnerf(0, **cfg_kw)
    model = port_model(cfg_kw, params)
    inp = {k: torch.from_numpy(np.asarray(v)) for k, v in _inputs(cam).items()}
    u = torch.rand(1, 64, 9, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(**inp)
        b = model(**inp, fine_u=u)
    torch.testing.assert_close(a["merge_img"], b["merge_img"], rtol=0, atol=0)
    assert (a["fine_merge_img"] - b["fine_merge_img"]).abs().max() > 1e-5
    assert set(model.state_dict()) >= {"fine_fg_CD_predictor.fea_0_kernel"}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_fused_with_an_option_raises_on_the_gpu(option):
    """The gate reads the device it is given, so no card is needed: on a
    CUDA device `use_fused` with an option raises a ValueError that names
    it; on the CPU it takes the plain path; without `use_fused` the option
    renders on any device."""
    model = HeadNeRF(NeRFConfig(**option_config(option)), use_fused=True, device="cpu")
    assert not model._fused_ok(torch.device("cpu"))
    with pytest.raises(ValueError, match=option):
        model._fused_ok(torch.device("cuda"))
    model.use_fused = False
    assert not model._fused_ok(torch.device("cuda"))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_fused_with_an_option_is_refused_at_construction_on_cuda(option, monkeypatch):
    """On a (faked) CUDA device the constructor refuses `use_fused` with an
    option before it allocates anything on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=option):
        HeadNeRF(NeRFConfig(**option_config(option)), use_fused=True, device="cuda")


def test_mesh_refuses_options():
    from nerf3dtalker_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="no option"):
        HeadNeRF(NeRFConfig(**option_config("include_vd")), use_fused=True, device="cpu",
                 mesh=object.__new__(Mesh))
