"""Port parity of the fused render module: `pack_weights` + the plain
`reference_render` against the JAX `reference_render` and the JAX Pallas
`fused_render_fwd` run in interpret mode, at hidden 32, FEAT 16, NS 8.

Tolerances: f32 atol/rtol 1e-5 (identical math, f32 sums in another
order). bf16 atol/rtol 2e-2: both round operands and every activation to
bf16 at the same places, but a different f32 summation order can flip a
bf16 rounding (one bf16 ulp is 2^-8 relative), and a flip propagates
through the later layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf3dtalker_tpu.models.nerf_mlp import NeRFMLP as JNeRFMLP
from nerf3dtalker_tpu.ops.pallas import fused_render as jfr
from nerf3dtalker_tpu_torch.ops.kernels import fused_render as fr

HID, FEAT, NS, B, R = 32, 16, 8, 2, 32


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    mlp = JNeRFMLP(vp_channels=63 + 179, vd_channels=127, hidden=HID, out_features=FEAT)
    shape = (rng.standard_normal((B, 179)) * 0.1).astype(np.float32)
    appea = (rng.standard_normal((B, 127)) * 0.1).astype(np.float32)
    aud = (rng.standard_normal((B, 64)) * 0.1).astype(np.float32)
    params = jax.jit(mlp.init)(jax.random.key(seed), jnp.zeros((1, 2, 2, 63)), shape[:1],
                      appea[:1], aud[:1])["params"]
    pe = rng.standard_normal((B, R, NS, 64)).astype(np.float32)
    pe[..., 63:] = 0.0
    zd = (np.abs(rng.standard_normal((B, R, NS))) * 0.3).astype(np.float32)
    zv = np.sort(rng.standard_normal((B, R, NS)), axis=-1).astype(np.float32)
    jpacked = jax.jit(jfr.pack_weights)(params, *(jnp.asarray(c) for c in (shape, appea, aud)))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tpacked = fr.pack_weights(tparams, *(torch.from_numpy(c) for c in (shape, appea, aud)))
    return (pe, zd, zv), jpacked, tpacked


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool contends with XLA's in one process; tiny
    shapes run fastest on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _torch(inputs):
    return [torch.from_numpy(v) for v in inputs]


def _assert_all(outs, refs, tol):
    for name, a, b in zip(("feat", "bg_alpha", "depth"), outs, refs):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


def test_pack_weights_matches_jax(setup):
    _, jp, tp = setup
    for k, v in tp.items():
        ref = np.asarray(jp[k])
        if k == "wd":            # the TPU kernel's 128-lane pad is not carried over
            ref = ref[:, :1]
        np.testing.assert_allclose(v.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=k)


def test_reference_render_matches_jax_f32(setup):
    inputs, jp, tp = setup
    refs = jax.jit(jfr.reference_render)(*(jnp.asarray(v) for v in inputs), jp)
    _assert_all(fr.reference_render(*_torch(inputs), tp, torch.float32), refs, 1e-5)


def test_plain_version_matches_pallas_interpret_f32(setup):
    inputs, jp, tp = setup
    refs = jfr.fused_render_fwd(*(jnp.asarray(v) for v in inputs), jp, tile_rays=16,
                                compute_dtype=jnp.float32, interpret=True)
    _assert_all(fr.reference_render(*_torch(inputs), tp, torch.float32), refs, 1e-5)


def test_reference_render_matches_jax_bf16(setup):
    inputs, jp, tp = setup
    refs = jax.jit(jfr.reference_render, static_argnames="compute_dtype")(
        *(jnp.asarray(v) for v in inputs), jp, compute_dtype=jnp.bfloat16)
    _assert_all(fr.reference_render(*_torch(inputs), tp, torch.bfloat16), refs, 2e-2)


def test_wrapper_takes_plain_version_on_cpu(setup):
    inputs, _, tp = setup
    before = fr.fused_render_fwd.launches
    out = fr.fused_render_fwd(*_torch(inputs), tp, torch.float32)
    ref = fr.reference_render(*_torch(inputs), tp, torch.float32)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fr.fused_render_fwd.launches == before   # the kernel did not run
