"""Port parity of the fused render module at hidden 32, FEAT 16, NS 8:
`pack_weights` and the plain `reference_render` against the JAX
`reference_render` and the JAX Pallas `fused_render_fwd` run in interpret
mode; the plain backward `reference_render_bwd` against the JAX Pallas
`fused_render_bwd` in interpret mode and against torch autograd; and the
autograd Function `fused_render` (K3, on the CPU through the plain
versions) against `jax.grad` through `pack_weights` + `fused_render`.

Tolerances: f32 atol/rtol 1e-5 (identical math, f32 sums in another
order). bf16 atol/rtol 2e-2: both round operands and every activation to
bf16 at the same places, but a different f32 summation order can flip a
bf16 rounding (one bf16 ulp is 2^-8 relative), and a flip propagates
through the later layers. Gradients are held per leaf against the leaf's
own magnitude, max|a - b| <= tol * max|b|: f32 1e-5; bf16 2e-2, where the
gradient activations pass through the same roundings backward as well.
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


def _cotangents(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, R, FEAT)).astype(np.float32),
            rng.standard_normal((B, R)).astype(np.float32),
            rng.standard_normal((B, R)).astype(np.float32))


def _assert_grads(port, jax_out, tol):
    """Port (d_pe, d_zd, d_zv, d_weights) against the JAX ones; JAX's
    lane-padded density kernel keeps its live column only."""
    d_pe, d_zd, d_zv, dw = port
    jd_pe, jd_zd, jd_zv, jdw = jax_out
    pairs = [(k, dw[k], np.asarray(jdw[k])[:, :1] if k == "wd" else np.asarray(jdw[k]))
             for k in dw]
    if d_pe is not None:
        pairs += [("d_pe", d_pe, jd_pe), ("d_zd", d_zd, jd_zd), ("d_zv", d_zv, jd_zv)]
    for name, a, b in pairs:
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        err, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= tol * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


@pytest.mark.parametrize("input_grads", [False, True])
def test_plain_bwd_matches_pallas_interpret_f32(setup, input_grads):
    inputs, jp, tp = setup
    cot = _cotangents()
    ref = jfr.fused_render_bwd(*(jnp.asarray(v) for v in inputs), jp,
                               *(jnp.asarray(c) for c in cot), tile_rays=16,
                               compute_dtype=jnp.float32, interpret=True,
                               input_grads=input_grads)
    out = fr.reference_render_bwd(*_torch(inputs), tp, *_torch(cot), torch.float32,
                                  input_grads=input_grads)
    assert (out[0] is None) == (not input_grads)
    _assert_grads(out, ref, 1e-5)


def test_plain_bwd_matches_pallas_interpret_bf16(setup):
    inputs, jp, tp = setup
    cot = _cotangents()
    ref = jfr.fused_render_bwd(*(jnp.asarray(v) for v in inputs), jp,
                               *(jnp.asarray(c) for c in cot), tile_rays=16,
                               compute_dtype=jnp.bfloat16, interpret=True, input_grads=True)
    out = fr.reference_render_bwd(*_torch(inputs), tp, *_torch(cot), torch.bfloat16,
                                  input_grads=True)
    _assert_grads(out, ref, 2e-2)


def test_plain_bwd_matches_autograd(setup):
    inputs, _, tp = setup
    cot = _torch(_cotangents())
    ins = [t.requires_grad_() for t in _torch(inputs)]
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    feat, bg, depth = fr.reference_render(*ins, leaves, torch.float32)
    loss = (feat * cot[0]).sum() + (bg * cot[1]).sum() + (depth * cot[2]).sum()
    grads = torch.autograd.grad(loss, ins + list(leaves.values()))
    out = fr.reference_render_bwd(*_torch(inputs), tp, *cot, torch.float32, input_grads=True)
    _assert_grads(out, (*grads[:3], dict(zip(leaves, grads[3:]))), 1e-5)


def test_fused_render_grads_match_jax_grad(setup):
    """K3 on the CPU: gradients of the NeRFMLP params and of the three codes
    through `pack_weights` + `fused_render`, against jax.grad through the
    JAX `pack_weights` + `fused_render` (Pallas, interpret mode), f32."""
    rng = np.random.default_rng(5)
    mlp = JNeRFMLP(vp_channels=63 + 179, vd_channels=127, hidden=HID, out_features=FEAT)
    codes = [(rng.standard_normal((B, n)) * 0.1).astype(np.float32) for n in (179, 127, 64)]
    params = jax.jit(mlp.init)(jax.random.key(1), jnp.zeros((1, 2, 2, 63)), codes[0][:1],
                               codes[1][:1], codes[2][:1])["params"]
    inputs = setup[0]
    cot = _cotangents(2)

    def jloss(p, c):
        packed = jfr.pack_weights(p, *c)
        feat, bg, depth = jfr.fused_render(*(jnp.asarray(v) for v in inputs), packed, 16,
                                           jnp.float32, True, False)
        return (feat * cot[0]).sum() + (bg * cot[1]).sum() + (depth * cot[2]).sum()

    jg_p, jg_c = jax.grad(jloss, argnums=(0, 1))(params, [jnp.asarray(c) for c in codes])
    tparams = {k: torch.tensor(np.array(v), requires_grad=True) for k, v in params.items()}
    tcodes = [torch.tensor(c, requires_grad=True) for c in codes]
    before = (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches)
    feat, bg, depth = fr.fused_render(*_torch(inputs), fr.pack_weights(tparams, *tcodes),
                                      torch.float32)
    tc = _torch(cot)
    ((feat * tc[0]).sum() + (bg * tc[1]).sum() + (depth * tc[2]).sum()).backward()
    assert (fr.fused_render_fwd.launches, fr.fused_render_bwd.launches) == before
    pairs = [(k, tparams[k].grad, jg_p[k]) for k in tparams]
    pairs += list(zip(("shape_code", "appea_code", "audio_style"),
                      (c.grad for c in tcodes), jg_c))
    for name, a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        err, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= 1e-5 * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"
