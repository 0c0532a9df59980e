"""Port parity: rays, positional encoding and compositing against the JAX
package (`ops/rays.py`, `ops/embedding.py`, `ops/compositing.py`), f32 on
the CPU, atol 1e-5 (same formulas; only the order of f32 sums and the
sin/cos implementations differ)."""

import jax.numpy as jnp
import numpy as np
import torch
import _jax_reference  # noqa: F401  (each xdist worker's share of torch threads)

from nerf3dtalker_tpu.ops import compositing as jcomp
from nerf3dtalker_tpu.ops import embedding as jemb
from nerf3dtalker_tpu.ops import rays as jrays
from nerf3dtalker_tpu.utils.camera import base_cam as jbase_cam
from nerf3dtalker_tpu_torch.ops import compositing, embedding, rays
from nerf3dtalker_tpu_torch.utils.camera import base_cam, ray_grid

ATOL = 1e-5


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=atol)


def _rays(S=8, B=2, seed=0):
    rng = np.random.default_rng(seed)
    xy, _ = ray_grid(S)
    cam = base_cam(S)
    xy = np.tile(xy, (B, 1, 1)) + rng.uniform(-0.5, 0.5, (B, S * S, 2)).astype(np.float32)
    Rm = np.tile(cam.Rmat, (B, 1, 1))
    Tv = np.tile(cam.Tvec, (B, 1)) + rng.normal(0, 0.1, (B, 3)).astype(np.float32)
    iv = np.tile(cam.inv_inmat, (B, 1, 1))
    return xy, Rm, Tv, iv


def test_camera_copy_matches_jax():
    a, b = base_cam(16), jbase_cam(16)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_rays_and_samples_match_jax():
    xy, Rm, Tv, iv = _rays()
    noise = np.random.default_rng(1).uniform(size=(2, 64, 17)).astype(np.float32)
    jr = jrays.gen_rays(*(jnp.asarray(v) for v in (xy, Rm, Tv, iv)))
    tr = rays.gen_rays(*(torch.from_numpy(v) for v in (xy, Rm, Tv, iv)))
    for a, b in zip(tr, jr):
        _close(a, b)
    # jittered strata: the same uniforms through both (u replaces jax.random)
    jz = jrays.stratified_zvals(jr, 16, 2.5, -3.5)
    jmid = 0.5 * (jz[..., 1:] + jz[..., :-1])
    ju = jnp.concatenate([jmid, jz[..., -1:]], -1)
    jl = jnp.concatenate([jz[..., :1], jmid], -1)
    jz_noisy = jl + (ju - jl) * jnp.asarray(noise)
    _close(rays.stratified_zvals(tr, 16, 2.5, -3.5), jz)
    _close(rays.stratified_zvals(tr, 16, 2.5, -3.5, torch.from_numpy(noise)), jz_noisy)
    jsp = jrays.sample_points(jr, jz)
    tsp = rays.sample_points(tr, rays.stratified_zvals(tr, 16, 2.5, -3.5))
    for a, b in zip(tsp, jsp):
        _close(a, b)


def test_positional_encodings_match_jax():
    xy, Rm, Tv, iv = _rays()
    jr = jrays.gen_rays(*(jnp.asarray(v) for v in (xy, Rm, Tv, iv)))
    tr = rays.gen_rays(*(torch.from_numpy(v) for v in (xy, Rm, Tv, iv)))
    jsp = jrays.sample_points(jr, jrays.stratified_zvals(jr, 16, 2.5, -3.5))
    tsp = rays.sample_points(tr, rays.stratified_zvals(tr, 16, 2.5, -3.5))
    _close(embedding.positional_encoding(tsp.pts, 10), jemb.positional_encoding(jsp.pts, 10))
    jpe = jemb.positional_encoding_rays(jr.origins, jr.directions, jr.lengths, jsp.zvals,
                                        10, True, pad_to=64)
    tpe = embedding.positional_encoding_rays(tr.origins, tr.directions, tr.lengths,
                                             tsp.zvals, 10, True, pad_to=64)
    assert tpe.shape == (2, 64, 16, 64)
    _close(tpe, jpe)
    assert float(tpe[..., 63:].abs().max()) == 0.0


def test_alpha_composite_matches_jax():
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((2, 32, 16, 8)).astype(np.float32)
    dens = np.abs(rng.standard_normal((2, 32, 16))).astype(np.float32) * 3
    zd = np.abs(rng.standard_normal((2, 32, 16))).astype(np.float32) * 0.2
    zv = np.sort(rng.standard_normal((2, 32, 16)), -1).astype(np.float32)
    j = jcomp.alpha_composite(*(jnp.asarray(v) for v in (feat, dens, zd, zv)))
    t = compositing.alpha_composite(*(torch.from_numpy(v) for v in (feat, dens, zd, zv)))
    for a, b in zip(t, j):
        _close(a, b)
