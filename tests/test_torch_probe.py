"""Port parity of the xᵀ·g probe (`ops/kernels/probe_xtg.py`) against the
JAX probe `scripts/probe_mosaic_bf16T.py`: each of its four Pallas kernels
(`mk_kernel`), run in interpret mode on the script's own inputs (N=1024,
K=384, H=384, bf16), against the port's wrapper on CPU tensors, which takes
the plain version.

Tolerances, max|a - b| <= tol * max|b|: `loaded` 1e-5 (f32 sums of the same
bf16 products in another order); the modes that compute x' = bf16(relu(x·w))
2e-3: a different f32 summation order of x·w can round an element of x' to
the neighbouring bf16 value (2^-8 of itself), which moves the products it
enters by that much (the card measured 2.6e-4 of max|ref| for the kernel
against the plain version).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_reference  # noqa: F401  (each xdist worker's share of torch threads)
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nerf3dtalker_tpu_torch.ops.kernels import probe_xtg as px

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "probe_mosaic_bf16T.py"
TOL = {"loaded": 1e-5, "computed": 2e-3, "scratch": 2e-3, "f32": 2e-3}


@pytest.fixture(scope="module")
def probe():
    """The JAX probe module. Importing it runs its own loop once, which on
    the CPU reports each mode as failing (no interpret mode there)."""
    spec = importlib.util.spec_from_file_location("probe_mosaic_bf16T", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_shapes_are_the_scripts(probe):
    assert (px.N, px.K, px.H) == (probe.N, probe.K, probe.H)
    assert px.MODES == ("loaded", "computed", "scratch", "f32")


@pytest.mark.parametrize("mode", px.MODES)
def test_plain_version_matches_pallas_interpret(probe, mode):
    N, K, H = probe.N, probe.K, probe.H
    ref = pl.pallas_call(
        probe.mk_kernel(mode),
        out_shape=jax.ShapeDtypeStruct((K if mode == "loaded" else H, H), jnp.float32),
        scratch_shapes=[pltpu.VMEM((N, H), jnp.bfloat16), pltpu.VMEM((N, H), jnp.bfloat16)],
        interpret=True,
    )(probe.x, probe.g, probe.w)
    ref = np.asarray(ref)
    x, g, w = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
               for a in (probe.x, probe.g, probe.w))
    before = px.probe_xtg.launches
    out = px.probe_xtg(x, g, w, mode).numpy()
    assert px.probe_xtg.launches == before            # the CPU: plain version
    assert out.dtype == np.float32 and out.shape == ref.shape
    err, peak = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    assert err <= TOL[mode] * peak, f"{mode}: max abs err {err:.3e}, max|ref| {peak:.3e}"


def test_wrapper_rejects_an_unknown_mode():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mode"):
        px.probe_xtg(x, x, x, "transposed")
