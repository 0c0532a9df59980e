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
import _jax_reference  # noqa: F401  (each xdist worker's share of torch threads)

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


def _unpack_chunk(stream, off, rows, n):
    """Undo a chunk's core-matrix layout: [n/8][rows/8][8][8] -> [rows, n]."""
    return stream[off:off + rows * n].reshape(n // 8, rows // 8, 8, 8).permute(
        1, 2, 0, 3).reshape(rows, n)


# (Reso64 widths: PE_PAD, hidden, rgb_1, FEAT) -> 118 chunks, 2,703,360 bytes
# in bf16; at this file's widths every hidden matrix is one chunk and rgb_2
# (16 rows) one short chunk: 2 + 4 + 2 + 1 + 2 + 1 + 1 + 1 = 14
@pytest.mark.parametrize("widths,chunks,nbytes", [
    ((64, 384, 192, 256), 118, 2_703_360), ((64, HID, HID // 2, FEAT), 14, 26_112)],
    ids=["reso64", "test_widths"])
def test_weight_stream_chunks(widths, chunks, nbytes):
    pe, h, h2, feat = widths
    shapes = {"w0p": (pe, h), "wh": (6, h, h), "w5p": (pe, h), "w5x": (h, h),
              "wr0": (h, h), "wr1": (h, h2), "wr2": (h2, feat)}
    g = torch.Generator().manual_seed(0)
    w = {k: torch.randn(v, generator=g).to(torch.bfloat16) for k, v in shapes.items()}
    layout, stream = fr.stream_layout(w), fr.pack_stream(w)
    assert len(layout) == chunks and stream.numel() * 2 == nbytes
    assert stream.dtype == torch.bfloat16
    for key, m, k0, rows, n, off in layout:     # every chunk is its rows of its matrix
        mat = w[key] if m is None else w[key][m]
        assert torch.equal(_unpack_chunk(stream, off, rows, n), mat[k0:k0 + rows]), (key, m, k0)


def _k1_twin(pe, z_dists, zvals, weights):
    """K1's consumption of its weight stream, on the CPU in f32: the stream
    read chunk by chunk in order, each chunk's core-matrix layout undone and
    its product with the matching K range of the layer's input accumulated,
    as the kernel accumulates it (fea_5: its PE rows, then its hidden rows,
    into one sum), then bias and ReLU, the density head, the composite and
    the weighted sum over the samples."""
    w = {k: v.float() for k, v in weights.items()}
    stream = fr.pack_stream(w)
    B, R, ns, pe_pad = pe.shape
    outs = []
    for b in range(B):
        chunks = iter(fr.stream_layout(w))
        p = pe[b].reshape(R * ns, pe_pad)

        def layer(inputs, bias):
            acc = 0.0
            for a in inputs:
                k = 0
                while k < a.shape[1]:
                    _, _, k0, rows, n, off = next(chunks)
                    assert k0 == k
                    acc = acc + a[:, k0:k0 + rows] @ _unpack_chunk(stream, off, rows, n)
                    k += rows
            return acc + bias

        x = torch.relu(layer([p], w["b0"][b]))
        for i in range(4):
            x = torch.relu(layer([x], w["bh"][i]))
        x = torch.relu(layer([p, x], w["b5"][b]))
        for i in range(4, 6):
            x = torch.relu(layer([x], w["bh"][i]))
        sigma = torch.relu(x @ w["wd"][:, 0] + w["bd"])
        r1 = torch.relu(layer([layer([x], w["br0"])], w["br1"][b]))
        rgb = layer([r1], w["br2"])
        assert next(chunks, None) is None      # the whole stream, nothing more
        outs.append(fr._composite(rgb, sigma, z_dists[b], zvals[b]))
    return tuple(torch.stack(o) for o in zip(*outs))


def test_stream_twin_matches_reference_render_and_jax_f32(setup):
    """A chunk-order or layout bug of the stream shows here without a card:
    the twin within 1e-5 of each output's max|ref| of `reference_render`
    and of the JAX reference."""
    inputs, jp, tp = setup
    twin = _k1_twin(*_torch(inputs), tp)
    ref = fr.reference_render(*_torch(inputs), tp, torch.float32)
    jref = jax.jit(jfr.reference_render)(*(jnp.asarray(v) for v in inputs), jp)
    for name, a, b, c in zip(("feat", "bg_alpha", "depth"), twin, ref, jref):
        for other in (b, np.asarray(c)):
            other = torch.as_tensor(np.asarray(other))
            err, peak = float((a - other).abs().max()), float(other.abs().max())
            assert err <= 1e-5 * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"


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


@pytest.fixture(scope="module")
def pallas_bwd_bf16(setup):
    """The Pallas backward at bf16 in interpret mode, with input grads."""
    inputs, jp, _ = setup
    return jfr.fused_render_bwd(*(jnp.asarray(v) for v in inputs), jp,
                                *(jnp.asarray(c) for c in _cotangents()), tile_rays=16,
                                compute_dtype=jnp.bfloat16, interpret=True, input_grads=True)


def test_plain_bwd_matches_pallas_interpret_bf16(setup, pallas_bwd_bf16):
    inputs, jp, tp = setup
    cot = _cotangents()
    out = fr.reference_render_bwd(*_torch(inputs), tp, *_torch(cot), torch.bfloat16,
                                  input_grads=True)
    _assert_grads(out, pallas_bwd_bf16, 2e-2)


# K2's plain version at bf16 against the Pallas backward at bf16, and each
# against the f64 gradient (autograd through the plain forward in f64, the
# weights unrounded), by relative L2 on d_pe and on every weight gradient.
# Both round weights and activations to bf16 at the same places and sum in
# f32, so only the f32 summation order separates them (measured up to
# 1.2e-7 here; a flipped bf16 rounding would show as ~1e-3). Against f64
# each is off by the bf16 rounding itself, the same for both (measured
# 5.8e-3 on bd to 2.0e-1 on d_pe and w5p, equal to 3 digits): the port's
# plain version must be no further off than the Pallas backward, beyond
# BF16_VS_F64_SLACK of the latter
BF16_PLAIN_VS_PALLAS_REL_L2 = 1e-5
BF16_VS_F64_SLACK = 1.01


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def bf16_backward_errors(setup, pallas, monkeypatch):
    """{name: (plain vs Pallas, plain vs f64, Pallas vs f64)} relative L2,
    names d_pe and the packed weight gradients. The f64 forward takes its
    products in f64 too (the plain versions' `_mm` multiplies in f32)."""
    inputs, _, tp = setup
    cot = _torch(_cotangents())
    port = fr.reference_render_bwd(*_torch(inputs), tp, *cot, torch.bfloat16, input_grads=True)
    ins = [t.double().requires_grad_() for t in _torch(inputs)]
    leaves = {k: v.double().requires_grad_() for k, v in tp.items()}
    monkeypatch.setattr(fr, "_mm", lambda a, b: a.double() @ b.double())
    outs = fr.reference_render(*ins, leaves, torch.float64)
    grads = torch.autograd.grad(outs, [ins[0], *leaves.values()], [c.double() for c in cot])
    f64 = {"d_pe": grads[0], **dict(zip(leaves, grads[1:]))}
    got = {"d_pe": port[0], **port[3]}
    ref = {"d_pe": pallas[0], **{k: np.asarray(v)[:, :1] if k == "wd" else v
                                 for k, v in pallas[3].items()}}
    return {k: (_rel_l2(got[k], ref[k]), _rel_l2(got[k], f64[k]), _rel_l2(ref[k], f64[k]))
            for k in got}


def test_plain_bwd_bf16_is_no_further_from_f64_than_pallas(setup, pallas_bwd_bf16,
                                                          monkeypatch):
    errs = bf16_backward_errors(setup, pallas_bwd_bf16, monkeypatch)
    for name, (vs_pallas, plain_f64, pallas_f64) in errs.items():
        assert vs_pallas <= BF16_PLAIN_VS_PALLAS_REL_L2, (name, vs_pallas)
        assert plain_f64 <= BF16_VS_F64_SLACK * pallas_f64, (name, plain_f64, pallas_f64)


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


def test_scratch_holds_the_stash_and_the_splits_partials():
    """K2's device scratch (`scratch_bytes`): the bf16 stash of 7,617 values
    a point in `_STASH_LAYOUT` order, then one f32 partial per reduction
    split of the weight-gradient pass (`csrc/xtg_core.cuh`: 91 tiles of
    128 x 128 over K2's 13 jobs, each batch row's rays cut into
    `xtg_splits_per_batch` splits)."""
    assert fr._STASH_WIDTH == 64 + 8 * 384 + 384 + 192 + 256 + 192 + 384 + 8 * 384 + 1 == 7617
    assert [n for n, _ in fr._STASH_LAYOUT][:2] == ["pe", "x0"]
    assert fr._STASH_LAYOUT[-1] == ("dsig", 1)
    # every weight and bias gradient once, each at a multiple of 4 floats
    outputs = (2 * 64 * 384 + 8 * 384 * 384 + 384 * 192 + 192 * 256 + 384      # weights
               + 384 + 6 * 384 + 384 + 384 + 192 + 256 + 1)                    # biases
    assert outputs <= fr._SPLIT_WIDTH < outputs + 64 + 4 * 26
    assert fr._SPLIT_WIDTH % 64 == 0
    assert fr._xtg_tiles(fr._K2_JOBS) == 91
    # the Reso64 training batch: 23 splits a batch row, 250 MB of partials
    assert fr.xtg_splits_per_batch(91, 2, 4096) == (2 * fr._XTG_TARGET_BLOCKS + 182) // 364
    for B, R in ((2, 4096), (1, 2048), (1, 33), (2, 64), (1, 1)):
        splits = fr.xtg_splits_per_batch(91, B, R)
        assert 1 <= splits <= R
        assert fr.scratch_bytes(B, R) == (B * R * NS_K2 * 7617 * 2
                                          + B * splits * fr._SPLIT_WIDTH * 4)
    assert fr.scratch_bytes(2, 4096) < 8.68e9    # 8.68 GB with 128 splits of 64 rays


NS_K2 = fr.NS


def test_xtg_core_plain_version_matches_jax():
    """The X^T G core's plain version (`reference_xtg_core`) against
    jax.numpy on the same inputs, f32: a shared job with its bias sums, a
    per-batch job (weight and bias), and a narrow job (out == 1, as dwd and
    dbd); the wrapper on CPU tensors takes it and launches nothing."""
    rng = np.random.default_rng(3)
    Bj, P = 3, 3 * 128
    shapes = [(64, 128), (192, 64), (128, 1)]
    data = [(rng.standard_normal((P, i)).astype(np.float32),
             rng.standard_normal((P, o)).astype(np.float32)) for i, o in shapes]
    flags = [(True, False, False), (True, True, True), (True, False, False)]
    jobs = [(torch.from_numpy(x), torch.from_numpy(g), *f) for (x, g), f in zip(data, flags)]
    before = fr.xtg_core.launches
    outs = fr.xtg_core(jobs, Bj)
    assert fr.xtg_core.launches == before
    for (x, g), (bias, pw, pb), (dw, db) in zip(data, flags, outs):
        xb, gb = jnp.asarray(x).reshape(Bj, -1, x.shape[1]), jnp.asarray(g).reshape(Bj, -1, g.shape[1])
        ref_w = jnp.einsum("bpi,bpo->bio", xb, gb, precision=jax.lax.Precision.HIGHEST)
        ref_b = gb.sum(1)
        for got, ref in ((dw, ref_w if pw else ref_w.sum(0)), (db, ref_b if pb else ref_b.sum(0))):
            ref = np.asarray(ref)
            assert got.shape == ref.shape
            err, peak = float(np.abs(got.numpy() - ref).max()), float(np.abs(ref).max())
            assert err <= 1e-5 * peak, f"max abs err {err:.3e}, max|ref| {peak:.3e}"


# The composite as the backward kernel's ray kernel runs it: one warp, lane l
# holding samples 2l and 2l + 1; the transmittance from an inclusive product
# scan over the lanes (Hillis-Steele, shuffles up by 1, 2, 4, 8, 16) of
# t[2l] t[2l+1], and the suffix sum of d_w w from a scan downwards. Against
# the serial loop the kernel ran before, in float32, op by op: the products
# and sums associate differently, so the two agree to rounding only. Over 64
# samples that is within COMPOSITE_RTOL of each output's max|serial| (the
# worst measured here, with densities that drive alpha to 1 and t to 1e-10,
# was 1.6e-7).
COMPOSITE_RTOL = 1e-5
f32 = np.float32


def _composite_serial(sp, zd, zv, dwr, g_bg, g_depth):
    n = sp.shape[0]
    a = f32(1) - np.exp(-np.maximum(sp, f32(0)) * zd)
    t = f32(1) - a + f32(1e-10)
    trans, w = np.empty(n, f32), np.empty(n, f32)
    tr = f32(1)
    for p in range(n):
        trans[p] = tr
        w[p] = a[p] * tr
        tr = f32(tr * t[p])
    ds, dzd = np.empty(n, f32), np.empty(n, f32)
    suffix = f32(0)
    for p in range(n - 1, -1, -1):
        d_w = f32(f32(dwr[p] + f32(zv[p] * g_depth)) - g_bg)
        d_alpha = f32(f32(d_w * trans[p]) - f32(suffix / t[p]))
        suffix = f32(suffix + f32(d_w * w[p]))
        one_m_a = f32(1) - a[p]
        ds[p] = d_alpha * zd[p] * one_m_a * (f32(1) if sp[p] > 0 else f32(0))
        dzd[p] = d_alpha * max(sp[p], f32(0)) * one_m_a
    return w, ds, dzd, w * g_depth


def _composite_warp_scan(sp, zd, zv, dwr, g_bg, g_depth):
    a = f32(1) - np.exp(-np.maximum(sp, f32(0)) * zd)
    t = f32(1) - a + f32(1e-10)
    lanes = np.arange(32)
    incl = t[0::2] * t[1::2]
    for o in (1, 2, 4, 8, 16):
        v = np.roll(incl, o)
        incl = np.where(lanes >= o, v * incl, incl)
    excl = np.where(lanes == 0, f32(1), np.roll(incl, 1))
    T = np.stack([excl, excl * t[0::2]], 1).reshape(-1)
    w = a * T
    d_w = (dwr + zv * g_depth) - g_bg
    c = d_w * w
    sfx = c[0::2] + c[1::2]
    for o in (1, 2, 4, 8, 16):
        v = np.roll(sfx, -o)
        sfx = np.where(lanes + o < 32, sfx + v, sfx)
    after = np.where(lanes == 31, f32(0), np.roll(sfx, -1))
    suffix = np.stack([after + c[1::2], after], 1).reshape(-1)
    d_alpha = d_w * T - suffix / t
    one_m_a = f32(1) - a
    ds = d_alpha * zd * one_m_a * (sp > 0).astype(f32)
    dzd = d_alpha * np.maximum(sp, f32(0)) * one_m_a
    return w, ds, dzd, w * g_depth


@pytest.mark.parametrize("density", [1.0, 30.0], ids=["moderate", "opaque"])
def test_warp_scan_composite_matches_the_serial_composite(density):
    rng = np.random.default_rng(11)
    outs = {"weights": [[], []], "d_sigma": [[], []], "d_zd": [[], []], "d_zv": [[], []]}
    for _ in range(64):
        sp = (rng.standard_normal(64) * density).astype(f32)
        zd = (rng.random(64) * 0.1).astype(f32)
        zv = np.sort(rng.standard_normal(64)).astype(f32)
        dwr = rng.standard_normal(64).astype(f32)
        g_bg, g_depth = f32(rng.standard_normal()), f32(rng.standard_normal())
        for k, res in enumerate((_composite_serial(sp, zd, zv, dwr, g_bg, g_depth),
                                 _composite_warp_scan(sp, zd, zv, dwr, g_bg, g_depth))):
            for name, v in zip(outs, res):
                outs[name][k].append(v)
    for name, (serial, scan) in outs.items():
        serial, scan = np.stack(serial), np.stack(scan)
        assert np.isfinite(scan).all(), name
        err, peak = float(np.abs(scan - serial).max()), float(np.abs(serial).max())
        assert err <= COMPOSITE_RTOL * peak, f"{name}: max abs err {err:.3e}, max|ref| {peak:.3e}"
