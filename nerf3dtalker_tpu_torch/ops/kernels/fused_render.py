"""Fused NeRF point-MLP + volume compositing: the CUDA kernels' wrappers,
their plain PyTorch versions and the autograd Function that joins them
(port of `nerf3dtalker_tpu/ops/pallas/fused_render.py`).

  fused_render_fwd  forward, `csrc/fused_render_fwd.cu`; plain version
                    `reference_render`; it reads the weights as one stream
                    of chunks laid out by `pack_stream`
  fused_render_bwd  recompute backward, `csrc/fused_render_bwd.cu`; plain
                    version `reference_render_bwd`
  xtg_core          its weight-gradient pass alone, the X^T G core
                    (`csrc/xtg_core.cuh`) over a list of jobs; plain version
                    `reference_xtg_core`
  fused_render      `FusedRender`, the differentiable render: forward
                    through the first, backward through the second
  fused_render_spmd `FusedRenderSPMD`, the same on one rank's shard of a
                    (data, rays) mesh, with the weight gradients all-reduced
                    over the rays group; plain version `reference_render_spmd`

A wrapper launches its kernel on a CUDA tensor and takes the plain version,
with the same arithmetic, on a CPU tensor. There is no other route: a CUDA
tensor the kernel does not take raises.

Each wrapper counts its launches (`fused_render_fwd.launches`, ...). A
launch made while a stream captures a CUDA graph runs only when the graph
replays: it is recorded by the `record_launches` in force and counted by
`replay`, once per replay.

Packed weight layout (kernels [in, out]; per-batch conditioning codes folded
into biases by `pack_weights`, a linear op in front of the kernel):
  w0p   [PE_PAD, H]  fea_0 rows for the (padded) positional encoding
  wh    [6, H, H]    fea_1..4, fea_6, fea_7
  w5p   [PE_PAD, H]  fea_5 skip rows for the PE
  w5x   [H, H]       fea_5 rows for the hidden state
  wd    [H, 1]       density head
  wr0   [H, H]       rgb_0 (no activation after it)
  wr1   [H, H2]      rgb_1 hidden rows (appearance code folded into br1)
  wr2   [H2, FEAT]   rgb_2
  b0, b5 [B, H]; br1 [B, H2] per batch; bh [6, H]; bd []; br0 [H]; br2 [FEAT]
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from nerf3dtalker_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

# the dims the CUDA kernel is compiled for (Reso32/64 flagship)
H = 384
H2 = 192
PE_PAD = 64
NS = 64
FEAT = 256

_WEIGHTS = ("w0p", "wh", "w5p", "w5x", "wd", "wr0", "wr1", "wr2")
_BIASES = ("b0", "bh", "b5", "bd", "br0", "br1", "br2")


def pe_pad_for(p_live: int) -> int:
    """Padded PE width (63 -> 64), shared by pack_weights and the model."""
    return -(-p_live // 8) * 8


def pack_weights(mlp_params: Dict[str, torch.Tensor], shape_code, appea_code,
                 audio_style) -> Dict[str, torch.Tensor]:
    """Fold NeRFMLP params (flax names, [in, out] kernels) and the
    per-batch [B, ...] codes into the kernel layout above."""
    p = mlp_params
    S = shape_code.shape[-1]
    A = audio_style.shape[-1]
    p_live = p["fea_0_kernel"].shape[0] - S - A
    pad = pe_pad_for(p_live) - p_live

    def pad_pe_rows(k):
        return F.pad(k, (0, 0, 0, pad))

    k0 = p["fea_0_kernel"]
    b0 = (shape_code @ k0[p_live:p_live + S] + audio_style @ k0[p_live + S:]
          + p["fea_0_bias"])
    hidden = p["fea_1_kernel"].shape[0]
    k5 = p["fea_5_kernel"]
    b5 = shape_code @ k5[p_live:p_live + S] + p["fea_5_bias"]
    kr1 = p["rgb_1_kernel"]
    br1 = appea_code @ kr1[hidden:] + p["rgb_1_bias"]
    idx = (1, 2, 3, 4, 6, 7)
    return {
        "w0p": pad_pe_rows(k0[:p_live]),
        "wh": torch.stack([p[f"fea_{i}_kernel"] for i in idx]),
        "w5p": pad_pe_rows(k5[:p_live]),
        "w5x": k5[p_live + S:],
        "wd": p["density_kernel"],
        "wr0": p["rgb_0_kernel"],
        "wr1": kr1[:hidden],
        "wr2": p["rgb_2_kernel"],
        "b0": b0,
        "bh": torch.stack([p[f"fea_{i}_bias"] for i in idx]),
        "b5": b5,
        "bd": p["density_bias"].reshape(()),
        "br0": p["rgb_0_bias"],
        "br1": br1,
        "br2": p["rgb_2_bias"],
    }


def _mm(a, b):
    """Operands in the compute dtype, f32 accumulate and f32 result (a
    product of two bf16 values is exact in f32)."""
    return a.float() @ b.float()


def _mlp_tile_stash(pe, w, b0, b5, br1, dtype):
    """Point MLP over pe [N, PE_PAD], keeping what the backward needs:
    (pe, xs = the 8 hidden activations, sigma_pre, r0, r1, rgb [N, FEAT]
    f32). Rounds to `dtype` where the TPU kernel rounds."""
    pe = pe.to(dtype)
    xs = [torch.relu(_mm(pe, w["w0p"]) + b0).to(dtype)]
    for i in range(4):
        xs.append(torch.relu(_mm(xs[-1], w["wh"][i]) + w["bh"][i]).to(dtype))
    xs.append(torch.relu(_mm(pe, w["w5p"]) + _mm(xs[-1], w["w5x"]) + b5).to(dtype))
    for i in range(4, 6):
        xs.append(torch.relu(_mm(xs[-1], w["wh"][i]) + w["bh"][i]).to(dtype))
    sigma_pre = _mm(xs[-1], w["wd"])[:, 0] + w["bd"]
    r0 = (_mm(xs[-1], w["wr0"]) + w["br0"]).to(dtype)
    r1 = torch.relu(_mm(r0, w["wr1"]) + br1).to(dtype)
    rgb = _mm(r1, w["wr2"]) + w["br2"]
    return pe, xs, sigma_pre, r0, r1, rgb


def _mlp_tile(pe, w, b0, b5, br1, dtype):
    """Point MLP: pe [N, PE_PAD] -> (rgb [N, FEAT] f32, sigma [N] f32)."""
    _, _, sigma_pre, _, _, rgb = _mlp_tile_stash(pe, w, b0, b5, br1, dtype)
    return rgb, torch.relu(sigma_pre)


def _composite_weights(sigma, z_dists):
    """sigma, z_dists [R, NS] -> (alpha, t = 1 - alpha + 1e-10, exclusive
    transmittance T, weights w = alpha * T)."""
    alpha = 1.0 - torch.exp(-sigma * z_dists)
    t = 1.0 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], 1), 1)
    return alpha, t, trans, alpha * trans


def _composite(rgb, sigma, z_dists, zvals):
    """rgb [R*NS, FEAT], sigma [R*NS] -> feat [R, FEAT], bg_alpha, depth."""
    r, ns = z_dists.shape
    w = _composite_weights(sigma.reshape(r, ns), z_dists)[3]
    feat = torch.sum(rgb.reshape(r, ns, -1) * w[:, :, None], dim=1)
    return feat, 1.0 - w.sum(-1), (w * zvals).sum(-1)


def _cast_weights(weights, compute_dtype):
    return {k: (v.to(compute_dtype) if k.startswith("w") else v.float())
            for k, v in weights.items()}


def reference_render(pe, z_dists, zvals, weights, compute_dtype=torch.float32):
    """Plain version of the forward kernel: the same arithmetic in PyTorch
    ops. Shapes as `fused_render_fwd`; one batch row at a time."""
    B, R, ns, pe_pad = pe.shape
    w = _cast_weights(weights, compute_dtype)
    outs = []
    for b in range(B):
        rgb, sigma = _mlp_tile(pe[b].reshape(R * ns, pe_pad), w, w["b0"][b],
                               w["b5"][b], w["br1"][b], compute_dtype)
        outs.append(_composite(rgb, sigma, z_dists[b], zvals[b]))
    return tuple(torch.stack(o) for o in zip(*outs))


_CHUNK_RAYS = 512   # rays per chunk of the plain backward (32,768 points)


def reference_render_bwd(pe, z_dists, zvals, weights, g_feat, g_bg, g_depth,
                         compute_dtype=torch.float32, input_grads=True):
    """Plain version of the backward kernel: recompute the forward, then
    backpropagate the composite in f32 and the MLP with the TPU kernel's
    rounding (`_bwd_kernel`): gradient activations in `compute_dtype`
    (ReLU masks applied in f32 before the cast), `d_sigma_pre` in f32 before
    its cast, weight and bias sums accumulated in f32.

    Returns (d_pe, d_zd, d_zv, d_weights), f32; d_weights has the packed
    layout of `pack_weights` (b0/b5/br1 per batch row). d_pe/d_zd/d_zv are
    None unless `input_grads`. Works through `_CHUNK_RAYS` rays at a time
    so that the activations of one chunk only are alive."""
    B, R, ns, pe_pad = pe.shape
    dt = compute_dtype
    w = _cast_weights(weights, dt)
    f32 = dict(dtype=torch.float32, device=pe.device)
    dw = {k: torch.zeros(v.shape, **f32) for k, v in w.items()}
    d_pe = torch.zeros(pe.shape, **f32) if input_grads else None
    d_zd = torch.zeros(z_dists.shape, **f32) if input_grads else None
    d_zv = torch.zeros(zvals.shape, **f32) if input_grads else None

    def relu_mask(g, act):
        return (g * (act.float() > 0).float()).to(dt)

    def mm_t(a, b):           # a.T @ b over the point axis
        return _mm(a.to(dt).T, b.to(dt))

    def colsum(x):
        return x.to(dt).float().sum(0)

    for b in range(B):
        for r0 in range(0, R, _CHUNK_RAYS):
            rs = slice(r0, min(r0 + _CHUNK_RAYS, R))
            zd, zv = z_dists[b, rs], zvals[b, rs]
            n = zd.shape[0]
            pe_c, xs, sigma_pre, x_r0, x_r1, rgb = _mlp_tile_stash(
                pe[b, rs].reshape(n * ns, pe_pad), w, w["b0"][b], w["b5"][b],
                w["br1"][b], dt)
            # composite backward, f32
            sig = torch.relu(sigma_pre).reshape(n, ns)
            alpha, t, trans, wts = _composite_weights(sig, zd)
            gf, gb, gd = g_feat[b, rs], g_bg[b, rs], g_depth[b, rs]
            d_rgb = (wts[:, :, None] * gf[:, None, :]).reshape(n * ns, -1)
            d_w = (rgb.reshape(n, ns, -1) * gf[:, None, :]).sum(-1) + zv * gd[:, None] \
                - gb[:, None]
            c = d_w * wts
            incl = torch.flip(torch.cumsum(torch.flip(c, [1]), 1), [1])
            suffix = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], 1)
            d_alpha = d_w * trans - suffix / t
            one_m_a = 1.0 - alpha
            if input_grads:
                d_zd[b, rs] = d_alpha * sig * one_m_a
                d_zv[b, rs] = wts * gd[:, None]
            d_sigma_pre = (d_alpha * zd * one_m_a).reshape(-1) * (sigma_pre > 0).float()

            # MLP backward, each gradient activation consumed as it is made
            d_sig = d_sigma_pre.to(dt)[:, None]
            d_rgb = d_rgb.to(dt)
            dw["wr2"] += mm_t(x_r1, d_rgb)
            dw["br2"] += colsum(d_rgb)
            d_r1 = relu_mask(_mm(d_rgb, w["wr2"].T), x_r1)
            dw["wr1"] += mm_t(x_r0, d_r1)
            dw["br1"][b] += colsum(d_r1)
            d_r0 = _mm(d_r1, w["wr1"].T).to(dt)
            dw["wr0"] += mm_t(xs[7], d_r0)
            dw["br0"] += colsum(d_r0)
            dw["wd"] += mm_t(xs[7], d_sig)
            dw["bd"] += colsum(d_sig)[0]
            g = relu_mask(_mm(d_sig, w["wd"].T) + _mm(d_r0, w["wr0"].T), xs[7])   # g7
            for layer, i in ((5, 7), (4, 6)):      # fea_7, fea_6
                dw["wh"][layer] += mm_t(xs[i - 1], g)
                dw["bh"][layer] += colsum(g)
                g = relu_mask(_mm(g, w["wh"][layer].T), xs[i - 1])
            g5 = g
            dw["w5p"] += mm_t(pe_c, g5)
            dw["w5x"] += mm_t(xs[4], g5)
            dw["b5"][b] += colsum(g5)
            g = relu_mask(_mm(g5, w["w5x"].T), xs[4])                            # g4
            for layer in (3, 2, 1, 0):              # fea_4 .. fea_1
                dw["wh"][layer] += mm_t(xs[layer], g)
                dw["bh"][layer] += colsum(g)
                g = relu_mask(_mm(g, w["wh"][layer].T), xs[layer])
            dw["w0p"] += mm_t(pe_c, g)
            dw["b0"][b] += colsum(g)
            if input_grads:
                d_pe[b, rs] = (_mm(g, w["w0p"].T) + _mm(g5, w["w5p"].T)).reshape(
                    n, ns, pe_pad)
    return d_pe, d_zd, d_zv, dw


def _check(name, t, shape, dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _kernel_args(pe, z_dists, zvals, weights):
    """Validate the kernel's operands and cast the packed weights to the
    kernel's types (bf16 weights, f32 biases), as the TPU wrapper does."""
    B, R = pe.shape[:2]
    dev = pe.device
    _check("pe", pe, (B, R, NS, PE_PAD), torch.float32)
    _check("z_dists", z_dists, (B, R, NS), torch.float32)
    _check("zvals", zvals, (B, R, NS), torch.float32)
    shapes = {
        "w0p": (PE_PAD, H), "wh": (6, H, H), "w5p": (PE_PAD, H), "w5x": (H, H),
        "wd": (H, 1), "wr0": (H, H), "wr1": (H, H2), "wr2": (H2, FEAT),
        "b0": (B, H), "bh": (6, H), "b5": (B, H), "bd": (), "br0": (H,),
        "br1": (B, H2), "br2": (FEAT,),
    }
    cast = {}
    for k in _WEIGHTS + _BIASES:
        dtype = torch.bfloat16 if k in _WEIGHTS else torch.float32
        v = weights[k]
        if v.device != dev:
            raise ValueError(f"weight {k} is on {v.device}, pe on {dev}")
        cast[k] = v.to(dtype).contiguous()
        _check(k, cast[k], shapes[k], dtype)
    return cast


_c_fns: Dict[str, object] = {}


def _c_fn(name: str, argtypes, symbol: Optional[str] = None):
    """The C function `symbol` (default `<name>_launch`) of kernel `name`,
    built, loaded and bound at its first call."""
    symbol = symbol or f"{name}_launch"
    fn = _c_fns.get(symbol)
    if fn is None:
        from nerf3dtalker_tpu_torch.ops.kernels import build

        fn = getattr(build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _c_fns[symbol] = fn
    return fn


# every pointer as c_void_p: left undeclared, ctypes passes a Python int as
# a 32-bit C int and cuts the pointer
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 15 + [_I, _I, _P]                           # ..., B, R, stream
_BWD_ARGS = [_P] * 40 + [_I, _I, _I, ctypes.c_longlong, _P]    # ..., B, R, input_grads,
#                                                                scratch bytes, stream


# K1's weight stream (`csrc/fused_render_fwd.cu`): the matrices in the order
# the kernel consumes them -- fea_0's PE rows, fea_1..4, fea_5's PE rows then
# its hidden rows, fea_6, fea_7, rgb_0, rgb_1, rgb_2 -- cut into chunks of
# STREAM_ROWS rows. The density head wd is not in it.
STREAM_ROWS = 32
_STREAM = (("w0p", None), ("wh", slice(0, 4)), ("w5p", None), ("w5x", None),
           ("wh", slice(4, 6)), ("wr0", None), ("wr1", None), ("wr2", None))


def _stream_runs(weights):
    """(key, first matrix index or None, [L, K, N]) for each run of _STREAM."""
    for key, sl in _STREAM:
        w = weights[key]
        yield (key, None, w[None]) if sl is None else (key, sl.start, w[sl])


def stream_layout(weights) -> list:
    """K1's weight stream chunk by chunk, in order: (key, matrix index in a
    stacked key or None, first row, rows, N, offset in elements). A chunk
    holds rows [first, first + rows) of its [K, N] matrix; the last chunk of
    a matrix is shorter when K is not a multiple of STREAM_ROWS."""
    out, off = [], 0
    for key, m0, run in _stream_runs(weights):
        L, K, N = run.shape
        for m in range(L):
            for k0 in range(0, K, STREAM_ROWS):
                rows = min(STREAM_ROWS, K - k0)
                out.append((key, None if m0 is None else m0 + m, k0, rows, N, off))
                off += rows * N
    return out


def pack_stream(weights) -> torch.Tensor:
    """The weights as K1 reads them, flat, in the weights' dtype: the chunks
    of `stream_layout` in order, each [rows, N] chunk stored as 8 x 8 core
    matrices [N / 8][rows / 8][8][8] (the 8 rows of a core matrix are 8
    consecutive k, its 8 columns 8 consecutive n), so that each chunk is one
    contiguous copy into the kernel's shared memory and the B operand of
    its wgmma as it lands. A reshape and permute, no kernel of its own."""
    parts = []
    for _, _, run in _stream_runs(weights):
        L, K, N = run.shape
        full = K - K % STREAM_ROWS
        if full == K:
            parts.append(run.reshape(L * K // STREAM_ROWS, STREAM_ROWS // 8, 8, N // 8, 8)
                         .permute(0, 3, 1, 2, 4).reshape(-1))
            continue
        for w in run:        # a short last chunk: matrix by matrix
            if full:
                parts.append(w[:full].reshape(full // STREAM_ROWS, STREAM_ROWS // 8, 8, N // 8, 8)
                             .permute(0, 3, 1, 2, 4).reshape(-1))
            parts.append(w[full:].reshape((K - full) // 8, 8, N // 8, 8)
                         .permute(2, 0, 1, 3).reshape(-1))
    return torch.cat(parts)


_DESIGN_KEYS = ("rays_per_block", "stages", "chunk_rows", "chunks", "stream_bytes", "smem_bytes",
                "resident_blocks")


def fused_render_fwd_design(device=None) -> Dict[str, int]:
    """K1's design as compiled (`fused_render_fwd_design` in its source):
    rays a block, ring slots, rows a chunk, the stream's chunks and bytes,
    shared memory a block, and the blocks resident at once on `device` (the
    most its persistent grid holds)."""
    out = (ctypes.c_longlong * len(_DESIGN_KEYS))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = _c_fn("fused_render_fwd", [_P], "fused_render_fwd_design")(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fused_render_fwd_design failed: cudaError_t {err}")
    return dict(zip(_DESIGN_KEYS, out))


_recording: List[Dict[str, int]] = []   # the captures in progress, innermost last


@contextlib.contextmanager
def record_launches() -> Iterator[Dict[str, int]]:
    """The K1 and K2 launches recorded into a CUDA graph captured inside
    this block, by wrapper name; `replay` counts them."""
    rec = {"fused_render_fwd": 0, "fused_render_bwd": 0, "input_grads": 0}
    _recording.append(rec)
    try:
        yield rec
    finally:
        _recording.pop()


def _launched(name: str, input_grads: bool = False) -> None:
    """Count one launch of kernel `name`: now, or, while a stream captures,
    at each replay of the graph."""
    if torch.cuda.is_current_stream_capturing():
        if not _recording:
            raise RuntimeError(f"{name} launched into a CUDA graph outside record_launches(): "
                               "its replays would go uncounted")
        _recording[-1][name] += 1
        _recording[-1]["input_grads"] += int(input_grads)
        return
    if name == "fused_render_fwd":
        fused_render_fwd.launches += 1
    else:
        fused_render_bwd.launches += 1
        fused_render_bwd.input_grads_launches += int(input_grads)


def replay(graph, launches: Dict[str, int]) -> None:
    """Replay a CUDA graph on the current stream and count the kernel
    launches `record_launches` recorded into it."""
    graph.replay()
    fused_render_fwd.launches += launches["fused_render_fwd"]
    fused_render_bwd.launches += launches["fused_render_bwd"]
    fused_render_bwd.input_grads_launches += launches["input_grads"]


def fused_render_fwd(
    pe: torch.Tensor,        # [B, R, NS, PE_PAD] f32 (PE padded 63 -> 64)
    z_dists: torch.Tensor,   # [B, R, NS] f32
    zvals: torch.Tensor,     # [B, R, NS] f32
    weights: Dict[str, torch.Tensor],   # see pack_weights()
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (features [B, R, FEAT], bg_alpha [B, R], depth [B, R]), f32.

    A CPU tensor runs `reference_render`. A CUDA tensor launches the kernel,
    which computes in bf16 with f32 accumulation, on the current stream,
    with the weights packed into its stream (`pack_stream`)."""
    if pe.device.type == "cpu":
        return reference_render(pe, z_dists, zvals, weights, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16")
    w = _kernel_args(pe, z_dists, zvals, weights)
    B, R = pe.shape[:2]
    feat = torch.empty((B, R, FEAT), dtype=torch.float32, device=pe.device)
    bg = torch.empty((B, R), dtype=torch.float32, device=pe.device)
    depth = torch.empty((B, R), dtype=torch.float32, device=pe.device)
    ws = pack_stream(w)
    ptrs = [t.data_ptr() for t in (pe, z_dists, zvals, ws, w["wd"])]
    ptrs += [w[k].data_ptr() for k in _BIASES]
    ptrs += [t.data_ptr() for t in (feat, bg, depth)]
    with torch.cuda.device(pe.device):   # the launch goes to the current device
        err = _c_fn("fused_render_fwd", _FWD_ARGS)(
            *ptrs, B, R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_render_fwd kernel launch failed: cudaError_t {err}")
    _launched("fused_render_fwd")
    return feat, bg, depth


fused_render_fwd.launches = 0


def fused_render_bwd(
    pe: torch.Tensor, z_dists: torch.Tensor, zvals: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    g_feat: torch.Tensor,    # [B, R, FEAT] f32
    g_bg: torch.Tensor,      # [B, R] f32
    g_depth: torch.Tensor,   # [B, R] f32
    compute_dtype: torch.dtype = torch.bfloat16,
    input_grads: bool = True,
    scratch: Optional[torch.Tensor] = None,
):
    """Backward of `fused_render_fwd` for the output cotangents: returns
    (d_pe, d_zd, d_zv, d_weights), f32, as `reference_render_bwd`; the
    first three are None unless `input_grads`.

    A CPU tensor runs `reference_render_bwd`. A CUDA tensor launches the
    kernel (bf16 operands, f32 accumulation) on the current stream, with a
    scratch buffer that holds every activation and gradient activation of
    the batch in bf16 (`scratch_bytes`): `scratch` when given (a uint8
    tensor of that size, which `stash_chain_errors` can read afterwards),
    else a new one."""
    if pe.device.type == "cpu":
        return reference_render_bwd(pe, z_dists, zvals, weights, g_feat, g_bg, g_depth,
                                    compute_dtype, input_grads)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16")
    w = _kernel_args(pe, z_dists, zvals, weights)
    B, R = pe.shape[:2]
    dev = pe.device
    _check("g_feat", g_feat, (B, R, FEAT), torch.float32)
    _check("g_bg", g_bg, (B, R), torch.float32)
    _check("g_depth", g_depth, (B, R), torch.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    dw = {k: torch.empty(v.shape, **f32) for k, v in w.items()}
    ins = (torch.empty(pe.shape, **f32), torch.empty(z_dists.shape, **f32),
           torch.empty(zvals.shape, **f32)) if input_grads else (None, None, None)
    nbytes = scratch_bytes(B, R)
    if scratch is None:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _check("scratch", scratch, (nbytes,), torch.uint8)
    ptrs = [t.data_ptr() for t in (pe, z_dists, zvals, g_feat, g_bg, g_depth)]
    ptrs += [w[k].data_ptr() for k in _WEIGHTS + _BIASES]
    ptrs += [t.data_ptr() if t is not None else None for t in ins]
    ptrs += [dw[k].data_ptr() for k in _WEIGHTS + _BIASES]
    ptrs.append(scratch.data_ptr())
    with torch.cuda.device(dev):
        err = _c_fn("fused_render_bwd", _BWD_ARGS)(
            *ptrs, B, R, int(input_grads), nbytes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_render_bwd kernel launch failed: cudaError_t {err}")
    _launched("fused_render_bwd", input_grads)
    return (*ins, dw)


fused_render_bwd.launches = 0
fused_render_bwd.input_grads_launches = 0   # the launches with input_grads=True

# the bf16 stash at the head of the backward kernel's scratch: for each
# name, [B * R * NS, width] values (`csrc/fused_render_bwd.cu:Stash`): pe,
# 8 hidden, r0, r1 activations; d_rgb, d_r1, d_r0, 8 hidden gradient
# activations and d_sigma
_STASH_LAYOUT = ([("pe", PE_PAD)] + [(f"x{l}", H) for l in range(8)]
                 + [("r0", H), ("r1", H2), ("drgb", FEAT), ("dr1", H2), ("dr0", H)]
                 + [(f"g{l}", H) for l in range(8)] + [("dsig", 1)])
_STASH_WIDTH = sum(width for _, width in _STASH_LAYOUT)
# The X^T G core (`csrc/xtg_core.cuh`): 128 x 128 output tiles (a narrow
# job, out == 1, takes one tile per 128 rows), rows of 64 points, and about
# _XTG_TARGET_BLOCKS blocks a launch (`splits_per_batch` there)
_XTG_TILE = 128
_XTG_ROW = 64
_XTG_TARGET_BLOCKS = 4224
# K2's weight-gradient jobs (in, out), as `weight_plan` in the kernel adds them
_K2_JOBS = ([(PE_PAD, H)] + [(H, H)] * 6
            + [(PE_PAD, H), (H, H), (H, H), (H, H2), (H2, FEAT), (H, 1)])


def _xtg_split_floats(counts) -> int:
    """f32 values of one split's partials: each output at a multiple of 4
    values (`Plan::take`), the whole padded to 64."""
    return -(-sum(-(-c // 4) * 4 for c in counts) // 64) * 64


# f32 values per reduction split of K2: every weight gradient, and the
# column sums of the biases (b0/b5/br1 once: each split lies in one batch
# row), in the order of `weight_plan`
_SPLIT_WIDTH = _xtg_split_floats(
    [PE_PAD * H, H] + [H * H, H] * 6 + [PE_PAD * H, H, H * H, H * H, H, H * H2, H2,
                                        H2 * FEAT, FEAT, H, 1])


def _xtg_tiles(shapes) -> int:
    return sum(-(-i // _XTG_TILE) * (1 if o == 1 else -(-o // _XTG_TILE)) for i, o in shapes)


def xtg_splits_per_batch(tiles: int, B: int, rows_per_batch: int) -> int:
    """Splits of each batch row's point axis in one launch of the core: the
    count that brings tiles x B x splits nearest to its block target, at
    least 1 and at most one split a row."""
    per = tiles * B
    return max(1, min(rows_per_batch, (2 * _XTG_TARGET_BLOCKS + per) // (2 * per)))


def scratch_bytes(B: int, R: int) -> int:
    """Bytes of device scratch one backward launch needs: the bf16 stash
    plus the f32 partial sums of every reduction split (the weight-gradient
    pass cuts each batch row's rays into `xtg_splits_per_batch` splits)."""
    splits = B * xtg_splits_per_batch(_xtg_tiles(_K2_JOBS), B, R)
    return B * R * NS * _STASH_WIDTH * 2 + splits * _SPLIT_WIDTH * 4


def reference_xtg_core(jobs, B: int):
    """Plain version of the X^T G core: for each job (x [P, in], g [P, out],
    bias, per_batch_w, per_batch_b) the f32 sum x^T g over the points and,
    with `bias`, the column sums of g; a per-batch output is [B, ...], each
    batch row's own sum over its P / B points."""
    out = []
    for x, g, bias, per_batch_w, per_batch_b in jobs:
        xb, gb = x.float().reshape(B, -1, x.shape[1]), g.float().reshape(B, -1, g.shape[1])
        dw = xb.transpose(1, 2) @ gb
        db = gb.sum(1) if bias else None
        out.append((dw if per_batch_w else dw.sum(0),
                    None if db is None else db if per_batch_b else db.sum(0)))
    return out


_CORE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                                           ctypes.c_void_p]


def xtg_core(jobs, B: int):
    """The X^T G core alone (`csrc/xtg_core.cuh`, through
    `csrc/fused_render_bwd.cu:xtg_core_launch`): jobs as
    `reference_xtg_core`, x and g bf16 with in and out multiples of 64 (or
    out == 1, a narrow job), P a multiple of 64 * B. A CPU tensor runs the
    plain version; a CUDA tensor launches the core on the current stream."""
    if jobs[0][0].device.type == "cpu":
        return reference_xtg_core(jobs, B)
    dev = jobs[0][0].device
    P = jobs[0][0].shape[0]
    if P % (_XTG_ROW * B):
        raise ValueError(f"P must be a multiple of {_XTG_ROW} x B, got {P}")
    ptrs, dims, outs, counts = [], [], [], []
    f32 = dict(dtype=torch.float32, device=dev)
    for x, g, bias, per_batch_w, per_batch_b in jobs:
        n_in, n_out = x.shape[1], g.shape[1]
        _check("x", x, (P, n_in), torch.bfloat16)
        _check("g", g, (P, n_out), torch.bfloat16)
        dw = torch.empty(((B,) if per_batch_w else ()) + (n_in, n_out), **f32)
        db = torch.empty(((B,) if per_batch_b else ()) + (n_out,), **f32) if bias else None
        ptrs.append((x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                     db.data_ptr() if bias else None))
        dims += [n_in, n_out, int(per_batch_w), int(per_batch_b)]
        outs.append((dw, db))
        counts += [n_in * n_out] + ([n_out] if bias else [])
    rows = P // _XTG_ROW // B
    splits = B * xtg_splits_per_batch(_xtg_tiles([(x.shape[1], g.shape[1]) for x, g, *_ in jobs]),
                                      B, rows)
    nbytes = splits * _xtg_split_floats(counts) * 4
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    arr = lambda vals: (ctypes.c_void_p * len(jobs))(*vals)
    with torch.cuda.device(dev):
        err = _c_fn("fused_render_bwd", _CORE_ARGS, "xtg_core_launch")(
            arr(p[0] for p in ptrs), arr(p[1] for p in ptrs), (ctypes.c_int * len(dims))(*dims),
            arr(p[2] for p in ptrs), arr(p[3] for p in ptrs), len(jobs), B, rows,
            scratch.data_ptr(), nbytes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"xtg_core kernel launch failed: cudaError_t {err}")
    xtg_core.launches += 1
    return outs


xtg_core.launches = 0


@torch.no_grad()
def stash_chain_errors(scratch: torch.Tensor, weights: Dict[str, torch.Tensor],
                       d_pe: torch.Tensor, d_weights: Dict[str, torch.Tensor],
                       B: int, R: int) -> Dict[str, float]:
    """K2's arithmetic apart from its forward recompute: after a
    `fused_render_bwd(..., input_grads=True, scratch=scratch)` launch,
    recompute in PyTorch (f32 products of the same bf16 values, the same
    ReLU masks and bf16 casts) each gradient activation d_r1, d_r0,
    g7 .. g0, d_pe and the gradients of w0p, b0 and wd from the kernel's own
    stash, and return the relative L2 error of what the kernel wrote against
    each. The ReLU mask flips between two forward recomputes do not enter:
    both sides start from the kernel's activations. One stash array is
    widened to f32 at a time."""
    N = B * R * NS
    flat = scratch[:N * _STASH_WIDTH * 2].view(torch.bfloat16)
    views, off = {}, 0
    for name, width in _STASH_LAYOUT:
        views[name] = flat[off:off + N * width].view(N, width)
        off += N * width
    st = lambda name: views[name].float()
    W = {k: v.float() for k, v in _cast_weights(weights, torch.bfloat16).items()}

    def rel_l2(got, ref):
        return float((got - ref).norm() / ref.norm().clamp_min(1e-30))

    def masked(g, act):
        return (g * (views[act] > 0).float()).to(torch.bfloat16).float()

    errs = {"dr1": rel_l2(st("dr1"), masked(st("drgb") @ W["wr2"].T, "r1")),
            "dr0": rel_l2(st("dr0"), (st("dr1") @ W["wr1"].T).to(torch.bfloat16).float()),
            "g7": rel_l2(st("g7"), masked(st("dsig") * W["wd"].T + st("dr0") @ W["wr0"].T,
                                          "x7"))}
    upper = {6: W["wh"][5], 5: W["wh"][4], 4: W["w5x"], 3: W["wh"][3], 2: W["wh"][2],
             1: W["wh"][1], 0: W["wh"][0]}    # g_l = relu'(x_l) * (g_{l+1} @ W_{l+1}^T)
    for l in range(6, -1, -1):
        errs[f"g{l}"] = rel_l2(st(f"g{l}"), masked(st(f"g{l + 1}") @ upper[l].T, f"x{l}"))
    errs["d_pe"] = rel_l2(d_pe.reshape(N, PE_PAD),
                          st("g0") @ W["w0p"].T + st("g5") @ W["w5p"].T)
    errs["dw0p"] = rel_l2(d_weights["w0p"], st("pe").T @ st("g0"))
    errs["db0"] = rel_l2(d_weights["b0"], st("g0").view(B, R * NS, H).sum(1))
    errs["dwd"] = rel_l2(d_weights["wd"], st("x7").T @ st("dsig"))
    return errs


class FusedRender(torch.autograd.Function):
    """Differentiable fused render: `fused_render_fwd` forward, one
    `fused_render_bwd` launch backward. The packed weights come in as
    positional tensors (a Function does not track tensors inside a dict), so
    their gradients flow on through `pack_weights` to the MLP parameters and
    the conditioning codes. Input gradients are computed only when
    `ctx.needs_input_grad` asks for them."""

    @staticmethod
    def forward(ctx, compute_dtype, pe, z_dists, zvals, *packed):
        weights = dict(zip(_WEIGHTS + _BIASES, packed))
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(pe, z_dists, zvals, *packed)
        return fused_render_fwd(pe, z_dists, zvals, weights, compute_dtype)

    @staticmethod
    def backward(ctx, g_feat, g_bg, g_depth):
        pe, z_dists, zvals, *packed = ctx.saved_tensors
        need = ctx.needs_input_grad[1:4]
        d_pe, d_zd, d_zv, dw = fused_render_bwd(
            pe, z_dists, zvals, dict(zip(_WEIGHTS + _BIASES, packed)),
            g_feat.contiguous(), g_bg.contiguous(), g_depth.contiguous(),
            ctx.compute_dtype, input_grads=any(need))
        ins = [g if n else None for g, n in zip((d_pe, d_zd, d_zv), need)]
        return (None, *ins, *(dw[k] for k in _WEIGHTS + _BIASES))


def fused_render(pe, z_dists, zvals, weights: Dict[str, torch.Tensor],
                 compute_dtype: torch.dtype = torch.bfloat16):
    """`fused_render_fwd` with a backward (`FusedRender`)."""
    return FusedRender.apply(compute_dtype, pe, z_dists, zvals,
                             *(weights[k] for k in _WEIGHTS + _BIASES))


class FusedRenderSPMD(torch.autograd.Function):
    """K4, the fused render on one rank's shard of a (data, rays) mesh
    (port of `fused_render.py:fused_render_spmd`, custom_vjp :779-851).

    Forward: `fused_render_fwd` (K1) on the local [B/D, R/Rr] shard; the
    per-batch b0/b5/br1 are this rank's rows, as `pack_weights` folds them
    from the local codes. Backward: one `fused_render_bwd` (K2) launch on
    the shard, then one all-reduce (sum) over the rays group of every
    weight gradient, flattened into one buffer.

    The sum over the data axis is not here: the train step all-reduces
    every trainable leaf once (over every rank, the rays copies averaged).
    JAX psums the per-batch keys over rays and every shared key over
    (data, rays) inside the backward (:836-837); its global view then
    routes both into the MLP leaves without double counting. In the port
    `pack_weights` sends a shared key's and a per-batch key's gradient into
    the same leaf (`fea_0_kernel`'s PE rows through w0p and its code rows
    through b0; `fea_5_kernel` and `rgb_1_kernel` likewise), so a data sum
    of the shared keys here and of every leaf in the step would count the
    shared part twice, and a step that skipped those leaves would leave the
    per-batch part unsummed. Summing over rays here and over data in the
    step gives JAX's totals.

    With `plain` the forward and backward are `reference_render` and
    `reference_render_bwd` with the same collectives: the plain version.
    Otherwise the wrappers launch the kernels on CUDA tensors (and take the
    plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, mesh: Mesh, compute_dtype, plain, pe, z_dists, zvals, *packed):
        weights = dict(zip(_WEIGHTS + _BIASES, packed))
        ctx.mesh, ctx.compute_dtype, ctx.plain = mesh, compute_dtype, plain
        ctx.save_for_backward(pe, z_dists, zvals, *packed)
        if plain:
            return reference_render(pe, z_dists, zvals, weights, compute_dtype)
        before = fused_render_fwd.launches
        out = fused_render_fwd(pe, z_dists, zvals, weights, compute_dtype)
        fused_render_spmd.launches += fused_render_fwd.launches - before
        return out

    @staticmethod
    def backward(ctx, g_feat, g_bg, g_depth):
        pe, z_dists, zvals, *packed = ctx.saved_tensors
        need = ctx.needs_input_grad[3:6]
        bwd = reference_render_bwd if ctx.plain else fused_render_bwd
        before = fused_render_bwd.launches
        d_pe, d_zd, d_zv, dw = bwd(
            pe, z_dists, zvals, dict(zip(_WEIGHTS + _BIASES, packed)),
            g_feat.contiguous(), g_bg.contiguous(), g_depth.contiguous(),
            ctx.compute_dtype, input_grads=any(need))
        fused_render_spmd.launches += fused_render_bwd.launches - before
        dws = all_reduce_sum([dw[k] for k in _WEIGHTS + _BIASES], ctx.mesh.rays_group)
        ins = [g if n else None for g, n in zip((d_pe, d_zd, d_zv), need)]
        return (None, None, None, *ins, *dws)


def fused_render_spmd(pe, z_dists, zvals, weights: Dict[str, torch.Tensor], mesh: Mesh,
                      compute_dtype: torch.dtype = torch.bfloat16):
    """K4 on this rank's shard: pe [B/D, R/Rr, NS, PE_PAD], the packed
    weights of its rows; returns its shard of (features, bg_alpha, depth).
    `launches` counts the K1 and K2 launches it made."""
    return FusedRenderSPMD.apply(mesh, compute_dtype, False, pe, z_dists, zvals,
                                 *(weights[k] for k in _WEIGHTS + _BIASES))


fused_render_spmd.launches = 0


def reference_render_spmd(pe, z_dists, zvals, weights: Dict[str, torch.Tensor], mesh: Mesh,
                          compute_dtype: torch.dtype = torch.float32):
    """Plain version of K4: `reference_render` / `reference_render_bwd` on
    the shard, the same collectives."""
    return FusedRenderSPMD.apply(mesh, compute_dtype, True, pe, z_dists, zvals,
                                 *(weights[k] for k in _WEIGHTS + _BIASES))
