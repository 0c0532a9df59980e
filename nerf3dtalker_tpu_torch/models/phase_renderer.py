"""Phase-stacked form of the NeuralRenderer upsampler (port of
`nerf3dtalker_tpu/models/phase_renderer.py`).

A fine image at level l is held as a stack of 4^l phase planes on the
fixed coarse grid of the featmap:
``X[..., pr, pc, i, j, c] = img[..., i * 2^l + pr, j * 2^l + pc, c]``.
Pixel-shuffle becomes a relabeling, the 3x3 binomial blur and the
half-pixel bilinear 2x become phase-mixing adds with +-1 coarse shifts
(reflect / clamp edges turn into single-row fills), and every Dense layer
is one `[P*N, C]` product. Flat phase p = pr * 2^l + pc; upsampling maps
pr' = 2*pr + di, so fine row u = i * 2^l + pr.

Every function takes any leading batch axes: the phase and spatial axes
are counted from the end (`[..., Pr, Pc, Hc, Wc, C]`). This module is the
plain version that the fused upsampler kernels (`ops/kernels/
fused_upsampler.py`) are held against: it keeps the JAX package's op order
and rounds to the compute dtype where that rounds (after every product +
bias, and after every elementwise op, as PyTorch does for bf16 tensors).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

_AP, _AC, _AH, _AW = -5, -4, -3, -2   # phase-row, phase-col, coarse-row, coarse-col axes


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


# --------------------------------------------------------------- constants


@functools.lru_cache(maxsize=None)
def _tile_pm_np(C: int) -> np.ndarray:
    """Phase-major tile matrix: T[c_x, p*C + c] = 1 iff c_x == (4c+p) mod C
    (the channel-tiled identity of PixelShuffleUpsample read through the
    pixel-shuffle and permuted to phase-major lanes)."""
    T = np.zeros((C, 4 * C), np.float32)
    for p in range(4):
        for c in range(C):
            T[(4 * c + p) % C, p * C + c] = 1.0
    return T


@functools.lru_cache(maxsize=None)
def tile_index(C: int) -> np.ndarray:
    """Source channel of each phase-major lane q = p*C + c of the tiled
    identity: ``x @ T == x[..., tile_index(C)]`` (a gather; the product with
    the 0/1 matrix copies the values exactly)."""
    q = np.arange(4 * C)
    return (4 * (q % C) + q // C) % C


def permute_w2_phase_major(w2: torch.Tensor, b2: torch.Tensor):
    """Reorder D2's output channels from torch ps order (c*4 + p) to
    phase-major (p*C + c). Differentiable (an index)."""
    C4 = w2.shape[1]
    C = C4 // 4
    q = np.arange(C4)
    src = torch.as_tensor((q % C) * 4 + (q // C), device=w2.device)
    return w2[:, src], b2[src]


# ----------------------------------------------------- phase-space stencils


def _sl(X: torch.Tensor, axis: int, a: int, b: int) -> torch.Tensor:
    return X.narrow(axis, a, b - a)


def _shift_m1(X: torch.Tensor, axis_p: int, axis_s: int, L: int, mode: str):
    """Fine neighbor f-1 of every phase plane: A[pr] = X[pr-1] for pr >= 1,
    A[0] = X[L-1] shifted down one coarse row, its first row filled per
    ``mode`` ('reflect' -> fine row 1, 'clamp' -> fine row 0)."""
    top_plane = _sl(X, axis_p, L - 1, L)
    shifted = _sl(top_plane, axis_s, 0, X.shape[axis_s] - 1)
    k = min(1, L - 1) if mode == "reflect" else 0
    fill = _sl(_sl(X, axis_p, k, k + 1), axis_s, 0, 1)
    plane0 = torch.cat([fill, shifted], dim=axis_s)
    if L == 1:
        return plane0
    return torch.cat([plane0, _sl(X, axis_p, 0, L - 1)], dim=axis_p)


def _shift_p1(X: torch.Tensor, axis_p: int, axis_s: int, L: int, mode: str):
    """Fine neighbor f+1: B[pr] = X[pr+1] for pr < L-1; B[L-1] = X[0]
    shifted up, its last row filled per ``mode`` ('reflect' -> fine F-2,
    'clamp' -> fine F-1)."""
    n_s = X.shape[axis_s]
    bot_plane = _sl(X, axis_p, 0, 1)
    shifted = _sl(bot_plane, axis_s, 1, n_s)
    k = max(L - 2, 0) if mode == "reflect" else L - 1
    fill = _sl(_sl(X, axis_p, k, k + 1), axis_s, n_s - 1, n_s)
    planeL = torch.cat([shifted, fill], dim=axis_s)
    if L == 1:
        return planeL
    return torch.cat([_sl(X, axis_p, 1, L), planeL], dim=axis_p)


def phase_blur3(X: torch.Tensor, l: int) -> torch.Tensor:
    """Separable [1,2,1]/4 x [1,2,1]/4 blur, reflect boundary, on the
    level-l fine grid of a phase stack [..., Pr, Pc, Hc, Wc, C]."""
    L = 1 << l
    A = _shift_m1(X, _AP, _AH, L, "reflect")
    Bv = _shift_p1(X, _AP, _AH, L, "reflect")
    X = (A + 2.0 * X + Bv) * 0.25
    A = _shift_m1(X, _AC, _AW, L, "reflect")
    Bh = _shift_p1(X, _AC, _AW, L, "reflect")
    return (A + 2.0 * X + Bh) * 0.25


def phase_bilinear2x(X: torch.Tensor, l: int) -> torch.Tensor:
    """Half-pixel bilinear 2x (align_corners=False) from level l to l+1:
    [..., Pr, Pc, Hc, Wc, C] -> [..., 2Pr, 2Pc, Hc, Wc, C];
    out[2f] = 0.75 in[f] + 0.25 in[f-1], out[2f+1] = 0.75 in[f] + 0.25
    in[f+1], edges clamped."""
    L = 1 << l

    def axis_double(Y, axis_p, axis_s):
        A = _shift_m1(Y, axis_p, axis_s, L, "clamp")
        B = _shift_p1(Y, axis_p, axis_s, L, "clamp")
        even = 0.75 * Y + 0.25 * A
        odd = 0.75 * Y + 0.25 * B
        st = torch.stack([even, odd], dim=axis_p)     # new axis right after axis_p
        shp = list(Y.shape)
        shp[axis_p] *= 2
        return st.reshape(shp)

    X = axis_double(X, _AP, _AH)
    return axis_double(X, _AC, _AW)


def phase_split(z: torch.Tensor, l: int) -> torch.Tensor:
    """Pixel shuffle as phase relabeling: [..., Pr, Pc, Hc, Wc, 4C] with
    phase-major lanes (q = (di*2+dj)*C + c) -> [..., 2Pr, 2Pc, Hc, Wc, C]."""
    *lead, Pr, Pc, Hc, Wc, C4 = z.shape
    C = C4 // 4
    x = z.reshape(*lead, Pr, Pc, Hc, Wc, 2, 2, C)          # di, dj
    n = len(lead)
    x = x.permute(*range(n), n, n + 4, n + 1, n + 5, n + 2, n + 3, n + 6)
    return x.reshape(*lead, 2 * Pr, 2 * Pc, Hc, Wc, C)


def unstack_phases(X: torch.Tensor) -> torch.Tensor:
    """[..., Pr, Pc, Hc, Wc, C] -> full image [..., Hc*Pr, Wc*Pc, C]."""
    *lead, Pr, Pc, Hc, Wc, C = X.shape
    n = len(lead)
    x = X.permute(*range(n), n + 2, n, n + 3, n + 1, n + 4)
    return x.reshape(*lead, Hc * Pr, Wc * Pc, C)


def stack_phases(img: torch.Tensor, l: int) -> torch.Tensor:
    """Inverse of :func:`unstack_phases` for a level-l image."""
    L = 1 << l
    *lead, H, W, C = img.shape
    n = len(lead)
    x = img.reshape(*lead, H // L, L, W // L, L, C)
    return x.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4)


# ------------------------------------------------------------------ params


def extract_phase_params(nr: torch.nn.Module, n_blocks: int) -> Dict[str, torch.Tensor]:
    """The port's `NeuralRenderer` in the phase-kernel layout: Dense
    kernels [in, out] (transposes of the `nn.Linear` weights), D2
    kernels/biases permuted to phase-major. Every entry is a differentiable
    view or index of a module parameter, so autograd carries each gradient
    back to the module's leaves."""
    out = {}
    for i in range(n_blocks):
        up = nr.feat_upsamples[i]
        out[f"w1_{i}"] = up.layer_1.weight.t()
        out[f"b1_{i}"] = up.layer_1.bias
        out[f"w2pm_{i}"], out[f"b2pm_{i}"] = permute_w2_phase_major(
            up.layer_2.weight.t(), up.layer_2.bias)
        out[f"wf_{i}"] = nr.feat_layers[i].weight.t()
        out[f"bf_{i}"] = nr.feat_layers[i].bias
    for i in range(n_blocks + 1):
        out[f"wr_{i}"] = nr.feat_2_rgb[i].weight.t()
        out[f"br_{i}"] = nr.feat_2_rgb[i].bias
    return out


# ----------------------------------------------------------------- forward


def _mm(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Operands in `cdt`, f32 products and sum (a product of two bf16
    values is exact in f32), f32 bias, then rounded to `cdt`."""
    out = a.to(cdt).reshape(-1, a.shape[-1]).float() @ w.to(cdt).float() + b.float()
    return out.to(cdt).reshape(*a.shape[:-1], w.shape[1])


def block_param_names(i: int) -> List[str]:
    """Block i's weights in the kernels' argument order."""
    names = [f"w1_{i}", f"b1_{i}", f"w2pm_{i}", f"b2pm_{i}",
             f"wf_{i}", f"bf_{i}", f"wr_{i+1}", f"br_{i+1}"]
    return names + (["wr_0", "br_0"] if i == 0 else [])


def block_params(pp: Dict, i: int) -> Dict:
    return {k: pp[k] for k in block_param_names(i)}


def phase_block_forward(
    net: torch.Tensor,                # [..., Pr, Pc, Hc, Wc, C] level-i features
    rgb: torch.Tensor,                # [..., Pr, Pc, Hc, Wc, 3] level-i rgb acc
    bp: Dict,                         # block_params(pp, i)
    i: int,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One upsampler block in phase space: level i -> level i+1. For i == 0
    the rgb input is ignored and rgb_0 = wr_0(net) is computed here; the
    rgb accumulator is bilinear+blur upsampled at the start of each block,
    then the new level's contribution is added."""
    return _block_forward(net, rgb, bp, i, compute_dtype)[:2]


def _block_forward(net, rgb, bp, i, cdt):
    """phase_block_forward, also returning what the backward reads:
    (net_next, rgb_next, saved) with the pre-activations a1, a2, af, the
    activations h1, up and the rgb_0 head input."""
    net = net.to(cdt)
    if i == 0:
        rgb = _mm(net, bp["wr_0"], bp["br_0"], cdt)
    rgbup = phase_blur3(phase_bilinear2x(rgb.to(cdt), i), i + 1)
    c = net.shape[-1]
    a1 = _mm(net, bp[f"w1_{i}"], bp[f"b1_{i}"], cdt)
    h1 = leaky_relu(a1)
    a2 = _mm(h1, bp[f"w2pm_{i}"], bp[f"b2pm_{i}"], cdt)
    tile = net[..., torch.as_tensor(tile_index(c), device=net.device)]
    up = phase_blur3(phase_split(leaky_relu(a2) + tile, i), i + 1)
    af = _mm(up, bp[f"wf_{i}"], bp[f"bf_{i}"], cdt)
    net_next = leaky_relu(af)
    rgb_next = rgbup + _mm(net_next, bp[f"wr_{i+1}"], bp[f"br_{i+1}"], cdt)
    saved = {"net": net, "a1": a1, "h1": h1, "a2": a2, "up": up, "af": af, "nn": net_next}
    return net_next, rgb_next, saved


def phase_renderer_forward(
    x: torch.Tensor,                  # [Hc, Wc, C] featmap (one image)
    pp: Dict,                         # extract_phase_params output
    n_blocks: int,
    compute_dtype: torch.dtype = torch.float32,
    final_actvn: bool = True,
) -> torch.Tensor:
    """Full NeuralRenderer forward in phase space; [img, img, 3]."""
    net = x[None, None]
    rgb = torch.zeros(net.shape[:-1] + (3,), dtype=compute_dtype, device=x.device)
    for i in range(n_blocks):
        net, rgb = phase_block_forward(net, rgb, block_params(pp, i), i, compute_dtype)
    img = unstack_phases(rgb.float())
    return torch.sigmoid(img) if final_actvn else img


# --------------------------------------------------------------- backward


def leaky_relu_vjp(pre: torch.Tensor, g: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """Cotangent at the pre-activation: g where pre >= 0, else slope * g
    (rounded to g's dtype)."""
    return torch.where(pre >= 0, g, slope * g)


def _blur1d_t(g: torch.Tensor, dim: int) -> torch.Tensor:
    """Transpose of the reflect-padded [1,2,1]/4 blur along image axis
    `dim`, in g's dtype: in[v] gets 0.5 out[v] + 0.25 out[v-1] + 0.25
    out[v+1], and at the edges the reflected taps: row 1 also gets 0.25
    out[0] (row -1 reads row 1), row S-2 also gets 0.25 out[S-1]."""
    S = g.shape[dim]
    out = 0.5 * g
    out.narrow(dim, 1, S - 1).add_(0.25 * g.narrow(dim, 0, S - 1))
    out.narrow(dim, 0, S - 1).add_(0.25 * g.narrow(dim, 1, S - 1))
    out.narrow(dim, 1, 1).add_(0.25 * g.narrow(dim, 0, 1))
    out.narrow(dim, S - 2, 1).add_(0.25 * g.narrow(dim, S - 1, 1))
    return out


def _bilinear1d_t(g: torch.Tensor, dim: int) -> torch.Tensor:
    """Transpose of the clamped half-pixel bilinear 2x along image axis
    `dim` (2S -> S): in[f] gets 0.75 (out[2f] + out[2f+1]) + 0.25 out[2f+2]
    + 0.25 out[2f-1], and the clamped taps pile onto the edges: in[0] also
    gets 0.25 out[0], in[S-1] also 0.25 out[2S-1]."""
    S2 = g.shape[dim]
    S = S2 // 2
    ev, od = g.narrow(dim, 0, S2).unflatten(dim, (S, 2)).unbind(dim + 1 if dim >= 0 else dim)
    out = 0.75 * ev + 0.75 * od
    out.narrow(dim, 0, S - 1).add_(0.25 * ev.narrow(dim, 1, S - 1))
    out.narrow(dim, 1, S - 1).add_(0.25 * od.narrow(dim, 0, S - 1))
    out.narrow(dim, 0, 1).add_(0.25 * ev.narrow(dim, 0, 1))
    out.narrow(dim, S - 1, 1).add_(0.25 * od.narrow(dim, S - 1, 1))
    return out


def blur3_t(X: torch.Tensor, l: int) -> torch.Tensor:
    """Transpose of :func:`phase_blur3` on a level-l phase stack, in X's
    dtype: the horizontal pass's transpose, then the vertical one's."""
    img = unstack_phases(X)
    img = _blur1d_t(_blur1d_t(img, -2), -3)
    return stack_phases(img, l)


def bilinear2x_t(X: torch.Tensor, l: int) -> torch.Tensor:
    """Transpose of :func:`phase_bilinear2x` (level l+1 -> l), in X's
    dtype: the column pass's transpose, then the row pass's."""
    img = unstack_phases(X)
    img = _bilinear1d_t(_bilinear1d_t(img, -2), -3)
    return stack_phases(img, l)


def phase_split_t(g: torch.Tensor) -> torch.Tensor:
    """Transpose of :func:`phase_split`: [..., 2Pr, 2Pc, Hc, Wc, C] ->
    [..., Pr, Pc, Hc, Wc, 4C] with phase-major lanes."""
    *lead, Pr2, Pc2, Hc, Wc, C = g.shape
    n = len(lead)
    x = g.reshape(*lead, Pr2 // 2, 2, Pc2 // 2, 2, Hc, Wc, C)      # pr, di, pc, dj
    x = x.permute(*range(n), n, n + 2, n + 4, n + 5, n + 1, n + 3, n + 6)
    return x.reshape(*lead, Pr2 // 2, Pc2 // 2, Hc, Wc, 4 * C)


def tile_t(g: torch.Tensor) -> torch.Tensor:
    """Transpose of the tiled identity: lane q = p*C + c adds into channel
    (4c + p) mod C, i.e. channel c_x sums the four lanes p = c_x mod 4,
    c = c_x // 4 + m*C/4 (m = 0..3)."""
    *lead, C4 = g.shape
    C = C4 // 4
    s = g.reshape(*lead, 4, 4, C // 4).sum(-2)                   # [.., p, c']
    return s.transpose(-1, -2).reshape(*lead, C)                # c_x = 4c' + p


def _mm_t(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g @ w.T in f32 over rows (f32 products of the compute-dtype values)."""
    return (g.reshape(-1, g.shape[-1]).float() @ w.float().t()).reshape(
        *g.shape[:-1], w.shape[0])


def _xtg(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x^T g summed over every leading axis, f32."""
    return x.reshape(-1, x.shape[-1]).float().t() @ g.reshape(-1, g.shape[-1]).float()


def _colsum(g: torch.Tensor) -> torch.Tensor:
    return g.reshape(-1, g.shape[-1]).float().sum(0)


def phase_block_backward(
    net: torch.Tensor, rgb: torch.Tensor, bp: Dict, i: int,
    g_net_next: torch.Tensor, g_rgb_next: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The VJP of :func:`phase_block_forward` for the cotangents of its two
    outputs: recompute the forward, then backpropagate. Returns (g_net,
    g_rgb, weight grads keyed as `bp`), all f32; g_rgb is zeros for i == 0.

    Rounding (where the forward value is in the compute dtype, so is its
    cotangent): g_nn = rd(g_net_next + g_rgb_next @ wr^T) with the sum in
    f32; each leaky-ReLU cotangent and each D2 / feat_layer input cotangent
    rounded to the compute dtype; the transposed blur of the net path in
    f32, rounded once; the rgb path's transposed stencils in f32 (for
    i == 0 rounded once at rgb_0); weight and bias sums and the input
    cotangents in f32."""
    cdt = compute_dtype
    _, _, s = _block_forward(net, rgb, bp, i, cdt)
    w = {k: v.to(cdt) for k, v in bp.items()}
    g_r = g_rgb_next.to(cdt)
    g_nn = (g_net_next.to(cdt).float() + _mm_t(g_r, w[f"wr_{i+1}"])).to(cdt)
    g_af = leaky_relu_vjp(s["af"], g_nn)
    gw = {f"wf_{i}": _xtg(s["up"], g_af), f"bf_{i}": _colsum(g_af),
          f"wr_{i+1}": _xtg(s["nn"], g_r), f"br_{i+1}": _colsum(g_r)}
    g_up = _mm_t(g_af, w[f"wf_{i}"]).to(cdt)
    g_z = phase_split_t(blur3_t(g_up.float(), i + 1).to(cdt))
    g_a2 = leaky_relu_vjp(s["a2"], g_z)
    gw[f"w2pm_{i}"], gw[f"b2pm_{i}"] = _xtg(s["h1"], g_a2), _colsum(g_a2)
    g_a1 = leaky_relu_vjp(s["a1"], _mm_t(g_a2, w[f"w2pm_{i}"]).to(cdt))
    gw[f"w1_{i}"], gw[f"b1_{i}"] = _xtg(s["net"], g_a1), _colsum(g_a1)
    g_net = _mm_t(g_a1, w[f"w1_{i}"]) + tile_t(g_z.float())
    g_rgb = bilinear2x_t(blur3_t(g_r.float(), i + 1), i)
    if i == 0:
        g_rgb0 = g_rgb.to(cdt)
        gw["wr_0"], gw["br_0"] = _xtg(s["net"], g_rgb0), _colsum(g_rgb0)
        g_net = g_net + _mm_t(g_rgb0, w["wr_0"])
        g_rgb = torch.zeros(rgb.shape, dtype=torch.float32, device=rgb.device)
    return g_net, g_rgb, {k: gw[k] for k in bp}
