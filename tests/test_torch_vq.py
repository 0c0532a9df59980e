"""The port's Standardized Space stage-1 modules against the JAX package's
(`nerf3dtalker_tpu/models/vq`), at the JAX tests' TINY size
(`_jax_reference.VQ_TINY`): the quantizer, attention and the transformer
block, the autoencoder's forward and every parameter gradient,
`decode_from_indices` / `decode_logit`, the AU classifier at 48^2 and 112^2
crops and both AU losses. The weights are numpy draws in the shapes of the
JAX step's init (`_jax_reference.vq_init`: `jax.eval_shape`, so no init
compiles; nonzero biases and LayerNorm scales), carried into the port by
`utils/bridge.py`.

Tolerances: f32 on both sides, summed in other orders (XLA's dot against
torch's): outputs within 1e-5 of max|ref| (measured ~2e-7 to 3e-6), and
gradients within 1e-4 of each leaf's max|ref| (the backward sums over
more terms). Code indices must agree wherever the two smallest distances
are further apart than the distances' own tolerance; near a tie either
code is right (`test_quantizer_matches_jax` counts them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_reference import FAST_COMPILE, VQ_TINY, vq_batch, vq_init

from nerf3dtalker_tpu.config import VQConfig as JVQConfig
from nerf3dtalker_tpu.models.vq import stage1 as jstage1
from nerf3dtalker_tpu.models.vq import transformer as jtr
from nerf3dtalker_tpu.models.vq.au_classifier import AUClassifier as JAUClassifier
from nerf3dtalker_tpu.models.vq.au_classifier import au_bce_loss as j_bce
from nerf3dtalker_tpu.models.vq.au_classifier import au_dice_loss as j_dice
from nerf3dtalker_tpu.models.vq.quantizer import VectorQuantizer as JVectorQuantizer
from nerf3dtalker_tpu_torch.config import VQConfig
from nerf3dtalker_tpu_torch.models.vq import au_classifier, quantizer, stage1, transformer
from nerf3dtalker_tpu_torch.utils import bridge

# the JAX references, each compiled once without XLA's backend passes
_jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
JCFG, CFG = JVQConfig(**VQ_TINY), VQConfig(**VQ_TINY)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} of max|ref| > {rtol:.0e}"


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _port_vq():
    vq = stage1.VQAutoEncoder(CFG, device="cpu")
    return bridge.load_into(vq, bridge.vq_state_dict(vq_init()[0]))


def test_quantizer_matches_jax():
    emb = vq_init()[0]["params"]["quantize"]["embedding"]
    z = np.random.default_rng(1).standard_normal((2, 24, CFG.embed_dim)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal(z.shape).astype(np.float32)
    jq = JVectorQuantizer(CFG.n_embed, CFG.embed_dim, CFG.beta)
    variables = {"params": {"embedding": jnp.asarray(emb)}}

    def jloss(v, z):
        r = jq.apply(v, z)
        return r.loss + jnp.sum(r.quantized * w), r

    def jref(v, z):   # one compiled program
        (_, r), grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(v, z)
        return (r, grads, jq.apply(v, z, method=JVectorQuantizer.distances),
                jq.apply(v, r.indices, method=JVectorQuantizer.codebook_entry))

    jr, (jg_v, jg_z), jd, jentry = _jit(jref)(variables, jnp.asarray(z))

    q = quantizer.VectorQuantizer(CFG.n_embed, CFG.embed_dim, CFG.beta)
    bridge.load_into(q, {"embedding": emb})
    zt = _t(z).requires_grad_(True)
    r = q(zt)
    (r.loss + (r.quantized * _t(w)).sum()).backward()
    d = q.distances(zt).detach().numpy()
    _close(d, jd, OUT_RTOL, "distances")
    # indices: equal wherever the top-2 margin exceeds the distances' tolerance
    tol = OUT_RTOL * np.abs(np.asarray(jd)).max()
    top2 = np.sort(np.asarray(jd), -1)[..., :2]
    clear = (top2[..., 1] - top2[..., 0]) > tol
    same = r.indices.numpy() == np.asarray(jr.indices)
    assert same[clear].all() and clear.mean() > 0.9, (same.mean(), clear.mean())
    _close(r.loss.item(), jr.loss, OUT_RTOL, "loss")
    _close(r.perplexity.item(), jr.perplexity, OUT_RTOL, "perplexity")
    _close(r.quantized.detach(), jr.quantized, OUT_RTOL, "quantized")
    _close(zt.grad, jg_z, GRAD_RTOL, "dz")
    _close(q.embedding.grad, jg_v["params"]["embedding"], GRAD_RTOL, "d embedding")
    _close(q.codebook_entry(torch.from_numpy(np.array(jr.indices))).detach(), jentry, 0.0,
           "codebook_entry")


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_attention_and_block_match_jax(masked):
    block = vq_init()[0]["params"]["encoder"]["transformer"]["block_0"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, CFG.hidden_size)).astype(np.float32)
    mask = np.triu(np.full((7, 7), -1e9, np.float32), 1) if masked else None
    jb = jtr.TransformerBlock(CFG.hidden_size, CFG.num_attention_heads, CFG.intermediate_size)
    ja = jtr.Attention(CFG.hidden_size, CFG.num_attention_heads)
    want_a, want_b = _jit(lambda p, x, mask: (ja.apply({"params": p["attn"]}, x, mask),
                                              jb.apply({"params": p}, x, mask)))(block, x, mask)
    tb = transformer.TransformerBlock(CFG.hidden_size, CFG.num_attention_heads,
                                      CFG.intermediate_size)
    bridge.load_into(tb, bridge.vq_state_dict({"params": block}))
    m = None if mask is None else _t(mask)
    with torch.no_grad():
        _close(tb.attn(_t(x), m), want_a, OUT_RTOL, "attention")
        _close(tb(_t(x), m), want_b, OUT_RTOL, "block")
    _close(transformer.sinusoidal_positions(11, 32), jtr.sinusoidal_positions(11, 32),
           OUT_RTOL, "positions")


def test_autoencoder_forward_and_gradients_match_jax():
    params = vq_init()[0]
    b = vq_batch(seed=4)
    au = np.random.default_rng(5).standard_normal((2, CFG.n_au, CFG.au_dim)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal(b["gen_img"].shape).astype(np.float32)
    jm = jstage1.VQAutoEncoder(JCFG)

    def jloss(p, img, au):
        out = jm.apply(p, img, au)
        return jnp.sum(out.recon * w) + out.quant_loss, out

    (_, jout), jg = _jit(jax.value_and_grad(jloss, has_aux=True))(params, b["gen_img"], au)
    vq = _port_vq()
    out = vq(_t(b["gen_img"]), _t(au))
    ((out.recon * _t(w)).sum() + out.quant_loss).backward()
    assert (out.indices.numpy() == np.asarray(jout.indices)).all()
    _close(out.recon.detach(), jout.recon, OUT_RTOL, "recon")
    _close(out.quant_loss.item(), jout.quant_loss, OUT_RTOL, "quant_loss")
    _close(out.perplexity.item(), jout.perplexity, OUT_RTOL, "perplexity")
    want = bridge.vq_state_dict(jg)
    grads = {k: p.grad for k, p in vq.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g is not None and g.abs().max() > 0, k
        _close(g, want[k], GRAD_RTOL, k)


def test_decode_from_indices_and_logit_match_jax():
    params = vq_init()[0]
    rng = np.random.default_rng(7)
    L = CFG.img_size * CFG.hidden_size // CFG.embed_dim
    ids = rng.integers(0, CFG.n_embed, (2, L))
    au_ids = rng.integers(0, CFG.n_embed_au, (2, CFG.n_au))
    logits = rng.standard_normal((2, L, CFG.n_embed)).astype(np.float32)
    jm = jstage1.VQAutoEncoder(JCFG)

    def jref(p, ids, logits, au_ids):
        return (jm.apply(p, ids, au_ids, method=jstage1.VQAutoEncoder.decode_from_indices),
                jm.apply(p, logits, au_ids, method=jstage1.VQAutoEncoder.decode_logit),
                jstage1.sample_code_logits(None, logits, sample=False))

    want_i, want_l, (jix, jprobs) = _jit(jref)(params, ids, logits, au_ids)
    vq = _port_vq()
    with torch.no_grad():
        _close(vq.decode_from_indices(torch.from_numpy(ids), torch.from_numpy(au_ids)), want_i,
               OUT_RTOL, "decode_from_indices")
        _close(vq.decode_logit(_t(logits), torch.from_numpy(au_ids)), want_l, OUT_RTOL,
               "decode_logit")
    ix, p = stage1.sample_code_logits(_t(logits), sample=False)
    _close(p, jprobs, OUT_RTOL, "probs")
    assert (ix.numpy() == np.asarray(jix)).all()
    draws = [stage1.sample_code_logits(_t(logits), generator=torch.Generator().manual_seed(0))[0]
             for _ in range(2)]
    assert torch.equal(*draws) and draws[0].shape == (2, L)


@pytest.mark.parametrize("crop", [48, 112])
def test_au_classifier_matches_jax(crop):
    stacked = jax.tree_util.tree_map(lambda a: a[:2], vq_init(crop=crop)[1])
    assert au_classifier.flat_features(crop) == stacked["params"]["linear0"]["kernel"].shape[1]
    x = np.random.default_rng(8).uniform(0, 1, (3, crop, crop, 3)).astype(np.float32)
    jf, jp = _jit(JAUClassifier().apply)(jax.tree_util.tree_map(lambda a: a[1], stacked), x)
    clfs = torch.nn.ModuleList(au_classifier.AUClassifier(crop, device="cpu")
                               for _ in range(len(stacked["params"]["linear0"]["kernel"])))
    bridge.load_into(clfs, bridge.au_classifiers_state_dict(stacked))
    with torch.no_grad():
        f, p = clfs[1](_t(x).permute(0, 3, 1, 2))
    _close(f, jf, OUT_RTOL, "features")
    _close(p, jp, OUT_RTOL, "probability")


def test_au_losses_match_jax():
    rng = np.random.default_rng(9)
    pred = rng.uniform(0, 1, (4, 5)).astype(np.float32)
    pred[0, 0], pred[1, 1] = 0.0, 1.0           # the clip's edges
    target = (rng.uniform(0, 1, (4, 5)) > 0.5).astype(np.float32)
    want = _jit(lambda p, t: (j_bce(p, t), j_dice(p, t)))(pred, target)
    _close(au_classifier.au_bce_loss(_t(pred), _t(target)).item(), want[0], OUT_RTOL, "bce")
    _close(au_classifier.au_dice_loss(_t(pred), _t(target)).item(), want[1], OUT_RTOL, "dice")
