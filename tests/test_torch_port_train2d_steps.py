"""The 2D trainer's seg and joint-seg losses held against the JAX package on
the CPU, gradients included.

One set of seeded weights goes to both sides through
``utils.from_jax.train2d_from_jax``; the JAX loss is composed as
``run/train2d.py``'s step bodies compose it (the X-Decoder forward, the
no-object logit, ``set_criterion``, under ``jax.value_and_grad``), the
port's is ``run.train2d.seg_losses`` / ``joint_seg_losses`` on the points
the JAX sampler drew. First the round-0 pre-threshold mask logits (against
JAX's reference-order masks, rel < 1e-5), then both sides on the port's
binary attention masks (JAX's ``attn_mask_override``): the losses within
rel 1e-5 and every gradient leaf, the no-object embedding and the language
tower included, within 1e-4 of its norm. ``tests/test_torch_port_
train2d_vlp.py`` holds the VLP and joint-zip losses the same way."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from geopurify_tpu.config import FocalNetConfig, XDecoderConfig
from geopurify_tpu.models import criterion as jcrit
from geopurify_tpu.models import lang as jlang
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu.parity.oracle import FOCAL_SMALL
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.run import train2d as ttrain
from geopurify_tpu_torch.utils.from_jax import train2d_from_jax
from tests.test_torch_port_backbones2d import seeded_jax_params

HW = (64, 96)
N_CLS = 4
NUM_POINTS = 128
VOCAB, CAP_LEN = 64, 8
LOGIT_SCALE = 10.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_cfg() -> XDecoderConfig:
    return XDecoderConfig(backbone=FocalNetConfig(**FOCAL_SMALL), hidden_dim=16, conv_dim=16,
                          mask_dim=16, num_queries=7, nheads=2, dim_feedforward=32,
                          dec_layers=2, enc_layers=1, mask_shape=HW, dtype="float32")


def build_pair(seed: int, caption_len: int = 0, lang: bool = False, no_object: bool = True):
    """(JAX config, JAX params tree, port ``Train2DParams`` loaded from it
    through ``train2d_from_jax``)."""
    jcfg = jax_cfg()
    tcfg = tconfig._apply_dict(tconfig.XDecoderConfig(), dataclasses.asdict(jcfg))
    jtree = {"model": seeded_jax_params(txd.XDecoderSegModel(tcfg, caption_len), seed)["params"]}
    parts = {"model": txd.XDecoderSegModel(tcfg, caption_len)}
    if lang:
        mk = lambda: tlang.LanguageEncoder(VOCAB, 16, 1, 2, CAP_LEN, 16)  # noqa: E731
        jtree["lang"] = seeded_jax_params(mk(), seed + 1, scale=0.3)["params"]
        # (np.ascontiguousarray makes the 0-d logit scale 1-d)
        jtree["lang"]["logit_scale"] = jtree["lang"]["logit_scale"].reshape(())
        parts["lang"] = mk()
    if no_object:
        jtree["no_object"] = np.random.default_rng(seed).normal(size=16).astype(np.float32)
        parts["no_object"] = torch.zeros(16)
    params = ttrain.Train2DParams(**parts)
    params.load_state_dict(train2d_from_jax(jtree))
    return jcfg, jtree, params


def jax_lang():
    return jlang.LanguageEncoder(vocab_size=VOCAB, width=16, layers=1, heads=2,
                                 context_length=CAP_LEN, dim_proj=16)


def seg_batch(seed: int, B: int = 2):
    rng = np.random.default_rng(seed)
    return [t.numpy() for t in ttrain.synthetic_batch(rng, B, HW, N_CLS)]


def unit_text(seed: int, n: int = N_CLS + 1):
    t = np.random.default_rng(seed).normal(size=(n, 16)).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def jax_points(seed: int):
    rows, cols = jcrit._sample_mask_points(jnp.zeros((HW[0] // 4, HW[1] // 4)),
                                           jax.random.key(seed), NUM_POINTS)
    return jax.random.key(seed), (torch.from_numpy(np.array(rows)),
                                  torch.from_numpy(np.array(cols)))


def port_masks(params, images, text, caption_tokens=None):
    """The port's own attention masks (the forcing set) and its round-0
    pre-threshold logits."""
    with torch.no_grad():
        out = params.model(torch.from_numpy(images), text, LOGIT_SCALE,
                           caption_tokens=caption_tokens, return_attn=True)
    return out["attn_masks"][:-1], out["attn_logits0"].numpy()


def check_round0(jcfg, jtree, images, text, logits0, caption_tokens=None):
    """The port's round-0 logits against JAX's reference-order round-0 masks
    resized to the level-0 size (return_aux=True)."""
    @jax.jit
    def ref0(model_params, images, text, caption_tokens):
        mf, ms = jxd.encode_pixel_features(jcfg, {"params": model_params}, images)
        aux = jxd._make_head(jcfg).apply(
            {"params": model_params["predictor"]}, list(ms), mf, text,
            jnp.float32(LOGIT_SCALE), caption_tokens=caption_tokens, return_aux=True)
        return jxd.resize_bicubic_antialias(aux["aux_masks"][0].transpose(0, 2, 3, 1),
                                            tuple(ms[0].shape[1:3]))

    ref = ref0(jtree["model"], jnp.asarray(images), jnp.asarray(text), caption_tokens)
    assert _rel(logits0, np.asarray(ref.transpose(0, 3, 1, 2))) < 1e-5


def jax_head_out(jcfg, model_params, images, text, forced, caption_tokens=None):
    """``XDecoderSegModel.apply`` (train2d.py:300) with the head forced."""
    mf, ms = jxd.encode_pixel_features(jcfg, {"params": model_params}, images)
    return jxd._make_head(jcfg).apply(
        {"params": model_params["predictor"]}, list(ms), mf, text, jnp.float32(LOGIT_SCALE),
        caption_tokens=caption_tokens, attn_mask_override=forced)


def jax_seg_losses(jcfg, params, batch, text, rng, forced):
    """The loss_fn body of ``make_train2d_step`` (train2d.py:298-317)."""
    images, gt_cls, gt_masks, gt_valid = batch
    out = jax_head_out(jcfg, params["model"], images, text, forced)
    no_obj = params["no_object"]
    no_obj = no_obj / jnp.maximum(jnp.linalg.norm(no_obj), 1e-8)
    emb = out["mask_embed"]
    emb = emb / jnp.maximum(jnp.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
    logits = jnp.concatenate([out["pred_logits"], (LOGIT_SCALE * emb @ no_obj)[..., None]],
                             axis=-1)
    losses = jcrit.set_criterion(logits, out["pred_masks"], gt_cls, gt_masks, gt_valid, rng,
                                 num_points=NUM_POINTS)
    return losses["loss"], losses


def jax_class_text(params, class_ids):
    """train2d.py:352-354: class prompts through the tower, a zero row."""
    pooled = jax_lang().apply({"params": params["lang"]}, class_ids)
    return jnp.concatenate([pooled, jnp.zeros((1, pooled.shape[1]), pooled.dtype)], 0)


def check_losses_and_grads(params, tlosses, jlosses, jgrads):
    """Losses within rel 1e-5; every parameter's gradient within 1e-4 of the
    JAX gradient's norm. A leaf whose JAX gradient is under 1e-6 of the
    whole gradient's norm vanishes in exact arithmetic (an attention key
    bias: softmax ignores a shift shared by every key; a backbone norm's
    bias ahead of the pixel decoder's GroupNorm) and holds only f32
    rounding: the port's must vanish there too."""
    assert set(tlosses) == set(jlosses)
    for k in jlosses:
        assert _rel(tlosses[k].detach().numpy(), jlosses[k]) < 1e-5, k
    ref = train2d_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in params.named_parameters()}
    assert set(ref) == set(got)
    total = float(torch.sqrt(sum((r.double() ** 2).sum() for r in ref.values())))
    worst = 0.0
    for k, r in ref.items():
        g = got[k]
        d = float(torch.linalg.norm((g - r).double()))
        n = float(torch.linalg.norm(r.double()))
        if n <= 1e-6 * total:
            assert float(torch.linalg.norm(g.double())) <= 1e-6 * total, (k, n)
            continue
        assert d <= 1e-4 * n, (k, d, n)
        worst = max(worst, d / max(n, 1e-30))
    return worst


def test_seg_loss_matches_jax():
    """The seg task's loss (``make_train2d_step``'s body): the model and the
    learned no-object embedding."""
    jcfg, jtree, params = build_pair(0)
    batch = seg_batch(1)
    text = unit_text(2)
    forced, logits0 = port_masks(params, batch[0], torch.from_numpy(text))
    check_round0(jcfg, jtree, batch[0], text, logits0)
    rng, points = jax_points(3)
    jforced = [jnp.asarray(m.numpy()) for m in forced]
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_seg_losses(jcfg, p, [jnp.asarray(a) for a in batch], jnp.asarray(text),
                                 rng, jforced), has_aux=True))(jtree)
    total, tlosses = ttrain.seg_losses(params, *(torch.from_numpy(a) for a in batch),
                                       torch.from_numpy(text), LOGIT_SCALE, NUM_POINTS,
                                       points=points, attn_mask_override=forced)
    total.backward()
    check_losses_and_grads(params, tlosses, jlosses, jgrads)
    assert params.no_object.grad.abs().max() > 0


def test_joint_seg_loss_matches_jax():
    """The joint (switch) seg loss (``make_joint_seg_step``'s body): the
    class text from the shared tower, so the tower's gradients too; the
    caption slots, untouched by this task, get zero gradients."""
    from geopurify_tpu_torch.models.lang import HashTokenizer, PROMPT_TEMPLATES

    jcfg, jtree, params = build_pair(4, caption_len=CAP_LEN, lang=True)
    batch = seg_batch(5)
    tk = HashTokenizer(vocab_size=VOCAB, context_length=CAP_LEN)
    class_ids = tk([PROMPT_TEMPLATES[0].format(n) for n in ("wall", "floor", "chair", "desk")])[0]
    text = ttrain.class_text(params, torch.from_numpy(class_ids)).detach()
    jtext = jax_class_text(jtree, jnp.asarray(class_ids))
    assert _rel(text.numpy(), jtext) < 1e-5
    forced, logits0 = port_masks(params, batch[0], text)
    check_round0(jcfg, jtree, batch[0], np.asarray(jtext), logits0)
    rng, points = jax_points(6)
    jforced = [jnp.asarray(m.numpy()) for m in forced]

    def jloss(p):
        return jax_seg_losses(jcfg, p, [jnp.asarray(a) for a in batch],
                              jax_class_text(p, jnp.asarray(class_ids)), rng, jforced)

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtree)
    total, tlosses = ttrain.joint_seg_losses(
        params, *(torch.from_numpy(a) for a in batch), torch.from_numpy(class_ids),
        LOGIT_SCALE, NUM_POINTS, points=points, attn_mask_override=forced)
    total.backward()
    check_losses_and_grads(params, tlosses, jlosses, jgrads)
    assert params.lang.lang_proj.grad.abs().max() > 0
    assert params.model.predictor.caping_embed.grad is None
