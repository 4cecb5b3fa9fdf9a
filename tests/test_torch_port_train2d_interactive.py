"""The 2D trainer's interactive (SEEM v1) loss held against the JAX package on
the CPU, gradients included.

The batch is the port's ``synthetic_interactive_batch`` (the visual
sampler's prompt points through ``InteractiveMapper``; its equality with
JAX's is in ``tests/test_torch_port_data2d.py``). One set of seeded weights
(the backbone, pixel decoder and ``SEEMHeadV1`` at ``tiny`` widths) goes to
both sides through ``train2d_from_jax``; the JAX loss is
``make_interactive_step``'s body under ``jax.value_and_grad``, with each
round's resized mask logits recorded. The port runs forced onto JAX's
binary attention masks through its ``models.seem._blocked`` seam: the
pre-threshold logits within rel 1e-5 (flips only at near-ties), then the
losses within rel 1e-5 and every gradient leaf within 1e-4 of its norm."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from geopurify_tpu.models import focalnet as jfocal
from geopurify_tpu.models import pixel_decoder as jpixdec
from geopurify_tpu.models import seem as jseem
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.data.mappers import InteractiveMapper
from geopurify_tpu_torch.data.visual_sampler import StrokeSamplerConfig
from geopurify_tpu_torch.models import seem as tseem
from geopurify_tpu_torch.models.xdecoder import _make_backbone, _make_pixel_decoder
from geopurify_tpu_torch.run import train2d as ttrain
from geopurify_tpu_torch.utils.from_jax import train2d_from_jax
from tests.test_torch_port_backbones2d import seeded_jax_params
from tests.test_torch_port_interactive import TINY
from tests.test_torch_port_seem import seed_head_
from tests.test_torch_port_train2d_steps import _rel, check_losses_and_grads

HW = (64, 64)
NUM_MASKS, BUDGET = 2, 8
LOGIT_SCALE = 10.0


def interactive_pair():
    """The tiny X-Decoder config, the JAX modules and params tree, and the
    port's ``Train2DParams`` loaded from it."""
    cfg = tconfig.load_config("scannet", overrides=TINY)
    xc = dataclasses.replace(cfg.xdecoder, dtype="float32", mask_shape=HW)
    head_kw = dict(hidden_dim=xc.hidden_dim, dim_proj=xc.hidden_dim,
                   num_queries=xc.num_queries, nheads=xc.nheads,
                   dim_feedforward=xc.dim_feedforward, dec_layers=xc.dec_layers,
                   mask_dim=xc.mask_dim, max_spatial_tokens=BUDGET)
    bb, pd, hd = _make_backbone(xc), _make_pixel_decoder(xc), tseem.SEEMHeadV1(**head_kw)
    jtree = {"backbone": seeded_jax_params(bb, 1)["params"],
             "pixdec": seeded_jax_params(pd, 2)["params"],
             "head": seed_head_(hd, 3)["params"]}
    head = tseem.SEEMHeadV1(**head_kw)
    params = ttrain.Train2DParams(backbone=_make_backbone(xc), pixdec=_make_pixel_decoder(xc),
                                  head=head)
    params.load_state_dict(train2d_from_jax(jtree, head=head))
    # train2d.py:672-687: the JAX entry's modules
    jmods = (jfocal.FocalNet(embed_dim=xc.backbone.embed_dim, depths=tuple(xc.backbone.depths),
                             focal_levels=tuple(xc.backbone.focal_levels),
                             focal_windows=tuple(xc.backbone.focal_windows)),
             jpixdec.TransformerEncoderPixelDecoder(
                 conv_dim=xc.conv_dim, mask_dim=xc.mask_dim, num_enc_layers=xc.enc_layers,
                 num_heads=xc.nheads, dim_feedforward=xc.dim_feedforward),
             jseem.SEEMHeadV1(**head_kw))
    return xc, jmods, jtree, params


def interactive_batch(seed: int, n_cls: int = 3, B: int = 1):
    mapper = InteractiveMapper(image_size=HW[0], min_scale=0.9, max_scale=1.1,
                               sampler_cfg=StrokeSamplerConfig(max_candidate=NUM_MASKS),
                               grounding=False)
    rng = np.random.default_rng(seed)
    batch = ttrain.synthetic_interactive_batch(rng, mapper, B, HW, n_cls, NUM_MASKS, BUDGET)
    return [t.numpy() for t in batch], rng


def jax_interactive_losses(jmods, params, batch, text, qidx, rec):
    """The loss_fn body of ``make_interactive_step`` (train2d.py:246-270)."""
    backbone, pixdec, head = jmods
    images, pts, valid, mask_ids, gt4, slot_valid = batch
    feats = backbone.apply({"params": params["backbone"]}, images / 127.5 - 1.0)
    mask_features, _, multi_scale = pixdec.apply({"params": params["pixdec"]}, feats)
    resize = jseem.resize_bilinear_torch

    def recording(x, out_hw):
        y = resize(x, out_hw)
        rec.append(y)
        return y

    jseem.resize_bilinear_torch = recording
    try:
        out = head.apply({"params": params["head"]}, list(multi_scale), mask_features, text,
                         jnp.float32(LOGIT_SCALE), pts, valid, jnp.ones_like(mask_ids),
                         mask_ids, qidx, num_masks=NUM_MASKS)
    finally:
        jseem.resize_bilinear_torch = resize
    pred = out["prev_mask"]
    p = pred.reshape(pred.shape[0], NUM_MASKS, -1)
    g = gt4.reshape(gt4.shape[0], NUM_MASKS, -1)
    ce = optax.sigmoid_binary_cross_entropy(p, g).mean(-1)
    prob = jax.nn.sigmoid(p)
    dice = 1.0 - (2.0 * (prob * g).sum(-1) + 1.0) / (prob.sum(-1) + g.sum(-1) + 1.0)
    w = slot_valid.astype(jnp.float32)
    denom = jnp.maximum(w.sum(), 1.0)
    l_ce, l_dice = (ce * w).sum() / denom, (dice * w).sum() / denom
    total = 2.0 * l_ce + 2.0 * l_dice
    return total, {"loss": total, "loss_spatial_ce": l_ce, "loss_spatial_dice": l_dice}


def test_interactive_loss_matches_jax(monkeypatch):
    xc, jmods, jtree, params = interactive_pair()
    batch, rng = interactive_batch(21)
    assert batch[2].sum() > 0 and batch[5].any()
    text = rng.normal(size=(3, xc.hidden_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    qidx = rng.integers(0, xc.num_queries, params.head.sample_size * NUM_MASKS)

    def jloss(p, batch, text, qidx):
        rec = []
        total, losses = jax_interactive_losses(jmods, p, batch, text, qidx, rec)
        return total, (losses, rec)

    (_, (jlosses, jrec)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jtree, [jnp.asarray(a) for a in batch], jnp.asarray(text), jnp.asarray(qidx))
    jrec = [np.asarray(y) for y in jrec]

    trec = []
    t_resize, t_blocked = tseem.resize_bilinear_torch, tseem._blocked

    def t_recording(x, out_hw):
        y = t_resize(x, out_hw)
        trec.append(y.detach().numpy())
        return y

    def forced(masks, size):
        t_blocked(masks, size)                  # records the port's own logits
        jm = jrec[len(trec) - 1]                # NHWC [B, h, w, N]
        blocked = 1.0 / (1.0 + np.exp(-jm.astype(np.float64))) < 0.5
        return torch.from_numpy(blocked.transpose(0, 3, 1, 2).reshape(
            jm.shape[0], jm.shape[3], -1).copy())

    monkeypatch.setattr(tseem, "resize_bilinear_torch", t_recording)
    monkeypatch.setattr(tseem, "_blocked", forced)
    total, tlosses = ttrain.interactive_losses(
        params, *(torch.from_numpy(a) for a in batch), torch.from_numpy(text), LOGIT_SCALE,
        torch.from_numpy(qidx))
    total.backward()
    assert len(trec) == len(jrec) > 0
    for a, b in zip(trec, jrec):
        assert _rel(a, b) < 1e-5
        flips = (a > 0) != (b > 0)
        assert not flips.any() or np.abs(b[flips]).max() <= 1e-5 * np.abs(b).max()
    check_losses_and_grads(params, tlosses, jlosses, jgrads)
    assert params.head.pn_indicator.grad.abs().max() > 0
