"""The assembled ``XDecoderSegModel`` with each alternative configuration
held against the JAX package on the CPU, on one set of seeded weights:
the focal_dw FocalNet (with pre-norm downsample embeds), DaViT and ViT-B
(at the JAX defaults, the only widths its config builds) and the
deformable pixel decoder (with caption tokens in the head). The pixel
features at f32 rel < 1e-5, then the head with both sides on the port's
attention masks (the 0.5 threshold would otherwise amplify f32 noise)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.config import FocalNetConfig, XDecoderConfig
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu.parity.oracle import FOCAL_SMALL
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import xdecoder as txd
from tests.test_torch_port_backbones2d import _rel, seeded_jax_params


def _xcfg(**kw):
    base = dict(backbone=FocalNetConfig(**FOCAL_SMALL), hidden_dim=16, conv_dim=16,
                mask_dim=16, num_queries=7, nheads=2, dim_feedforward=32, dec_layers=2,
                enc_layers=1, mask_shape=(32, 64), dtype="float32")
    base.update(kw)
    return XDecoderConfig(**base)


def _tcfg(cfg):
    return tconfig._apply_dict(tconfig.XDecoderConfig(), dataclasses.asdict(cfg))


def compare_seg_model(cfg, hw=(64, 96), seed=2, caption_len=0):
    """The assembled models on one set of seeded weights: pixel features at
    rel < 1e-5, then the head (with ``caption_len`` caption tokens) with
    both sides on the port's attention masks."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (1, *hw, 3)).astype(np.float32)
    text = rng.normal(size=(4, cfg.hidden_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    cap = (rng.normal(size=(1, caption_len, cfg.hidden_dim)).astype(np.float32)
           if caption_len else None)
    tm = txd.XDecoderSegModel(_tcfg(cfg), caption_len=caption_len).eval()
    params = seeded_jax_params(tm, seed + 1)
    with torch.no_grad():
        mf_t, ms_t = txd.encode_pixel_features(tm, torch.from_numpy(img))
        got = txd.apply_head(tm, ms_t, mf_t, torch.from_numpy(text), 10.0,
                             caption_tokens=None if cap is None else torch.from_numpy(cap),
                             return_attn=True)
    forced = [jnp.asarray(m.numpy()) for m in got["attn_masks"][:-1]]

    @jax.jit
    def jax_model(params, img, text, cap):
        mf, ms = jxd.encode_pixel_features(cfg, params, img)
        return mf, ms, jxd._make_head(cfg).apply(
            {"params": params["params"]["predictor"]}, list(ms), mf, text, jnp.float32(10.0),
            caption_tokens=cap, attn_mask_override=forced)

    mf_j, ms_j, ref = jax_model(params, jnp.asarray(img), jnp.asarray(text),
                                None if cap is None else jnp.asarray(cap))
    assert _rel(mf_t.numpy(), mf_j) < 1e-5
    for a, b in zip(ms_t, ms_j):
        assert _rel(a.numpy(), b) < 1e-5
    for k in ("pred_logits", "pred_masks", "mask_embed", "cls_embed"):
        assert _rel(got[k].numpy(), ref[k]) < 1e-5, k


@pytest.mark.parametrize("kind", ["focal_dw", "davit", "vit"])
def test_seg_model_with_backbone_matches_jax(kind):
    if kind == "focal_dw":
        bb = FocalNetConfig(**{**FOCAL_SMALL, "variant": "focal_dw",
                               "use_pre_norms": (False, True, True, False)})
        cfg = _xcfg(backbone=bb)
    else:
        cfg = _xcfg(backbone_type=kind)
    compare_seg_model(cfg)


def test_seg_model_with_deform_pixel_decoder_matches_jax():
    compare_seg_model(_xcfg(pixel_decoder="deform"), caption_len=5)


@pytest.mark.parametrize("layer", ["self", "cross", "ffn", "encoder"])
def test_pre_norm_layers_match_jax(layer):
    """The ``pre_norm`` forms of the head's and the FPN encoder's layers
    (``xdecoder.pre_norm``), f32 rel < 1e-5."""
    from geopurify_tpu.models import layers as jl
    from geopurify_tpu_torch.models import layers as tl

    rng = np.random.default_rng(7)
    x, mem = (rng.normal(size=s).astype(np.float32) for s in ((2, 5, 16), (2, 9, 16)))
    pos, qpos = rng.normal(size=(2, 9, 16)).astype(np.float32), x[::-1].copy()
    mask = rng.random((2, 1, 5, 9)) < 0.3
    jm, tm, args = {
        "self": (jl.SelfAttentionLayer(16, 2, pre_norm=True),
                 tl.SelfAttentionLayer(16, 2, pre_norm=True), (x, qpos, mask[..., :5])),
        "cross": (jl.CrossAttentionLayer(16, 2, pre_norm=True),
                  tl.CrossAttentionLayer(16, 2, pre_norm=True), (x, mem, mask, pos, qpos)),
        "ffn": (jl.FFNLayer(16, 32, pre_norm=True), tl.FFNLayer(16, 32, pre_norm=True), (x,)),
        "encoder": (jl.TransformerEncoderLayer(16, 2, 32, pre_norm=True),
                    tl.TransformerEncoderLayer(16, 2, 32, pre_norm=True), (mem, pos)),
    }[layer]
    jargs = [jnp.asarray(a) for a in args]
    params = seeded_jax_params(tm, 8, scale=0.3)
    with torch.no_grad():
        got = tm(*[torch.from_numpy(np.asarray(a)) for a in args])
    assert _rel(got.numpy(), jm.apply(params, *jargs)) < 1e-5
