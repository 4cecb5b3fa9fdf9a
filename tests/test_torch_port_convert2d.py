"""The 2D family's checkpoint converters held against the JAX package on
the CPU. Reference-layout state dicts are written by the port's inverse
(``synthesize_torch_state_dict``) from seeded port modules; the JAX
converters and the port's then give equal trees, and the port's gives the
modules' own state dicts back: the focal_dw FocalNet with caption slots
(through ``convert_xdecoder_checkpoint``), DaViT, ViT (transposed convs,
the [1, g, g, C] position table) and the deformable pixel decoder (through
the standalone converters, which ``convert_xdecoder_checkpoint`` names for
them) and the SEEM heads (``convert_seem``, named the same way; the heads
it loads answer as the JAX heads do with ``jcx.convert_seem``'s tree)."""

import dataclasses

import numpy as np
import pytest
import torch

from geopurify_tpu.utils import convert_xdecoder as jcx
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import davit as tdavit
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.models import pixel_decoder_deform as tpdd
from geopurify_tpu_torch.models import vit_backbone as tvit
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.utils import convert_xdecoder as tcx
from geopurify_tpu_torch.utils.from_jax import _state_dict, params_from_jax
from geopurify_tpu.models import seem as jseem
from geopurify_tpu_torch.models import seem as tseem
from geopurify_tpu_torch.utils.from_jax import seem_from_jax
from tests.test_torch_port_backbones2d import DAVIT_SMALL, _vit_small
from tests.test_torch_port_seem import (DEMO_KW, SCALE, V0_KW, V1_KW, check, feature_inputs,
                                        run_both, seeded_head, spatial_prompts, v1_inputs)

LANG = dict(vocab_size=64, width=16, layers=1, heads=2, context_length=6, dim_proj=16)


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return module


def _same_state(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and torch.equal(got[k], ref[k]), k


def _reference(module, part: str):
    """The reference-layout keys of one port module standing as ``part``
    (``backbone`` / ``pixel_decoder``) of an X-Decoder."""
    state = {f"{part}.{k}": v for k, v in module.state_dict().items()}
    return tcx.synthesize_torch_state_dict(state, {})


@pytest.fixture(scope="module")
def focal_dw():
    """A tiny focal_dw X-Decoder with caption slots and a language tower,
    written out in the reference layout."""
    cfg = tconfig.load_config("tiny", overrides=[
        "xdecoder.backbone.variant=focal_dw",
        "xdecoder.backbone.use_pre_norms=[False,True,False,True]"]).xdecoder
    xdec = _seeded(txd.XDecoderSegModel(cfg, caption_len=LANG["context_length"]), 1)
    lang = _seeded(tlang.LanguageEncoder(**LANG), 2)
    kw = dict(depths=tuple(cfg.backbone.depths), enc_layers=cfg.enc_layers,
              dec_layers=cfg.dec_layers)
    return xdec, lang, tcx.synthesize_torch_state_dict(xdec, lang), kw


def test_focal_dw_with_caption_slots_converts_like_jax(focal_dw):
    xdec, lang, sd, kw = focal_dw
    assert "backbone.layers.0.blocks.0.dw1.weight" in sd
    assert sd["sem_seg_head.predictor.pos_embed_caping.weight"].shape == (6, 16)
    ref = jcx.convert_xdecoder_checkpoint(sd, **kw)
    got = tcx.convert_xdecoder_checkpoint(sd, **kw)
    _same_state(got["xdecoder"], params_from_jax(ref["xdecoder"]))
    _same_state(got["lang"], params_from_jax(ref["lang"]))
    # the round trip, caption slots included
    _same_state(got["xdecoder"], xdec.state_dict())
    _same_state(got["lang"], lang.state_dict())


def test_davit_converts_like_jax():
    m = _seeded(tdavit.DaViT(**DAVIT_SMALL), 3)
    sd = _reference(m, "backbone")
    assert "backbone.blocks.3.0.channel_block.channel_attn.fn.qkv.weight" in sd
    depths = DAVIT_SMALL["depths"]
    ref = params_from_jax(jcx.convert_davit(sd, "backbone", depths))
    got = _state_dict(tcx.convert_davit(sd, "backbone", depths))
    _same_state(got, ref)
    _same_state(got, m.state_dict())


def test_vit_converts_like_jax():
    kw = _vit_small(8)
    m = _seeded(tvit.ViTBackbone(**kw), 4)
    sd = _reference(m, "backbone")
    assert sd["backbone.pos_embed"].shape == (1, 8, 8, 32)
    assert sd["backbone.neck.down_4.0.weight"].shape == (32, 16, 2, 2)   # [in, out, k, k]
    ref = params_from_jax(jcx.convert_vit(sd, "backbone", kw["depth"]))
    got = _state_dict(tcx.convert_vit(sd, "backbone", kw["depth"]))
    _same_state(got, ref)
    _same_state(got, m.state_dict())


def test_deform_pixel_decoder_converts_like_jax():
    m = _seeded(tpdd.MSDeformAttnPixelDecoder((8, 16, 32, 64), conv_dim=16, mask_dim=16,
                                              num_enc_layers=2, num_heads=2,
                                              dim_feedforward=32), 5)
    sd = _reference(m, "pixel_decoder")
    p = "sem_seg_head.pixel_decoder"
    assert f"{p}.input_proj.2.1.weight" in sd and f"{p}.transformer.level_embed" in sd
    ref = params_from_jax(jcx.convert_deform_pixel_decoder(sd, p, 2))
    got = _state_dict(tcx.convert_deform_pixel_decoder(sd, p, 2))
    _same_state(got, ref)
    _same_state(got, m.state_dict())


@pytest.mark.parametrize("kind", ["v0", "v1", "demo"])
def test_seem_converts_like_jax(monkeypatch, kind):
    """A SEEM head written out as a reference-layout predictor (the
    spatial projections under the reference's ``mask_sptial_embed``) comes
    back through the port's ``convert_seem`` equal to the JAX
    ``convert_seem`` carried by ``seem_from_jax`` and to its own state; the
    head it loads answers as the JAX head does on the JAX tree."""
    jcls, tcls, kw = {"v0": (jseem.SEEMHead, tseem.SEEMHead, V0_KW),
                      "v1": (jseem.SEEMHeadV1, tseem.SEEMHeadV1, V1_KW),
                      "demo": (jseem.SEEMHeadDemo, tseem.SEEMHeadDemo, DEMO_KW)}[kind]
    head, _ = seeded_head(tcls, 14, **kw)
    sd = _reference(head, "predictor")
    p = "sem_seg_head.predictor"
    assert sd[f"{p}.mask_sptial_embed.2"].shape == (16, 16)
    assert (f"{p}.spatial_embed.weight" in sd) == (kind != "demo")
    jtree = jcx.convert_seem(sd, p, kw["dec_layers"])
    got = _state_dict(tcx.convert_seem(sd, p, kw["dec_layers"]))
    _same_state(got, seem_from_jax(jtree, head))
    _same_state(got, head.state_dict())
    loaded = tcls(**kw).eval()
    loaded.load_state_dict(got)
    rng, ms, mf, text = feature_inputs(15)
    pts, valid, tags = spatial_prompts(rng)
    if kind == "v1":
        args, call = v1_inputs(16, 1)[1], {}
    else:
        args = (ms, mf, text, SCALE)
        call = dict(spatial_points=pts, spatial_valid=valid, spatial_posneg=tags)
    check(*run_both(monkeypatch, jcls(**kw), {"params": jtree}, loaded, *args, **call))


@pytest.mark.parametrize("key,error,match", [
    ("backbone.convs.0.proj.weight", ValueError, "convert_davit"),
    ("backbone.pos_embed", ValueError, "convert_vit"),
    ("sem_seg_head.pixel_decoder.transformer.level_embed", ValueError,
     "convert_deform_pixel_decoder"),
    ("sem_seg_head.predictor.mask_sptial_embed.0", ValueError, "SEEM.*convert_seem"),
    ("sem_seg_head.predictor.pn_indicator.weight", ValueError, "SEEM.*convert_seem"),
])
def test_checkpoints_outside_the_focal_fpn_scope_raise(focal_dw, key, error, match):
    _, _, sd, kw = focal_dw
    with pytest.raises(error, match=match):
        tcx.convert_xdecoder_checkpoint({**sd, key: np.zeros(1, np.float32)}, **kw)


@pytest.mark.parametrize("kind", ["davit", "vit", "deform"])
def test_whole_models_round_trip(kind):
    """An X-Decoder of each other backbone / pixel decoder written out and
    read back part by part through the standalone converters."""
    over = {"davit": ["xdecoder.backbone_type=davit"], "vit": ["xdecoder.backbone_type=vit"],
            "deform": ["xdecoder.pixel_decoder=deform"]}[kind]
    cfg = tconfig.load_config("tiny", overrides=over).xdecoder
    m = _seeded(txd.XDecoderSegModel(dataclasses.replace(cfg, dec_layers=1)), 6)
    sd = tcx.synthesize_torch_state_dict(m, {})
    bb = {"davit": lambda: tcx.convert_davit(sd, "backbone", (1, 1, 3, 1)),
          "vit": lambda: tcx.convert_vit(sd, "backbone", 12),
          "deform": lambda: tcx.convert_focalnet(sd, "backbone", cfg.backbone.depths)}[kind]
    pd = (tcx.convert_deform_pixel_decoder(sd, "sem_seg_head.pixel_decoder", cfg.enc_layers)
          if kind == "deform" else
          tcx.convert_pixel_decoder(sd, "sem_seg_head.pixel_decoder", cfg.enc_layers))
    tree = {"backbone": bb(), "pixel_decoder": pd,
            "predictor": tcx.convert_predictor(sd, "sem_seg_head.predictor", 1)}
    _same_state(_state_dict(tree), m.state_dict())
