"""The released-checkpoint converters held against the JAX package on the
CPU. X-Decoder: a reference-layout state dict (the JAX synthesizer's, under
both key prefixes) converts to bit-equal tensors in both packages; the
port's inverse writes exactly the reference keys and shapes and round-trips;
the converted model and language tower run forward like the JAX ones at f32
rel < 1e-5; 2D-family checkpoints raise. Sonata: the synthetic release
layout (both spconv generations, LayerNorm and folded BatchNorm) converts
bit-equal, runs forward like JAX at rel < 1e-5, and the layout errors raise
in both packages."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.config import SonataConfig as JSonataConfig
from geopurify_tpu.models import lang as jlang
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu.models.sonata import SonataTeacher as JSonata
from geopurify_tpu.utils import convert_sonata as jcs
from geopurify_tpu.utils import convert_xdecoder as jcx
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.models.pipeline import build_sonata
from geopurify_tpu_torch.utils import convert_sonata as tcs
from geopurify_tpu_torch.utils import convert_xdecoder as tcx
from geopurify_tpu_torch.utils.from_jax import params_from_jax
from tests.test_convert_sonata import _scene
from tests.test_pipeline import tiny_cfg

LANG = dict(vocab_size=64, width=16, layers=2, heads=2, context_length=8, dim_proj=16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _same_state(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


# ---------------------------------------------------------------------------
# X-Decoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xdec():
    """The tiny X-Decoder (tests/test_pipeline.tiny_cfg) and a small
    language tower: JAX shape trees, the JAX synthesizer's reference-layout
    state dict, and the conversion arguments."""
    cfg = tiny_cfg().xdecoder
    key = jax.random.key(0)
    xshapes = jax.eval_shape(jxd.XDecoderSegModel(cfg).init, key,
                             jnp.zeros((1, *cfg.mask_shape, 3)), jnp.zeros((5, 16)),
                             jnp.float32(1.0))
    lshapes = jax.eval_shape(jlang.LanguageEncoder(**LANG).init, key,
                             jnp.zeros((1, 8), jnp.int32))
    sd = jcx.synthesize_torch_state_dict(xshapes["params"], lshapes["params"])
    sd["sem_seg_head.predictor.lang_encoder.logit_scale"] = np.float32(2.5)
    kw = dict(depths=tuple(cfg.backbone.depths), enc_layers=cfg.enc_layers,
              dec_layers=cfg.dec_layers)
    return cfg, xshapes, lshapes, sd, kw


def _tcfg(cfg):
    return tconfig._apply_dict(tconfig.XDecoderConfig(), dataclasses.asdict(cfg))


@pytest.mark.parametrize("prefix", ["", "model."])
def test_xdecoder_converter_matches_jax(xdec, prefix):
    cfg, _, _, sd, kw = xdec
    sd = {prefix + k: v for k, v in sd.items()}
    ref = jcx.convert_xdecoder_checkpoint(sd, **kw)
    got = tcx.convert_xdecoder_checkpoint(sd, **kw)
    _same_state(got["xdecoder"], params_from_jax(ref["xdecoder"]))
    _same_state(got["lang"], params_from_jax(ref["lang"]))
    assert got["logit_scale"] == ref["logit_scale"] == float(np.exp(np.float32(2.5)))
    # the converted trees load strictly into the port's modules
    txd.XDecoderSegModel(_tcfg(cfg)).load_state_dict(got["xdecoder"])
    tlang.LanguageEncoder(**LANG).load_state_dict(got["lang"])


def test_converter_inverse_keys_shapes_and_round_trip(xdec):
    """The port's inverse writes exactly the JAX synthesizer's keys and
    shapes; port -> reference -> port is the identity."""
    cfg, _, _, sd, kw = xdec
    tm, tl = txd.XDecoderSegModel(_tcfg(cfg)), tlang.LanguageEncoder(**LANG)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in [*tm.parameters(), *tl.parameters()]:
            p.copy_(torch.randn(p.shape, generator=g))
    inv = tcx.synthesize_torch_state_dict(tm, tl)
    assert set(inv) == set(sd)
    for k in sd:
        assert inv[k].shape == np.shape(sd[k]) and inv[k].dtype == np.float32, k
    back = tcx.convert_xdecoder_checkpoint(inv, **kw)
    _same_state(back["xdecoder"], tm.state_dict())
    _same_state(back["lang"], tl.state_dict())
    assert back["logit_scale"] == float(np.exp(tl.logit_scale.detach().numpy()))


def test_converted_xdecoder_forward_matches_jax(xdec):
    """Seeded weights written out by the port's inverse, converted by each
    package: pixel features, the head with both sides on the port's
    attention masks, and the class embeddings of the converted language
    tower, f32, rel < 1e-5."""
    cfg, xshapes, lshapes, _, kw = xdec
    rng = np.random.default_rng(4)

    def fill(path, leaf):
        x = rng.normal(size=leaf.shape).astype(np.float32) * 0.2
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else x

    seeded = jax.tree_util.tree_map_with_path(fill, {"x": xshapes, "l": lshapes})
    sd = tcx.synthesize_torch_state_dict(params_from_jax(seeded["x"]),
                                         params_from_jax(seeded["l"]))
    ref = jcx.convert_xdecoder_checkpoint(sd, **kw)
    got = tcx.convert_xdecoder_checkpoint(sd, **kw)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, ref["xdecoder"]["params"])}
    tm = txd.XDecoderSegModel(_tcfg(cfg)).eval()
    tm.load_state_dict(got["xdecoder"])

    img = rng.integers(0, 256, (2, *cfg.mask_shape, 3)).astype(np.float32)
    text = rng.normal(size=(5, 16)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    mf_j, ms_j = jxd.encode_pixel_features(cfg, jparams, jnp.asarray(img))
    with torch.no_grad():
        mf_t, ms_t = txd.encode_pixel_features(tm, torch.from_numpy(img))
        free = txd.apply_head(tm, ms_t, mf_t, torch.from_numpy(text), 20.0,
                              return_attn=True)
    assert _rel(mf_t.numpy(), mf_j) < 1e-5
    for a, b in zip(ms_t, ms_j):
        assert _rel(a.numpy(), b) < 1e-5
    forced = [m.numpy() for m in free["attn_masks"][:-1]]
    out_j = jxd._make_head(cfg).apply(
        {"params": jparams["params"]["predictor"]}, list(ms_j), mf_j, jnp.asarray(text),
        jnp.float32(20.0), attn_mask_override=[jnp.asarray(m) for m in forced])
    for k in ("pred_logits", "pred_masks", "mask_embed"):
        assert _rel(free[k].numpy(), out_j[k]) < 1e-5, k

    jl = jlang.LanguageEncoder(**LANG)
    tl = tlang.LanguageEncoder(**LANG)
    tl.load_state_dict(got["lang"])
    names = ["wall", "floor", "chair-other"]
    tk_j, tk_t = jlang.HashTokenizer(64, 8), tlang.HashTokenizer(64, 8)
    emb_j = jlang.embed_class_names(lambda v, i: jl.apply(v, i), ref["lang"], tk_j, names,
                                    use_templates=False, template="a {} in a scene")
    emb_t = tlang.embed_class_names(tl, tk_t, names, use_templates=False,
                                    template="a {} in a scene")
    assert emb_t.shape == (4, 16) and _rel(emb_t, emb_j) < 1e-5


def test_xdecoder_converter_errors(xdec, caplog):
    _, _, _, sd, kw = xdec
    short = dict(sd)
    del short["sem_seg_head.predictor.decoder_norm.weight"]
    for convert in (jcx.convert_xdecoder_checkpoint, tcx.convert_xdecoder_checkpoint):
        with pytest.raises(KeyError, match="decoder_norm"):
            convert(short, **kw)
    with pytest.raises(tcx.MissingKeys):
        tcx.convert_xdecoder_checkpoint(short, **kw)
    # the 2D family: the JAX converter maps these, the port has no module
    for key, family in (("backbone.layers.0.blocks.0.dw1.weight", "focal_dw"),
                        ("backbone.convs.0.proj.weight", "DaViT"),
                        ("backbone.pos_embed", "ViT"),
                        ("sem_seg_head.pixel_decoder.transformer.level_embed", "deformable"),
                        ("sem_seg_head.predictor.mask_sptial_embed.0", "SEEM")):
        with pytest.raises(NotImplementedError, match=f"{family}.*2D family"):
            tcx.convert_xdecoder_checkpoint({**sd, key: np.zeros(1, np.float32)}, **kw)
    # caption slots belong to the captioning task: left out, with a warning
    cap = {**sd, "sem_seg_head.predictor.caping_embed": np.zeros((16, 16), np.float32)}
    with caplog.at_level(logging.WARNING, logger="geopurify.convert_xdecoder"):
        got = tcx.convert_xdecoder_checkpoint(cap, **kw)
    assert "caping_embed" in caplog.text
    assert not any("caping" in k for k in got["xdecoder"])


# ---------------------------------------------------------------------------
# Sonata
# ---------------------------------------------------------------------------

DEPTHS, CHANNELS = (1, 2), (8, 16)


def _scfg(pkg_cfg, norm="ln", depths=DEPTHS):
    return pkg_cfg(in_channels=6, enc_depths=depths, enc_channels=CHANNELS,
                   enc_num_head=(2, 4), enc_patch_size=(16, 16), stem_kernel=3,
                   norm=norm, upcast_levels=1, dtype="float32")


def _other_generation(sd):
    """The stem in the spconv 1 layout and the blocks' xCPE in the spconv >= 2
    layout: the opposite of ``fake_sonata_state_dict``'s."""
    out = dict(sd)
    out["embedding.stem.conv.weight"] = sd["embedding.stem.conv.weight"].transpose(1, 2, 3, 4, 0)
    for k, v in sd.items():
        if k.endswith("cpe.0.weight"):
            out[k] = v.transpose(4, 0, 1, 2, 3)
    return out


@pytest.mark.parametrize("norm", ["ln", "bn_folded"])
@pytest.mark.parametrize("generation", ["stem2_cpe1", "stem1_cpe2"])
def test_sonata_converter_matches_jax(rng, norm, generation):
    sd = jcs.fake_sonata_state_dict(DEPTHS, CHANNELS, stem_kernel=3,
                                    batchnorm_aux=norm == "bn_folded")
    port_fake = tcs.fake_sonata_state_dict(DEPTHS, CHANNELS, stem_kernel=3,
                                           batchnorm_aux=norm == "bn_folded")
    assert sd.keys() == port_fake.keys()
    assert all(np.array_equal(sd[k], port_fake[k]) for k in sd)
    if generation == "stem1_cpe2":
        sd = _other_generation(sd)
    jcfg, tcfg = _scfg(JSonataConfig, norm), _scfg(tconfig.SonataConfig, norm)
    ref = jcs.convert_sonata_checkpoint(sd, jcfg)
    got = tcs.convert_sonata_checkpoint(sd, tcfg)
    _same_state(got, params_from_jax(ref))
    if generation == "stem1_cpe2":      # the same tensors from either layout
        native = jcs.fake_sonata_state_dict(DEPTHS, CHANNELS, stem_kernel=3,
                                            batchnorm_aux=norm == "bn_folded")
        _same_state(got, tcs.convert_sonata_checkpoint(native, tcfg))
    teacher = build_sonata(tcfg)
    teacher.load_state_dict(got)
    args = _scene(rng)
    out_j = JSonata(
        in_channels=6, enc_depths=DEPTHS, enc_channels=CHANNELS, enc_num_head=(2, 4),
        enc_patch_size=(16, 16), upcast_levels=1, stem_kernel=3,
        aux_norm_affine_only=norm == "bn_folded").apply(ref, *args)
    with torch.no_grad():
        out_t = teacher(*(torch.from_numpy(np.array(a)) for a in args))
    assert out_t.shape == out_j.shape and np.abs(np.asarray(out_j)).max() > 0
    assert _rel(out_t.numpy(), out_j) < 1e-5


def test_sonata_export_round_trip():
    tcfg = _scfg(tconfig.SonataConfig)
    teacher = build_sonata(tcfg)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in teacher.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    out = tcs.export_sonata_state_dict(teacher)
    fake = jcs.fake_sonata_state_dict(DEPTHS, CHANNELS, stem_kernel=3)
    assert set(out) == set(fake)
    for k in fake:
        # spconv >= 2 layout (out, kx, ky, kz, in) for every kernel
        want = fake[k].shape if not k.endswith("cpe.0.weight") else (
            fake[k].shape[4], *fake[k].shape[:4])
        assert out[k].shape == want, k
    _same_state(tcs.convert_sonata_checkpoint(out, tcfg), teacher.state_dict())
    _same_state(tcs.convert_sonata_checkpoint(out, tcfg),
                params_from_jax(jcs.convert_sonata_checkpoint(out, _scfg(JSonataConfig))))


@pytest.mark.parametrize("case", ["depths", "bn_with_ln", "bn_folded_without_stats"])
def test_sonata_conversion_errors(case):
    sd = jcs.fake_sonata_state_dict(DEPTHS, CHANNELS, stem_kernel=3,
                                    batchnorm_aux=case == "bn_with_ln")
    norm, depths = {"depths": ("ln", (1, 1)), "bn_with_ln": ("ln", DEPTHS),
                    "bn_folded_without_stats": ("bn_folded", DEPTHS)}[case]
    with pytest.raises(jcs.SonataConversionError):
        jcs.convert_sonata_checkpoint(sd, _scfg(JSonataConfig, norm, depths))
    with pytest.raises(tcs.SonataConversionError):
        tcs.convert_sonata_checkpoint(sd, _scfg(tconfig.SonataConfig, norm, depths))
