"""Released X-Decoder checkpoint (torch) -> the port's state dicts.

Port of geopurify_tpu/utils/convert_xdecoder.py, the part the 3D path
reads: the FocalNet (``focal`` variant) backbone, the transformer-encoder
FPN pixel decoder, the X-Decoder predictor and the CLIP-style language
tower of ``xdecoder_focall_last.pt``. The reference keys map first onto
the Flax-layout tree of the JAX package (numpy arrays; a FocalNet stage's
blocks are numbered children here, where the JAX converter stacks them for
its scanned stage), then through ``utils.from_jax._state_dict`` onto the
port's parameter names and layouts.

The 2D family's checkpoints (the ``focal_dw`` FocalNet, DaViT, ViT, the
deformable pixel decoder, SEEM) raise ``NotImplementedError``: their
modules are not ported (ROADMAP Queue 1, the 2D family). The predictor's
caption slots (``caping_embed``, ``pos_embed_caping``), which a
captioning-trained checkpoint carries, are read by the captioning task
only; the 3D path has no module for them, so they are left out with a
warning.

``synthesize_torch_state_dict`` is the inverse: the port's X-Decoder and
language tower written out under the reference's keys and layouts.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from geopurify_tpu_torch.utils.from_jax import _state_dict

log = logging.getLogger("geopurify.convert_xdecoder")

Array = np.ndarray
SD = Dict[str, Array]

_TWO_D_FAMILY = (
    (re.compile(r"(^|\.)backbone\.layers\.\d+\.blocks\.\d+\.dw1\."), "the focal_dw FocalNet"),
    (re.compile(r"(^|\.)backbone\.convs\.\d+\."), "the DaViT backbone"),
    (re.compile(r"(^|\.)backbone\.(pos_embed|blocks\.\d+\.attn\.qkv)"), "the ViT backbone"),
    (re.compile(r"pixel_decoder\.(transformer\.level_embed|input_proj\.\d+\.0\.)"),
     "the deformable pixel decoder"),
    (re.compile(r"predictor\.(mask_sptial_embed|spatial_embed|spatial_featured|pn_indicator)"),
     "the SEEM decoder"),
)


# geopurify_tpu/utils/convert_xdecoder.py:44
class MissingKeys(KeyError):
    pass


# geopurify_tpu/utils/convert_xdecoder.py:48
def _get(sd: SD, key: str) -> Array:
    if key not in sd:
        raise MissingKeys(key)
    return np.asarray(sd[key])


# geopurify_tpu/utils/convert_xdecoder.py:54
def _lin(sd: SD, prefix: str) -> Dict[str, Array]:
    out = {"kernel": _get(sd, f"{prefix}.weight").T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _get(sd, f"{prefix}.bias")
    return out


# geopurify_tpu/utils/convert_xdecoder.py:61
def _conv(sd: SD, prefix: str) -> Dict[str, Array]:
    """OIHW -> HWIO; a depthwise [C, 1, kh, kw] takes the same transpose to
    [kh, kw, 1, C]."""
    out = {"kernel": _get(sd, f"{prefix}.weight").transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _get(sd, f"{prefix}.bias")
    return out


# geopurify_tpu/utils/convert_xdecoder.py:73
def _ln(sd: SD, prefix: str) -> Dict[str, Array]:
    return {"scale": _get(sd, f"{prefix}.weight"), "bias": _get(sd, f"{prefix}.bias")}


# geopurify_tpu/utils/convert_xdecoder.py:77
def _mha(sd: SD, prefix: str) -> Dict[str, Any]:
    """torch nn.MultiheadAttention -> q / k / v / out projections (the packed
    ``in_proj`` [3C, C] split in three)."""
    w = _get(sd, f"{prefix}.in_proj_weight")
    b = _get(sd, f"{prefix}.in_proj_bias")
    C = w.shape[1]
    return {
        "q_proj": {"kernel": w[:C].T, "bias": b[:C]},
        "k_proj": {"kernel": w[C: 2 * C].T, "bias": b[C: 2 * C]},
        "v_proj": {"kernel": w[2 * C:].T, "bias": b[2 * C:]},
        "out_proj": _lin(sd, f"{prefix}.out_proj"),
    }


# geopurify_tpu/utils/convert_xdecoder.py:92
def _conv_gn(sd: SD, prefix: str) -> Dict[str, Any]:
    """detectron2 Conv2d with a GroupNorm child (adapter_ / layer_ convs)."""
    out: Dict[str, Any] = {"conv": _conv(sd, prefix)}
    if f"{prefix}.norm.weight" in sd:
        out["norm"] = _ln(sd, f"{prefix}.norm")
    return out


# geopurify_tpu/utils/convert_xdecoder.py:106
def convert_focalnet(sd: SD, prefix: str, depths) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "patch_embed": {
            "proj": _conv(sd, f"{prefix}.patch_embed.proj"),
            "norm": _ln(sd, f"{prefix}.patch_embed.norm"),
        }
    }
    for i, depth in enumerate(depths):
        blocks: Dict[str, Any] = {}
        for j in range(depth):
            bp = f"{prefix}.layers.{i}.blocks.{j}"
            mod: Dict[str, Any] = {
                "f": _lin(sd, f"{bp}.modulation.f"),
                "h": _conv(sd, f"{bp}.modulation.h"),
                "proj": _lin(sd, f"{bp}.modulation.proj"),
            }
            level = 0
            while f"{bp}.modulation.focal_layers.{level}.0.weight" in sd:
                mod[f"focal_layers{level}"] = _conv(
                    sd, f"{bp}.modulation.focal_layers.{level}.0")
                level += 1
            if f"{bp}.modulation.ln.weight" in sd:
                mod["ln"] = _ln(sd, f"{bp}.modulation.ln")
            blk: Dict[str, Any] = {
                "norm1": _ln(sd, f"{bp}.norm1"),
                "norm2": _ln(sd, f"{bp}.norm2"),
                "mlp": {"fc1": _lin(sd, f"{bp}.mlp.fc1"), "fc2": _lin(sd, f"{bp}.mlp.fc2")},
                "modulation": mod,
            }
            if f"{bp}.gamma_1" in sd:
                blk["gamma_1"] = _get(sd, f"{bp}.gamma_1")
                blk["gamma_2"] = _get(sd, f"{bp}.gamma_2")
            blocks[str(j)] = blk
        p[f"layers{i}_blocks"] = blocks
        if f"{prefix}.layers.{i}.downsample.proj.weight" in sd:
            ds: Dict[str, Any] = {"proj": _conv(sd, f"{prefix}.layers.{i}.downsample.proj")}
            if f"{prefix}.layers.{i}.downsample.norm.weight" in sd:
                ds["norm"] = _ln(sd, f"{prefix}.layers.{i}.downsample.norm")
            p[f"layers{i}_downsample"] = ds
        if f"{prefix}.norm{i}.weight" in sd:
            p[f"norm{i}"] = _ln(sd, f"{prefix}.norm{i}")
    return p


# geopurify_tpu/utils/convert_xdecoder.py:284
def convert_pixel_decoder(sd: SD, prefix: str, enc_layers: int) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "input_proj": _conv(sd, f"{prefix}.input_proj"),
        "mask_features": _conv(sd, f"{prefix}.mask_features"),
    }
    for i in range(enc_layers):
        lp = f"{prefix}.transformer.encoder.layers.{i}"
        p[f"encoder_layer{i}"] = {
            "self_attn": _mha(sd, f"{lp}.self_attn"),
            "norm1": _ln(sd, f"{lp}.norm1"),
            "norm2": _ln(sd, f"{lp}.norm2"),
            "linear1": _lin(sd, f"{lp}.linear1"),
            "linear2": _lin(sd, f"{lp}.linear2"),
        }
    # the reference registers adapter_{1..L-1} and layer_{1..L}
    for kind in ("adapter", "layer"):
        n = 1
        while f"{prefix}.{kind}_{n}.weight" in sd:
            p[f"{kind}_{n}"] = _conv_gn(sd, f"{prefix}.{kind}_{n}")
            n += 1
    return p


# geopurify_tpu/utils/convert_xdecoder.py:311
def convert_predictor(sd: SD, prefix: str, dec_layers: int) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "query_feat": _get(sd, f"{prefix}.query_feat.weight"),
        "query_embed": _get(sd, f"{prefix}.query_embed.weight"),
        "level_embed": _get(sd, f"{prefix}.level_embed.weight"),
        "class_embed": _get(sd, f"{prefix}.class_embed"),
        "decoder_norm": _ln(sd, f"{prefix}.decoder_norm"),
    }
    mlp: Dict[str, Any] = {}
    i = 0
    while f"{prefix}.mask_embed.layers.{i}.weight" in sd:
        mlp[f"layers{i}"] = _lin(sd, f"{prefix}.mask_embed.layers.{i}")
        i += 1
    p["mask_embed"] = mlp
    caption = [k for k in (f"{prefix}.caping_embed", f"{prefix}.pos_embed_caping.weight")
               if k in sd]
    if caption:
        log.warning("%s: caption slots of the captioning task, which the 3D path "
                    "does not run (ROADMAP Queue 1, the 2D family); left out", caption)
    for i in range(dec_layers):
        cp = f"{prefix}.transformer_cross_attention_layers.{i}"
        sp = f"{prefix}.transformer_self_attention_layers.{i}"
        fp = f"{prefix}.transformer_ffn_layers.{i}"
        p[f"cross_attn{i}"] = {"multihead_attn": _mha(sd, f"{cp}.multihead_attn"),
                               "norm": _ln(sd, f"{cp}.norm")}
        p[f"self_attn{i}"] = {"self_attn": _mha(sd, f"{sp}.self_attn"),
                              "norm": _ln(sd, f"{sp}.norm")}
        p[f"ffn{i}"] = {"linear1": _lin(sd, f"{fp}.linear1"),
                        "linear2": _lin(sd, f"{fp}.linear2"),
                        "norm": _ln(sd, f"{fp}.norm")}
    return p


# geopurify_tpu/utils/convert_xdecoder.py:374
def convert_lang_encoder(sd: SD, prefix: str) -> Tuple[Dict[str, Any], Array]:
    """(LanguageEncoder tree, logit_scale before the exp)."""
    tp = f"{prefix}.lang_encoder"
    enc: Dict[str, Any] = {
        "token_embedding": {"embedding": _get(sd, f"{tp}.token_embedding.weight")},
        "positional_embedding": _get(sd, f"{tp}.positional_embedding"),
        "ln_final": _ln(sd, f"{tp}.ln_final"),
    }
    i = 0
    while f"{tp}.resblocks.{i}.ln_1.weight" in sd:
        rp = f"{tp}.resblocks.{i}"
        enc[f"resblocks{i}"] = {
            "ln_1": _ln(sd, f"{rp}.ln_1"),
            "ln_2": _ln(sd, f"{rp}.ln_2"),
            "attn": _mha(sd, f"{rp}.attn"),
            "mlp_c_fc": _lin(sd, f"{rp}.mlp.c_fc"),
            "mlp_c_proj": _lin(sd, f"{rp}.mlp.c_proj"),
        }
        i += 1
    params = {
        "lang_encoder": enc,
        "lang_proj": _get(sd, f"{prefix}.lang_proj"),
        "logit_scale": _get(sd, f"{prefix}.logit_scale"),
    }
    return params, params["logit_scale"]


# geopurify_tpu/utils/convert_xdecoder.py:401
def convert_xdecoder_checkpoint(sd: SD, depths=(2, 2, 18, 2), enc_layers: int = 6,
                                dec_layers: int = 9) -> Dict[str, Any]:
    """Full conversion of a reference state dict (keys under ``backbone.`` /
    ``sem_seg_head.``, or under ``model.``). Returns ``{"xdecoder": state
    dict of models.xdecoder.XDecoderSegModel, "lang": state dict of
    models.lang.LanguageEncoder, "logit_scale": exp of the checkpoint's}``.
    A key of a 2D-family module (``_TWO_D_FAMILY``) raises
    ``NotImplementedError``."""
    for key in sd:
        for pattern, family in _TWO_D_FAMILY:
            if pattern.search(key):
                raise NotImplementedError(
                    f"{key}: {family} belongs to the 2D family, not ported yet "
                    "(ROADMAP Queue 1, the 2D family)")
    bb = "backbone" if "backbone.patch_embed.proj.weight" in sd else "model.backbone"
    head = ("sem_seg_head" if "sem_seg_head.pixel_decoder.input_proj.weight" in sd
            else "model.sem_seg_head")
    xparams = {
        "backbone": convert_focalnet(sd, bb, depths),
        "pixel_decoder": convert_pixel_decoder(sd, f"{head}.pixel_decoder", enc_layers),
        "predictor": convert_predictor(sd, f"{head}.predictor", dec_layers),
    }
    lang_params, logit_scale = convert_lang_encoder(sd, f"{head}.predictor.lang_encoder")
    return {
        "xdecoder": _state_dict(xparams),
        "lang": _state_dict(lang_params),
        "logit_scale": float(np.exp(logit_scale)),
    }


# port parameter name -> reference name, per module; the q / k / v
# projections of an attention layer are packed back into ``in_proj``
_RENAME = {
    "backbone": (
        (r"^layers(\d+)_blocks\.(\d+)\.modulation\.focal_layers(\d+)\.",
         r"layers.\1.blocks.\2.modulation.focal_layers.\3.0."),
        (r"^layers(\d+)_blocks\.(\d+)\.", r"layers.\1.blocks.\2."),
        (r"^layers(\d+)_downsample\.", r"layers.\1.downsample."),
    ),
    "pixel_decoder": (
        (r"^encoder_layer(\d+)\.", r"transformer.encoder.layers.\1."),
        (r"^((adapter|layer)_\d+)\.conv\.", r"\1."),
    ),
    "predictor": (
        (r"^(query_feat|query_embed|level_embed)$", r"\1.weight"),
        (r"^mask_embed\.layers(\d+)\.", r"mask_embed.layers.\1."),
        (r"^cross_attn(\d+)\.", r"transformer_cross_attention_layers.\1."),
        (r"^self_attn(\d+)\.", r"transformer_self_attention_layers.\1."),
        (r"^ffn(\d+)\.", r"transformer_ffn_layers.\1."),
    ),
    "lang": (
        (r"^lang_encoder\.token_embedding\.embedding$", r"lang_encoder.token_embedding.weight"),
        (r"^lang_encoder\.resblocks(\d+)\.mlp_c_(fc|proj)\.", r"lang_encoder.resblocks.\1.mlp.c_\2."),
        (r"^lang_encoder\.resblocks(\d+)\.", r"lang_encoder.resblocks.\1."),
    ),
}
_QKV = re.compile(r"^(.*)\.([qkv])_proj\.(weight|bias)$")


def _numpy_state(module_or_sd) -> Dict[str, np.ndarray]:
    sd = module_or_sd.state_dict() if isinstance(module_or_sd, torch.nn.Module) else module_or_sd
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _emit(out: SD, sd: Dict[str, np.ndarray], rules, prefix: str) -> None:
    packed: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in sd.items():
        name = key
        for pat, rep in rules:
            name, n = re.subn(pat, rep, name)
            if n:
                break
        m = _QKV.match(name)
        if m:
            packed.setdefault(f"{prefix}{m.group(1)}.in_proj_{m.group(3)}", {})[m.group(2)] = val
        else:
            out[f"{prefix}{name}"] = val
    for name, parts in packed.items():
        out[name] = np.concatenate([parts["q"], parts["k"], parts["v"]])


# geopurify_tpu/utils/convert_xdecoder.py:433
def synthesize_torch_state_dict(xdecoder, lang) -> SD:
    """The reference-layout state dict (``backbone.`` / ``sem_seg_head.``
    keys, torch layouts) of the port's ``XDecoderSegModel`` and
    ``LanguageEncoder`` (modules or their state dicts), such that
    ``convert_xdecoder_checkpoint`` gives their state dicts back unchanged.
    The JAX version fills the same keys with random values from Flax shape
    trees."""
    xsd = _numpy_state(xdecoder)
    out: SD = {}
    for module, prefix in (("backbone", "backbone."),
                           ("pixel_decoder", "sem_seg_head.pixel_decoder."),
                           ("predictor", "sem_seg_head.predictor.")):
        part = {k[len(module) + 1:]: v for k, v in xsd.items() if k.startswith(module + ".")}
        _emit(out, part, _RENAME[module], prefix)
    _emit(out, _numpy_state(lang), _RENAME["lang"], "sem_seg_head.predictor.lang_encoder.")
    return out
