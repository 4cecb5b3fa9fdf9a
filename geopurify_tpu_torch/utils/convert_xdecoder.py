"""Released X-Decoder checkpoint (torch) -> the port's state dicts.

Port of geopurify_tpu/utils/convert_xdecoder.py. The reference keys map
first onto the Flax-layout tree of the JAX package (numpy arrays; a
FocalNet stage's blocks are numbered children here, where the JAX
converter stacks them for its scanned stage), then through
``utils.from_jax._state_dict`` onto the port's parameter names and
layouts.

``convert_xdecoder_checkpoint`` converts, as the JAX one does, a FocalNet
(``focal`` or ``focal_dw``) + transformer-encoder FPN checkpoint with its
predictor (caption slots kept when present) and language tower. DaViT, ViT,
deformable-decoder and SEEM checkpoints go through the standalone
converters (``convert_davit``, ``convert_vit``,
``convert_deform_pixel_decoder``, ``convert_seem``), and
``convert_xdecoder_checkpoint`` names them in its error.

``synthesize_torch_state_dict`` is the inverse: the port's X-Decoder (any
backbone and pixel decoder, caption slots included, or a SEEM head as the
predictor) and language tower written out under the reference's keys and
layouts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from geopurify_tpu_torch.utils.from_jax import _state_dict

Array = np.ndarray
SD = Dict[str, Array]

# checkpoints that convert_xdecoder_checkpoint leaves to a standalone converter
_STANDALONE = (
    (re.compile(r"predictor\.(mask_sptial_embed|spatial_embed|spatial_featured|pn_indicator)"),
     "a SEEM decoder", "convert_seem"),
    (re.compile(r"(^|\.)backbone\.convs\.\d+\."), "a DaViT backbone", "convert_davit"),
    (re.compile(r"(^|\.)backbone\.(pos_embed|blocks\.\d+\.attn\.qkv)"), "a ViT backbone",
     "convert_vit"),
    (re.compile(r"pixel_decoder\.(transformer\.level_embed|input_proj\.\d+\.0\.)"),
     "the deformable pixel decoder", "convert_deform_pixel_decoder"),
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
            # the focal_dw variant's depthwise residual convs
            if f"{bp}.dw1.weight" in sd:
                blk["dw1"] = _conv(sd, f"{bp}.dw1")
                blk["dw2"] = _conv(sd, f"{bp}.dw2")
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


# geopurify_tpu/utils/convert_xdecoder.py:163
def convert_davit(sd: SD, prefix: str, depths) -> Dict[str, Any]:
    """torch DaViT (vision/backbone/davit.py) -> the ``models.davit.DaViT``
    tree: ``convs.{s}`` -> ``patch_embed{s}`` / ``embed_norm{s}``;
    ``blocks.{s}.{j}.{spatial,channel}_block`` -> ``stage{s}_block{j}``'s
    ``s_`` / ``c_`` halves."""
    p: Dict[str, Any] = {}
    for s, depth in enumerate(depths):
        p[f"patch_embed{s}"] = _conv(sd, f"{prefix}.convs.{s}.proj")
        p[f"embed_norm{s}"] = _ln(sd, f"{prefix}.convs.{s}.norm")
        for j in range(depth):
            blk: Dict[str, Any] = {}
            for tag, ref, attn in (("s", "spatial_block", "window_attn"),
                                   ("c", "channel_block", "channel_attn")):
                bp = f"{prefix}.blocks.{s}.{j}.{ref}"
                blk[f"{tag}_cpe1"] = {"dw": _conv(sd, f"{bp}.conv1.fn.dw")}
                blk[f"{tag}_norm1"] = _ln(sd, f"{bp}.{attn}.norm")
                blk[f"{tag}_attn"] = {"qkv": _lin(sd, f"{bp}.{attn}.fn.qkv"),
                                      "proj": _lin(sd, f"{bp}.{attn}.fn.proj")}
                blk[f"{tag}_cpe2"] = {"dw": _conv(sd, f"{bp}.conv2.fn.dw")}
                blk[f"{tag}_norm2"] = _ln(sd, f"{bp}.ffn.norm")
                blk[f"{tag}_mlp_fc1"] = _lin(sd, f"{bp}.ffn.fn.net.fc1")
                blk[f"{tag}_mlp_fc2"] = _lin(sd, f"{bp}.ffn.fn.net.fc2")
            p[f"stage{s}_block{j}"] = blk
    return p


# geopurify_tpu/utils/convert_xdecoder.py:194
def _convt(sd: SD, prefix: str) -> Dict[str, Array]:
    """torch ConvTranspose2d [in, out, kh, kw] -> the Flax ConvTranspose
    kernel [kh, kw, in, out], spatially flipped (torch's is the gradient of
    a conv, Flax's a correlation over the dilated input)."""
    w = _get(sd, f"{prefix}.weight").transpose(2, 3, 0, 1)[::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(w)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _get(sd, f"{prefix}.bias")
    return out


# geopurify_tpu/utils/convert_xdecoder.py:209
def _gn(sd: SD, prefix: str) -> Dict[str, Array]:
    return _ln(sd, prefix)


# the SimpleFPN's Sequential indices (vision/backbone/vit.py:406-445)
_VIT_NECK = (
    ("d4_up1", "down_4.0", _convt), ("d4_gn1", "down_4.1", _gn),
    ("d4_up2", "down_4.3", _convt), ("d4_gn2", "down_4.4", _gn),
    ("d4_out", "down_4.5", _conv), ("d4_gn3", "down_4.6", _gn),
    ("d8_up", "down_8.0", _convt), ("d8_gn1", "down_8.1", _gn),
    ("d8_out", "down_8.2", _conv), ("d8_gn2", "down_8.3", _gn),
    ("d16_out", "down_16.0", _conv), ("d16_gn", "down_16.1", _gn),
    ("d32_down", "down_32.0", _conv), ("d32_gn1", "down_32.1", _gn),
    ("d32_out", "down_32.2", _conv), ("d32_gn2", "down_32.3", _gn),
)


# geopurify_tpu/utils/convert_xdecoder.py:212
def convert_vit(sd: SD, prefix: str, depth: int) -> Dict[str, Any]:
    """torch D2ViT + SimpleFPN (vision/backbone/vit.py) -> the
    ``models.vit_backbone.ViTBackbone`` tree."""
    p: Dict[str, Any] = {
        "patch_embed": _conv(sd, f"{prefix}.patch_embed.proj"),
        "pos_embed": _get(sd, f"{prefix}.pos_embed")[0],       # [1, g, g, C] -> [g, g, C]
    }
    for i in range(depth):
        bp = f"{prefix}.blocks.{i}"
        attn: Dict[str, Any] = {"qkv": _lin(sd, f"{bp}.attn.qkv"),
                                "proj": _lin(sd, f"{bp}.attn.proj")}
        if f"{bp}.attn.rel_pos_h" in sd:
            attn["rel_pos_h"] = _get(sd, f"{bp}.attn.rel_pos_h")
            attn["rel_pos_w"] = _get(sd, f"{bp}.attn.rel_pos_w")
        p[f"block{i}"] = {"norm1": _ln(sd, f"{bp}.norm1"), "norm2": _ln(sd, f"{bp}.norm2"),
                          "attn": attn, "mlp_fc1": _lin(sd, f"{bp}.mlp.lin1"),
                          "mlp_fc2": _lin(sd, f"{bp}.mlp.lin2")}
    p["neck"] = {ours: fn(sd, f"{prefix}.neck.{ref}") for ours, ref, fn in _VIT_NECK}
    return p


# geopurify_tpu/utils/convert_xdecoder.py:250
def convert_deform_pixel_decoder(sd: SD, prefix: str, enc_layers: int) -> Dict[str, Any]:
    """torch MSDeformAttnPixelDecoder (transformer_encoder_deform.py) -> the
    ``models.pixel_decoder_deform.MSDeformAttnPixelDecoder`` tree:
    ``input_proj.{i}`` is a Conv2d (bias) + GN Sequential, ``adapter_1`` /
    ``layer_1`` detectron2 norm-convs, the transformer the level embedding
    and each layer's MSDeformAttn linears."""
    p: Dict[str, Any] = {
        "level_embed": _get(sd, f"{prefix}.transformer.level_embed"),
        "mask_features": _conv(sd, f"{prefix}.mask_features"),
        "adapter_1": _conv_gn(sd, f"{prefix}.adapter_1"),
        "layer_1": _conv_gn(sd, f"{prefix}.layer_1"),
    }
    i = 0
    while f"{prefix}.input_proj.{i}.0.weight" in sd:
        p[f"input_proj{i}"] = {"conv": _conv(sd, f"{prefix}.input_proj.{i}.0"),
                               "norm": _gn(sd, f"{prefix}.input_proj.{i}.1")}
        i += 1
    for j in range(enc_layers):
        lp = f"{prefix}.transformer.encoder.layers.{j}"
        p[f"encoder_layer{j}"] = {
            **{n: _lin(sd, f"{lp}.self_attn.{n}") for n in
               ("value_proj", "sampling_offsets", "attention_weights", "output_proj")},
            "norm1": _ln(sd, f"{lp}.norm1"),
            "linear1": _lin(sd, f"{lp}.linear1"),
            "linear2": _lin(sd, f"{lp}.linear2"),
            "norm2": _ln(sd, f"{lp}.norm2"),
        }
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
    # the caption slots of a captioning-trained checkpoint
    if f"{prefix}.caping_embed" in sd:
        p["caping_embed"] = _get(sd, f"{prefix}.caping_embed")
    if f"{prefix}.pos_embed_caping.weight" in sd:
        p["pos_embed_caping"] = _get(sd, f"{prefix}.pos_embed_caping.weight")
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


# geopurify_tpu/utils/convert_xdecoder.py:353
def convert_seem(sd: SD, prefix: str, dec_layers: int) -> Dict[str, Any]:
    """torch SEEM decoder (interface/seem_v0.py:27-160) -> the
    ``models.seem`` heads' tree: the X-Decoder predictor's layout plus the
    per-level spatial projections (``mask_sptial_embed``, the reference's
    own spelling), the spatial memory embeddings and the +-1 point
    indicator, each where the checkpoint has it
    (``utils.from_jax.seem_from_jax`` names a group a head lacks)."""
    p = convert_predictor(sd, prefix, dec_layers)
    for i in range(3):
        if f"{prefix}.mask_sptial_embed.{i}" in sd:
            p[f"mask_spatial_embed{i}"] = _get(sd, f"{prefix}.mask_sptial_embed.{i}")
    for ours in ("spatial_embed", "spatial_featured", "pn_indicator"):
        if f"{prefix}.{ours}.weight" in sd:
            p[ours] = _get(sd, f"{prefix}.{ours}.weight")
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
    A DaViT, ViT, deformable decoder or SEEM key raises ``ValueError``
    naming its standalone converter."""
    for key in sd:
        for pattern, family, converter in _STANDALONE:
            if pattern.search(key):
                raise ValueError(
                    f"{key}: {family}; convert_xdecoder_checkpoint converts FocalNet + "
                    f"FPN checkpoints only, as the JAX one does: use {converter}")
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


# DaViT: stage{s}_block{j}.{s,c}_* -> blocks.{s}.{j}.{spatial,channel}_block.*
_DAVIT_BLOCKS = tuple(
    (rf"^stage(\d+)_block(\d+)\.{t}_{ours}", rf"blocks.\1.\2.{block}.{ref}")
    for t, block, attn in (("s", "spatial_block", "window_attn"),
                           ("c", "channel_block", "channel_attn"))
    for ours, ref in ((r"cpe(\d)\.dw\.", r"conv\3.fn.dw."), (r"norm1\.", f"{attn}.norm."),
                      (r"attn\.", f"{attn}.fn."), (r"norm2\.", "ffn.norm."),
                      (r"mlp_fc(\d)\.", r"ffn.fn.net.fc\3.")))

# port parameter name -> reference name, per module (FocalNet, DaViT and ViT
# backbones; FPN and deformable pixel decoders); the q / k / v projections
# of an attention layer are packed back into ``in_proj``
_RENAME = {
    "backbone": (
        (r"^layers(\d+)_blocks\.(\d+)\.modulation\.focal_layers(\d+)\.",
         r"layers.\1.blocks.\2.modulation.focal_layers.\3.0."),
        (r"^layers(\d+)_blocks\.(\d+)\.", r"layers.\1.blocks.\2."),
        (r"^layers(\d+)_downsample\.", r"layers.\1.downsample."),
        (r"^patch_embed(\d+)\.", r"convs.\1.proj."),
        (r"^embed_norm(\d+)\.", r"convs.\1.norm."),
        *_DAVIT_BLOCKS,
        (r"^patch_embed\.(weight|bias)$", r"patch_embed.proj.\1"),
        (r"^block(\d+)\.mlp_fc(\d)\.", r"blocks.\1.mlp.lin\2."),
        (r"^block(\d+)\.", r"blocks.\1."),
        *((rf"^neck\.{ours}\.", f"neck.{ref}.") for ours, ref, _ in _VIT_NECK),
    ),
    "pixel_decoder": (
        (r"^level_embed$", r"transformer.level_embed"),
        (r"^input_proj(\d+)\.conv\.", r"input_proj.\1.0."),
        (r"^input_proj(\d+)\.norm\.", r"input_proj.\1.1."),
        (r"^encoder_layer(\d+)\.(value_proj|sampling_offsets|attention_weights|output_proj)\.",
         r"transformer.encoder.layers.\1.self_attn.\2."),
        (r"^encoder_layer(\d+)\.", r"transformer.encoder.layers.\1."),
        (r"^((adapter|layer)_\d+)\.conv\.", r"\1."),
    ),
    "predictor": (
        (r"^(query_feat|query_embed|level_embed|pos_embed_caping)$", r"\1.weight"),
        (r"^(spatial_embed|spatial_featured|pn_indicator)$", r"\1.weight"),
        (r"^mask_spatial_embed(\d+)$", r"mask_sptial_embed.\1"),
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
    keys, torch layouts) of the port's ``XDecoderSegModel`` (any backbone
    and pixel decoder, caption slots included) and ``LanguageEncoder``
    (modules or their state dicts), such that ``convert_xdecoder_checkpoint``
    (FocalNet + FPN) or the standalone converters give their state dicts
    back unchanged. A SEEM head goes in as the predictor: ``xdecoder`` a
    state dict with its keys under ``predictor.``. The JAX version fills
    the FocalNet + FPN keys with random values from Flax shape trees."""
    xsd = _numpy_state(xdecoder)
    out: SD = {}
    for module, prefix in (("backbone", "backbone."),
                           ("pixel_decoder", "sem_seg_head.pixel_decoder."),
                           ("predictor", "sem_seg_head.predictor.")):
        part = {k[len(module) + 1:]: v for k, v in xsd.items() if k.startswith(module + ".")}
        _emit(out, part, _RENAME[module], prefix)
    if "backbone.pos_embed" in out:                 # ViT: [g, g, C] -> [1, g, g, C]
        out["backbone.pos_embed"] = out["backbone.pos_embed"][None]
    _emit(out, _numpy_state(lang), _RENAME["lang"], "sem_seg_head.predictor.lang_encoder.")
    return out
