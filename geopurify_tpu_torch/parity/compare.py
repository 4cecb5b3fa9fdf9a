"""The port's side of the reference-oracle harness: convert + run + diff.

Port of geopurify_tpu/parity/compare.py, written against the port's
modules and converters. Each ``parity_<stage>`` takes the oracle's record
(parity/oracle.py: the reference torch module with seeded random weights,
its inputs, activations and state dict), converts the state dict through
``utils/convert_xdecoder.py`` (or ``utils/checkpoint.
convert_student_checkpoint``) straight into the port's module, runs that
module on ``device`` on the same inputs, and returns ``{row: (max|d|,
rel)}`` with rel = max|a-b| / max|b|: the target is rel < 1e-4 in f32.

``ref`` hands in the oracle's record instead of building it (the oracle
runs only when ``ref`` is None), so that a stage can be checked against a
record made elsewhere. ``ALL_STAGES`` keeps the JAX harness's keys and
``run_all`` their order; every stage but ``sonata`` (the naive numpy
Sonata of parity/sonata_oracle.py, which needs no reference) needs the
reference tree at ``shims.reference_root()``, and ``run_all`` raises
``FileNotFoundError`` naming it before any stage runs when it is absent.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np
import torch

from geopurify_tpu_torch import resolve_device

Rows = Dict[str, Tuple[float, float]]


# geopurify_tpu/parity/compare.py:16
def _diff(ours: np.ndarray, theirs: np.ndarray) -> Tuple[float, float]:
    a = np.asarray(ours, np.float32)
    b = np.asarray(theirs, np.float32)
    assert a.shape == b.shape, f"shape {a.shape} vs {b.shape}"
    d = float(np.max(np.abs(a - b))) if a.size else 0.0
    return d, d / (float(np.max(np.abs(b))) + 1e-12)


def _oracle(name: str, **kw) -> Dict:
    """Run the oracle builder ``name`` on the CPU, ``torch.cuda`` patched as
    the reference needs only for its duration (shims.cpu_cuda)."""
    from geopurify_tpu_torch.parity import oracle, shims

    with shims.cpu_cuda():
        return getattr(oracle, name)(**kw)


def _t(a, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _load(module: torch.nn.Module, tree, dev) -> torch.nn.Module:
    """``module`` with the converted Flax-layout ``tree`` loaded (strict),
    on ``dev``, in eval mode."""
    from geopurify_tpu_torch.utils.from_jax import _state_dict

    module.load_state_dict(_state_dict(tree))
    return module.to(dev).eval()


def _maps(module, inputs: Dict[str, np.ndarray], prefix: str, acts, dev) -> Rows:
    with torch.no_grad():
        outs = module(_t(inputs, dev))
    return {f"{prefix}/{k}": _diff(_np(outs[k]), v) for k, v in acts.items()}


# geopurify_tpu/parity/compare.py:24
def parity_focalnet(size: str = "small", device="cuda", ref=None) -> Rows:
    from geopurify_tpu_torch.models.focalnet import FocalNet
    from geopurify_tpu_torch.parity.oracle import FOCAL_FULL, FOCAL_SMALL
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_focalnet

    dev = resolve_device(device)
    kw = FOCAL_FULL if size == "full" else FOCAL_SMALL
    if ref is None:
        ref = _oracle("focalnet_oracle",
                      image_hw=(484, 648) if size == "full" else (64, 96), **kw)
    model = FocalNet(embed_dim=kw["embed_dim"], depths=ref["depths"],
                     focal_levels=(4, 4, 4, 4), focal_windows=(3, 3, 3, 3))
    _load(model, convert_focalnet(ref["sd"], "backbone", ref["depths"]), dev)
    return _maps(model, ref["input_nhwc"], "focalnet", ref["acts"], dev)


# geopurify_tpu/parity/compare.py:47
def parity_focalnet_dw(size: str = "small", use_postln: bool = True, device="cuda",
                       ref=None) -> Rows:
    """focal_dw variant (the SEEM-release FocalNet) — dw residual convs,
    post-residual norm placement, pre-norm downsample embeds. (The JAX
    harness's ``run_all`` hands its size to ``use_postln``, which runs the
    post-LN case; here ``size`` has a slot of its own.)"""
    from geopurify_tpu_torch.models.focalnet import FocalNet
    from geopurify_tpu_torch.parity.oracle import FOCAL_SMALL
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_focalnet

    dev = resolve_device(device)
    kw = FOCAL_SMALL
    pre_norms = (False, True, True, False)
    if ref is None:
        ref = _oracle("focalnet_dw_oracle", embed_dim=kw["embed_dim"], depths=kw["depths"],
                      use_conv_embed=False, use_postln=use_postln, use_pre_norms=pre_norms)
    model = FocalNet(embed_dim=kw["embed_dim"], depths=ref["depths"],
                     focal_levels=(3, 3, 3, 3), focal_windows=(9, 9, 9, 9),
                     use_conv_embed=False, use_postln=use_postln, use_dw=True,
                     use_pre_norms=pre_norms)
    _load(model, convert_focalnet(ref["sd"], "backbone", ref["depths"]), dev)
    tag = "postln" if use_postln else "preln"
    return _maps(model, ref["input_nhwc"], f"focalnet_dw_{tag}", ref["acts"], dev)


# geopurify_tpu/parity/compare.py:78
def parity_davit(size: str = "small", device="cuda", ref=None) -> Rows:
    from geopurify_tpu_torch.models.davit import DaViT
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_davit

    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("davit_oracle")
    model = DaViT(embed_dims=(8, 16, 24, 32), depths=ref["depths"], num_heads=(2, 2, 2, 2),
                  num_groups=(2, 2, 2, 2), window_size=4)
    _load(model, convert_davit(ref["sd"], "backbone", ref["depths"]), dev)
    return _maps(model, ref["input_nhwc"], "davit", ref["acts"], dev)


# geopurify_tpu/parity/compare.py:99
def parity_vit(size: str = "small", device="cuda", ref=None) -> Rows:
    from geopurify_tpu_torch.models.vit_backbone import ViTBackbone
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_vit

    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("vit_oracle")
    model = ViTBackbone(embed_dim=16, depth=ref["depth"], num_heads=2, patch_size=16,
                        window_size=2, global_attn_indexes=(1, 3), out_dims=(8, 12, 16, 24),
                        pretrain_grid=4)
    _load(model, convert_vit(ref["sd"], "backbone", ref["depth"]), dev)
    return _maps(model, ref["input_nhwc"], "vit", ref["acts"], dev)


def _in_channels(inputs_nhwc: Dict[str, np.ndarray]):
    return tuple(inputs_nhwc[f"res{i}"].shape[-1] for i in (2, 3, 4, 5))


# geopurify_tpu/parity/compare.py:120
def parity_pixel_decoder(size: str = "small", device="cuda", ref=None) -> Rows:
    from geopurify_tpu_torch.models.pixel_decoder import TransformerEncoderPixelDecoder
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_pixel_decoder

    dev = resolve_device(device)
    if size == "full":
        kw = dict(base_hw=(121, 162), channels=(192, 384, 768, 1536),
                  conv_dim=512, mask_dim=512, enc_layers=6, nheads=8,
                  dim_feedforward=2048)
    else:
        kw = dict()
    if ref is None:
        ref = _oracle("pixel_decoder_oracle", **kw)
    model = TransformerEncoderPixelDecoder(
        _in_channels(ref["inputs_nhwc"]), conv_dim=kw.get("conv_dim", 32),
        mask_dim=kw.get("mask_dim", 32), num_enc_layers=ref["enc_layers"],
        num_heads=kw.get("nheads", 8), dim_feedforward=kw.get("dim_feedforward", 64))
    _load(model, convert_pixel_decoder(ref["sd"], "sem_seg_head.pixel_decoder",
                                       ref["enc_layers"]), dev)
    with torch.no_grad():
        mask_features, transformer_features, multi_scale = model(
            {k: _t(v, dev) for k, v in ref["inputs_nhwc"].items()})
    rows = {
        "pixel_decoder/mask_features": _diff(_np(mask_features), ref["mask_features"]),
        "pixel_decoder/transformer_features": _diff(_np(transformer_features),
                                                    ref["transformer_features"]),
    }
    for i, (a, b) in enumerate(zip(multi_scale, ref["multi_scale"])):
        rows[f"pixel_decoder/multi_scale{i}"] = _diff(_np(a), b)
    return rows


# geopurify_tpu/parity/compare.py:160
def parity_deform_pixel_decoder(size: str = "small", device="cuda", ref=None) -> Rows:
    from geopurify_tpu_torch.models.pixel_decoder_deform import MSDeformAttnPixelDecoder
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_deform_pixel_decoder

    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("deform_pixel_decoder_oracle")
    model = MSDeformAttnPixelDecoder(
        _in_channels(ref["inputs_nhwc"]), conv_dim=32, mask_dim=32,
        num_enc_layers=ref["enc_layers"], num_heads=2, dim_feedforward=64)
    _load(model, convert_deform_pixel_decoder(ref["sd"], "pixdec", ref["enc_layers"]), dev)
    with torch.no_grad():
        mf, tf, ms = model({k: _t(v, dev) for k, v in ref["inputs_nhwc"].items()})
    ours = {"mask_features": mf, "transformer_features": tf,
            **{f"multi_scale{i}": v for i, v in enumerate(ms)}}
    return {f"deform_pixdec/{k}": _diff(_np(ours[k]), v) for k, v in ref["acts"].items()}


def _head(ref, kw, dev, caption_len: int = 0):
    """The port's XDecoderHead with the oracle's converted predictor."""
    from geopurify_tpu_torch.models.xdecoder import XDecoderHead
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_predictor

    model = XDecoderHead(
        hidden_dim=kw.get("hidden_dim", 32), dim_proj=kw.get("dim_proj", 32),
        num_queries=kw.get("num_queries", 13), nheads=kw.get("nheads", 4),
        dim_feedforward=kw.get("dim_feedforward", 64), dec_layers=ref["dec_layers"],
        mask_dim=kw.get("mask_dim", 32), caption_len=caption_len)
    return _load(model, convert_predictor(ref["sd"], "sem_seg_head.predictor",
                                          ref["dec_layers"]), dev)


def _head_inputs(ref, dev):
    return ([_t(v, dev) for v in ref["multi_scale_nhwc"]], _t(ref["mask_features_nhwc"], dev),
            _t(ref["text"], dev), float(ref["logit_scale"]))


# geopurify_tpu/parity/compare.py:183
def parity_head(size: str = "small", device="cuda", ref=None) -> Rows:
    dev = resolve_device(device)
    if size == "full":
        kw = dict(base_hw=(121, 162), conv_dim=512, mask_dim=512,
                  hidden_dim=512, dim_proj=512, num_queries=201, nheads=8,
                  dim_feedforward=2048, dec_layers=9, n_text=8)
    else:
        kw = dict()
    if ref is None:
        ref = _oracle("xdecoder_head_oracle", **kw)
    model = _head(ref, kw, dev)
    with torch.no_grad():
        out = model(*_head_inputs(ref, dev))
    return {f"head/{k}": _diff(_np(out[k]), ref[k])
            for k in ("pred_logits", "cls_logits", "pred_masks", "mask_embed")}


# geopurify_tpu/parity/compare.py:222
def parity_head_vlp(size: str = "small", device="cuda", ref=None) -> Rows:
    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("xdecoder_vlp_oracle")
    slots = ref["sd"]["sem_seg_head.predictor.pos_embed_caping.weight"].shape[0]
    model = _head(ref, dict(), dev, caption_len=slots)
    with torch.no_grad():
        out = model(*_head_inputs(ref, dev), caption_tokens=_t(ref["caption_tokens"], dev))
    return {f"head_vlp/{k}": _diff(_np(out[k]), ref[k])
            for k in ("pred_captionings", "pred_captions")}


# geopurify_tpu/parity/compare.py:255
def parity_head_fullsize(device="cuda", ref=None) -> Rows:
    """FULL-SIZE head parity despite the 0.5-threshold amplifier: the real
    eval geometry (stride-4 = 121x162 of 484x648, 201 queries, hidden 512,
    9 rounds) compared PRE-threshold and with the port's head FORCED onto
    the reference's binarized attention masks.

    Rows:
      head_full/round{r}_masks   — per-round pre-threshold stride-4 mask
                                   logits (free-running; drift grows with r
                                   as mask-set differences compound)
      head_full/flip_frac        — (total flipped attn-mask bits, fraction)
      head_full/flip_margin      — (max, p99) of |sigmoid-0.5| of the
                                   reference's resized mask logits at flipped
                                   bits: divergence is threshold-marginal
      head_full/forced_*         — final outputs with the port's head forced
                                   onto the REFERENCE's binarized masks: the
                                   amplifier removed, full-size parity holds
    """
    from geopurify_tpu_torch.models.layers import resize_bicubic_antialias

    dev = resolve_device(device)
    kw = dict(base_hw=(121, 162), conv_dim=512, mask_dim=512,
              hidden_dim=512, dim_proj=512, num_queries=201, nheads=8,
              dim_feedforward=2048, dec_layers=9)
    if ref is None:
        ref = _oracle("xdecoder_head_oracle", capture_aux=True, **kw)
    model = _head(ref, kw, dev)
    inputs = _head_inputs(ref, dev)
    with torch.no_grad():
        out = model(*inputs, return_aux=True)

    rows: Rows = {}
    L = ref["dec_layers"]
    for r in (0, 1, L // 2, L):
        rows[f"head_full/round{r}_masks"] = _diff(_np(out["aux_masks"][r]), ref["aux_masks"][r])

    # binarized attn-mask agreement + threshold-margin of flips
    h = ref["nheads"]
    tot_bits = tot_flips = 0
    flip_margins = []
    num_levels = 3
    for r in range(L):
        ref_mask = ref["attn_masks"][r]                 # [B*h, Q, HW] bool
        B = ref_mask.shape[0] // h
        ref_mask = ref_mask.reshape(B, h, *ref_mask.shape[1:])[:, 0]
        ours_mask = out["aux_attn"][r][:, 0].cpu().numpy()
        flips = ours_mask != ref_mask
        tot_bits += flips.size
        tot_flips += int(flips.sum())
        if flips.any():
            # the reference's pre-threshold RESIZED logits at this round's level
            lvl = r % num_levels
            hsz, wsz = ref["multi_scale_nhwc"][lvl].shape[1:3]
            rl = _np(resize_bicubic_antialias(
                torch.from_numpy(np.ascontiguousarray(ref["aux_masks"][r].transpose(0, 2, 3, 1))),
                (hsz, wsz)).permute(0, 3, 1, 2)).reshape(B, -1, hsz * wsz)
            flip_margins.append(np.abs(1.0 / (1.0 + np.exp(-rl[flips])) - 0.5))
    if flip_margins:
        fm = np.concatenate(flip_margins)
        rows["head_full/flip_margin"] = (float(fm.max()), float(np.quantile(fm, 0.99)))
    else:
        rows["head_full/flip_margin"] = (0.0, 0.0)
    rows["head_full/flip_frac"] = (float(tot_flips), tot_flips / tot_bits)

    # forced-mask run: the port's head on the REFERENCE's binarized masks
    override = []
    for r in range(L):
        m_ = ref["attn_masks"][r]
        B = m_.shape[0] // h
        override.append(_t(m_.reshape(B, h, *m_.shape[1:])[:, 0], dev))
    with torch.no_grad():
        forced = model(*inputs, attn_mask_override=override)
    for k in ("pred_logits", "pred_masks", "mask_embed", "cls_logits"):
        rows[f"head_full/forced_{k}"] = _diff(_np(forced[k]), ref[k])
    return rows


def _prompt_arrays(masks_and_tags, S: int, n_per_mask=None):
    """Spatial prompt tokens [1, S] from boolean prompt masks: the
    (y / H, x / W) of every set pixel in nonzero order, its +1 / -1 tag,
    and (given a mask index per mask) its mask id."""
    pts = np.zeros((1, S, 2), np.float32)
    valid = np.zeros((1, S), bool)
    tags = np.ones((1, S), np.int32)
    mids = np.zeros((1, S), np.int32)
    n = 0
    for mask, tag, mid in masks_and_tags:
        H, W = mask.shape
        ys, xs = np.nonzero(mask)
        k = len(ys)
        pts[0, n: n + k, 0] = ys / H            # nonzero/divisor convention
        pts[0, n: n + k, 1] = xs / W
        tags[0, n: n + k] = tag
        mids[0, n: n + k] = mid
        valid[0, n: n + k] = True
        n += k
    return pts, valid, tags, mids, n


def _seem_rows(prefix: str, out, acts, reshape_keys) -> Rows:
    rows = {}
    for k, v in acts.items():
        if k not in out:                      # oracle-only debug anchors (aux0_smasks)
            continue
        ours = _np(out[k])
        if k in reshape_keys:
            v = v.reshape(ours.shape)
        rows[f"{prefix}/{k}"] = _diff(ours, v)
    return rows


# geopurify_tpu/parity/compare.py:365
def parity_seem(size: str = "small", device="cuda", ref=None) -> Rows:
    from geopurify_tpu_torch.models.seem import SEEMHead
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_seem

    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("seem_oracle")
    S = 32
    G = ref["grounding_tokens"].shape[1]
    model = SEEMHead(hidden_dim=32, dim_proj=32, num_queries=7, nheads=4,
                     dim_feedforward=64, dec_layers=ref["dec_layers"], mask_dim=32,
                     max_spatial_tokens=S, num_spatial_memories=ref["num_memories"],
                     max_grounding_tokens=G)
    _load(model, convert_seem(ref["sd"], "seem", ref["dec_layers"]), dev)
    pts, valid, tags, _, _ = _prompt_arrays(
        ((ref["pos_mask"], 1, 0), (ref["neg_mask"], -1, 0)), S)
    kwargs = dict(spatial_points=_t(pts, dev), spatial_valid=_t(valid, dev),
                  spatial_posneg=_t(tags, dev),
                  grounding_tokens=_t(ref["grounding_tokens"], dev),
                  grounding_valid=torch.ones((1, G), dtype=torch.bool, device=dev))
    if ref["prev_mask"] is not None:
        kwargs["prev_mask"] = _t(ref["prev_mask"], dev)
    with torch.no_grad():
        out = model(*_head_inputs(ref, dev), **kwargs)
    return _seem_rows("seem", out, ref["acts"], ("pred_pspatials", "pred_nspatials"))


# geopurify_tpu/parity/compare.py:420
def parity_seem_demo(size: str = "small", device="cuda", ref=None) -> Rows:
    """SEEM demo variant: refimg visual-prompt pass + the composed demo
    forward (stroke + grounding + audio + visual) vs the reference
    seem_demo.py under the demo ATTENTION_ARCH."""
    from geopurify_tpu_torch.models.seem import SEEMHeadDemo
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_seem

    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("seem_demo_oracle")
    S = 32
    G, A = ref["grounding_tokens"].shape[1], ref["audio_tokens"].shape[1]
    model = SEEMHeadDemo(hidden_dim=32, dim_proj=32, num_queries=7, nheads=4,
                         dim_feedforward=64, dec_layers=ref["dec_layers"], mask_dim=32,
                         max_spatial_tokens=S, max_grounding_tokens=G, max_audio_tokens=A)
    _load(model, convert_seem(ref["sd"], "seem", ref["dec_layers"]), dev)
    text, ls = _t(ref["text"], dev), float(ref["logit_scale"])

    def prompts(pos, neg):
        pts, valid, tags, _, n = _prompt_arrays(((pos, 1, 0), (neg, -1, 0)), S)
        return _t(pts, dev), _t(valid, dev), _t(tags, dev), n

    rows: Rows = {}
    # --- refimg pass: the port's visual bundle vs the reference's ---
    r_pts, r_valid, r_tags, r_n = prompts(ref["refimg_pos"], ref["refimg_neg"])
    with torch.no_grad():
        bundle = model([_t(v, dev) for v in ref["multi_scale_ref_nhwc"]],
                       _t(ref["mask_features_ref_nhwc"], dev), text, ls,
                       spatial_points=r_pts, spatial_valid=r_valid, spatial_posneg=r_tags,
                       task="refimg")
    rb = ref["visual_bundle"]
    ours_p, ours_n = _np(bundle["visual_query_pos"]), _np(bundle["visual_query_neg"])
    rows["seem_demo/refimg_pos"] = _diff(ours_p, rb["visual_query_pos"].reshape(ours_p.shape))
    rows["seem_demo/refimg_neg"] = _diff(ours_n, rb["visual_query_neg"].reshape(ours_n.shape))
    for i, t in enumerate(rb["src_visual_queries"]):
        ours_t = _np(bundle["src_visual_queries"][i])[:, : t.shape[1]]
        rows[f"seem_demo/refimg_tokens{i}"] = _diff(ours_t, t)

    # --- demo pass: composed prompts ---
    pts, valid, tags, _ = prompts(ref["pos_mask"], ref["neg_mask"])
    vis_valid = np.zeros((1, S), bool)
    vis_valid[0, :r_n] = True
    with torch.no_grad():
        out = model([_t(v, dev) for v in ref["multi_scale_nhwc"]],
                    _t(ref["mask_features_nhwc"], dev), text, ls,
                    spatial_points=pts, spatial_valid=valid, spatial_posneg=tags,
                    grounding_tokens=_t(ref["grounding_tokens"], dev),
                    grounding_valid=torch.ones((1, G), dtype=torch.bool, device=dev),
                    audio_tokens=_t(ref["audio_tokens"], dev),
                    audio_valid=torch.ones((1, A), dtype=torch.bool, device=dev),
                    visual_tokens_by_level=list(bundle["src_visual_queries"]),
                    visual_valid=_t(vis_valid, dev),
                    visual_query_pos=bundle["visual_query_pos"],
                    visual_query_neg=bundle["visual_query_neg"], task="demo")
    rows.update(_seem_rows("seem_demo", out, ref["acts"],
                           ("pred_pspatials", "pred_nspatials", "pred_pvisuals",
                            "pred_nvisuals")))
    return rows


# geopurify_tpu/parity/compare.py:508
def parity_seem_v1(size: str = "small", device="cuda", ref=None) -> Rows:
    """Both branches of SEEM v1: with the prev-mask memory and without it
    (other group offsets; a regression there would otherwise hide behind
    the memory run). ``ref``: the two oracle records, ``{"memory": ...,
    "nomem": ...}``."""
    ref = ref or {}
    rows = _parity_seem_v1_case(True, "", device, ref.get("memory"))
    rows.update(_parity_seem_v1_case(False, "nomem/", device, ref.get("nomem")))
    return rows


def _parity_seem_v1_case(use_memory: bool, tag: str, device, ref) -> Rows:
    from geopurify_tpu_torch.models.seem import SEEMHeadV1
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_seem

    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("seem_v1_oracle", use_memory=use_memory)
    S = 32
    NM = ref["n_masks"]
    # one EXTRA padded grounding slot on the port's side: invalid-slot key
    # blocking must be output-invisible vs the unpadded reference
    G = ref["grounding_tokens"].shape[1]
    model = SEEMHeadV1(hidden_dim=32, dim_proj=32, num_queries=7, nheads=4,
                       dim_feedforward=64, dec_layers=ref["dec_layers"], mask_dim=32,
                       max_spatial_tokens=S, num_spatial_memories=ref["num_memories"],
                       sample_size=ref["sample_size"], max_grounding_tokens=G + 1)
    _load(model, convert_seem(ref["sd"], "seem", ref["dec_layers"]), dev)
    pts, valid, tags, mids, _ = _prompt_arrays(
        [(masks[mid], t, mid) for masks, t in ((ref["pos_mask"], 1), (ref["neg_mask"], -1))
         for mid in range(NM)], S)
    gt_pad = np.concatenate([ref["grounding_tokens"], np.ones((1, 1, 32), np.float32)], axis=1)
    gv_pad = np.concatenate([np.ones((1, G), bool), np.zeros((1, 1), bool)], 1)
    kwargs = dict(grounding_tokens=_t(gt_pad, dev), grounding_valid=_t(gv_pad, dev))
    if ref["prev_mask"] is not None:
        kwargs["prev_mask"] = _t(ref["prev_mask"], dev)
        kwargs["memory_indices"] = _t(ref["memory_indices"], dev, torch.long)
    with torch.no_grad():
        out = model(*_head_inputs(ref, dev), _t(pts, dev), _t(valid, dev), _t(tags, dev),
                    _t(mids, dev), _t(ref["spatial_query_indices"], dev, torch.long),
                    num_masks=NM, **kwargs)
    return _seem_rows(f"seem_v1/{tag}".rstrip("/"), out, ref["acts"],
                      ("pred_pspatials", "pred_nspatials"))


# geopurify_tpu/parity/compare.py:587
def parity_lang(size: str = "small", device="cuda", ref=None) -> Rows:
    from geopurify_tpu_torch.models.lang import LanguageEncoder
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_lang_encoder

    dev = resolve_device(device)
    if size == "full":
        kw = dict(vocab_size=49408, width=512, layers=12, heads=8, dim_proj=512, n_seq=8)
    else:
        kw = dict()
    if ref is None:
        ref = _oracle("lang_transformer_oracle", **kw)
    params, _ = convert_lang_encoder(ref["sd"], "sem_seg_head.predictor.lang_encoder")
    model = LanguageEncoder(vocab_size=kw.get("vocab_size", 512), width=kw.get("width", 64),
                            layers=ref["layers"], heads=kw.get("heads", 4), context_length=77,
                            dim_proj=kw.get("dim_proj", 32))
    _load(model, params, dev)
    with torch.no_grad():
        emb = model(_t(ref["input_ids"], dev, torch.long))
    return {"lang/emb": _diff(_np(emb), ref["emb"])}


# geopurify_tpu/parity/compare.py:610
def parity_resize(size: str = "small", device="cuda", ref=None) -> Rows:
    """Bicubic antialiased resize, up (the lift's mask resize,
    affinity_module.py:527-533) and down (the attention-mask target resize,
    xdecoder.py:459, where the antialias matters). ``ref``: the two oracle
    records, ``{"up": ..., "down": ...}``."""
    from geopurify_tpu_torch.models.layers import resize_bicubic_antialias

    dev = resolve_device(device)
    ref = ref or {}
    rows = {}
    for name, in_hw, out_hw in [("up", (17, 23), (64, 96)), ("down", (64, 96), (17, 23))]:
        r = ref.get(name) or _oracle("bicubic_resize_oracle", in_hw=in_hw, out_hw=out_hw)
        ours = resize_bicubic_antialias(_t(r["input_nhwc"], dev), out_hw)
        rows[f"resize/bicubic_aa_{name}"] = _diff(_np(ours), r["output_nhwc"])
    return rows


# geopurify_tpu/parity/compare.py:628
def parity_pad(size: str = "small", device="cuda", ref=None) -> Rows:
    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("imagelist_pad_oracle", hw=(37, 53))
    x = _t(ref["input_hwc"], dev)[None]
    H, W = x.shape[1:3]
    Hp, Wp = -(-H // 32) * 32, -(-W // 32) * 32
    ours = torch.nn.functional.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    return {"pad/imagelist32": _diff(_np(ours), ref["padded_nhwc"])}


# geopurify_tpu/parity/compare.py:691
def _our_lift_from(ref, dev, coords_key: str = "points") -> torch.Tensor:
    """The port's full lift (per-view features + top-3 consensus fusion +
    unseen fill) on the oracle's recorded teacher outputs; [N, C] f32."""
    from geopurify_tpu_torch.models.lift import (
        fill_unseen_points,
        fuse_views,
        lift_view_features,
    )

    N = ref["num_points"]
    V = len(ref["teacher"])
    text = ref["text"] / np.linalg.norm(ref["text"], axis=-1, keepdims=True)
    C, n_cls = text.shape[1], text.shape[0]
    coords = ref[coords_key]
    Pv = max(int(ref["vis"][v].sum()) for v in range(V))

    vf = torch.zeros((V, Pv, C), device=dev)
    vl = torch.zeros((V, Pv, n_cls), device=dev)
    ids = np.full((V, Pv), N, np.int32)
    pvv = np.zeros((V, Pv), bool)
    with torch.no_grad():
        for v in range(V):
            sel = np.where(ref["vis"][v])[0]
            pad = Pv - len(sel)
            t = ref["teacher"][v]
            out = lift_view_features(
                _t(t["pred_masks"], dev), _t(t["mask_embed"], dev), _t(t["pred_logits"], dev),
                _t(np.pad(ref["xl"][v, sel], (0, pad)), dev),
                _t(np.pad(ref["yl"][v, sel], (0, pad)), dev),
                _t(np.arange(Pv) < len(sel), dev),
                _t(np.pad(coords[sel], ((0, pad), (0, 0))), dev),
                _t(text, dev), float(ref["logit_scale"]), tuple(ref["mask_hw"]))
            vf[v], vl[v] = out.features, out.logits
            ids[v, : len(sel)] = sel
            pvv[v, : len(sel)] = True
        fused, count = fuse_views(vf, vl, _t(ids, dev), _t(pvv, dev), N)
        return fill_unseen_points(fused, _t(coords, dev), count,
                                  torch.ones((N,), dtype=torch.bool, device=dev))


# geopurify_tpu/parity/compare.py:641
def parity_lift(size: str = "small", device="cuda", ref=None) -> Rows:
    """Reference lift_xdecoder_features vs the port's lift_view_features +
    fuse_views + fill_unseen_points on identical stubbed teacher outputs."""
    dev = resolve_device(device)
    if ref is None:
        ref = _oracle("lift_oracle", **(dict(num_points=200, num_views=4)
                                        if size == "full" else {}))
    final = _our_lift_from(ref, dev, "coords")
    return {"lift/final_features": _diff(_np(final), ref["final_features"])}


# the Stage-2 oracle is deterministic (seeded) and the most expensive one:
# cache it per size so that mutation checks re-run only the port's pipeline
# against the cached reference scene
_STAGE2_ORACLE_CACHE: Dict[str, Dict] = {}


def _stage2_oracle(size: str) -> Dict:
    if size not in _STAGE2_ORACLE_CACHE:
        kw = dict(num_points=6000, num_views=4, box=16) if size == "full" else dict()
        _STAGE2_ORACLE_CACHE[size] = _oracle("stage2_oracle", **kw)
    return _STAGE2_ORACLE_CACHE[size]


# geopurify_tpu/parity/compare.py:753
def parity_stage2(size: str = "small", mutate=None, features_only: bool = False,
                  device="cuda", ref=None) -> Rows:
    """COMPOSED Stage-2 parity: the reference's evaluate_scene + validate()
    prediction block (run on torch-cpu under runnable faiss / torch_scatter
    / MinkowskiEngine shims) vs the port's pipeline (lift -> scatter ->
    student -> kNN-96 -> 19 smoothing rounds, banded through K1 on the card
    -> argmax -> I/U/T histograms) on the identical synthetic scene, stubbed
    teacher outputs, and converted student weights.

    Returns diff rows plus exact-match stats under special keys:
    ``stage2/pred_agree`` carries (n_tie, frac_disagree_among_confident)
    where confident = the fp64 logit margin clears 4x the measured fp32
    noise; ``stage2/knn_sets`` (rows differing, 0/1 flag).

    ``mutate`` (a dict of PoolingConfig overrides, e.g.
    ``{"num_iterations": 17}``) runs the port's pipeline with a deliberately
    wrong contract against the CACHED oracle scene — the mutation check
    that calibrated the feature tolerances. ``features_only`` skips
    everything but the feature-path diff (what a mutant check needs)."""
    from geopurify_tpu_torch.config import GeoPurifyConfig, PoolingConfig, StudentConfig
    from geopurify_tpu_torch.data.batch import SceneBatch
    from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline
    from geopurify_tpu_torch.ops.pooling import build_affinity_graph
    from geopurify_tpu_torch.utils.checkpoint import convert_student_checkpoint
    from geopurify_tpu_torch.utils.metrics import intersection_and_union

    dev = resolve_device(device)
    if ref is None:
        ref = _stage2_oracle(size)
    N, M = ref["num_points"], ref["num_voxels"]
    n_cls, n_ignore = ref["n_cls"], ref["n_ignore"]

    f2d = _our_lift_from(ref, dev, "points")                      # [N, 512]
    student_state = convert_student_checkpoint(ref["student_state"])
    hidden = ref["student_state"]["input_layer.0.kernel"].shape[-1]
    embed = ref["student_state"]["output_layer.kernel"].shape[-1]
    text_full = np.concatenate(
        [ref["text"], np.zeros((1, ref["text"].shape[1]), np.float32)], axis=0)

    def make_pipe(smooth_space: str) -> GeoPurifyPipeline:
        cfg = GeoPurifyConfig()
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, all_label=tuple(f"c{i}" for i in range(n_cls))),
            student=StudentConfig(input_dim=512 + 6, hidden_dim=hidden, embed_dim=embed,
                                  num_res_blocks=4),
            pooling=PoolingConfig(**{
                **dict(knn_k=96, sharpen=20.0, num_iterations=19, feature_dim=512,
                       smooth_space=smooth_space),
                **(mutate or {}),
            }),
        )
        return GeoPurifyPipeline(cfg, text_embeddings=torch.from_numpy(text_full),
                                 logit_scale=float(ref["logit_scale"]),
                                 student_state=student_state, device=dev)

    batch = SceneBatch.from_numpy(dict(
        points=ref["points"], point_valid=np.ones((N,), bool), geom_feats=ref["geom"],
        labels=ref["labels"].astype(np.int32), voxel_coords=ref["voxel_coords"],
        voxel_valid=np.ones((M,), bool), point2voxel=ref["inds_reconstruct"],
        images=np.zeros((1, 8, 8, 3), np.uint8), view_valid=np.ones((1,), bool),
        view_point_ids=np.zeros((1, 8), np.int32), view_point_valid=np.zeros((1, 8), bool),
        view_rows=np.zeros((1, 8), np.int32), view_cols=np.zeros((1, 8), np.int32)),
        device=dev)

    rows: Rows = {}
    pipe_f = make_pipe("feature")
    with torch.no_grad():
        if features_only:
            refined, _, logits_f, _ = pipe_f._pool_classify(f2d, batch, want_features=True)
            rows["stage2/features"] = _diff(_np(refined), ref["final_features"])
            rows["stage2/logits"] = _diff(_np(logits_f), ref["logits"])
            return rows

        # --- pre-amplification intermediates at TIGHT tolerances ---
        voxel_in, emb, _ = pipe_f._voxel_embed(f2d, batch)
        rows["stage2/voxel_in"] = _diff(_np(voxel_in), ref["voxel_in"])
        emb_n = _np(emb)
        emb_n = emb_n / np.maximum(np.linalg.norm(emb_n, axis=1, keepdims=True), 1e-12)
        rows["stage2/embed"] = _diff(emb_n, ref["embed"])

        nbr, w = build_affinity_graph(emb, batch.voxel_coords, batch.voxel_valid, k=96,
                                      sharpen=20.0)
        nbr, w = nbr.cpu().numpy(), _np(w)
        o_sort = np.argsort(nbr, axis=1)
        r_sort = np.argsort(ref["knn_idx"], axis=1)
        ids_equal = np.array_equal(np.take_along_axis(nbr, o_sort, 1),
                                   np.take_along_axis(ref["knn_idx"], r_sort, 1))
        # the neighbour-set row carries (rows differing, 0/1 flag)
        rows["stage2/knn_sets"] = (0.0 if ids_equal else float(M), 0.0 if ids_equal else 1.0)
        rows["stage2/affinity_w"] = _diff(np.take_along_axis(w, o_sort, 1),
                                          np.take_along_axis(ref["affinity_w"], r_sort, 1))

        # --- feature-space path: smoothed per-point features + cosine logits ---
        refined, _, logits_f, pred_f = pipe_f._pool_classify(f2d, batch, want_features=True)
        rows["stage2/features"] = _diff(_np(refined), ref["final_features"])
        rows["stage2/logits"] = _diff(_np(logits_f), ref["logits"])

        # --- logit-space path (production default): argmax predictions ---
        pipe_l = make_pipe("logit")
        _, _, _, pred_l = pipe_l._pool_classify(f2d, batch, want_features=False)
        i_o, u_o, t_o = intersection_and_union(
            pred_l, batch.labels, batch.point_valid, num_classes=n_cls,
            ignore_labels=tuple(range(n_cls, n_cls + n_ignore)))
    pred_l, pred_f = pred_l.cpu().numpy(), pred_f.cpu().numpy()

    # margin-aware argmax agreement, judged against the fp64 truth: rows
    # whose fp64 logit margin clears the measured fp32 noise must agree
    logits64 = ref["logits64"]
    part = np.partition(logits64, -2, axis=1)
    margin = part[:, -1] - part[:, -2]
    delta = max(float(np.max(np.abs(_np(logits_f).astype(np.float64) - logits64))),
                float(np.max(np.abs(ref["logits"].astype(np.float64) - logits64))))
    confident = margin > 4.0 * delta
    nc = max(int(confident.sum()), 1)
    dis = 0
    for p in (pred_l, pred_f, ref["pred"]):
        dis = max(dis, int(((p != ref["pred64"]) & confident).sum()))
    n_tie = int((~confident).sum())
    rows["stage2/pred_agree"] = (float(n_tie), float(dis) / nc)

    ri, ru, rt = ref["iut"]
    rows["stage2/hist_I"] = _diff(_np(i_o), ri)
    rows["stage2/hist_U"] = _diff(_np(u_o), ru)
    rows["stage2/hist_T"] = _diff(_np(t_o), rt)
    return rows


# geopurify_tpu/parity/compare.py:949
def parity_visual_sampler(size: str = "small", device="cuda", ref=None) -> Rows:
    """Visual-sampler family parity: every case of
    oracle.visual_sampler_oracle — ShapeSampler train (mixed + each shape
    forced), ShapeSampler eval (growing prompt stacks), SimpleClickSampler
    (all five modes) — replayed through data/visual_sampler.py in
    Draws.torch_compat mode after identical re-seeding. Masks must be
    BIT-EQUAL (the rng streams coincide call-for-call); rows carry
    (#mismatching elements, 0/1 flag). The samplers run on the host:
    ``device`` is not used."""
    import random as _random

    from geopurify_tpu_torch.data import visual_sampler as vs

    if ref is None:
        ref = _oracle("visual_sampler_oracle")
    masks, boxes = ref["masks"], ref["boxes"]
    kw = ref["sampler_kwargs"]
    rows: Rows = {}
    for name, case in ref["cases"].items():
        _random.seed(case["seed"])
        np.random.seed(case["seed"])
        torch.manual_seed(case["seed"])
        draws = vs.Draws.torch_compat()
        if case["kind"] == "shape_train":
            cfg = vs.StrokeSamplerConfig(candidate_probs=case["probs"], **kw)
            out = vs.ShapeSampler(cfg, is_train=True)(masks, boxes, draws)
        elif case["kind"] == "shape_eval":
            cfg = vs.StrokeSamplerConfig(**kw)
            out = vs.ShapeSampler(cfg, is_train=False, mode=case["mode"])(masks, boxes, draws)
        else:                                   # click
            cfg = vs.StrokeSamplerConfig(**kw)
            out = vs.SimpleClickSampler(cfg, is_train=False, mode=case["mode"])(
                masks, boxes, draws=draws)
        got, want = out["rand_shape"].astype(bool), case["rand_shape"].astype(bool)
        ok = (np.array_equal(got, want)
              and np.array_equal(out["gt_masks"].astype(bool), case["gt_masks"].astype(bool))
              and list(out["types"]) == list(case["types"]))
        n_bad = 0.0 if ok else (float(np.sum(got != want)) if got.shape == want.shape
                                else -1.0)
        rows[f"vsampler/{name}"] = (n_bad, 0.0 if ok else 1.0)
    return rows


# the two contract cases of the naive Sonata check (compare.py:1041-1053):
# stage0 depth 4 cycles all four serialization orders with the stem conv,
# max pooling and the full-concat upcast; the other the dense embed, mean
# pooling, the propagate upcast tail and the folded-BN affine norms
SONATA_CASES = {
    "maxpool_stem": dict(enc_depths=(4, 1, 1), enc_channels=(8, 12, 16),
                         enc_num_head=(2, 2, 2), enc_patch_size=(16, 16, 16),
                         stem_kernel=3, pool_reduce="max", upcast_levels=2,
                         aux_norm_affine_only=False),
    "meanpool_affine": dict(enc_depths=(2, 1, 1), enc_channels=(8, 12, 16),
                            enc_num_head=(2, 2, 2), enc_patch_size=(16, 16, 16),
                            stem_kernel=1, pool_reduce="mean", upcast_levels=1,
                            aux_norm_affine_only=True),
}


def sonata_scene(seed: int = 3, N: int = 400, box: int = 14):
    """The naive Sonata check's scene (compare.py:1020-1039): N integer
    points in a box, the last 24 invalid, voxelized on the host into unique
    coords in ascending x-major lexicographic order with a budget of N
    voxels (a shared INPUT of both sides, not part of the check), and
    N(0, 1) features. Returns (feats, voxel_coords, voxel_valid,
    point2voxel, point_valid)."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, box, (N, 3)).astype(np.int32)
    valid = np.ones(N, bool)
    valid[-24:] = False
    uniq = sorted({tuple(int(v) for v in p) for p, ok in zip(pts, valid) if ok})
    vid = {c: i for i, c in enumerate(uniq)}
    voxel_coords = np.zeros((N, 3), np.int32)
    voxel_valid = np.zeros(N, bool)
    for c, i in vid.items():
        voxel_coords[i] = c
        voxel_valid[i] = True
    point2voxel = np.array([vid[tuple(int(v) for v in p)] if ok else N
                            for p, ok in zip(pts, valid)], np.int32)
    feats = rng.normal(0, 1, (N, 6)).astype(np.float32)
    return feats, voxel_coords, voxel_valid, point2voxel, valid


def seeded_sonata(kw, seed: int = 11):
    """The port's SonataTeacher of the case ``kw`` with every parameter
    drawn N(0, 0.4^2) from a numpy seed, in sorted name order (the default
    init leaves the norms at identity, which would hide scale / bias layout
    divergences)."""
    from geopurify_tpu_torch.models.sonata import SonataTeacher

    teacher = SonataTeacher(in_channels=6, **kw)
    prng = np.random.default_rng(seed)
    sd = teacher.state_dict()
    teacher.load_state_dict({k: torch.from_numpy(prng.normal(0, 0.4, sd[k].shape)
                                                 .astype(np.float32)) for k in sorted(sd)})
    return teacher.eval()


# geopurify_tpu/parity/compare.py:1006
def parity_sonata(size: str = "small", mutate_naive=None, device="cuda",
                  ref=None) -> Rows:
    """Independent Sonata cross-check: the port's SonataTeacher vs
    parity/sonata_oracle.py's de-novo naive-loop numpy forward (scalar
    Skilling Hilbert, hash-map sparse convs, per-patch attention loops,
    sorted-unique grid pooling) on IDENTICAL seeded parameters, handed to
    the naive forward as its Flax-layout tree through
    ``utils.from_jax.sonata_to_jax``; compared on the valid points. Needs no
    reference tree. ``mutate_naive`` overrides the naive side's contract
    (e.g. ``{"pool_reduce": "mean"}``); ``ref`` maps a case name to the
    naive forward's output, standing in for it."""
    from geopurify_tpu_torch.parity import sonata_oracle as so
    from geopurify_tpu_torch.utils.from_jax import sonata_to_jax

    dev = resolve_device(device)
    feats, voxel_coords, voxel_valid, point2voxel, valid = sonata_scene()
    rows: Rows = {}
    for name, kw in SONATA_CASES.items():
        teacher = seeded_sonata(kw)
        if ref is not None and name in ref:
            naive = ref[name]
        else:
            naive = so.sonata_forward_naive(
                sonata_to_jax(teacher.state_dict()), feats, voxel_coords, voxel_valid,
                point2voxel, valid, **{**kw, **(mutate_naive or {})})
        teacher.to(dev)
        with torch.no_grad():
            ours = teacher(_t(feats, dev), _t(voxel_coords, dev), _t(voxel_valid, dev),
                           _t(point2voxel, dev), _t(valid, dev))
        rows[f"sonata/{name}"] = _diff(_np(ours)[valid], naive[valid])
    return rows


# geopurify_tpu/parity/compare.py:920, :1003, :1083
ALL_STAGES = {
    "pad": parity_pad,
    "resize": parity_resize,
    "lang": parity_lang,
    "focalnet": parity_focalnet,
    "focalnet_dw": parity_focalnet_dw,
    "davit": parity_davit,
    "vit": parity_vit,
    "pixel_decoder": parity_pixel_decoder,
    "deform_pixel_decoder": parity_deform_pixel_decoder,
    "head": parity_head,
    "head_vlp": parity_head_vlp,
    "seem": parity_seem,
    "seem_v1": parity_seem_v1,
    "seem_demo": parity_seem_demo,
    "lift": parity_lift,
    "stage2": parity_stage2,
    "visual_sampler": parity_visual_sampler,
    "sonata": parity_sonata,
}

# the stages that run without the reference tree
NO_REFERENCE = ("sonata",)


# geopurify_tpu/parity/compare.py:940
def run_all(size: str = "small", stages=None, device="cuda") -> Rows:
    """Every stage of ``stages`` (None: all), in ``ALL_STAGES``' order,
    its port side on ``device``. Raises ``FileNotFoundError`` naming the
    reference tree before any stage runs when one of them needs it and it
    is not there."""
    from geopurify_tpu_torch.parity import shims

    names = tuple(stages) if stages else tuple(ALL_STAGES)
    need = [s for s in names if s not in NO_REFERENCE]
    if need and not os.path.isdir(shims.reference_root()):
        raise FileNotFoundError(
            f"stages {', '.join(need)} run the reference torch code, and the reference "
            f"tree {shims.reference_root()} does not exist (only 'sonata' runs without it)")
    rows: Rows = {}
    for name, fn in ALL_STAGES.items():
        if stages and name not in stages:
            continue
        rows.update(fn(size, device=device))
    return rows
