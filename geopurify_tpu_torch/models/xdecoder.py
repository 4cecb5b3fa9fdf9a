"""X-Decoder query decoder + assembled 2D teacher (seg inference path).

Port of geopurify_tpu/models/xdecoder.py: 201 learned queries, 3-level
memory with level embeddings and sine PE, ``dec_layers`` rounds of masked
cross-attention -> structured self-attention -> FFN, and per-round
prediction heads. In the default inference order (``return_aux=False``,
xdecoder.py:138-149,176-178) the mask features are resized to the three
memory sizes once, and each round's attention mask is the mask einsum at
the target size, thresholded at sigmoid < 0.5. ``return_aux=True`` keeps
the reference-shaped order (the mask einsum at stride 4, then each round's
resize to its target size) and returns every round's stride-4 masks and
binary attention masks (``aux_masks``, ``aux_attn``; xdecoder.py:257-259);
the two orders differ by float reassociation only. With
``caption_tokens`` (the captioning task) the caption slots join the
queries through the structured mask's causal block. The backbone is
FocalNet (``focal`` or ``focal_dw``), DaViT or ViT, and the pixel decoder
the transformer-encoder FPN or the deformable one, as ``XDecoderConfig``
says.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from geopurify_tpu_torch.config import XDecoderConfig
from geopurify_tpu_torch.models.davit import DaViT
from geopurify_tpu_torch.models.focalnet import FocalNet
from geopurify_tpu_torch.models.layers import (
    CrossAttentionLayer,
    FFNLayer,
    LayerNorm,
    MLPHead,
    SelfAttentionLayer,
    position_embedding_sine,
    resize_bicubic_antialias,
)
from geopurify_tpu_torch.models.pixel_decoder import TransformerEncoderPixelDecoder
from geopurify_tpu_torch.models.pixel_decoder_deform import MSDeformAttnPixelDecoder
from geopurify_tpu_torch.models.vit_backbone import ViTBackbone
from geopurify_tpu_torch.utils import profiling


# geopurify_tpu/models/xdecoder.py:45
def _structured_self_attn_mask(num_queries: int, contxt_len: int = 0) -> np.ndarray:
    """[Q+T, Q+T] bool, True = blocked: object queries and the class token
    (the last query) do not see each other; with ``contxt_len`` caption
    tokens appended, the queries do not see the captions, and the captions
    see each other causally and every query."""
    Q, T = num_queries, contxt_len
    m = np.zeros((Q + T, Q + T), bool)
    m[:Q, Q:] = True
    m[Q:, Q:] = np.triu(np.ones((T, T), bool), 1)
    m[: Q - 1, Q - 1: Q] = True
    m[Q - 1: Q, : Q - 1] = True
    return m


# geopurify_tpu/models/xdecoder.py:59
class XDecoderHead(nn.Module):
    """Query decoder over pixel-decoder outputs (seg task, inference order).
    ``caption_len`` > 0 adds the caption slots (``caping_embed``,
    ``pos_embed_caping``) that the captioning task runs."""

    def __init__(self, hidden_dim: int = 512, dim_proj: int = 512,
                 num_queries: int = 201, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, mask_dim: int = 512, num_levels: int = 3,
                 pre_norm: bool = False, caption_len: int = 0, dtype=torch.float32):
        super().__init__()
        C = hidden_dim
        self.hidden_dim, self.num_queries, self.dec_layers = C, num_queries, dec_layers
        self.dim_proj, self.dtype = dim_proj, dtype
        self.level_embed = nn.Parameter(torch.zeros(num_levels, C))
        self.query_feat = nn.Parameter(torch.zeros(num_queries, C))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, C))
        self.class_embed = nn.Parameter(torch.zeros(C, dim_proj))
        self.mask_embed = MLPHead(C, C, mask_dim, 3, dtype=dtype)
        self.decoder_norm = LayerNorm(C)
        for i in range(dec_layers):
            self.add_module(f"cross_attn{i}", CrossAttentionLayer(C, nheads, dtype, pre_norm))
            self.add_module(f"self_attn{i}", SelfAttentionLayer(C, nheads, dtype, pre_norm))
            self.add_module(f"ffn{i}", FFNLayer(C, dim_feedforward, dtype, pre_norm))
        self.caping_embed = self.pos_embed_caping = None
        if caption_len:
            self.add_caption_slots(caption_len)

    def add_caption_slots(self, caption_len: int) -> None:
        """Zero caption slots for ``caption_len`` tokens, the stand-ins the
        JAX captioning entry gives a model built without them
        (run/infer2d.py:303-316)."""
        dev = self.class_embed.device
        self.caping_embed = nn.Parameter(torch.zeros(self.hidden_dim, self.dim_proj,
                                                     device=dev))
        self.pos_embed_caping = nn.Parameter(torch.zeros(caption_len, self.hidden_dim,
                                                         device=dev))

    def forward(
        self,
        multi_scale: List[torch.Tensor],   # 3 NHWC maps, lowest-res first
        mask_features: torch.Tensor,       # [B, H4, W4, mask_dim]
        text_embeddings: torch.Tensor,     # [n_cls(+1), dim_proj]
        logit_scale,                       # [] (already exp'd)
        caption_tokens: Optional[torch.Tensor] = None,   # [B, T, C]
        attn_mask_override: Optional[List[torch.Tensor]] = None,
        return_attn: bool = False,
        return_aux: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """``caption_tokens`` (the language tower's token embeddings) add
        ``pred_captionings`` [B, T, dim_proj] and ``pred_captions`` [B, Q,
        dim_proj] to the outputs. ``attn_mask_override[i]`` forces round i's
        cross-attention mask ([B, Q(+T), HW_level] bool, True = block) and
        ``return_attn`` returns the masks the rounds computed under
        ``attn_masks`` (and round 0's pre-threshold logits under
        ``attn_logits0``) — instrumentation for holding the port against JAX
        on the same binarized masks. ``return_aux`` takes the
        reference-shaped order and adds ``aux_masks`` (dec_layers + 1 x [B, Q,
        H4, W4]) and ``aux_attn`` (dec_layers + 1 x [B, 1, Q+T, HW_level]
        bool) as the JAX head does (xdecoder.py:138-149, 257-259)."""
        dt = self.dtype
        B = mask_features.shape[0]
        Q, C = self.num_queries, self.hidden_dim
        T = caption_tokens.shape[1] if caption_tokens is not None else 0
        dev = mask_features.device

        srcs, poss, sizes = [], [], []
        for i, x in enumerate(multi_scale):
            b, h, w, c = x.shape
            sizes.append((h, w))
            pe = position_embedding_sine(h, w, C // 2, dtype=dt, device=dev)
            poss.append(pe[None].expand(b, h, w, C).reshape(b, h * w, C))
            srcs.append(x.reshape(b, h * w, c) + self.level_embed[i].to(dt)[None, None])

        self_mask = torch.from_numpy(_structured_self_attn_mask(Q, T)).to(dev)[None, None]
        mf = mask_features.to(torch.float32)
        text_t = text_embeddings.to(torch.float32)
        if not return_aux:
            mf_small = [resize_bicubic_antialias(mf, s) for s in sizes]

        def prediction_heads(output, level: int, want_full: bool):
            dec_all = self.decoder_norm(output)                    # f32 [B, Q+T, C]
            capt = dec_all[:, Q:] @ self.caping_embed if T else None
            dec = dec_all[:, :Q]
            ndec = dec / (torch.linalg.norm(dec, dim=-1, keepdim=True) + 1e-7)
            obj_tok, cls_tok = ndec[:, : Q - 1], ndec[:, Q - 1: Q]
            sim = torch.softmax(torch.einsum("bic,bqc->biq", cls_tok, obj_tok),
                                dim=-1)[:, 0, :, None]
            cls_re = (sim * dec[:, : Q - 1]).sum(1, keepdim=True)
            dec_out = torch.cat([dec[:, : Q - 1], cls_re], 1)     # [B, Q, C]
            class_embed = dec_out @ self.class_embed
            v = class_embed / (torch.linalg.norm(class_embed, dim=-1, keepdim=True) + 1e-7)
            outputs_class = logit_scale * torch.einsum("bqd,nd->bqn", v, text_t)
            m_emb = self.mask_embed(dec_out.to(dt)).to(torch.float32)
            outputs_mask = (torch.einsum("bqc,bhwc->bqhw", m_emb, mf)
                            if want_full or return_aux else None)
            if return_aux:
                # the stride-4 masks resized to the target scale
                logits = resize_bicubic_antialias(outputs_mask.permute(0, 2, 3, 1),
                                                  sizes[level]).permute(0, 3, 1, 2)
            else:
                # the commuted form: the einsum straight at the target scale
                logits = torch.einsum("bqc,bhwc->bqhw", m_emb, mf_small[level])
            am = torch.sigmoid(logits).reshape(B, Q, -1) < 0.5        # True = block
            am = am & ~am.all(dim=-1, keepdim=True)
            if T:
                # caption rows attend the full memory (xdecoder.py:265-267)
                am = torch.cat([am, am.new_zeros((B, T, am.shape[-1]))], 1)
            return outputs_class, outputs_mask, class_embed, capt, am, logits

        output = self.query_feat[None].expand(B, Q, C).to(dt)
        qpe = self.query_embed[None].expand(B, Q, C).to(dt)
        if T:
            # the queries see detached caption states; the caption QPE
            # carries the token embedding + pos_embed_caping
            cap = caption_tokens.to(dt)
            output = torch.cat([output, cap.detach()], 1)
            qpe = torch.cat([qpe, cap + self.pos_embed_caping[None].to(dt)], 1)
        num_levels = len(multi_scale)
        outputs_class, outputs_mask, class_embed, capt, am, logits0 = prediction_heads(
            output, 0, want_full=self.dec_layers == 0)
        attn, aux_masks = [am], [outputs_mask]
        for i in range(self.dec_layers):
            level = i % num_levels
            if attn_mask_override is not None:
                am = attn_mask_override[i]
            output = getattr(self, f"cross_attn{i}")(
                output, srcs[level], memory_mask=am[:, None], pos=poss[level],
                query_pos=qpe)
            output = getattr(self, f"self_attn{i}")(output, query_pos=qpe,
                                                    tgt_mask=self_mask)
            output = getattr(self, f"ffn{i}")(output)
            outputs_class, outputs_mask, class_embed, capt, am, _ = prediction_heads(
                output, (i + 1) % num_levels, want_full=i == self.dec_layers - 1)
            attn.append(am)
            aux_masks.append(outputs_mask)
        out = {
            "pred_logits": outputs_class[:, : Q - 1],
            "pred_masks": outputs_mask[:, : Q - 1],
            "mask_embed": class_embed[:, : Q - 1],
            "cls_logits": outputs_class[:, Q - 1],
            "cls_embed": class_embed[:, Q - 1],
        }
        if T:
            out["pred_captionings"] = capt                 # [B, T, dim_proj]
            out["pred_captions"] = class_embed             # the class row included
        if return_attn:
            out["attn_masks"] = attn
            out["attn_logits0"] = logits0          # round 0, pre-threshold
        if return_aux:
            out["aux_masks"] = aux_masks
            out["aux_attn"] = [a[:, None] for a in attn]
        return out


def model_dtype(cfg: XDecoderConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# geopurify_tpu/models/xdecoder.py:267
def _normalize_and_pad(cfg: XDecoderConfig, images: torch.Tensor) -> torch.Tensor:
    """Pixel normalization + /size_divisibility zero padding (NHWC)."""
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=images.device)
    x = (images.to(torch.float32) - mean) / std
    H, W = x.shape[1:3]
    div = cfg.size_divisibility
    Hp, Wp = -(-H // div) * div, -(-W // div) * div
    return torch.nn.functional.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))


# geopurify_tpu/models/xdecoder.py:280
def _make_backbone(cfg: XDecoderConfig) -> nn.Module:
    """FocalNet as ``cfg.backbone`` says, or DaViT / ViT at the JAX
    package's defaults."""
    dtype = model_dtype(cfg)
    if cfg.backbone_type == "davit":
        return DaViT(dtype=dtype)
    if cfg.backbone_type == "vit":
        return ViTBackbone(dtype=dtype)
    bb = cfg.backbone
    return FocalNet(
        embed_dim=bb.embed_dim, depths=tuple(bb.depths),
        focal_levels=tuple(bb.focal_levels), focal_windows=tuple(bb.focal_windows),
        mlp_ratio=bb.mlp_ratio, use_conv_embed=bb.use_conv_embed,
        use_postln=bb.use_postln, use_postln_in_modulation=bb.use_postln_in_modulation,
        scaling_modulator=bb.scaling_modulator, use_layerscale=bb.use_layerscale,
        use_dw=bb.variant == "focal_dw", use_pre_norms=tuple(bb.use_pre_norms),
        fast_gelu=bb.fast_gelu and dtype == torch.bfloat16, patch_size=bb.patch_size,
        out_indices=tuple(bb.out_indices), dtype=dtype,
    )


def _backbone_channels(cfg: XDecoderConfig) -> List[int]:
    """Channels of res2..res5 of ``_make_backbone(cfg)``."""
    if cfg.backbone_type == "davit":
        return [96, 192, 384, 768]
    if cfg.backbone_type == "vit":
        return [128, 256, 512, 1024]
    return [cfg.backbone.embed_dim * 2 ** i for i in range(len(cfg.backbone.depths))]


# geopurify_tpu/models/xdecoder.py:312
def _make_pixel_decoder(cfg: XDecoderConfig) -> nn.Module:
    dtype = model_dtype(cfg)
    chans = _backbone_channels(cfg)
    if cfg.pixel_decoder == "deform":
        return MSDeformAttnPixelDecoder(
            chans, conv_dim=cfg.conv_dim, mask_dim=cfg.mask_dim,
            num_enc_layers=cfg.enc_layers, num_heads=cfg.nheads,
            dim_feedforward=cfg.dim_feedforward, dtype=dtype)
    return TransformerEncoderPixelDecoder(
        chans, conv_dim=cfg.conv_dim, mask_dim=cfg.mask_dim,
        num_enc_layers=cfg.enc_layers, num_heads=cfg.nheads,
        dim_feedforward=cfg.dim_feedforward, pre_norm=cfg.pre_norm, dtype=dtype)


# geopurify_tpu/models/xdecoder.py:340
def _make_head(cfg: XDecoderConfig, caption_len: int = 0) -> XDecoderHead:
    return XDecoderHead(
        hidden_dim=cfg.hidden_dim, dim_proj=cfg.hidden_dim,
        num_queries=cfg.num_queries, nheads=cfg.nheads,
        dim_feedforward=cfg.dim_feedforward, dec_layers=cfg.dec_layers,
        mask_dim=cfg.mask_dim, pre_norm=cfg.pre_norm, caption_len=caption_len,
        dtype=model_dtype(cfg))


# geopurify_tpu/models/xdecoder.py:393
class XDecoderSegModel(nn.Module):
    """Backbone + pixel decoder + query decoder (forward_seg_all).
    ``caption_len`` > 0 gives the head its caption slots."""

    def __init__(self, cfg: XDecoderConfig, caption_len: int = 0):
        super().__init__()
        self.cfg = cfg
        self.backbone = _make_backbone(cfg)
        self.pixel_decoder = _make_pixel_decoder(cfg)
        self.predictor = _make_head(cfg, caption_len)

    def forward(self, images, text_embeddings, logit_scale,
                caption_tokens: Optional[torch.Tensor] = None,
                **head_kw) -> Dict[str, torch.Tensor]:
        """``head_kw``: the head's instrumentation (``attn_mask_override``
        / ``return_attn``), as ``apply_head`` takes it."""
        mask_features, multi_scale = encode_pixel_features(self, images)
        out = apply_head(self, multi_scale, mask_features, text_embeddings, logit_scale,
                         caption_tokens=caption_tokens, **head_kw)
        div = self.cfg.size_divisibility
        out["padded_hw"] = torch.tensor([-(-images.shape[1] // div) * div,
                                         -(-images.shape[2] // div) * div])
        return out


# geopurify_tpu/models/xdecoder.py:355
def encode_pixel_features(model: XDecoderSegModel, images: torch.Tensor
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Normalize/pad + backbone + pixel decoder: (mask_features,
    multi_scale). Loops that re-run only the head (captioning) encode once."""
    with profiling.span("backbone"):
        x = _normalize_and_pad(model.cfg, images)
        feats = model.backbone(x.to(model_dtype(model.cfg)))
    with profiling.span("pixel_decoder"):
        mask_features, _, multi_scale = model.pixel_decoder(feats)
    return mask_features, multi_scale


# geopurify_tpu/models/xdecoder.py:375
def apply_head(model: XDecoderSegModel, multi_scale: Sequence[torch.Tensor],
               mask_features: torch.Tensor, text_embeddings, logit_scale,
               caption_tokens: Optional[torch.Tensor] = None, **kw) -> Dict[str, torch.Tensor]:
    """The query-decoder half of ``XDecoderSegModel`` (``kw``: the head's
    instrumentation, ``attn_mask_override`` / ``return_attn``)."""
    with profiling.span("head"):
        return model.predictor(list(multi_scale), mask_features, text_embeddings,
                               logit_scale, caption_tokens=caption_tokens, **kw)
