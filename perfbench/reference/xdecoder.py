"""X-Decoder (FocalNet-L + FPN pixel decoder + query decoder) of the plain
reference: a frozen copy of the port's ``models/xdecoder.py`` seg path, in
the inference order (``return_aux=False``), without the captioning slots,
the instrumentation or the other backbones. ``XDecoderSegModel`` takes the
configuration file's ``xdecoder`` section.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from perfbench.reference.focalnet import FocalNet
from perfbench.reference.layers import (
    CrossAttentionLayer,
    FFNLayer,
    LayerNorm,
    MLPHead,
    SelfAttentionLayer,
    position_embedding_sine,
    resize_bicubic_antialias,
)
from perfbench.reference.pixel_decoder import TransformerEncoderPixelDecoder


# geopurify_tpu/models/xdecoder.py:45
def _structured_self_attn_mask(num_queries: int) -> np.ndarray:
    """[Q, Q] bool, True = blocked: object queries and the class token (the
    last query) do not see each other."""
    Q = num_queries
    m = np.zeros((Q, Q), bool)
    m[: Q - 1, Q - 1: Q] = True
    m[Q - 1: Q, : Q - 1] = True
    return m


# geopurify_tpu/models/xdecoder.py:59
class XDecoderHead(nn.Module):
    """Query decoder over pixel-decoder outputs (seg task, inference order)."""

    def __init__(self, hidden_dim: int = 512, dim_proj: int = 512,
                 num_queries: int = 201, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, mask_dim: int = 512, num_levels: int = 3,
                 pre_norm: bool = False, dtype=torch.float32):
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

    def forward(self, multi_scale: List[torch.Tensor], mask_features: torch.Tensor,
                text_embeddings: torch.Tensor, logit_scale) -> Dict[str, torch.Tensor]:
        """``multi_scale``: 3 NHWC maps, lowest-res first; ``mask_features``
        [B, H4, W4, mask_dim]; ``text_embeddings`` [n_cls + 1, dim_proj]."""
        dt = self.dtype
        B = mask_features.shape[0]
        Q, C = self.num_queries, self.hidden_dim
        dev = mask_features.device

        srcs, poss, sizes = [], [], []
        for i, x in enumerate(multi_scale):
            b, h, w, c = x.shape
            sizes.append((h, w))
            pe = position_embedding_sine(h, w, C // 2, dtype=dt, device=dev)
            poss.append(pe[None].expand(b, h, w, C).reshape(b, h * w, C))
            srcs.append(x.reshape(b, h * w, c) + self.level_embed[i].to(dt)[None, None])

        self_mask = torch.from_numpy(_structured_self_attn_mask(Q)).to(dev)[None, None]
        mf = mask_features.to(torch.float32)
        text_t = text_embeddings.to(torch.float32)
        mf_small = [resize_bicubic_antialias(mf, s) for s in sizes]

        def prediction_heads(output, level: int, want_full: bool):
            dec = self.decoder_norm(output)                        # f32 [B, Q, C]
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
            outputs_mask = torch.einsum("bqc,bhwc->bqhw", m_emb, mf) if want_full else None
            logits = torch.einsum("bqc,bhwc->bqhw", m_emb, mf_small[level])
            am = torch.sigmoid(logits).reshape(B, Q, -1) < 0.5        # True = block
            am = am & ~am.all(dim=-1, keepdim=True)
            return outputs_class, outputs_mask, class_embed, am

        output = self.query_feat[None].expand(B, Q, C).to(dt)
        qpe = self.query_embed[None].expand(B, Q, C).to(dt)
        num_levels = len(multi_scale)
        outputs_class, outputs_mask, class_embed, am = prediction_heads(
            output, 0, want_full=self.dec_layers == 0)
        for i in range(self.dec_layers):
            level = i % num_levels
            output = getattr(self, f"cross_attn{i}")(
                output, srcs[level], memory_mask=am[:, None], pos=poss[level],
                query_pos=qpe)
            output = getattr(self, f"self_attn{i}")(output, query_pos=qpe,
                                                    tgt_mask=self_mask)
            output = getattr(self, f"ffn{i}")(output)
            outputs_class, outputs_mask, class_embed, am = prediction_heads(
                output, (i + 1) % num_levels, want_full=i == self.dec_layers - 1)
        return {
            "pred_logits": outputs_class[:, : Q - 1],
            "pred_masks": outputs_mask[:, : Q - 1],
            "mask_embed": class_embed[:, : Q - 1],
        }


# geopurify_tpu/models/xdecoder.py:267
def normalize_and_pad(x_cfg: dict, images: torch.Tensor) -> torch.Tensor:
    """Pixel normalization + /size_divisibility zero padding (NHWC)."""
    mean = torch.tensor(x_cfg["pixel_mean"], dtype=torch.float32, device=images.device)
    std = torch.tensor(x_cfg["pixel_std"], dtype=torch.float32, device=images.device)
    x = (images.to(torch.float32) - mean) / std
    H, W = x.shape[1:3]
    div = x_cfg["size_divisibility"]
    Hp, Wp = -(-H // div) * div, -(-W // div) * div
    return torch.nn.functional.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))


# geopurify_tpu/models/xdecoder.py:393
class XDecoderSegModel(nn.Module):
    """FocalNet + FPN pixel decoder + query decoder, in f32 by default."""

    def __init__(self, x_cfg: dict, dtype=torch.float32):
        super().__init__()
        self.x_cfg = x_cfg
        self.dtype = dtype
        bb = x_cfg["backbone"]
        self.backbone = FocalNet(
            embed_dim=bb["embed_dim"], depths=tuple(bb["depths"]),
            focal_levels=tuple(bb["focal_levels"]),
            focal_windows=tuple(bb["focal_windows"]), mlp_ratio=bb["mlp_ratio"],
            use_conv_embed=bb["use_conv_embed"], use_postln=bb["use_postln"],
            use_postln_in_modulation=bb["use_postln_in_modulation"],
            scaling_modulator=bb["scaling_modulator"],
            use_layerscale=bb["use_layerscale"], patch_size=bb["patch_size"],
            out_indices=(0, 1, 2, 3), dtype=dtype)
        chans = [bb["embed_dim"] * 2 ** i for i in range(len(bb["depths"]))]
        self.pixel_decoder = TransformerEncoderPixelDecoder(
            chans, conv_dim=x_cfg["conv_dim"], mask_dim=x_cfg["mask_dim"],
            num_enc_layers=x_cfg["enc_layers"], num_heads=x_cfg["nheads"],
            dim_feedforward=x_cfg["dim_feedforward"], pre_norm=x_cfg["pre_norm"],
            dtype=dtype)
        self.predictor = XDecoderHead(
            hidden_dim=x_cfg["hidden_dim"], dim_proj=x_cfg["hidden_dim"],
            num_queries=x_cfg["num_queries"], nheads=x_cfg["nheads"],
            dim_feedforward=x_cfg["dim_feedforward"], dec_layers=x_cfg["dec_layers"],
            mask_dim=x_cfg["mask_dim"], pre_norm=x_cfg["pre_norm"], dtype=dtype)

    def forward(self, images, text_embeddings, logit_scale) -> Dict[str, torch.Tensor]:
        x = normalize_and_pad(self.x_cfg, images)
        feats = self.backbone(x.to(self.dtype))
        mask_features, _, multi_scale = self.pixel_decoder(feats)
        return self.predictor(list(multi_scale), mask_features, text_embeddings,
                              logit_scale)
