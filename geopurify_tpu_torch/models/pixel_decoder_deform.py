"""Multi-scale deformable-attention pixel decoder (Mask2Former-style).

Port of geopurify_tpu/models/pixel_decoder_deform.py: res3..res5 are 1x1
projected (+GN), flattened with level embeddings on the positional stream,
and run through ``num_enc_layers`` deformable self-attention encoder layers
(``ops/ms_deform_attn.py``); res2 joins through an FPN lateral with a
bilinear upsample, and a 1x1 conv gives the stride-4 mask features. The
output contract is ``TransformerEncoderPixelDecoder``'s.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from geopurify_tpu_torch.models.layers import (
    Conv,
    ConvGN,
    Dense,
    LayerNorm,
    position_embedding_sine,
    resize_bilinear,
)
from geopurify_tpu_torch.ops.ms_deform_attn import ms_deform_attn


# geopurify_tpu/models/pixel_decoder_deform.py:37
def make_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                          device=None) -> torch.Tensor:
    """[L, n_levels, 2] normalized (x, y) centre of every flattened
    position, the same for every target level."""
    pts = []
    for hl, wl in spatial_shapes:
        ys = (torch.arange(hl, dtype=torch.float32, device=device) + 0.5) / hl
        xs = (torch.arange(wl, dtype=torch.float32, device=device) + 0.5) / wl
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(pts, 0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


# geopurify_tpu/models/pixel_decoder_deform.py:54
class MSDeformAttnEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int = 8, n_levels: int = 3,
                 n_points: int = 4, d_ffn: int = 1024, dtype=torch.float32):
        super().__init__()
        C, self.H, self.NL, self.P = d_model, n_heads, n_levels, n_points
        self.dtype = dtype
        self.value_proj = Dense(C, C, dtype)
        self.sampling_offsets = Dense(C, n_heads * n_levels * n_points * 2, dtype)
        self.attention_weights = Dense(C, n_heads * n_levels * n_points, dtype)
        self.output_proj = Dense(C, C, dtype)
        self.norm1 = LayerNorm(C)
        self.linear1 = Dense(C, d_ffn, dtype)
        self.linear2 = Dense(d_ffn, C, dtype)
        self.norm2 = LayerNorm(C)

    def forward(self, src, pos, ref_points, spatial_shapes):
        """src [B, L, C]; pos [B, L, C]; ref_points [L, n_levels, 2]."""
        B, L, C = src.shape
        H, P, NL, dt = self.H, self.P, self.NL, self.dtype
        q = (src + pos).to(dt)
        value = self.value_proj(src).reshape(B, L, H, C // H)
        offsets = self.sampling_offsets(q).reshape(B, L, H, NL, P, 2).to(torch.float32)
        attn = self.attention_weights(q).reshape(B, L, H, NL * P)
        attn = torch.softmax(attn.to(torch.float32), -1).reshape(B, L, H, NL, P)
        wh = torch.tensor([(wl, hl) for hl, wl in spatial_shapes], dtype=torch.float32,
                          device=src.device)
        loc = ref_points[None, :, None, :, None, :] + offsets / wh[None, None, None, :, None, :]
        out = ms_deform_attn(value, spatial_shapes, loc, attn)
        src = src + self.output_proj(out.to(dt))
        src = self.norm1(src).to(dt)
        h = self.linear2(torch.relu(self.linear1(src)))
        return self.norm2(src + h).to(dt)


# geopurify_tpu/models/pixel_decoder_deform.py:100
class MSDeformAttnPixelDecoder(nn.Module):
    """Deformable encoder over res3..res5 + FPN merge of res2.
    ``in_channels``: channels of res2..res5."""

    TRANS_NAMES = ("res5", "res4", "res3")          # low-res first

    def __init__(self, in_channels: Sequence[int], conv_dim: int = 512,
                 mask_dim: int = 512, num_enc_layers: int = 6, num_heads: int = 8,
                 n_points: int = 4, dim_feedforward: int = 1024, num_scales: int = 3,
                 dtype=torch.float32):
        super().__init__()
        C = conv_dim
        self.conv_dim, self.num_scales, self.num_enc_layers = C, num_scales, num_enc_layers
        self.dtype = dtype
        n = len(self.TRANS_NAMES)
        self.level_embed = nn.Parameter(torch.zeros(n, C))
        for i in range(n):
            # a plain Conv2d with bias + GN (transformer_encoder_deform.py:215-219)
            self.add_module(f"input_proj{i}", ConvGN(in_channels[3 - i], C, kernel=1,
                                                     bias=True, dtype=dtype))
        for i in range(num_enc_layers):
            self.add_module(f"encoder_layer{i}", MSDeformAttnEncoderLayer(
                C, num_heads, n, n_points, dim_feedforward, dtype))
        self.adapter_1 = ConvGN(in_channels[0], C, kernel=1, dtype=dtype)
        self.layer_1 = ConvGN(C, C, relu=True, dtype=dtype)
        self.mask_features = Conv(C, mask_dim, 1, dtype=dtype)

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        C, dt = self.conv_dim, self.dtype
        shapes = tuple(tuple(features[n].shape[1:3]) for n in self.TRANS_NAMES)
        srcs, poss = [], []
        for i, name in enumerate(self.TRANS_NAMES):
            x = getattr(self, f"input_proj{i}")(features[name])
            b, h, w, _ = x.shape
            # the level embedding rides the positional stream only
            pe = position_embedding_sine(h, w, C // 2, dtype=dt, device=x.device)
            pe = pe[None].expand(b, h, w, C).reshape(b, h * w, C)
            poss.append(pe + self.level_embed[i].to(dt)[None, None])
            srcs.append(x.reshape(b, h * w, C))
        src, pos = torch.cat(srcs, 1), torch.cat(poss, 1)
        ref = make_reference_points(shapes, device=src.device)
        for i in range(self.num_enc_layers):
            src = getattr(self, f"encoder_layer{i}")(src, pos, ref, shapes)
        outs, off = [], 0
        for hl, wl in shapes:
            outs.append(src[:, off:off + hl * wl].reshape(src.shape[0], hl, wl, C))
            off += hl * wl
        lateral = self.adapter_1(features["res2"])
        y = lateral + resize_bilinear(outs[-1], tuple(lateral.shape[1:3])).to(lateral.dtype)
        y = self.layer_1(y)
        return self.mask_features(y), outs[0], outs[: self.num_scales]
