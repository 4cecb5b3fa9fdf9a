"""FPN pixel decoder of the plain reference: a frozen copy of the port's
``models/pixel_decoder.py``.

FPN pixel decoder with a transformer encoder on the coarsest level.

Port of geopurify_tpu/models/pixel_decoder.py:30 (TransformerEncoderPixelDecoder):
res5 -> 1x1 input proj -> post-norm transformer encoder with sine PE ->
3x3 GN+ReLU; FPN laterals (1x1 conv + GN) with nearest upsampling and 3x3
GN+ReLU down to res2; a final 3x3 conv gives the stride-4 mask features.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from perfbench.reference.layers import (
    Conv,
    ConvGN,
    TransformerEncoderLayer,
    position_embedding_sine,
    resize_nearest,
)


# geopurify_tpu/models/pixel_decoder.py:30
class TransformerEncoderPixelDecoder(nn.Module):
    def __init__(self, in_channels: Sequence[int], conv_dim: int = 512,
                 mask_dim: int = 512, num_enc_layers: int = 6, num_heads: int = 8,
                 dim_feedforward: int = 2048, num_scales: int = 3,
                 pre_norm: bool = False, dtype=torch.float32):
        """``in_channels``: channels of res2..res5."""
        super().__init__()
        self.conv_dim, self.num_scales, self.dtype = conv_dim, num_scales, dtype
        self.num_enc_layers = num_enc_layers
        self.input_proj = Conv(in_channels[3], conv_dim, 1, dtype=dtype)
        for i in range(num_enc_layers):
            self.add_module(f"encoder_layer{i}", TransformerEncoderLayer(
                conv_dim, num_heads, dim_feedforward, dtype=dtype, pre_norm=pre_norm))
        self.layer_4 = ConvGN(conv_dim, conv_dim, relu=True, dtype=dtype)
        for level in (2, 1, 0):
            self.add_module(f"adapter_{level + 1}", ConvGN(
                in_channels[level], conv_dim, kernel=1, dtype=dtype))
            self.add_module(f"layer_{level + 1}", ConvGN(
                conv_dim, conv_dim, relu=True, dtype=dtype))
        self.mask_features = Conv(conv_dim, mask_dim, 3, dtype=dtype)

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """Returns (mask_features, transformer_features, multi_scale[3]
        low-res first)."""
        multi_scale: List[torch.Tensor] = []
        x5 = features["res5"]
        b, h, w, _ = x5.shape
        t = self.input_proj(x5)
        pos = position_embedding_sine(h, w, self.conv_dim // 2, dtype=self.dtype,
                                      device=x5.device)
        pos = pos[None].expand(b, h, w, self.conv_dim).reshape(b, h * w, -1)
        t = t.reshape(b, h * w, self.conv_dim)
        for i in range(self.num_enc_layers):
            t = getattr(self, f"encoder_layer{i}")(t, pos=pos)
        transformer_features = t.reshape(b, h, w, self.conv_dim)
        y = self.layer_4(transformer_features)
        multi_scale.append(y)
        for level, name in zip((2, 1, 0), ("res4", "res3", "res2")):
            lateral = getattr(self, f"adapter_{level + 1}")(features[name])
            y = lateral + resize_nearest(y, tuple(lateral.shape[1:3]))
            y = getattr(self, f"layer_{level + 1}")(y)
            if len(multi_scale) < self.num_scales:
                multi_scale.append(y)
        return self.mask_features(y), transformer_features, multi_scale
