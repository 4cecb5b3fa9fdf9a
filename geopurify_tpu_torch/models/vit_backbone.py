"""Plain ViT backbone (ViTDet / SAM style) with a SimpleFPN neck, NHWC.

Port of geopurify_tpu/models/vit_backbone.py: 16x16 patch embed, an
absolute position table resized to the input grid (``jax.image.resize``
bilinear, antialiased on downscale), pre-norm blocks with windowed
attention except at the global-attention indices, decomposed relative
position biases on the attention logits, and a deconv / conv neck that
turns the stride-16 map into res2..res5. GELU is the exact erf form.
Inference only.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geopurify_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    GroupNorm,
    LayerNorm,
    gelu_exact,
    resize_bilinear,
)


# geopurify_tpu/models/vit_backbone.py:33
def _rel_pos_bias(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """[q_size, k_size, C] decomposed relative positions. A table whose
    length is not 2 * size - 1 is first resized linearly
    (F.interpolate(mode='linear', align_corners=False): half-pixel centres,
    no kernel widening on downscale)."""
    need = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != need:
        rel_pos = F.interpolate(rel_pos.to(torch.float32).T[None], size=need,
                                mode="linear", align_corners=False)[0].T
    coords = (torch.arange(q_size, device=rel_pos.device)[:, None]
              - torch.arange(k_size, device=rel_pos.device)[None, :])
    return rel_pos[coords + (k_size - 1)]


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NHWC padding of flax's 'SAME' for a k x k, stride-s conv."""
    pads = []
    for n in (x.shape[2], x.shape[1]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0, *pads)) if any(pads) else x


# geopurify_tpu/models/vit_backbone.py:58
class ViTAttention(nn.Module):
    """MHA with decomposed relative position biases; ``input_size`` is the
    rel-pos table's grid (the pretrain grid or the window)."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int],
                 dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        d = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, d))

    def forward(self, x):                        # [B, H, W, C]
        B, H, W, C = x.shape
        h = self.num_heads
        d = C // h
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, h, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * (d ** -0.5)).float() @ k.float().transpose(-1, -2)
        rh = _rel_pos_bias(self.rel_pos_h, H, H).float()         # [H, H, d]
        rw = _rel_pos_bias(self.rel_pos_w, W, W).float()         # [W, W, d]
        # the unscaled q feeds the rel-pos einsums (vit.py:240-245)
        qr = q.float().reshape(B, h, H, W, d)
        bias_h = torch.einsum("bhywd,ykd->bhywk", qr, rh)
        bias_w = torch.einsum("bhywd,wkd->bhywk", qr, rw)
        attn = attn.reshape(B, h, H, W, H, W) + bias_h[..., :, None] + bias_w[..., None, :]
        attn = torch.softmax(attn.reshape(B, h, H * W, H * W), -1).to(self.dtype)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(B, H, W, C)
        return self.proj(out)


# geopurify_tpu/models/vit_backbone.py:110
class ViTBlock(nn.Module):
    """Pre-norm block (LayerNorm eps 1e-6); windowed unless
    ``window_size`` is 0 (global attention)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 14,
                 input_size: Tuple[int, int] = (64, 64), mlp_ratio: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.ws, self.dtype = window_size, dtype
        self.norm1 = LayerNorm(dim, eps=1e-6)
        size = (window_size, window_size) if window_size > 0 else tuple(input_size)
        self.attn = ViTAttention(dim, num_heads, size, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x):                        # [B, H, W, C]
        B, H, W, C = x.shape
        shortcut, ws = x, self.ws
        x = self.norm1(x).to(self.dtype)
        if ws > 0:
            x = F.pad(x, (0, 0, 0, (-W) % ws, 0, (-H) % ws))
            Hp, Wp = x.shape[1:3]
            nh, nw = Hp // ws, Wp // ws
            x = x.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
            x = self.attn(x.reshape(B * nh * nw, ws, ws, C))
            x = x.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(B, Hp, Wp, C)[:, :H, :W]
        else:
            x = self.attn(x)
        x = shortcut + x
        h = self.mlp_fc2(gelu_exact(self.mlp_fc1(self.norm2(x).to(self.dtype))))
        return x + h


# geopurify_tpu/models/vit_backbone.py:153
class SimpleFPN(nn.Module):
    """Deconv / conv neck: one stride-16 map -> res2..res5."""

    def __init__(self, in_dim: int = 768, out_dims: Sequence[int] = (128, 256, 512, 1024),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c4 = max(out_dims[0] * 2, in_dim // 2)
        c8 = max(out_dims[1], in_dim // 2)
        c32 = max(out_dims[3], in_dim * 2)
        self.d4_up1 = ConvTranspose(in_dim, c4, 2, dtype)
        self.d4_up2 = ConvTranspose(c4, c4 // 2, 2, dtype)
        self.d4_out = Conv(c4 // 2, out_dims[0], 1, dtype=dtype)
        self.d8_up = ConvTranspose(in_dim, c8, 2, dtype)
        self.d8_out = Conv(c8, out_dims[1], 1, dtype=dtype)
        self.d16_out = Conv(in_dim, out_dims[2], 1, dtype=dtype)
        self.d32_down = Conv(in_dim, c32, 2, stride=2, padding=0, dtype=dtype)
        self.d32_out = Conv(c32, out_dims[3], 1, dtype=dtype)
        for name, c in (("d4_gn1", c4), ("d4_gn2", c4 // 2), ("d4_gn3", out_dims[0]),
                        ("d8_gn1", c8), ("d8_gn2", out_dims[1]), ("d16_gn", out_dims[2]),
                        ("d32_gn1", c32), ("d32_gn2", out_dims[3])):
            self.add_module(name, GroupNorm(1, c))

    def _gn(self, name, y):
        return getattr(self, name)(y).to(self.dtype)

    def forward(self, x) -> Dict[str, torch.Tensor]:     # [B, H16, W16, C]
        y = gelu_exact(self._gn("d4_gn1", self.d4_up1(x)))
        y = self._gn("d4_gn2", self.d4_up2(y))
        res2 = gelu_exact(self._gn("d4_gn3", self.d4_out(y)))
        y = self._gn("d8_gn1", self.d8_up(x))
        res3 = gelu_exact(self._gn("d8_gn2", self.d8_out(y)))
        res4 = gelu_exact(self._gn("d16_gn", self.d16_out(x)))
        y = self._gn("d32_gn1", self.d32_down(_same_pad(x, 2, 2)))
        res5 = gelu_exact(self._gn("d32_gn2", self.d32_out(y)))
        return {"res2": res2, "res3": res3, "res4": res4, "res5": res5}


# geopurify_tpu/models/vit_backbone.py:188
class ViTBackbone(nn.Module):
    """Patch embed + blocks (+ absolute / relative positions) + SimpleFPN."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 out_dims: Sequence[int] = (128, 256, 512, 1024), pretrain_grid: int = 64,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.dtype, self.depth, self.patch_size = dtype, depth, patch_size
        self.patch_embed = Conv(3, embed_dim, patch_size, stride=patch_size, padding=0,
                                dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(pretrain_grid, pretrain_grid, embed_dim))
        for i in range(depth):
            ws = 0 if i in tuple(global_attn_indexes) else window_size
            self.add_module(f"block{i}", ViTBlock(
                embed_dim, num_heads, ws, (pretrain_grid, pretrain_grid), mlp_ratio, dtype))
        self.neck = SimpleFPN(embed_dim, tuple(out_dims), dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:   # [B, H, W, 3]
        p = self.patch_size
        x = self.patch_embed(_same_pad(x, p, p))
        _, H, W, _ = x.shape
        pos = resize_bilinear(self.pos_embed.to(torch.float32)[None], (H, W))[0]
        x = x + pos[None].to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.neck(x)
