"""DaViT backbone: dual (spatial window + channel group) attention, NHWC.

Port of geopurify_tpu/models/davit.py: 4 stages of dual-block pairs, each
a spatial block (depthwise-conv positional residual, pre-norm window
attention, conv, pre-norm MLP) then a channel block of the same shape with
group channel attention. Conv patch embeds (7/4/3 stem, then 3/2/1) between
stages: stage 0 post-norm, stages 1-3 pre-norm over the incoming channels;
the stage outputs carry no extra norm. GELU is the exact erf form.
Inference only.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from geopurify_tpu_torch.models.layers import Conv, Dense, LayerNorm, gelu_exact


# geopurify_tpu/models/davit.py:33
class DWConv(nn.Module):
    """Depthwise 3x3 conv residual (the conditional position encoding)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dw = Conv(dim, dim, 3, groups=dim, dtype=dtype)

    def forward(self, x):
        return x + self.dw(x)


# geopurify_tpu/models/davit.py:47
class ChannelAttention(nn.Module):
    """Group channel attention: softmax over channels, 1/sqrt(N) scaling."""

    def __init__(self, dim: int, groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.groups, self.dtype = groups, dtype
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x):                        # [B, N, C]
        B, N, C = x.shape
        g = self.groups
        qkv = self.qkv(x).reshape(B, N, 3, g, C // g).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (N ** -0.5), qkv[1], qkv[2]
        attn = torch.einsum("bgnd,bgne->bgde", q.float(), k.float())
        attn = torch.softmax(attn, -1).to(self.dtype)
        out = torch.einsum("bgde,bgne->bgnd", attn, v)
        return self.proj(out.permute(0, 2, 1, 3).reshape(B, N, C))


# geopurify_tpu/models/davit.py:72
class WindowAttention(nn.Module):
    """Non-shifted window multi-head attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.ws, self.dtype = num_heads, window_size, dtype
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x):                        # [B, H, W, C]
        B, H, W, C = x.shape
        ws, h = self.ws, self.num_heads
        xp = F.pad(x, (0, 0, 0, (-W) % ws, 0, (-H) % ws))
        Hp, Wp = xp.shape[1:3]
        nh, nw = Hp // ws, Wp // ws
        win = xp.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
        win = win.reshape(B * nh * nw, ws * ws, C)
        d = C // h
        qkv = self.qkv(win).reshape(-1, ws * ws, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (d ** -0.5), qkv[1], qkv[2]
        attn = torch.softmax(q.float() @ k.float().transpose(-1, -2), -1).to(self.dtype)
        out = (attn @ v).transpose(1, 2).reshape(-1, ws * ws, C)
        out = self.proj(out).reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(B, Hp, Wp, C)[:, :H, :W]


# geopurify_tpu/models/davit.py:112
class DualBlock(nn.Module):
    """One (spatial, channel) block pair."""

    def __init__(self, dim: int, num_heads: int, groups: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        hidden = int(dim * mlp_ratio)
        for t in ("s", "c"):
            self.add_module(f"{t}_cpe1", DWConv(dim, dtype))
            self.add_module(f"{t}_norm1", LayerNorm(dim))
            self.add_module(f"{t}_cpe2", DWConv(dim, dtype))
            self.add_module(f"{t}_norm2", LayerNorm(dim))
            self.add_module(f"{t}_mlp_fc1", Dense(dim, hidden, dtype))
            self.add_module(f"{t}_mlp_fc2", Dense(hidden, dim, dtype))
        self.s_attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.c_attn = ChannelAttention(dim, groups, dtype)

    def _half(self, t: str, x, attn):
        dt = self.dtype
        x = getattr(self, f"{t}_cpe1")(x)
        x = x + attn(getattr(self, f"{t}_norm1")(x).to(dt))
        x = getattr(self, f"{t}_cpe2")(x)
        h = getattr(self, f"{t}_norm2")(x).to(dt)
        return x + getattr(self, f"{t}_mlp_fc2")(gelu_exact(getattr(self, f"{t}_mlp_fc1")(h)))

    def forward(self, x):                        # [B, H, W, C]
        B, H, W, C = x.shape
        x = self._half("s", x, self.s_attn)
        return self._half("c", x, lambda h: self.c_attn(h.reshape(B, H * W, C))
                          .reshape(B, H, W, C))


# geopurify_tpu/models/davit.py:145
class DaViT(nn.Module):
    """4-stage DaViT emitting {"res2".."res5"}."""

    def __init__(self, embed_dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (1, 1, 3, 1),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 num_groups: Sequence[int] = (3, 6, 12, 24),
                 patch_size: Sequence[int] = (7, 3, 3, 3),
                 patch_stride: Sequence[int] = (4, 2, 2, 2),
                 patch_padding: Sequence[int] = (3, 1, 1, 1),
                 patch_prenorm: Sequence[bool] = (False, True, True, True),
                 window_size: int = 7, mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.dtype, self.depths = dtype, tuple(depths)
        # pre-norm normalizes the incoming channels and never the raw image
        self.prenorm = tuple(bool(p) and s > 0 for s, p in enumerate(patch_prenorm))
        self.postnorm = tuple(not p for p in patch_prenorm)
        for s in range(4):
            cin = 3 if s == 0 else embed_dims[s - 1]
            self.add_module(f"patch_embed{s}", Conv(
                cin, embed_dims[s], patch_size[s], stride=patch_stride[s],
                padding=patch_padding[s], dtype=dtype))
            if self.prenorm[s]:
                self.add_module(f"embed_norm{s}", LayerNorm(cin))
            elif self.postnorm[s]:
                self.add_module(f"embed_norm{s}", LayerNorm(embed_dims[s]))
            for b in range(depths[s]):
                self.add_module(f"stage{s}_block{b}", DualBlock(
                    embed_dims[s], num_heads[s], num_groups[s], window_size, mlp_ratio,
                    dtype))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:   # [B, H, W, 3]
        outs: Dict[str, torch.Tensor] = {}
        for s in range(4):
            if self.prenorm[s]:
                x = getattr(self, f"embed_norm{s}")(x).to(self.dtype)
            x = getattr(self, f"patch_embed{s}")(x)
            if self.postnorm[s]:
                x = getattr(self, f"embed_norm{s}")(x).to(self.dtype)
            for b in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x)
            outs[f"res{s + 2}"] = x
        return outs
