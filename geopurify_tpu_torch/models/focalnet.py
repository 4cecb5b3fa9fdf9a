"""FocalNet backbone (``focal`` variant), NHWC in and out.

Port of geopurify_tpu/models/focalnet.py (the xdecoder_focall FocalNet:
conv patch embed, PostLN + LayerScale FocalModulation blocks with
depthwise focal convs, conv downsampling). The JAX stages run their blocks
under ``nn.scan`` with stacked parameters; here each stage is a ModuleList
``layers{i}_blocks`` that ``utils.from_jax`` fills by unstacking.
Inference only: DropPath / Dropout are identity.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from geopurify_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    Mlp,
    gelu_exact,
    gelu_poly,
)


def _gelu(x, fast: bool):
    return gelu_poly(x) if fast else gelu_exact(x)


# geopurify_tpu/models/focalnet.py:47
class PatchEmbed(nn.Module):
    """Overlapped conv patch embedding + LN: stem 7x7/4 pad 2, else 3x3/2."""

    def __init__(self, in_ch: int, embed_dim: int, is_stem: bool, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if is_stem:
            self.proj = Conv(in_ch, embed_dim, 7, stride=4, padding=2, dtype=dtype)
        else:
            self.proj = Conv(in_ch, embed_dim, 3, stride=2, padding=1, dtype=dtype)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        return self.norm(self.proj(x)).to(self.dtype)


# geopurify_tpu/models/focalnet.py:88
class FocalModulation(nn.Module):
    def __init__(self, dim: int, focal_level: int = 4, focal_window: int = 3,
                 focal_factor: int = 2, fast_gelu: bool = False, dtype=torch.float32):
        super().__init__()
        self.dim, self.focal_level, self.fast_gelu = dim, focal_level, fast_gelu
        self.f = Dense(dim, 2 * dim + focal_level + 1, dtype)
        for level in range(focal_level):
            k = focal_factor * level + focal_window
            self.add_module(f"focal_layers{level}",
                            Conv(dim, dim, k, groups=dim, bias=False, dtype=dtype))
        self.h = Conv(dim, dim, 1, dtype=dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x):                        # [B, H, W, C]
        C, L = self.dim, self.focal_level
        y = self.f(x)
        q, ctx, gates = y[..., :C], y[..., C:2 * C], y[..., 2 * C:]
        ctx_all = torch.zeros_like(ctx)
        for level in range(L):
            ctx = _gelu(getattr(self, f"focal_layers{level}")(ctx), self.fast_gelu)
            ctx_all = ctx_all + ctx * gates[..., level:level + 1]
        ctx_global = _gelu(ctx.mean(dim=(1, 2), keepdim=True), self.fast_gelu)
        ctx_all = (ctx_all + ctx_global * gates[..., L:]) / (L + 1)   # scaling modulator
        return self.proj(q * self.h(ctx_all))


# geopurify_tpu/models/focalnet.py:127 (use_dw=False, PostLN, LayerScale)
class FocalModulationBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 4.0, focal_level: int = 4,
                 focal_window: int = 3, fast_gelu: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gamma_1 = nn.Parameter(torch.full((dim,), 1e-4))
        self.gamma_2 = nn.Parameter(torch.full((dim,), 1e-4))
        self.norm1 = LayerNorm(dim)
        self.modulation = FocalModulation(dim, focal_level, focal_window,
                                          fast_gelu=fast_gelu, dtype=dtype)
        act = gelu_poly if fast_gelu else gelu_exact
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=act, dtype=dtype)
        self.norm2 = LayerNorm(dim)

    def forward(self, x):
        # f32 gammas promote the residual stream to f32 inside the block
        x = x + self.gamma_1 * self.norm1(self.modulation(x)).to(self.dtype)
        x = x + self.gamma_2 * self.norm2(self.mlp(x)).to(self.dtype)
        # the scan body's carry cast (focalnet.py:244)
        return x.to(self.dtype)


# geopurify_tpu/models/focalnet.py:247
class FocalNet(nn.Module):
    """4-stage FocalNet emitting {"res2".."res5"} NHWC maps."""

    def __init__(self, embed_dim: int = 192, depths: Sequence[int] = (2, 2, 18, 2),
                 focal_levels: Sequence[int] = (4, 4, 4, 4),
                 focal_windows: Sequence[int] = (3, 3, 3, 3),
                 mlp_ratio: float = 4.0, fast_gelu: bool = False,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = len(depths)
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(3, embed_dim, is_stem=True, dtype=dtype)
        for i in range(self.num_layers):
            dim = embed_dim * (2 ** i)
            self.add_module(f"layers{i}_blocks", nn.ModuleList([
                FocalModulationBlock(dim, mlp_ratio, focal_levels[i], focal_windows[i],
                                     fast_gelu=fast_gelu, dtype=dtype)
                for _ in range(depths[i])
            ]))
            if i in self.out_indices:
                self.add_module(f"norm{i}", LayerNorm(dim))
            if i < self.num_layers - 1:
                self.add_module(f"layers{i}_downsample",
                                PatchEmbed(dim, 2 * dim, is_stem=False, dtype=dtype))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:   # [B, H, W, 3]
        x = self.patch_embed(x)
        outs: Dict[str, torch.Tensor] = {}
        for i in range(self.num_layers):
            for blk in getattr(self, f"layers{i}_blocks"):
                x = blk(x)
            if i in self.out_indices:
                outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x).to(self.dtype)
            if i < self.num_layers - 1:
                x = getattr(self, f"layers{i}_downsample")(x)
        return outs
