"""FocalNet backbone of the plain reference, NHWC in and out: a frozen copy
of the port's ``models/focalnet.py``.

FocalNet backbone, NHWC in and out, with the JAX FocalNet's options.

Port of geopurify_tpu/models/focalnet.py: conv patch embed (overlapped 7x7
stem, or non-overlapped ``patch_size`` patches), FocalModulation blocks with
depthwise focal convs, post- or pre-LN, with or without LayerScale, and
conv downsampling. ``use_dw`` is the focal_dw variant (the SEEM-release
FocalNet): depthwise residual convs in every block, stem pad 3 and the
optional pre-norm downsample embeds. The JAX stages run their blocks under
``nn.scan`` with stacked parameters; here each stage is a ModuleList
``layers{i}_blocks`` that ``utils.from_jax`` fills by unstacking.
Inference only: DropPath / Dropout are identity.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from perfbench.reference.layers import (
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
    """Conv patch embedding + LN. Overlapped (``use_conv_embed``): stem 7x7/4
    padded ``stem_pad``, else 3x3/2 pad 1; non-overlapped: ``patch_size``
    patches (stem) or 2x2/2. ``pre_norm`` normalizes the incoming channels
    before the projection instead of the output."""

    def __init__(self, in_ch: int, embed_dim: int, is_stem: bool,
                 use_conv_embed: bool = True, patch_size: int = 4, stem_pad: int = 2,
                 pre_norm: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype, self.pre_norm = dtype, pre_norm
        if use_conv_embed:
            k, s, p = (7, 4, stem_pad) if is_stem else (3, 2, 1)
        else:
            k = patch_size if is_stem else 2
            s, p = k, 0
        self.proj = Conv(in_ch, embed_dim, k, stride=s, padding=p, dtype=dtype)
        self.norm = LayerNorm(in_ch if pre_norm else embed_dim)

    def forward(self, x):
        if self.pre_norm:
            return self.proj(self.norm(x).to(self.dtype))
        return self.norm(self.proj(x)).to(self.dtype)


# geopurify_tpu/models/focalnet.py:88
class FocalModulation(nn.Module):
    def __init__(self, dim: int, focal_level: int = 4, focal_window: int = 3,
                 focal_factor: int = 2, scaling_modulator: bool = True,
                 use_postln_in_modulation: bool = False, fast_gelu: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.focal_level, self.fast_gelu = dim, focal_level, fast_gelu
        self.scaling_modulator, self.dtype = scaling_modulator, dtype
        self.f = Dense(dim, 2 * dim + focal_level + 1, dtype)
        for level in range(focal_level):
            k = focal_factor * level + focal_window
            self.add_module(f"focal_layers{level}",
                            Conv(dim, dim, k, groups=dim, bias=False, dtype=dtype))
        self.h = Conv(dim, dim, 1, dtype=dtype)
        self.ln = LayerNorm(dim) if use_postln_in_modulation else None
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
        ctx_all = ctx_all + ctx_global * gates[..., L:]
        if self.scaling_modulator:
            ctx_all = ctx_all / (L + 1)
        out = q * self.h(ctx_all)
        if self.ln is not None:
            out = self.ln(out).to(self.dtype)
        return self.proj(out)


# geopurify_tpu/models/focalnet.py:127
class FocalModulationBlock(nn.Module):
    """Post- or pre-LN block with optional LayerScale. ``use_dw`` (focal_dw)
    adds depthwise 3x3 residual convs before the modulation (dw1) and the
    FFN (dw2), and under post-LN moves norm1 after the modulation's
    residual add and norm2 over the whole FFN residual."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, focal_level: int = 4,
                 focal_window: int = 3, use_postln: bool = True,
                 use_postln_in_modulation: bool = False, scaling_modulator: bool = True,
                 use_layerscale: bool = True, use_dw: bool = False,
                 fast_gelu: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype, self.use_postln, self.use_dw = dtype, use_postln, use_dw
        if use_layerscale:
            self.gamma_1 = nn.Parameter(torch.full((dim,), 1e-4))
            self.gamma_2 = nn.Parameter(torch.full((dim,), 1e-4))
        else:
            self.gamma_1 = self.gamma_2 = 1.0
        self.norm1 = LayerNorm(dim)
        if use_dw:
            self.dw1 = Conv(dim, dim, 3, groups=dim, dtype=dtype)
            self.dw2 = Conv(dim, dim, 3, groups=dim, dtype=dtype)
        self.modulation = FocalModulation(
            dim, focal_level, focal_window, scaling_modulator=scaling_modulator,
            use_postln_in_modulation=use_postln_in_modulation, fast_gelu=fast_gelu,
            dtype=dtype)
        act = gelu_poly if fast_gelu else gelu_exact
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=act, dtype=dtype)
        self.norm2 = LayerNorm(dim)

    def forward(self, x):
        # f32 gammas and norms promote the residual stream to f32 inside the
        # block, as in JAX
        dt = self.dtype
        if self.use_dw:
            x = x + self.dw1(x)
        shortcut = x
        if not self.use_postln:
            x = self.norm1(x).to(dt)
        x = self.modulation(x)
        if self.use_dw:
            x = shortcut + self.gamma_1 * x
            if self.use_postln:
                x = self.norm1(x).to(dt)
            x = x + self.dw2(x)
        else:
            if self.use_postln:
                x = self.norm1(x).to(dt)
            x = shortcut + self.gamma_1 * x
        if not self.use_postln:
            x = x + self.gamma_2 * self.mlp(self.norm2(x).to(dt))
        elif self.use_dw:
            x = self.norm2(x + self.gamma_2 * self.mlp(x)).to(dt)
        else:
            x = x + self.gamma_2 * self.norm2(self.mlp(x)).to(dt)
        # the scan body's carry cast (focalnet.py:244)
        return x.to(dt)


# geopurify_tpu/models/focalnet.py:247
class FocalNet(nn.Module):
    """4-stage FocalNet emitting {"res2".."res5"} NHWC maps.
    ``use_pre_norms[i]`` applies to the downsample embed closing stage i."""

    def __init__(self, embed_dim: int = 192, depths: Sequence[int] = (2, 2, 18, 2),
                 focal_levels: Sequence[int] = (4, 4, 4, 4),
                 focal_windows: Sequence[int] = (3, 3, 3, 3),
                 mlp_ratio: float = 4.0, use_conv_embed: bool = True,
                 use_postln: bool = True, use_postln_in_modulation: bool = False,
                 scaling_modulator: bool = True, use_layerscale: bool = True,
                 use_dw: bool = False,
                 use_pre_norms: Sequence[bool] = (False, False, False, False),
                 fast_gelu: bool = False, patch_size: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = len(depths)
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(3, embed_dim, is_stem=True,
                                      use_conv_embed=use_conv_embed, patch_size=patch_size,
                                      stem_pad=3 if use_dw else 2, dtype=dtype)
        for i in range(self.num_layers):
            dim = embed_dim * (2 ** i)
            self.add_module(f"layers{i}_blocks", nn.ModuleList([
                FocalModulationBlock(
                    dim, mlp_ratio, focal_levels[i], focal_windows[i],
                    use_postln=use_postln, use_postln_in_modulation=use_postln_in_modulation,
                    scaling_modulator=scaling_modulator, use_layerscale=use_layerscale,
                    use_dw=use_dw, fast_gelu=fast_gelu, dtype=dtype)
                for _ in range(depths[i])
            ]))
            if i in self.out_indices:
                self.add_module(f"norm{i}", LayerNorm(dim))
            if i < self.num_layers - 1:
                self.add_module(f"layers{i}_downsample", PatchEmbed(
                    dim, 2 * dim, is_stem=False, use_conv_embed=use_conv_embed,
                    pre_norm=bool(use_pre_norms[i]), dtype=dtype))

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
